"""Σ rᵢ·Pᵢ on the card: the Pippenger bucket MSM (host plan and three
kernels), and the tree sums of the verify kernels.

The bucket MSM is the port of grandine_tpu/tpu/msm.py: `plan_msm` /
`MsmPlan` (:60-205) are this module's own copies and give the same
arrays; `expand_glv_points` + `msm_bucket_scan` (:362, :244) become three
hand-written kernels (csrc/msm.cu) and their plain versions:

  msm_lane_scan — one thread a lane of the plan's (S, T) sorted-lane
      grid: load Pₑ (e < N) or φPₑ₋ₙ (the GLV expansion, done at load),
      complete-add it into the lane's accumulator, write the accumulator
      at a flush and restart from ∞;
  msm_bucket_reduce — one block a section (group·W + window), one thread
      a digit: fold the digit's J pieces, the Hillis–Steele digit suffix
      U_d = Σ_{e≥d} S_e, ∞ at digit 0, the tree sum Σ_{d≥1} U_d = Σ d·S_d;
  msm_horner — the window totals from high to low, from the top total
      on w doublings and one complete addition each: in G1 one thread a group on `fpc` (the Fp product as a call), in G2
      one warp a group on G2DBL and G2ADD warp programs.

`msm_bucket_scan` composes them over plan arrays already on the device
(the reference's programs take them so); `msm_bucket_sum` over an
`MsmPlan` on the host. Each wrapper launches its kernel on CUDA tensors
and runs its plain version on CPU tensors; the plain versions repeat the
kernels' additions in the kernels' order, so kernel and plain version
agree word for word (Jacobian canonical words), and against the JAX
package the tests compare affine points.

`strided_tree_sum` fixes the summation order the other kernels use —
thread t of a block of T threads accumulates rows t, t + T, … and the
block then folds position t + s into t for s = pow2ceil(T)/2 … 1 — so a
kernel's Jacobian output equals its plain version's bit for bit;
`sum_points_contiguous` applies it per group of a flat batch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace

import numpy as np
import torch

from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L

#: threads of the kernels' summation trees (BLS_TREE in csrc/bls12_381.cuh)
TREE = 128


def _pad_inf(points, ax, n, ops):
    """Append n ∞ points (1, 1, 0) along batch axis `ax`."""
    X, Y, Z = points
    one = ops.one(X.shape[:ax] + (n,), X.device)
    return (torch.cat([X, one], ax), torch.cat([Y, one], ax),
            torch.cat([Z, torch.zeros_like(one)], ax))


def strided_tree_sum(points, live, ops, tree: int = TREE):
    """Sum (…, N) Jacobian points along the last batch axis in the order
    of a `tree`-thread block: thread t adds rows t, t + tree, … and the
    block then folds position t + s into t (t + s < tree) for s =
    pow2ceil(tree)/2 … 1, which equals folding a tree padded with ∞ to a
    power of two (∞ + P returns P's words). Rows with live=False count as
    ∞."""
    X = points[0]
    ax = len(ops.batch(X)) - 1
    n = X.shape[ax]
    chunks = max(1, -(-n // tree))
    pad = chunks * tree - n
    if pad:
        points = _pad_inf(points, ax, pad, ops)
        live = torch.cat([live, live.new_zeros(live.shape[:-1] + (pad,))], -1)
    pts = C._mask_inf(points, ~live, ops)
    one = ops.one(X.shape[:ax] + (tree,), X.device)
    acc = (one, one, torch.zeros_like(one))
    for c in range(chunks):
        acc = C.point_add_complete(
            acc, tuple(t.narrow(ax, c * tree, tree) for t in pts), ops)
    width = 1 << (tree - 1).bit_length()
    if width > tree:
        acc = _pad_inf(acc, ax, width - tree, ops)
    return C.sum_points_grouped(acc, ops)


def group_rows(offsets, device):
    """(M, K) row indices and live mask of M groups given by offsets
    (M + 1 ints): group m holds rows offsets[m] … offsets[m+1] − 1, K the
    widest group (at least 1); padding positions index row 0."""
    off = np.asarray(offsets, np.int64)
    counts = np.diff(off)
    k = max(1, int(counts.max(initial=0)))
    pos = np.arange(k)
    live = pos[None, :] < counts[:, None]
    idx = np.where(live, off[:-1, None] + pos[None, :], 0)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(live).to(device))


def sum_points_contiguous(points, offsets, ops, tree: int = TREE):
    """Per-group sums of a flat (N,) batch of Jacobian points over the
    contiguous groups [offsets[m], offsets[m+1]) — ∞ for an empty group —
    each in the order of a `tree`-thread block (strided_tree_sum). The
    counterpart of grandine_tpu/tpu/curve.py sum_points_contiguous (groups
    of one power-of-two width there; any offsets here)."""
    if points[0].shape[0] == 0:  # every group empty: give the gather a row
        points = _pad_inf(points, 0, 1, ops)
    idx, live = group_rows(offsets, points[0].device)
    return strided_tree_sum(tuple(c[idx] for c in points), live, ops, tree)


# --- the Pippenger bucket MSM: host plan ---------------------------------

#: scan lanes T of a plan (the reference's default, grandine_tpu/tpu/msm.py
#: MSM_LANES); `plan_msm` halves it for small batches. Pass another count
#: through `lanes=`.
MSM_LANES = 8192


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


@dataclass(frozen=True)
class MsmPlan:
    """Static-shape plan of one MSM batch (host-built, numpy), the port's
    copy of grandine_tpu/tpu/msm.py MsmPlan.

    Shapes: point_idx/valid/flush (S, T); gather_idx/gather_valid
    (J, n_groups·W, B). point_idx indexes the EXPANDED point array
    (e < N → r0-slot of point e; e ≥ N → r1/φ-slot of point e−N).
    """

    point_idx: np.ndarray
    valid: np.ndarray
    flush: np.ndarray
    gather_idx: np.ndarray
    gather_valid: np.ndarray
    n_groups: int
    windows: int
    window_bits: int

    @property
    def arrays(self):
        return (
            self.point_idx, self.valid, self.flush,
            self.gather_idx, self.gather_valid,
        )


def plan_msm(r_lo, r_hi, inf_mask, group_of_point=None, n_groups: int = 1,
             window_bits: int = 8, lanes: "int | None" = None,
             j_min: int = 2) -> MsmPlan:
    """The plan of Σᵢ (r0ᵢ + r1ᵢ·λ)·Pᵢ per group (grandine_tpu/tpu/msm.py
    plan_msm, the same arrays for the same inputs).

    r_lo/r_hi: (N,) 32-bit GLV scalar halves. inf_mask: (N,) bool — points
    at infinity contribute nothing and are dropped here. group_of_point:
    (N,) ints (None → all group 0). Zero digits are dropped; the
    expanded entries are sorted by (section, digit), section = group·W +
    window, and dealt contiguously into T lanes of S slots; a rank flushes
    where the next starts a new bucket or a new lane, and the j-th flush of
    a bucket is its piece j of at most J."""
    r_lo = np.asarray(r_lo, dtype=np.uint64)
    r_hi = np.asarray(r_hi, dtype=np.uint64)
    n = r_lo.shape[0]
    w = window_bits
    W = (32 + w - 1) // w
    B = 1 << w
    n_sec = n_groups * W
    inf_mask = np.asarray(inf_mask, dtype=bool)

    # digits (2N, W) of the expanded scalars, in 32-bit words (every
    # window's shift is below 32); drop zero digits and ∞ points
    scal = np.concatenate([r_lo, r_hi]).astype(np.uint32)
    shifts = (np.arange(W, dtype=np.uint32) * np.uint32(w))[None, :]
    digits = (scal[:, None] >> shifts) & np.uint32(B - 1)
    keep = digits != 0
    keep[np.concatenate([inf_mask, inf_mask])] = False
    e_idx, e_win = np.nonzero(keep)  # entry → (expanded point, window)
    # key = section·B + digit, section = group·W + window
    key = e_win * B + digits[e_idx, e_win]
    if group_of_point is not None:
        grp = np.asarray(group_of_point, dtype=np.int64)
        key = key + np.concatenate([grp, grp])[e_idx] * (W * B)

    # a stable sort; keys below 2^16 take numpy's radix sort
    key = key.astype(np.uint16 if n_sec * B <= 1 << 16 else np.int64)
    order = np.argsort(key, kind="stable")
    k_sorted = key[order].astype(np.int64)
    E = order.shape[0]

    # T lanes × S slots; lane t owns sorted ranks [t·S, (t+1)·S). S is a
    # function of the UNPRUNED total, not of the scalars drawn.
    T = int(lanes if lanes is not None else MSM_LANES)
    total = 2 * n * W
    while T > 256 and total < 8 * T:
        T //= 2
    S = max(1, -(-total // T))

    # rank r sits at (r % S, r // S): the (S, T) arrays filled column by
    # column. A rank flushes where the next starts a new bucket or a new
    # lane, and the last rank flushes.
    idx_ts = np.zeros(T * S, dtype=np.int32)
    idx_ts[:E] = e_idx[order]
    valid_ts = np.zeros(T * S, dtype=bool)
    valid_ts[:E] = True
    last = np.zeros(T * S, dtype=bool)
    if E:
        last[:E - 1] = k_sorted[1:] != k_sorted[:-1]
        last[S - 1:E:S] = True
        last[E - 1] = True
    point_idx = np.ascontiguousarray(idx_ts.reshape(T, S).T)
    valid = np.ascontiguousarray(valid_ts.reshape(T, S).T)
    flush = np.ascontiguousarray(last.reshape(T, S).T)

    # pieces: the j-th flush of a key is that bucket's piece j
    fr = np.flatnonzero(last)
    fkey = k_sorted[fr]
    m = fr.shape[0]
    pos = np.arange(m)
    first_of_key = np.empty(m, dtype=bool)
    if m:
        first_of_key[0] = True
        first_of_key[1:] = fkey[1:] != fkey[:-1]
    first_pos = (np.maximum.accumulate(np.where(first_of_key, pos, 0)) if m
                 else pos)
    piece_j = pos - first_pos
    # J from a data-independent floor (mean + 6√mean + 8 entries a bucket,
    # in lanes spanned) so that it does not move with the draw, as the
    # reference's compiled shapes need; the card needs no fixed J, but
    # equal inputs give the reference's arrays
    mean_bucket = total / max(1, n_groups * W * B)
    tail_bucket = mean_bucket + 6.0 * mean_bucket ** 0.5 + 8.0
    predicted = int(-(-tail_bucket // S)) + 1
    actual = int(piece_j.max()) + 1 if m else 1
    J = _next_pow2(max(j_min, predicted, actual))

    # piece j of bucket key at [j, key // B, key % B]; the emit slot of
    # rank r in the (S, T) scan output is (r % S)·T + (r // S)
    gather_idx = np.zeros((J, n_sec * B), dtype=np.int32)
    gather_valid = np.zeros((J, n_sec * B), dtype=bool)
    gather_idx[piece_j, fkey] = (fr % S) * T + fr // S
    gather_valid[piece_j, fkey] = True
    gather_idx = gather_idx.reshape(J, n_sec, B)
    gather_valid = gather_valid.reshape(J, n_sec, B)

    return MsmPlan(point_idx=point_idx, valid=valid, flush=flush,
                   gather_idx=gather_idx, gather_valid=gather_valid,
                   n_groups=n_groups, windows=W, window_bits=w)


_ARRAYS = ("point_idx", "valid", "flush", "gather_idx", "gather_valid")


def upload_plan(plan: MsmPlan, device) -> MsmPlan:
    """The plan with its five arrays as tensors on `device`; to a card
    through pinned memory without waiting (a copy from pageable memory
    would first wait for the kernels queued on the stream)."""
    dev = torch.device(device)
    out = []
    for a in plan.arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out.append(t)
    return replace(plan, **dict(zip(_ARRAYS, out)))


# --- the Pippenger bucket MSM: kernels and plain versions ---------------------


def _field(t: torch.Tensor, lead: int):
    """(k, ops) of point words with `lead` axes before the field axes:
    (…, 12) coordinates are G1 over Fp, (…, 2, 12) G2 over Fp2."""
    k = t.dim() - lead
    if k not in (1, 2) or t.shape[-1] != 12 or (k == 2 and t.shape[-2] != 2):
        raise ValueError(f"expected G1 (…, 12) or G2 (…, 2, 12) words, got "
                         f"{tuple(t.shape)}")
    return k, (C.FP_OPS if k == 1 else C.FP2_OPS)


def _inf(ops, batch, device):
    one = ops.one(batch, device)
    return one, one, torch.zeros_like(one)


def _add(p, q, ops):
    """C.point_add_complete(p, q), its formulas evaluated only where
    neither point is ∞; elsewhere its select chain gives q (p ∞) or p
    (q ∞), so the words are the same. Most buckets of a small batch are
    ∞, which keeps the plain versions cheap on the CPU."""
    p_inf, q_inf = ops.is_zero(p[2]), ops.is_zero(q[2])
    out = C._sel3(p_inf, q, p)
    at = (~p_inf & ~q_inf).nonzero(as_tuple=True)
    if at[0].numel():
        both = C.point_add_complete(tuple(c[at] for c in p),
                                    tuple(c[at] for c in q), ops)
        for o, c in zip(out, both):
            o[at] = c
    return out


def msm_lane_scan_plain(px, py, live, point_idx, valid, flush):
    """Plain version of `msm_lane_scan`: the T lanes as one batch, S steps
    of complete additions; the φ-expansion of the N points ahead of the
    loop; zero words at slots that do not flush."""
    k, ops = _field(px, 1)
    n = px.shape[0]
    S, T = point_idx.shape
    dev = px.device
    shape = (S * T, 3) + tuple(px.shape[1:])
    if n == 0:  # no point: no entry is valid, nothing flushes
        return torch.zeros(shape, dtype=torch.int32, device=dev)
    x, y = L.from_words(px), L.from_words(py)
    endo = C.g1_endo(dev) if k == 1 else C.g2_endo(dev)
    x2, y2 = ops.mul_many([x, y], list(endo))
    ex, ey = torch.cat([x, x2]), torch.cat([y, y2])
    elive = torch.cat([live, live])
    inf = _inf(ops, (T,), dev)
    zero = tuple(torch.zeros_like(c) for c in inf)
    acc, out = inf, []
    for s in range(S):
        e = point_idx[s].long()
        pt = C._sel3(valid[s] & elive[e], (ex[e], ey[e], inf[0]), inf)
        acc = _add(acc, pt, ops)
        out.append(C._sel3(flush[s], acc, zero))
        acc = C._sel3(flush[s], inf, acc)
    emit = tuple(torch.stack([o[i] for o in out]) for i in range(3))
    return C.jac_to_words(emit, k).reshape(shape)


def msm_lane_scan(px, py, live, point_idx, valid, flush):
    """The bucket pieces of a plan's sorted-lane grid: px, py (N, 12) (G1)
    or (N, 2, 12) (G2) affine canonical words of the N points, live (N,)
    (a point not live adds ∞ wherever the plan takes it), point_idx
    (S, T) int32 into the expanded batch (e < N: Pₑ, else φPₑ₋ₙ), valid
    and flush (S, T) bool. Lane t adds its column's points in order and
    at each flush writes its sum to slot s·T + t and restarts from ∞.
    Returns (S·T, 3, [2,] 12) Jacobian words, zero at slots that do not
    flush (`msm_bucket_reduce` reads only flushed ones). CUDA kernel
    `msm_lane_scan` (csrc/msm.cu, instances g1_ and g2_) on CUDA tensors,
    the plain version on CPU tensors.

    Replaces grandine_tpu/tpu/msm.py expand_glv_points (:362) and step 1
    of msm_bucket_scan (:274-306, the gather into lanes and the S-step
    lax.scan). One thread a lane, one warp a block so that the T/32
    blocks spread over the SMs. Bound: operations — the least work is one
    mixed addition a live entry (the point loaded is affine: 11 Fp
    products in G1, 33 in G2; the kernel runs a complete one, 16 or 48)
    plus two for the φ of an r1 entry, against 100 (G1) or 196 (G2) bytes
    read an entry; at the route's T = 2,048 lanes (64 warps on 132 SMs)
    the kernel is latency-bound on the S ≈ 12 dependent additions of a
    lane."""
    if px.device.type == "cpu":
        return msm_lane_scan_plain(px, py, live, point_idx, valid, flush)
    from grandine_tpu_torch.gpu import _build

    k, _ = _field(px, 1)
    n = px.shape[0]
    S, T = point_idx.shape
    if (py.shape != px.shape or live.shape != (n,)
            or point_idx.dtype != torch.int32 or valid.shape != (S, T)
            or flush.shape != (S, T) or live.dtype != torch.bool
            or valid.dtype != torch.bool or flush.dtype != torch.bool):
        raise ValueError("msm_lane_scan: px, py (N, [2,] 12), live (N,) "
                         "bool, point_idx (S, T) int32, valid and flush "
                         "(S, T) bool")
    emit = torch.zeros((S * T, 3) + tuple(px.shape[1:]), dtype=torch.int32,
                       device=px.device)
    _build.launch(f"g{k}_msm_lane_scan", px, py, live, ctypes.c_int(n),
                  point_idx, valid, flush, ctypes.c_int(S), ctypes.c_int(T),
                  emit)
    msm_lane_scan.launches += 1
    return emit


msm_lane_scan.launches = 0


def msm_bucket_reduce_plain(emit, gather_idx, gather_valid):
    """Plain version of `msm_bucket_reduce`: the sections' digits as one
    (n_sec, B) batch — the J-piece fold (an invalid piece skipped), the
    suffix U_d += U_{d+k} for d + k < B, k = 1, 2, …, ∞ at digit 0, the
    tree sum over the digits (position d + s into d, s = B/2 … 1)."""
    k, ops = _field(emit, 2)
    J, n_sec, B = gather_idx.shape
    pts = C.jac_from_words(emit, k)
    inf = _inf(ops, (n_sec, B), emit.device)
    acc = inf
    for j in range(J):
        if not gather_valid[j].any():  # the select would keep acc
            continue
        idx = gather_idx[j].long()
        summed = _add(acc, tuple(c[idx] for c in pts), ops)
        acc = C._sel3(gather_valid[j], summed, acc)
    s = 1
    while s < B:
        head = _add(tuple(c[:, : B - s] for c in acc),
                    tuple(c[:, s:] for c in acc), ops)
        acc = tuple(torch.cat([h, c[:, B - s:]], 1) for h, c in zip(head,
                                                                  acc))
        s *= 2
    digit0 = torch.arange(B, device=emit.device) == 0
    acc = C._sel3(digit0.expand(n_sec, B), inf, acc)
    while B > 1:  # C.sum_points_grouped's order: position d + B/2 into d
        B //= 2
        acc = _add(tuple(c[:, :B] for c in acc), tuple(c[:, B:] for c in acc),
                   ops)
    return C.jac_to_words(tuple(c[:, 0] for c in acc), k)


def msm_bucket_reduce(emit, gather_idx, gather_valid):
    """The window totals Σ_{d≥1} d·S_d of each section (group·W + window)
    from the lane scan's pieces: emit (E, 3, [2,] 12) Jacobian words,
    gather_idx (J, n_sec, B) int32 emit slots of each bucket's pieces with
    gather_valid (J, n_sec, B) bool, B = 2^w digits. Returns (n_sec, 3,
    [2,] 12) Jacobian words. CUDA kernel `msm_bucket_reduce` (csrc/msm.cu)
    on CUDA tensors, the plain version on CPU tensors.

    Replaces steps 2 and 3 of grandine_tpu/tpu/msm.py msm_bucket_scan
    (:308-353: the piece gather and J-step fold, the Hillis–Steele suffix
    and the roll-tree reduction). One block a section, one thread a digit;
    the B points of a section stay in dynamic shared memory (B·144 B in
    G1, B·288 B in G2: 72 KiB at w = 8, above the 48 KiB a block gets
    without opting in). The kernel runs up to J + 2·w complete additions
    a digit; the function needs fewer — the fold's pieces − 1 a digit and
    2·(B − 2) a section for Σ d·S_d by a running sum, against ~150 (G1)
    or ~300 (G2) bytes a piece. The J-piece fold and the 2·w suffix and
    tree levels are one thread's dependent chain, so the kernel is
    latency-bound on them."""
    if emit.device.type == "cpu":
        return msm_bucket_reduce_plain(emit, gather_idx, gather_valid)
    from grandine_tpu_torch.gpu import _build

    k, _ = _field(emit, 2)
    J, n_sec, B = gather_idx.shape
    if (gather_idx.dtype != torch.int32 or gather_valid.shape != (J, n_sec, B)
            or gather_valid.dtype != torch.bool or B & (B - 1) or B > 256
            or emit.shape[1] != 3):
        raise ValueError("msm_bucket_reduce: emit (E, 3, [2,] 12), gather_idx "
                         "(J, n_sec, B) int32 with B a power of two ≤ 256, "
                         "gather_valid (J, n_sec, B) bool")
    totals = torch.empty((n_sec,) + tuple(emit.shape[1:]), dtype=torch.int32,
                         device=emit.device)
    if n_sec:
        _build.launch(f"g{k}_msm_bucket_reduce", emit, gather_idx,
                      gather_valid, ctypes.c_int(J), ctypes.c_int(n_sec),
                      ctypes.c_int(B), totals)
        msm_bucket_reduce.launches += 1
    return totals


msm_bucket_reduce.launches = 0


def msm_horner_plain(totals, n_groups: int, window_bits: int):
    """Plain version of `msm_horner`: the groups as one batch, the windows
    from high to low — w doublings, one complete addition."""
    k, ops = _field(totals, 2)
    W = totals.shape[0] // max(1, n_groups)
    pts = C.jac_from_words(totals.reshape((n_groups, W) + totals.shape[1:]),
                           k)
    acc = _inf(ops, (n_groups,), totals.device)
    for win in range(W - 1, -1, -1):
        for _ in range(window_bits):
            acc = C.point_double(acc, ops)
        acc = _add(acc, tuple(c[:, win] for c in pts), ops)
    return C.jac_to_words(acc, k)


def msm_horner(totals, n_groups: int, window_bits: int):
    """Σ_win 2^(w·win)·T_win per group from the window totals (n_groups·W,
    3, [2,] 12) Jacobian words (section g·W + win): from the highest
    window down, w doublings and one complete addition. Returns
    (n_groups, 3, [2,] 12) Jacobian words, ∞ (1, 1, 0) for a group with
    no entry. CUDA kernel `msm_horner` (csrc/msm.cu) on CUDA tensors, the
    plain version on CPU tensors.

    Replaces step 4 of grandine_tpu/tpu/msm.py msm_bucket_scan (:355-377,
    the Horner lax.scan batched over groups). G1: one thread a group on
    `fpc`, point_double and point_add_complete with the Fp product as one
    call (inlined, a G1 formula's products run ~2.2× their parts). G2:
    one warp a group, one block a group, each doubling a G2DBL warp
    program and each addition `warp_g2_join` (G2ADD with
    point_add_complete's cases: ∞ on either side, equal points doubled,
    opposite points ∞). Both start the sum at the top window's total:
    the plain version doubles (1, 1, 0) to itself and adds that total to
    it, which gives the total's words. Bound: operations — (W − 1)·w
    doublings and W − 1 complete additions a group against 144 (G1) or
    288 (G2) bytes a window total; at a route's 1–16 groups the kernel is
    one group's dependent chain (G1 at w = 4: 28 doublings and 7
    additions; G2 at w = 8: 24 G2DBL programs and 3 additions)."""
    if totals.device.type == "cpu":
        return msm_horner_plain(totals, n_groups, window_bits)
    from grandine_tpu_torch.gpu import _build

    k, _ = _field(totals, 2)
    n_sec = totals.shape[0]
    if n_groups < 1 or n_sec % n_groups or totals.shape[1] != 3:
        raise ValueError(f"msm_horner: {n_sec} window totals do not split "
                         f"into {n_groups} groups")
    W = n_sec // n_groups
    out = torch.empty((n_groups,) + tuple(totals.shape[1:]),
                      dtype=torch.int32, device=totals.device)
    _build.launch(f"g{k}_msm_horner", totals, ctypes.c_int(n_groups),
                  ctypes.c_int(W), ctypes.c_int(window_bits), out)
    msm_horner.launches += 1
    return out


msm_horner.launches = 0


def msm_horner_geometry(k: int, n_groups: int):
    """(blocks, threads a block, shared memory bytes, blocks one SM holds
    at once) of the `msm_horner` launch over n_groups groups of G1 (k = 1)
    or G2 (k = 2), on the current CUDA device. A query: it launches
    nothing."""
    from grandine_tpu_torch.gpu import _build

    geometry = np.zeros((4,), np.int32)
    _build.launch("msm_horner_geometry", ctypes.c_int(k),
                  ctypes.c_int(n_groups),
                  ctypes.c_void_p(geometry.ctypes.data))
    return tuple(int(v) for v in geometry)


def msm_bucket_scan(px, py, live, point_idx, valid, flush, gather_idx,
                    gather_valid, windows: int, window_bits: int,
                    n_groups: int):
    """Σᵢ (r0ᵢ + r1ᵢ·λ)·Pᵢ per group over a plan's arrays on the device of
    the points: the counterpart of grandine_tpu/tpu/msm.py
    expand_glv_points + msm_bucket_scan. px, py (N, 12) or (N, 2, 12)
    affine canonical words with live (N,); the plan's arrays as tensors.
    Returns (n_groups, 3, [2,] 12) Jacobian words. Launches
    `msm_lane_scan`, `msm_bucket_reduce`, `msm_horner`."""
    if gather_idx.shape[1] != n_groups * windows or \
            gather_idx.shape[2] != 1 << window_bits:
        raise ValueError(f"msm_bucket_scan: gather arrays "
                         f"{tuple(gather_idx.shape)} do not match {n_groups} "
                         f"groups × {windows} windows of {window_bits} bits")
    emit = msm_lane_scan(px, py, live, point_idx, valid, flush)
    totals = msm_bucket_reduce(emit, gather_idx, gather_valid)
    return msm_horner(totals, n_groups, window_bits)


def msm_bucket_sum(px, py, live, plan: MsmPlan):
    """`msm_bucket_scan` over a plan: host arrays are uploaded to the
    device of the points first, tensors taken as they are."""
    if isinstance(plan.point_idx, np.ndarray):
        plan = upload_plan(plan, px.device)
    return msm_bucket_scan(px, py, live, *plan.arrays, windows=plan.windows,
                           window_bits=plan.window_bits,
                           n_groups=plan.n_groups)


__all__ = ["TREE", "strided_tree_sum", "sum_points_contiguous",
           "group_rows", "MSM_LANES", "MsmPlan", "plan_msm", "upload_plan",
           "msm_lane_scan", "msm_lane_scan_plain", "msm_bucket_reduce",
           "msm_bucket_reduce_plain", "msm_horner", "msm_horner_geometry",
           "msm_horner_plain", "msm_bucket_scan", "msm_bucket_sum"]
