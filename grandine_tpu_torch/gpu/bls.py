"""BLS batch verification on the card: the verify kernels that follow
decompression, and the host-facing backend.

`TorchBlsBackend` is the counterpart of grandine_tpu/tpu/bls.py
TpuBlsBackend with its verify seams and their edge semantics. Four
kinds of batches run on the same kernels:

  fast-aggregate (M aggregates, each one message over many signers —
  gossip): g2_decompress_subgroup or g2_subgroup_check (gpu/curve.py),
  aggregate_rlc_scale (this module: apkᵢ = Σ members, rᵢ·apkᵢ, rᵢ·sigᵢ),
  miller_loop_pairs (gpu/pairing.py), rlc_finish (this module: ∏ fᵢ ·
  f(−g1, Σ rᵢ·sigᵢ), final exponentiation, verdict) — replacing the JAX
  programs aggregate_fast_verify_msm{,_idx}{,_comp};

  flat (N signature sets, one signer key each — a block's sets, a replay
  window): the same signature plane, multi_rlc_scale (this module: rᵢ·pkᵢ
  and rᵢ·sigᵢ), miller_loop_pairs, rlc_finish — replacing
  multi_verify_msm{,_idx,_comp};

  message-grouped (N sets over M ≤ N/2 messages — a sync-committee slot,
  unaggregated attestations): multi_rlc_scale, g1_group_sum (this module:
  Σᵢ∈ⱼ rᵢ·pkᵢ per message), M Miller loops, rlc_finish over M message
  terms and N signature terms — replacing grouped_multi_verify_msm;

  RLC partition (the fault localizer's passes): the flat kernels with
  rlc_finish giving one verdict per contiguous group of sets —
  replacing rlc_partition_verify.

rlc_finish is one group-indexed kernel for all four: offsets name each
group's terms, and groups with no term cost nothing.

Keyed seams upload their keys' affine coordinates as the gather source
and pass an index plane over them, so the registry-indexed and keyed
seams of each family share one kernel. The uncompressed seams run
`g2_subgroup_check` on the same stream and fold its mask into the
verdict, as the JAX package fuses the ψ ladder into its verify programs
by default; the compressed seams get it from the decompression kernel.

Host prep per batch: the row pack of the wire bytes or the affine
conversion of the signature points, hash-to-G2 of each distinct message
(LRU-cached), the RLC pairs and the index plane — no field arithmetic on
the card's behalf.
"""

from __future__ import annotations

import ctypes
import secrets
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto import constants
from grandine_tpu_torch.crypto.curves import G1
from grandine_tpu_torch.crypto.fields import batch_inverse
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm
from grandine_tpu_torch.gpu import pairing as TP

#: largest batch one verification covers; bigger batches are split into
#: chunks of this size, each one RLC check (all must pass)
MAX_BUCKET = 1 << 14

#: entries of the hash-to-G2 point cache (one per distinct signing root;
#: a slot at mainnet width has at most 64 committees)
H2C_CACHE_CAP = 4096


def resolve_device(device) -> torch.device:
    """`device` or CUDA; raises when CUDA is asked for and absent (the
    port never moves to the CPU unless the caller says so)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    return dev


# --- aggregate_rlc_scale ------------------------------------------------------


def aggregate_rlc_scale_plain(src_x, src_y, idx, cnt, sig_x, sig_y,
                              sig_mask, r01):
    """Plain version of `aggregate_rlc_scale`: gather members
    src[idx[m, :cnt[m]]], sum them, rᵢ·apkᵢ (complete-add GLV ladder) and
    rᵢ·sigᵢ (mixed-add GLV ladder) with rᵢ = r01[m, 0] + r01[m, 1]·λ."""
    m, k = idx.shape
    dev = idx.device
    rows = idx.long()
    mx = L.from_words(src_x[rows])
    my = L.from_words(src_y[rows])
    live = torch.arange(k, device=dev).unsqueeze(0) < cnt.long().unsqueeze(1)
    apk = msm.strided_tree_sum((mx, my, L.one_fp((m, k), dev)), live,
                               C.FP_OPS)
    agg_inf = L.is_zero(apk[2])
    r = r01.to(torch.int64) & 0xFFFFFFFF
    rpk = C.scalar_mul_jac_glv(apk, agg_inf, r[:, 0], r[:, 1],
                               C.g1_endo(dev), C.FP_OPS)
    rsig = C.scalar_mul_glv(L.from_words(sig_x), L.from_words(sig_y),
                            sig_mask, r[:, 0], r[:, 1], C.g2_endo(dev),
                            C.FP2_OPS)
    return C.jac_to_words(rpk, 1), agg_inf, C.jac_to_words(rsig, 2)


def aggregate_rlc_scale(src_x, src_y, idx, cnt, sig_x, sig_y, sig_mask, r01):
    """Per aggregate: gather its members' G1 keys by index, sum them,
    then rᵢ·apkᵢ and rᵢ·sigᵢ. src_x/src_y (rows, 12) affine canonical
    words (the registry, or a keyed batch's uploaded members); idx (M, K)
    int32 with cnt (M,) members each; sig_x/sig_y (M, 2, 12) affine with
    sig_mask (M,) (∞ or rejected rows); r01 (M, 2) the 32-bit RLC halves.
    Returns rpk (M, 3, 12) Jacobian, agg_inf (M,), rsig (M, 3, 2, 12).
    CUDA kernel `aggregate_rlc_scale` (csrc/aggregate.cu) on CUDA tensors, the plain version
    on CPU tensors.

    Replaces, in the JAX programs aggregate_fast_verify_msm_idx_comp /
    _comp (grandine_tpu/tpu/bls.py:839, :815), the registry gather
    (bls.py:851-854), grandine_tpu/tpu/curve.py sum_points_grouped and
    scalar_mul_jac_glv (G1), and the per-row rᵢ·sigᵢ of the signature MSM.
    One block of 128 threads per aggregate: the threads sum the members
    in a strided loop and a shared-memory tree, then warp 0 runs the G1
    ladder and warp 1 the G2 ladder at once. Bound: operations — one
    complete G1 addition a member (16 Fp products), the tree, and two
    32-step ladders (~4,800 Fp products an aggregate of 130) against 100
    bytes a member (index and gathered row); the two
    ladders run on one thread each, so the kernel is latency-bound on the
    ladders, which later work splits across a warp."""
    if idx.device.type == "cpu":
        return aggregate_rlc_scale_plain(src_x, src_y, idx, cnt, sig_x,
                                         sig_y, sig_mask, r01)
    from grandine_tpu_torch.gpu import _build

    m, k = idx.shape
    dev = idx.device
    rpk = torch.empty((m, 3, 12), dtype=torch.int32, device=dev)
    agg_inf = torch.empty((m,), dtype=torch.bool, device=dev)
    rsig = torch.empty((m, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.launch("aggregate_rlc_scale", src_x, src_y, idx, cnt,
                  ctypes.c_int(m), ctypes.c_int(k), sig_x, sig_y, sig_mask,
                  r01, rpk, agg_inf, rsig)
    aggregate_rlc_scale.launches += 1
    return rpk, agg_inf, rsig


aggregate_rlc_scale.launches = 0


# --- multi_rlc_scale --------------------------------------------------------


def multi_rlc_scale_plain(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """Plain version of `multi_rlc_scale`: rᵢ·pkᵢ with pkᵢ = src[idx[i]]
    and rᵢ·sigᵢ, both by the mixed-add GLV ladder."""
    n = idx.shape[0]
    dev = idx.device
    rows = idx.long()
    r = r01.to(torch.int64) & 0xFFFFFFFF
    rpk = C.scalar_mul_glv(L.from_words(src_x[rows]), L.from_words(src_y[rows]),
                           torch.zeros((n,), dtype=torch.bool, device=dev),
                           r[:, 0], r[:, 1], C.g1_endo(dev), C.FP_OPS)
    rsig = C.scalar_mul_glv(L.from_words(sig_x), L.from_words(sig_y),
                            sig_mask, r[:, 0], r[:, 1], C.g2_endo(dev),
                            C.FP2_OPS)
    return C.jac_to_words(rpk, 1), C.jac_to_words(rsig, 2)


def multi_rlc_scale(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """Per signature set: rᵢ·pkᵢ (G1 GLV ladder from the affine key
    src[idx[i]]) and rᵢ·sigᵢ (G2 GLV ladder), rᵢ = r01[i, 0] + r01[i, 1]·λ.
    src_x/src_y (rows, 12) affine canonical words (the registry, or a
    keyed batch's uploaded keys, none ∞); idx (N,) int32; sig_x/sig_y
    (N, 2, 12) affine with sig_mask (N,) (∞ or rejected rows); r01 (N, 2)
    the 32-bit RLC halves. Returns rpk (N, 3, 12) and rsig (N, 3, 2, 12)
    Jacobian, the layouts `miller_loop_pairs` and `rlc_finish` take. CUDA
    kernel `multi_rlc_scale` (csrc/multi.cu) on CUDA tensors, the plain
    version on CPU tensors.

    Replaces, in the JAX programs multi_verify_msm{,_idx,_comp}
    (grandine_tpu/tpu/bls.py:592, :610, :790), the registry gather
    (:629-632), the per-signature G1 scalar_mul_glv and the G2 scalar
    plane of `_flat_msm_verify_tail` (:556-589). One thread per ladder:
    the first ⌈N/32⌉ warps run the G1 ladders and the warps after them
    the G2 ladders, one warp a block, so no warp holds both branches and
    the G1 and G2 warps land on separate SMs (N = 1,048 is 66 warps on
    132 SMs, one wave). Bound: operations — 32 doublings and ~32 mixed
    additions on each group (~2,300 Fp products a set) against ~640 bytes
    a set; each ladder is one thread's dependent chain, so the kernel is
    latency-bound on the G2 ladder (3 Fp products to each of G1's)."""
    if idx.device.type == "cpu":
        return multi_rlc_scale_plain(src_x, src_y, idx, sig_x, sig_y,
                                     sig_mask, r01)
    from grandine_tpu_torch.gpu import _build

    n = idx.shape[0]
    if (idx.dtype != torch.int32 or sig_x.shape != (n, 2, 12)
            or sig_y.shape != (n, 2, 12) or sig_mask.shape != (n,)
            or r01.shape != (n, 2)):
        raise ValueError("multi_rlc_scale: idx (N,) int32, sig_x/sig_y "
                         "(N, 2, 12), sig_mask (N,), r01 (N, 2)")
    dev = idx.device
    rpk = torch.empty((n, 3, 12), dtype=torch.int32, device=dev)
    rsig = torch.empty((n, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.launch("multi_rlc_scale", src_x, src_y, idx, ctypes.c_int(n),
                  sig_x, sig_y, sig_mask, r01, rpk, rsig)
    multi_rlc_scale.launches += 1
    return rpk, rsig


multi_rlc_scale.launches = 0


# --- g1_group_sum ---------------------------------------------------------------


def _offsets(offsets, n: int, what: str) -> np.ndarray:
    """Group offsets as an int64 array: M + 1 non-decreasing ints in
    [0, n]; raises ValueError otherwise."""
    off = np.asarray(offsets, np.int64).reshape(-1)
    if (off.size < 2 or off[0] < 0 or off[-1] > n
            or (np.diff(off) < 0).any()):
        raise ValueError(f"{what}: offsets must be M + 1 non-decreasing "
                         f"ints in [0, {n}], got {off.tolist()}")
    return off


def _offsets_to(off: np.ndarray, device) -> torch.Tensor:
    """int32 offsets on the card without waiting: a copy from pageable
    host memory first waits for every kernel queued on the stream, which
    would hold the host until the batch's earlier kernels finish, so the
    table goes through pinned memory, non-blocking."""
    return torch.from_numpy(off.astype(np.int32)).pin_memory().to(
        device, non_blocking=True)


def g1_group_sum_plain(rows, offsets):
    """Plain version of `g1_group_sum`: the groups' sums in the kernel's
    order (msm.sum_points_contiguous over a BLS_TREE-thread block)."""
    off = _offsets(offsets, rows.shape[0], "g1_group_sum")
    total = msm.sum_points_contiguous(C.jac_from_words(rows, 1), off,
                                      C.FP_OPS)
    return C.jac_to_words(total, 1)


def g1_group_sum(rows, offsets):
    """Σ of the Jacobian G1 rows (N, 3, 12) of each group [offsets[m],
    offsets[m+1]) — offsets, M + 1 host ints, are the only way groups are
    given — as (M, 3, 12) Jacobian words, ∞ (1, 1, 0) for an empty group.
    CUDA kernel `g1_group_sum` (csrc/multi.cu) on CUDA tensors, the plain
    version on CPU tensors.

    Replaces, in grandine_tpu/tpu/bls.py grouped_multi_verify_msm_kernel
    (:483), the per-message key MSM Σᵢ∈ⱼ rᵢ·pkᵢ of `_grouped_msm_verify_tail`
    (:461-466), given the rᵢ·pkᵢ that `multi_rlc_scale` computes per set
    (the bucket MSM is queued as a perf item). One block of 128 threads per
    group: a strided loop of complete additions, then the shared-memory
    tree. Bound: operations — one complete G1 addition (16 Fp products) a
    row against 144 bytes a row; at M = 12 groups on 132 SMs the kernel is
    latency-bound on the ⌈rows/128⌉ + 7 dependent additions of a group."""
    if rows.device.type == "cpu":
        return g1_group_sum_plain(rows, offsets)
    return _g1_group_sum_cuda(rows, offsets)


def _g1_group_sum_cuda(rows, offsets):
    from grandine_tpu_torch.gpu import _build

    n = rows.shape[0]
    if rows.shape != (n, 3, 12) or rows.dtype != torch.int32:
        raise ValueError("g1_group_sum: rows (N, 3, 12) int32")
    off = _offsets(offsets, n, "g1_group_sum")
    m = off.size - 1
    out = torch.empty((m, 3, 12), dtype=torch.int32, device=rows.device)
    _build.launch("g1_group_sum", rows.contiguous(),
                  _offsets_to(off, rows.device), ctypes.c_int(m), out)
    g1_group_sum.launches += 1
    return out


g1_group_sum.launches = 0


# --- rlc_finish -----------------------------------------------------------------


#: the widest span that `rlc_finish` runs one thread a group: a slot (an
#: Fp12 term and a signature term) costs that thread ~120 Fp products in
#: its strided loop, so 8 slots are ~3 % of the ~30,000 of its Miller loop
#: and final exponentiation, about what a 32-thread block's tree (5
#: levels) would cost instead — and 32 groups share a warp where a block
#: would leave 31 lanes idle through the tail
PER_THREAD_SPAN = 8


def finish_threads(spans) -> int:
    """Threads `rlc_finish` gives each live group of one launch, from the
    groups' spans (terms of the more numerous kind): 1 when no group
    spans more than PER_THREAD_SPAN (one thread a group, its strided loop
    sequential, no tree), else ⌈widest/32⌉ warps, at most one 128-thread
    block."""
    widest = max(spans, default=0)
    if widest <= PER_THREAD_SPAN:
        return 1
    return min(msm.TREE, 32 * -(-widest // 32))


def finish_groups(f, rsig, f_off=None, s_off=None):
    """(f_off, s_off, live group ids, threads) of an `rlc_finish` call; no
    offsets means one group over every term."""
    n_f, n_s = f.shape[0], rsig.shape[0]
    fo = _offsets([0, n_f] if f_off is None else f_off, n_f, "rlc_finish")
    so = _offsets([0, n_s] if s_off is None else s_off, n_s, "rlc_finish")
    if fo.size != so.size:
        raise ValueError("rlc_finish: f_off and s_off name different "
                         "numbers of groups")
    span = np.maximum(np.diff(fo), np.diff(so))
    live = np.nonzero(span > 0)[0]
    return fo, so, live, finish_threads(span[live].tolist())


def rlc_sig_miller_plain(rsig, offsets=None, tree: int = msm.TREE):
    """f(−g1, Σ rᵢ·sigᵢ) per group [offsets[m], offsets[m+1]) of the
    signature terms (M, 3, 2, 12) (no offsets: one group), each sum in
    the kernel's order; an (M, …) Fp12 batch."""
    dev = rsig.device
    off = [0, rsig.shape[0]] if offsets is None else offsets
    sig = msm.sum_points_contiguous(C.jac_from_words(rsig, 2), off,
                                    C.FP2_OPS, tree)
    m = sig[0].shape[0]
    neg = (-G1).to_affine()
    ng = (L.const_fp(neg[0].n, (m,), dev), L.const_fp(neg[1].n, (m,), dev),
          L.one_fp((m,), dev))
    return TP.miller_loop(ng, TP.jacobian_to_homogeneous(sig),
                          F.fp2_is_zero(sig[2]))


def _segment_any(flags, lo, hi):
    """any(flags[lo[m]:hi[m]]) per segment."""
    cs = torch.cat([flags.new_zeros(1, dtype=torch.int64),
                    flags.to(torch.int64).cumsum(0)])
    lo_t = torch.from_numpy(lo).to(flags.device)
    hi_t = torch.from_numpy(hi).to(flags.device)
    return (cs[hi_t] - cs[lo_t]) > 0


def rlc_finish_plain(f, rsig, agg_inf, sig_ok, sig_sub, f_off=None,
                     s_off=None):
    """Plain version of `rlc_finish`: (G,) uint8 verdicts; each live
    group's product and sum in the kernel's order at the launch's thread
    count, the groups batched; dead groups 1."""
    fo, so, live, threads = finish_groups(f, rsig, f_off, s_off)
    out = torch.ones((fo.size - 1,), dtype=torch.uint8, device=f.device)
    if live.size == 0:
        return out
    # dead groups hold no terms, so the live ones tile the same ranges
    lf = np.append(fo[live], fo[-1])
    ls = np.append(so[live], so[-1])
    prod = TP.fp12_product_tree_grouped(L.from_words(f), lf, threads)
    one = F.fp12_is_one(TP.final_exponentiation(
        F.fp12_mul(prod, rlc_sig_miller_plain(rsig, ls, threads))))
    bad = (_segment_any(agg_inf, lf[:-1], lf[1:])
           | _segment_any(~(sig_ok & sig_sub), ls[:-1], ls[1:]))
    out[torch.from_numpy(live).to(f.device)] = (one & ~bad).to(torch.uint8)
    return out


def rlc_finish(f, rsig, agg_inf, sig_ok, sig_sub, f_off=None, s_off=None):
    """The verdicts of G RLC groups: group g owns the Fp12 terms
    f[f_off[g]:f_off[g+1]] (M, 2, 3, 2, 12) with their flags agg_inf and
    the signature terms rsig[s_off[g]:s_off[g+1]] (N, 3, 2, 12) with
    sig_ok and sig_sub; its verdict is: Σ of its signature terms, the
    Miller loop of that against −g1, the product with its f terms and the
    final exponentiation give one, none of its aggregates summed to ∞,
    each of its signature rows decoded and lies in G2. Offsets are M + 1
    host ints; none means one group over every term (the flat and
    fast-aggregate batches: G = 1, f_off = [0, M], s_off = [0, N]; the
    grouped route: G = 1 with M message terms and N signature terms; an
    RLC partition: G groups of B/G slots). Returns (G,) uint8. CUDA kernel
    `rlc_finish` (csrc/pairing.cu) on CUDA tensors, the plain version on
    CPU tensors.

    Replaces grandine_tpu/tpu/bls.py `_rlc_finish` (:162) and
    `_rlc_finish_grouped` (:177) with grandine_tpu/tpu/pairing.py
    fp12_product_tree (:334), fp12_product_tree_grouped (:354) and
    final_exp_is_one (:300), the tree sums of the signature MSM and
    curve.py sum_points_contiguous, and the verdict folds of
    bls.py:703-724 and :857-865 (fast-aggregate), `_flat_msm_verify_tail`
    (flat sets) and rlc_partition_verify_kernel's fused subgroup check.
    Only live groups launch (a group with no term is 1: an empty product
    and an ∞ sum, written here without work). Threads follow the span
    (`finish_threads`): a group of span s gets ⌈s/32⌉ warps, one block a
    group, with a strided loop and trees over threads × 576 B of dynamic
    shared memory (the partial sums share the product tree's buffer);
    groups of span ≤ PER_THREAD_SPAN run one a thread, 32 to a block, no
    shared memory.
    Bound: operations — ~66 Fp products a term plus ~30,000 a live group
    for its Miller loop and final exponentiation, which stay sequential
    on one thread, so the kernel is latency-bound on them: its time is
    one group's tail times the waves its groups take
    (`rlc_finish_geometry`)."""
    if f.device.type == "cpu":
        return rlc_finish_plain(f, rsig, agg_inf, sig_ok, sig_sub, f_off,
                                s_off)
    return _rlc_finish_cuda(f, rsig, agg_inf, sig_ok, sig_sub, f_off, s_off)


def _rlc_finish_cuda(f, rsig, agg_inf, sig_ok, sig_sub, f_off, s_off):
    from grandine_tpu_torch.gpu import _build

    m, n = f.shape[0], rsig.shape[0]
    if (f.shape[1:] != (2, 3, 2, 12) or rsig.shape[1:] != (3, 2, 12)
            or agg_inf.shape != (m,) or sig_ok.shape != (n,)
            or sig_sub.shape != (n,)):
        raise ValueError("rlc_finish: f (M, 2, 3, 2, 12), rsig (N, 3, 2, "
                         "12), agg_inf (M,), sig_ok and sig_sub (N,)")
    fo, so, live, threads = finish_groups(f, rsig, f_off, s_off)
    dev = f.device
    verdict = torch.ones((fo.size - 1,), dtype=torch.uint8, device=dev)
    if live.size:
        table = _offsets_to(np.concatenate([fo, so, live]), dev)
        g1 = fo.size
        _build.launch("rlc_finish", f.contiguous(), rsig.contiguous(),
                      agg_inf.contiguous(), sig_ok.contiguous(),
                      sig_sub.contiguous(), table[:g1], table[g1:2 * g1],
                      table[2 * g1:], ctypes.c_int(live.size),
                      ctypes.c_int(threads), verdict)
        rlc_finish.launches += 1
    return verdict


rlc_finish.launches = 0


def rlc_finish_geometry(f, rsig, f_off=None, s_off=None):
    """(blocks, threads a block, dynamic shared memory bytes, blocks one
    SM holds at once) of the launch `rlc_finish` makes for these operands
    on the current CUDA device; (0, 0, 0, 0) when no group is live. A
    query: it launches nothing."""
    from grandine_tpu_torch.gpu import _build

    _, _, live, threads = finish_groups(f, rsig, f_off, s_off)
    geometry = np.zeros((4,), np.int32)
    if live.size:
        _build.launch("rlc_finish_geometry", ctypes.c_int(live.size),
                      ctypes.c_int(threads),
                      ctypes.c_void_p(geometry.ctypes.data))
    return tuple(int(v) for v in geometry)


def signature_plane(sig_x, sig_y, sig_inf):
    """Uploaded affine signatures as the verify kernels take them:
    (sig_x, sig_y, mask, decoded, in_subgroup), `g2_subgroup_check`
    running on the same stream (the JAX package's fused ψ ladder)."""
    return (sig_x, sig_y, sig_inf, torch.ones_like(sig_inf),
            C.g2_subgroup_check(sig_x, sig_y, sig_inf))


def signature_plane_compressed(sig_rows, sig_inf):
    """(B, 96) wire rows decompressed on the card, the ψ check fused:
    (sig_x, sig_y, mask, decoded, in_subgroup); `sig_inf` is the host's
    wire infinity-flag mask."""
    sx, sy, dinf, dok, _be, _bc, _bi, sub = C.g2_decompress_subgroup(sig_rows)
    return sx, sy, sig_inf | dinf | ~dok, dok, sub


def verify_aggregates(src_x, src_y, idx, cnt, plane, msg, msg_inf, r01):
    """One fast-aggregate RLC verification on the device of its inputs;
    returns the (1,) uint8 verdict tensor without waiting for it."""
    sx, sy, mask, ok, sub = plane
    rpk, agg_inf, rsig = aggregate_rlc_scale(src_x, src_y, idx, cnt, sx, sy,
                                             mask, r01)
    f = TP.miller_loop_pairs(rpk, msg, agg_inf | msg_inf)
    return rlc_finish(f, rsig, agg_inf, ok, sub)


def verify_sets(src_x, src_y, idx, plane, msg, pair_inf, r01, offsets=None):
    """Flat RLC verification of N (message, signature, key) sets on the
    device of its inputs (pair_inf masks a set's pairing); `offsets` (host
    ints) splits the sets into contiguous groups, each with its own
    verdict (none: one group). Returns the (G,) uint8 verdict tensor
    without waiting for it."""
    sx, sy, mask, ok, sub = plane
    rpk, rsig = multi_rlc_scale(src_x, src_y, idx, sx, sy, mask, r01)
    f = TP.miller_loop_pairs(rpk, msg, pair_inf)
    return rlc_finish(f, rsig, torch.zeros_like(pair_inf), ok, sub, offsets,
                      offsets)


def verify_grouped(src_x, src_y, idx, plane, offsets, msg, msg_inf, r01):
    """One message-grouped RLC verification: N sets ordered by message,
    message j owning sets offsets[j] … offsets[j+1] − 1 (host ints), M
    messages. Σᵢ∈ⱼ rᵢ·pkᵢ per message (`g1_group_sum` over the rᵢ·pkᵢ of
    `multi_rlc_scale`), M Miller loops, one finish over M message terms
    and N signature terms. Returns the (1,) uint8 verdict tensor without
    waiting for it."""
    sx, sy, mask, ok, sub = plane
    rpk, rsig = multi_rlc_scale(src_x, src_y, idx, sx, sy, mask, r01)
    gpk = g1_group_sum(rpk, offsets)
    gpk_inf = (gpk[:, 2] == 0).all(-1)
    f = TP.miller_loop_pairs(gpk, msg, gpk_inf | msg_inf)
    return rlc_finish(f, rsig, torch.zeros_like(msg_inf), ok, sub)


# --- host helpers ------------------------------------------------------------


def _bucket(n: int, lo: int = 4, hi: int = MAX_BUCKET) -> int:
    """The power-of-two bucket (at least `lo`) a batch of n pads into in
    the JAX package (grandine_tpu/tpu/bls.py `_bucket`); ValueError past
    `hi`. The port pads nothing on the card: the bucket sets the grouped
    route's rule and a partition's group geometry."""
    b = lo
    while b < n:
        b <<= 1
    if b > hi:
        raise ValueError(f"batch of {n} exceeds max bucket {hi}")
    return b


def message_groups(messages) -> "dict[bytes, list[int]]":
    """Set indices by message, in order of first appearance."""
    groups: "dict[bytes, list[int]]" = {}
    for i, message in enumerate(messages):
        groups.setdefault(bytes(message), []).append(i)
    return groups


def grouped_route(n_groups: int, widest: int, n: int) -> bool:
    """The JAX package's rule for `multi_verify_async`'s grouped route
    (grandine_tpu/tpu/bls.py:1972-1975): at least two sets a message on
    average, and the (messages × widest group) padding of its TPU program
    within 4× the flat bucket. A padding rule of the TPU, kept so that
    both packages take the same route; on the card it is to be replaced
    by a measured cost (ROADMAP.md)."""
    return (2 * n_groups <= n
            and _bucket(n_groups) * _bucket(widest) <= 4 * _bucket(n))



class _LruCache:
    """Bounded thread-safe LRU (the hash-to-G2 point cache)."""

    def __init__(self, cap: int) -> None:
        self.cap = max(1, int(cap))
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()

    def get(self, key):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
            return hit

    def put(self, key, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)


def g2_affine_words(pt) -> "tuple[np.ndarray, bool]":
    """Host G2 point → ((2, 2, 12) int32 [x, y] canonical words, is_inf)."""
    x, y, inf = g2_affine_words_many([pt])
    return np.stack([x[0], y[0]]), bool(inf[0])


def g1_affine_words(points) -> "tuple[np.ndarray, np.ndarray]":
    """Host G1 points (any Z, none ∞) → (N, 12) x and y canonical words,
    with one batched inversion."""
    p = L.P
    zinv = batch_inverse([pt.z.n for pt in points], p)
    xs, ys = [], []
    for pt, zi in zip(points, zinv):
        zi2 = zi * zi % p
        xs.append(pt.x.n * zi2 % p)
        ys.append(pt.y.n * zi2 % p * zi % p)
    w = L.ints_to_words(xs + ys)
    return w[: len(points)], w[len(points):]


def g2_affine_words_many(points):
    """Host G2 points (any Z) → ((N, 2, 12) x, (N, 2, 12) y canonical
    words, zero on ∞ rows; (N,) ∞ mask), with one batched inversion."""
    p = L.P
    n = len(points)
    inf = np.array([pt.is_infinity() for pt in points], bool).reshape(n)
    live = [pt for pt, i in zip(points, inf) if not i]
    ninv = batch_inverse([(pt.z.c0.n ** 2 + pt.z.c1.n ** 2) % p
                          for pt in live], p)
    vals = []
    for pt, ni in zip(live, ninv):
        z0, z1 = pt.z.c0.n * ni % p, -pt.z.c1.n * ni % p  # 1/Z = conj(Z)/|Z|
        a0, a1 = (z0 * z0 - z1 * z1) % p, 2 * z0 * z1 % p  # 1/Z²
        b0, b1 = (a0 * z0 - a1 * z1) % p, (a0 * z1 + a1 * z0) % p  # 1/Z³
        x0, x1, y0, y1 = pt.x.c0.n, pt.x.c1.n, pt.y.c0.n, pt.y.c1.n
        vals += [(x0 * a0 - x1 * a1) % p, (x0 * a1 + x1 * a0) % p,
                 (y0 * b0 - y1 * b1) % p, (y0 * b1 + y1 * b0) % p]
    xy = np.zeros((n, 2, 2, 12), np.int32)
    xy[~inf] = L.ints_to_words(vals).reshape(-1, 2, 2, 12)
    return xy[:, 0], xy[:, 1], inf


def rlc_pairs_words(pairs) -> np.ndarray:
    """[(r0, r1), …] 32-bit halves → (M, 2) int32 (read as uint32)."""
    return np.array(pairs, dtype=np.uint32).reshape(-1, 2).view(np.int32)


def rlc_bits_host(pairs) -> np.ndarray:
    """[(r0, r1), …] → (M, 64) int32 bits [r0 MSB first | r1 MSB first]:
    the JAX package's RLC bit layout, for comparisons."""
    out = np.zeros((len(pairs), 64), np.int32)
    for i, (r0, r1) in enumerate(pairs):
        for b in range(32):
            out[i, b] = (r0 >> (31 - b)) & 1
            out[i, 32 + b] = (r1 >> (31 - b)) & 1
    return out


def g1_decompress_rows(rows, device):
    """g1_decompress on (B, 48) uint8 numpy rows placed on
    `device`; the registry's ingest seam."""
    t = torch.as_tensor(np.ascontiguousarray(rows), dtype=torch.uint8)
    return C.g1_decompress(t.to(device))


# --- backend ------------------------------------------------------------------


class TorchBlsBackend:
    """Host façade over the verify kernels, with the edge semantics of
    grandine_tpu/tpu/bls.py TpuBlsBackend's seams: an empty batch is True;
    a length mismatch, an empty member list, an out-of-range index, an
    identity key or a wrong-length signature is False; batches over
    MAX_BUCKET run in chunks; an indexed batch past MAX_BUCKET (a wider
    committee, or more flat sets) goes to the keyed seam through the
    registry's host mirror. The RLC pairs are drawn from `rng` in the JAX
    package's order, one per set after the batch's messages are hashed.
    `multi_verify_async` routes a keyed batch with repeated messages to
    the grouped kernels where the JAX package does; `rlc_partition_verify`
    gives per-group verdicts for the fault localizer
    (runtime/isolation.py)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._h2c_cache = _LruCache(H2C_CACHE_CAP)

    # -- host prep ---------------------------------------------------------

    def _up(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, order="C")).to(self.device)

    def _hash_to_g2_words(self, message: bytes, dst: bytes):
        key = (bytes(message), dst)
        hit = self._h2c_cache.get(key)
        if hit is None:
            hit = g2_affine_words(hash_to_g2(message, dst))
            self._h2c_cache.put(key, hit)
        return hit

    @staticmethod
    def _rlc_pair(rng) -> "tuple[int, int]":
        """A nonzero (r0, r1) pair of 32-bit halves: the RLC scalar is
        r0 + r1·λ (λ = x² mod r), drawn in the JAX package's order."""
        a, b = 0, 0
        while a == 0 and b == 0:
            a, b = rng.randbits(32), rng.randbits(32)
        return a, b

    @staticmethod
    def _pack_sig_rows(signatures, b: int):
        """(b, 96) uint8 signature rows + the wire infinity-flag mask;
        padding rows carry the canonical infinity encoding. Raises
        ValueError on a wrong-length blob."""
        rows = C.compressed_rows(signatures, 96)
        n = rows.shape[0]
        sig_rows = np.zeros((b, 96), np.uint8)
        sig_rows[:, 0] = C.COMPRESSED_FLAG | C.INFINITY_FLAG
        sig_rows[:n] = rows
        sig_inf = np.ones((b,), bool)
        sig_inf[:n] = C.compressed_infinity_flags(rows)
        return sig_rows, sig_inf

    def _sig_plane(self, signatures, compressed: bool):
        """The signature operands on the card (`signature_plane*`): wire
        bytes, or `Signature`s converted to affine words on the host.
        None for a wrong-length blob."""
        if compressed:
            try:
                rows, inf = self._pack_sig_rows(signatures, len(signatures))
            except ValueError:
                return None
            return signature_plane_compressed(self._up(rows), self._up(inf))
        sx, sy, inf = g2_affine_words_many([s.point for s in signatures])
        return signature_plane(self._up(sx), self._up(sy), self._up(inf))

    def _messages(self, messages, dst):
        m = len(messages)
        msg = np.zeros((m, 2, 2, 12), np.int32)
        msg_inf = np.zeros((m,), bool)
        for i, message in enumerate(messages):
            msg[i], msg_inf[i] = self._hash_to_g2_words(message, dst)
        return self._up(msg), self._up(msg_inf)

    def _keys_src(self, points):
        """Affine words of host G1 keys (none ∞) uploaded as a gather
        source."""
        fx, fy = g1_affine_words(points)
        return self._up(fx), self._up(fy)

    @staticmethod
    def _chunked(fn, m, *seqs):
        first = fn(*(s[0:MAX_BUCKET] for s in seqs))

        def settle_chunks() -> bool:
            pending = first
            for i in range(MAX_BUCKET, m, MAX_BUCKET):
                nxt = fn(*(s[i : i + MAX_BUCKET] for s in seqs))
                if not pending():
                    return False
                pending = nxt
            return pending()

        return settle_chunks

    @staticmethod
    def _settle(verdict):
        return lambda: bool(verdict.item())

    # -- the two families ----------------------------------------------------

    def _aggregate_async(self, messages, signatures, members, registry, dst,
                         rng, compressed: bool):
        """Fast-aggregate seams: `members` are PublicKey lists (registry
        None) or index lists into `registry`."""
        m = len(messages)
        if not (m == len(signatures) == len(members)):
            return lambda: False
        if m == 0:
            return lambda: True
        if any(len(ks) == 0 for ks in members):
            return lambda: False
        if m > MAX_BUCKET:
            return self._chunked(
                lambda a, b, c: self._aggregate_async(
                    a, b, c, registry, dst, rng, compressed),
                m, messages, signatures, members)
        widest = max(len(ks) for ks in members)
        if registry is not None:
            reg_x, reg_y, reg_n = registry.arrays()
            if reg_x is None or any(
                not 0 <= int(i) < reg_n for ix in members for i in ix
            ):
                return lambda: False
            if widest > MAX_BUCKET:
                return self._aggregate_async(
                    messages, signatures,
                    [registry.public_keys(ix) for ix in members], None, dst,
                    rng, compressed)
            src_x, src_y = reg_x, reg_y
            idx = np.zeros((m, widest), np.int32)
            for i, ix in enumerate(members):
                idx[i, : len(ix)] = np.fromiter((int(v) for v in ix),
                                                np.int32, count=len(ix))
        else:
            if any(pk.point.is_infinity() for ks in members for pk in ks):
                return lambda: False
            if widest > MAX_BUCKET:
                members = [
                    ks if len(ks) <= MAX_BUCKET else [A.PublicKey.aggregate(ks)]
                    for ks in members
                ]
                widest = max(len(ks) for ks in members)
            src_x, src_y = self._keys_src(
                [pk.point for ks in members for pk in ks])
            idx = np.zeros((m, widest), np.int32)
            pos = 0
            for i, ks in enumerate(members):
                idx[i, : len(ks)] = np.arange(pos, pos + len(ks),
                                              dtype=np.int32)
                pos += len(ks)
        cnt = np.array([len(ks) for ks in members], np.int32)
        plane = self._sig_plane(signatures, compressed)
        if plane is None:
            return lambda: False
        msg, msg_inf = self._messages(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(m)]
        return self._settle(verify_aggregates(
            src_x, src_y, self._up(idx), self._up(cnt), plane, msg, msg_inf,
            self._up(rlc_pairs_words(pairs))))

    def _sets_async(self, messages, signatures, keys, registry, dst, rng,
                    compressed: bool):
        """The screening every flat seam shares, in the JAX package's
        order — length mismatch False, empty True, an out-of-range index
        False, past MAX_BUCKET an indexed batch goes keyed through the
        registry's host mirror and a keyed one runs in chunks, an ∞ key
        False — then the launch: an indexed or compressed batch flat, a
        keyed uncompressed one grouped by message where `grouped_route`
        says so. `keys` are PublicKeys (registry None) or registry
        indices, one signer per set."""
        n = len(messages)
        if not (n == len(signatures) == len(keys)):
            return lambda: False
        if n == 0:
            return lambda: True
        if registry is not None:
            reg_x, reg_y, reg_n = registry.arrays()
            if reg_x is None or any(not 0 <= int(i) < reg_n for i in keys):
                return lambda: False
            if n > MAX_BUCKET:
                return self._sets_async(messages, signatures,
                                        registry.public_keys(keys), None,
                                        dst, rng, compressed)
            idx = np.fromiter((int(v) for v in keys), np.int32, count=n)
            return self._flat_multi_verify_async(
                messages, signatures, reg_x, reg_y, idx, dst, rng,
                compressed)
        if n > MAX_BUCKET:
            return self._chunked(
                lambda a, b, c: self._sets_async(a, b, c, None, dst, rng,
                                                 compressed),
                n, messages, signatures, keys)
        if any(pk.point.is_infinity() for pk in keys):
            return lambda: False
        src_x, src_y = self._keys_src([pk.point for pk in keys])
        if not compressed:
            groups = message_groups(messages)
            if grouped_route(len(groups), max(map(len, groups.values())), n):
                return self._grouped_multi_verify_async(
                    groups, signatures, src_x, src_y, dst, rng)
        return self._flat_multi_verify_async(
            messages, signatures, src_x, src_y, np.arange(n, dtype=np.int32),
            dst, rng, compressed)

    def _flat_multi_verify_async(self, messages, signatures, src_x, src_y,
                                 idx, dst, rng, compressed: bool):
        """The flat launch: set i's key is row idx[i] of (src_x, src_y)."""
        plane = self._sig_plane(signatures, compressed)
        if plane is None:
            return lambda: False
        msg, msg_inf = self._messages(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(len(messages))]
        return self._settle(verify_sets(
            src_x, src_y, self._up(idx), plane, msg, msg_inf,
            self._up(rlc_pairs_words(pairs))))

    def _grouped_multi_verify_async(self, groups, signatures, src_x, src_y,
                                    dst, rng):
        """The message-grouped launch (the JAX package's
        `_grouped_multi_verify_async`, tpu/bls.py:2069): the sets in
        message order, one RLC pair each drawn in that order, set i's key
        row i of (src_x, src_y)."""
        order = np.fromiter((i for ix in groups.values() for i in ix),
                            np.int32, count=len(signatures))
        offsets = np.cumsum([0] + [len(ix) for ix in groups.values()])
        plane = self._sig_plane([signatures[i] for i in order], False)
        msg, msg_inf = self._messages(list(groups), dst)
        pairs = [self._rlc_pair(rng) for _ in range(len(order))]
        return self._settle(verify_grouped(
            src_x, src_y, self._up(order), plane, offsets, msg, msg_inf,
            self._up(rlc_pairs_words(pairs))))

    # -- flat seams ------------------------------------------------------------

    def multi_verify(self, messages, signatures, public_keys,
                     dst: bytes = constants.DST_SIGNATURE,
                     rng=secrets) -> bool:
        return self.multi_verify_async(messages, signatures, public_keys,
                                       dst, rng)()

    def multi_verify_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        public_keys: Sequence["A.PublicKey"],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """RLC verify of N (message, signature, key) sets: launches now
        and returns a zero-arg callable giving the verdict, so the
        caller's host work overlaps the device run. Batches with repeated
        messages take the grouped route where `grouped_route` says so (M
        Miller loops over Σᵢ∈ⱼ rᵢ·pkᵢ instead of N), the rest the flat
        one; the verdict is the same."""
        return self._sets_async(messages, signatures, public_keys, None, dst,
                                rng, compressed=False)

    def multi_verify_compressed(self, messages, signatures, public_keys,
                                dst: bytes = constants.DST_SIGNATURE,
                                rng=secrets) -> bool:
        return self.multi_verify_compressed_async(
            messages, signatures, public_keys, dst, rng)()

    def multi_verify_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence["A.PublicKey"],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """multi_verify_async with signatures as 96-byte wire rows,
        decompressed and ψ-checked on the card."""
        return self._sets_async(messages, signatures, public_keys, None, dst,
                                rng, compressed=True)

    def multi_verify_indexed(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        indices: Sequence[int],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ) -> bool:
        """Flat RLC verify with each set's signer key gathered on the card
        from the registry by validator index; an index the registry does
        not cover fails."""
        return self._sets_async(messages, signatures, indices, registry, dst,
                                rng, compressed=False)()

    def g2_subgroup_check_batch(self, points) -> np.ndarray:
        return self.g2_subgroup_check_batch_async(points)()

    def g2_subgroup_check_batch_async(self, points):
        """ψ-criterion membership of host G2 points (on the curve) in one
        launch; the callable gives an (N,) bool array, ∞ rows True."""
        if not points:
            return lambda: np.zeros((0,), bool)
        sx, sy, inf = g2_affine_words_many(points)
        out = C.g2_subgroup_check(self._up(sx), self._up(sy), self._up(inf))
        return lambda: out.cpu().numpy()

    # -- fault localization ----------------------------------------------

    def rlc_partition_verify(self, messages, signatures, member_keys,
                             groups: int, dst: bytes = constants.DST_SIGNATURE,
                             rng=secrets) -> np.ndarray:
        return self.rlc_partition_verify_async(
            messages, signatures, member_keys, groups, dst, rng)()

    def rlc_partition_verify_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        member_keys: Sequence[Sequence["A.PublicKey"]],
        groups: int,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """Per-group verdicts of one RLC pass, the seam the fault localizer
        descends through (grandine_tpu/tpu/bls.py rlc_partition_verify_async
        and rlc_partition_verify_kernel, :2898 and :279), with its
        semantics: `groups` rounds up to a power of two of at least 4,
        clamped to the batch's bucket B; slot i is item i, group j the
        slots j·B/G … (j+1)·B/G − 1. Each item's member keys are summed
        on the host to one key. An item with no keys or an identity key
        is named bad on the host, stays out of the device pass (padding)
        and makes its group False; a group with no live item is True; each
        group's verdict is ANDed with its members' G2 subgroup flags (the
        fused ψ check, `signature_plane`). One flat pass on the card:
        `multi_rlc_scale` and `miller_loop_pairs` over the live items,
        `rlc_finish` with one group per partition group. RLC pairs are
        drawn for every item, in order, after the hashing. Returns a settle
        callable giving a (G,) bool array (an empty or mismatched batch:
        size 0)."""
        n = len(messages)
        g = _bucket(groups, lo=4)
        if not (n and n == len(signatures) == len(member_keys)):
            return lambda: np.zeros((0,), bool)
        b = _bucket(n)
        g = min(g, b)
        span = b // g
        bad_host = np.zeros((n,), bool)
        slots, agg = [], []
        for i, ks in enumerate(member_keys):
            if not ks or any(pk.point.is_infinity() for pk in ks):
                bad_host[i] = True
                continue
            slots.append(i)
            agg.append(ks[0] if len(ks) == 1 else A.PublicKey.aggregate(ks))
        pk_inf = np.array([k.point.is_infinity() for k in agg], bool)
        msg, msg_inf = self._messages([messages[i] for i in slots], dst)
        pairs = [self._rlc_pair(rng) for _ in range(n)]
        verdict = None
        if slots:
            # an ∞ aggregate's pair is masked: its row only feeds the ladder
            src_x, src_y = self._keys_src([
                G1 if inf else k.point for k, inf in zip(agg, pk_inf)])
            sx, sy, sinf = g2_affine_words_many(
                [signatures[i].point for i in slots])
            plane = signature_plane(self._up(sx), self._up(sy),
                                    self._up(sinf))
            counts = np.bincount(np.array(slots) // span, minlength=g)
            verdict = verify_sets(
                src_x, src_y, self._up(np.arange(len(slots), dtype=np.int32)),
                plane, msg, msg_inf | self._up(pk_inf),
                self._up(rlc_pairs_words([pairs[i] for i in slots])),
                np.concatenate([[0], np.cumsum(counts)]))

        def settle() -> np.ndarray:
            out = (np.ones((g,), bool) if verdict is None
                   else verdict.cpu().numpy().astype(bool))
            out[np.nonzero(bad_host)[0] // span] = False
            return out

        return settle

    # -- fast-aggregate seams --------------------------------------------------

    def fast_aggregate_verify_batch(self, messages, signatures, member_keys,
                                    dst: bytes = constants.DST_SIGNATURE,
                                    rng=secrets) -> bool:
        return self.fast_aggregate_verify_batch_async(
            messages, signatures, member_keys, dst, rng)()

    def fast_aggregate_verify_batch_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        member_keys: Sequence[Sequence["A.PublicKey"]],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as `Signature`s, their member keys as PublicKeys
        (uploaded as the gather source)."""
        return self._aggregate_async(messages, signatures, member_keys, None,
                                     dst, rng, compressed=False)

    def fast_aggregate_verify_batch_indexed(
        self, messages, signatures, member_indices, registry,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_indexed_async(
            messages, signatures, member_indices, registry, dst, rng)()

    def fast_aggregate_verify_batch_indexed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        member_indices: Sequence[Sequence[int]],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as `Signature`s whose member keys are rows of the
        device-resident registry (gpu/registry.py), gathered on the card."""
        return self._aggregate_async(messages, signatures, member_indices,
                                     registry, dst, rng, compressed=False)

    def fast_aggregate_verify_batch_compressed(
        self, messages, signatures, member_keys,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_compressed_async(
            messages, signatures, member_keys, dst, rng)()

    def fast_aggregate_verify_batch_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        member_keys: Sequence[Sequence["A.PublicKey"]],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as wire bytes with their member keys given as
        PublicKeys."""
        return self._aggregate_async(messages, signatures, member_keys, None,
                                     dst, rng, compressed=True)

    def fast_aggregate_verify_batch_indexed_compressed(
        self, messages, signatures, member_indices, registry,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_indexed_compressed_async(
            messages, signatures, member_indices, registry, dst, rng)()

    def fast_aggregate_verify_batch_indexed_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        member_indices: Sequence[Sequence[int]],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as wire bytes whose member keys are registry rows
        gathered on the card by index."""
        return self._aggregate_async(messages, signatures, member_indices,
                                     registry, dst, rng, compressed=True)


__all__ = [
    "TorchBlsBackend", "MAX_BUCKET", "resolve_device", "aggregate_rlc_scale",
    "aggregate_rlc_scale_plain", "multi_rlc_scale", "multi_rlc_scale_plain",
    "g1_group_sum", "g1_group_sum_plain", "rlc_finish", "rlc_finish_plain",
    "rlc_sig_miller_plain", "finish_threads", "finish_groups",
    "rlc_finish_geometry", "PER_THREAD_SPAN",
    "signature_plane", "signature_plane_compressed", "verify_aggregates",
    "verify_sets", "verify_grouped", "grouped_route", "message_groups",
    "g1_decompress_rows", "rlc_pairs_words", "rlc_bits_host",
    "g2_affine_words", "g2_affine_words_many", "g1_affine_words",
]
