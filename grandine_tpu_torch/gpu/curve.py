"""Jacobian curve arithmetic for G1 (over Fp) and G2 (over Fp2 on the
twist), point decompression and the ψ subgroup check, on torch tensors —
plus the two decompression kernels' wrappers.

The group-law formulas are the JAX package's (grandine_tpu/tpu/curve.py:
dbl-2009-l doubling, madd-2007-bl mixed addition, add-2007-bl complete
addition with its selects), and the CUDA kernels (csrc/bls12_381.cuh)
run the same formulas, so Jacobian coordinates agree exactly between a
kernel and its plain version; against the JAX package the tests compare
affine points.

A point in the plain working format is a tuple (X, Y, Z) of Montgomery
limb tensors (limbs.py); at a kernel boundary it is a canonical word
tensor with the coordinate axis ahead of the field axes: G1 ``(…, 3, 12)``
Jacobian or ``(…, 12)`` per affine coordinate, G2 ``(…, 3, 2, 12)``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from grandine_tpu_torch.crypto import constants
from grandine_tpu_torch.crypto.curves import endo_constants, psi_constants_ints
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import limbs as L

P = L.P
ABS_X = -constants.X

#: byte-0 flag bits of the ZCash BLS12-381 serialization
COMPRESSED_FLAG = 0x80
INFINITY_FLAG = 0x40
SIGN_FLAG = 0x20


@dataclass(frozen=True)
class FieldOps:
    """The field surface the curve formulas need; `k` is the number of
    trailing axes of one element (1 for Fp, 2 for Fp2)."""

    k: int
    mul: Callable

    def mul_many(self, aa, bb):
        d, n = -1 - self.k, len(aa)
        xs = torch.broadcast_tensors(*aa, *bb)
        t = self.mul(torch.stack(xs[:n], d), torch.stack(xs[n:], d))
        return [t.select(d, i) for i in range(n)]

    def is_zero(self, a):
        z = L.is_zero(a)
        return z.all(-1) if self.k == 2 else z

    def one(self, batch, device):
        return (L.one_fp(batch, device) if self.k == 1
                else F.fp2_one(batch, device))

    def batch(self, a):
        return a.shape[: a.dim() - self.k]


FP_OPS = FieldOps(1, L.montmul)
FP2_OPS = FieldOps(2, F.fp2_mul)

add, sub = L.add_mod, L.sub_mod


def _sel3(cond, a, b):
    return tuple(L.select(cond, x, y) for x, y in zip(a, b))


def point_double(p, ops):
    """dbl-2009-l (a = 0); complete on these curves."""
    X, Y, Z = p
    A, Bq, YZ = ops.mul_many([X, Y, Y], [X, Y, Z])
    XB = add(X, Bq)
    E = add(add(A, A), A)
    C, T1, Fv = ops.mul_many([Bq, XB, E], [Bq, XB, E])
    D = sub(T1, add(A, C))
    D = add(D, D)
    X3 = sub(Fv, add(D, D))
    (t,) = ops.mul_many([E], [sub(D, X3)])
    C2 = add(C, C)
    C4 = add(C2, C2)
    C8 = add(C4, C4)
    return (X3, sub(t, C8), add(YZ, YZ))


def point_madd_unsafe(p, qx, qy, ops):
    """madd-2007-bl: P (Jacobian) + Q (affine), P ≠ ±Q, neither ∞."""
    X, Y, Z = p
    (Z2,) = ops.mul_many([Z], [Z])
    U2, ZZZ = ops.mul_many([qx, Z], [Z2, Z2])
    H = sub(U2, X)
    S2, HH = ops.mul_many([qy, H], [ZZZ, H])
    I = add(HH, HH)
    I = add(I, I)
    r = sub(S2, Y)
    r = add(r, r)
    J, V, R2 = ops.mul_many([H, X, r], [I, I, r])
    X3 = sub(R2, add(J, add(V, V)))
    ZH = add(Z, H)
    t, YJ, ZH2 = ops.mul_many([r, Y, ZH], [sub(V, X3), J, ZH])
    return (X3, sub(t, add(YJ, YJ)), sub(ZH2, add(Z2, HH)))


def point_add_complete(p, q, ops):
    """add-2007-bl with the doubling fallback and ∞ handled by selects, in
    the JAX package's order of selects."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2, dA, dB, dYZ = ops.mul_many(
        [Z1, Z2, X1, Y1, Y1], [Z1, Z2, X1, Y1, Z1])
    dE = add(add(dA, dA), dA)
    dXB = add(X1, dB)
    U1, U2, t1, t2, Z1Z2, dC, dT1, dF = ops.mul_many(
        [X1, X2, Z2, Z1, Z1, dB, dXB, dE],
        [Z2Z2, Z1Z1, Z2Z2, Z1Z1, Z2, dB, dXB, dE])
    H = sub(U2, U1)
    H2 = add(H, H)
    ZZ2 = add(Z1Z2, Z1Z2)
    dD = sub(dT1, add(dA, dC))
    dD = add(dD, dD)
    dX3 = sub(dF, add(dD, dD))
    S1, S2, I, Z3, dt = ops.mul_many(
        [Y1, Y2, H2, ZZ2, dE], [t1, t2, H2, H, sub(dD, dX3)])
    r = sub(S2, S1)
    r = add(r, r)
    p_inf, q_inf = ops.is_zero(Z1), ops.is_zero(Z2)
    eq_x, eq_y = ops.is_zero(H), ops.is_zero(r)
    J, V, R2 = ops.mul_many([H, U1, r], [I, I, r])
    X3 = sub(R2, add(J, add(V, V)))
    t, S1J = ops.mul_many([r, S1], [sub(V, X3), J])
    Y3 = sub(t, add(S1J, S1J))
    dC2 = add(dC, dC)
    dC4 = add(dC2, dC2)
    dY3 = sub(dt, add(dC4, dC4))
    dbl = (dX3, dY3, add(dYZ, dYZ))
    one = ops.one(ops.batch(X1), X1.device)
    inf = (one, one, torch.zeros_like(X1))
    out = (X3, Y3, Z3)
    out = _sel3(eq_x & ~eq_y & ~p_inf & ~q_inf, inf, out)
    out = _sel3(eq_x & eq_y, dbl, out)
    out = _sel3(q_inf, p, out)
    return _sel3(p_inf, q, out)


def _bits_msb(values: torch.Tensor, nbits: int):
    """(…,) int64 scalars below 2³² (nbits ≤ 32), or (…, nbits/32) int64
    little-endian 32-bit words → list of nbits (…,) bool tensors, MSB
    first."""
    if nbits <= 32:
        return [((values >> (nbits - 1 - i)) & 1).bool() for i in range(nbits)]
    return [((values[..., i // 32] >> (i % 32)) & 1).bool()
            for i in range(nbits - 1, -1, -1)]


def _mask_inf(st, inf, ops):
    X, Y, Z = st
    one = ops.one(ops.batch(X), X.device)
    return _sel3(inf, (one, one, torch.zeros_like(X)), st)


def scalar_mul(qx, qy, q_inf, bits, ops):
    """[k]Q for affine Q, MSB-first bit list (mixed adds; k < r)."""
    return _mask_inf(ladder([(qx, qy)], [bits], ops), q_inf, ops)


def ladder(bases, bits, ops):
    """The joint branchless ladder over affine bases [(qx, qy), …], none
    ∞: every step doubles, then each base's slot adds it by a mixed
    addition where its bit is set (the base itself before the first set
    bit), the bits choosing by select. `bits` holds one MSB-first list of
    (…,) bool tensors a base. Returns the Jacobian sum, ∞ (1, 1, 0) where
    no bit is set."""
    qx = bases[0][0]
    one = ops.one(ops.batch(qx), qx.device)
    st = (one, one, torch.zeros_like(qx))
    started = torch.zeros(ops.batch(qx), dtype=torch.bool, device=qx.device)
    for step in zip(*bits):
        st = point_double(st, ops)
        for b, (bx, by) in zip(step, bases):
            added = point_madd_unsafe(st, bx, by, ops)
            st = _sel3(b, _sel3(started, added, (bx, by, one)), st)
            started = started | b
    return st


def scalar_mul_glv(qx, qy, q_inf, r0, r1, endo, ops, nbits: int = 32,
                   neg_lo=None, neg_hi=None):
    """[±r0 ± r1·λ]Q for affine Q: the dual n-bit GLV ladder with mixed
    adds (grandine_tpu/tpu/curve.py scalar_mul_glv); `endo` = (cx, cy)
    with (cx·x, cy·y) = [λ](x, y). r0, r1 are (…,) int64 in [0, 2³²) for
    the 32-bit RLC halves, or (…, nbits/32) int64 little-endian 32-bit
    words for wider halves (128-bit signing scalars); the (…,) bool masks
    neg_lo / neg_hi negate the y of the matching base (after the
    endomorphism), for signed GLV decompositions. Every step doubles and
    both additions are computed, the bits choosing by select (`ladder`)."""
    q2x, q2y = ops.mul_many([qx, qy], list(endo))
    if neg_lo is not None:
        qy = L.select(neg_lo, L.neg_mod(qy), qy)
    if neg_hi is not None:
        q2y = L.select(neg_hi, L.neg_mod(q2y), q2y)
    st = ladder([(qx, qy), (q2x, q2y)],
                [_bits_msb(r0, nbits), _bits_msb(r1, nbits)], ops)
    return _mask_inf(st, q_inf, ops)


def scalar_mul_glv_split(qx, qy, q_inf, r0, r1, endo, ops):
    """[r0 + r1·λ]Q for affine Q with the halves' ladders apart: [r0]Q and
    [r1]·endo(Q), each a 32-bit `ladder` of mixed additions, joined by one
    complete addition (p the r0 half) — the order of aggregate_rlc_scale's
    two G2 warps (csrc/aggregate.cu). The same point as `scalar_mul_glv`'s
    joint ladder (grandine_tpu/tpu/curve.py scalar_mul_glv)."""
    q2x, q2y = ops.mul_many([qx, qy], list(endo))
    # both halves in one ladder over a leading axis of 2: each element's
    # steps are its own, so the words are those of two ladders apart
    lo, hi = zip(*(c.unbind(0) for c in ladder(
        [(torch.stack([qx, q2x]), torch.stack([qy, q2y]))],
        [_bits_msb(torch.stack([r0, r1]), 32)], ops)))
    return _mask_inf(point_add_complete(lo, hi, ops), q_inf, ops)


def jac_ladder(q, bits, ops):
    """[k]Q for a Jacobian base Q, k's MSB-first bits (a list of (…,)
    bool tensors): from ∞, each step a doubling and, where the bit is
    set, a complete addition of Q."""
    one = ops.one(ops.batch(q[0]), q[0].device)
    st = (one, one, torch.zeros_like(q[0]))
    for b in bits:
        st = point_double(st, ops)
        st = _sel3(b, point_add_complete(st, q, ops), st)
    return st


def scalar_mul_jac_glv(q, q_inf, r0, r1, endo, ops):
    """[r0 + r1·λ]Q for a Jacobian base, complete additions throughout,
    the halves' ladders apart: [r0]Q and [r1]·endo(Q) (`jac_ladder`)
    joined by one complete addition (p the r0 half) — the order of
    aggregate_rlc_scale's two G1 lanes (csrc/aggregate.cu). The same point
    as the JAX package's joint ladder (grandine_tpu/tpu/curve.py
    scalar_mul_jac_glv)."""
    Q = _mask_inf(q, q_inf, ops)
    e2x, e2y = ops.mul_many([Q[0], Q[1]], list(endo))
    # both halves in one ladder, as in scalar_mul_glv_split
    lo, hi = zip(*(c.unbind(0) for c in jac_ladder(
        (torch.stack([Q[0], e2x]), torch.stack([Q[1], e2y]),
         torch.stack([Q[2], Q[2]])), _bits_msb(torch.stack([r0, r1]), 32),
        ops)))
    return _mask_inf(point_add_complete(lo, hi, ops), q_inf, ops)


def sum_points_grouped(p, ops):
    """Tree sum of (…, T) Jacobian points along the last batch axis (T a
    power of two): level s adds position t + s into t — the order of the
    CUDA kernels' shared-memory trees."""
    t = p[0].shape[len(ops.batch(p[0])) - 1]
    while t > 1:
        s = t // 2
        lo = tuple(c.narrow(len(ops.batch(c)) - 1, 0, s) for c in p)
        hi = tuple(c.narrow(len(ops.batch(c)) - 1, s, s) for c in p)
        p = point_add_complete(lo, hi, ops)
        t = s
    return tuple(c.squeeze(len(ops.batch(c)) - 1) for c in p)


def g1_endo(device):
    """(βx, βy) with (βx·x, βy·y) = [λ](x, y) on G1 (crypto/curves.py)."""
    bx, by = endo_constants()["g1"]
    return (L.const_fp(bx, (), device), L.const_fp(by, (), device))


def g2_endo(device):
    """(ωx, ωy) as Fp2 constants: (ωx·x, ωy·y) = [λ](x, y) on G2."""
    wx, wy = endo_constants()["g2"]
    return (F.fp2_const(wx, 0, (), device), F.fp2_const(wy, 0, (), device))


# --- ψ subgroup check -------------------------------------------------------


def neg_psi(x, y):
    """−ψ of affine Fp2 Montgomery (x, y): (cx·x̄, −cy·ȳ), which is
    [|x|](x, y) on G2 (ψ acts there as [x], x < 0)."""
    (cx0, cx1), (cy0, cy1) = psi_constants_ints()
    cx = F.fp2_const(cx0, cx1, (), x.device)
    cy = F.fp2_const(cy0, cy1, (), x.device)
    nx, ny = FP2_OPS.mul_many([cx, cy], [F.fp2_conj(x), F.fp2_conj(y)])
    return nx, L.neg_mod(ny)


def psi_check(x, y, inf):
    """ψ(P) + [|x|]P == ∞ (Bowe's criterion, the JAX package's
    `_psi_ladder_check`); affine Fp2 Montgomery x, y; rows masked by
    `inf` pass."""
    xp = scalar_mul(x, y, inf, [torch.full(inf.shape, b == "1", device=x.device)
                                for b in bin(ABS_X)[2:]], FP2_OPS)
    (cx0, cx1), (cy0, cy1) = psi_constants_ints()
    cx = F.fp2_const(cx0, cx1, (), x.device)
    cy = F.fp2_const(cy0, cy1, (), x.device)
    px, py = FP2_OPS.mul_many([cx, cy], [F.fp2_conj(x), F.fp2_conj(y)])
    one = F.fp2_one(inf.shape, x.device)
    total = point_add_complete(xp, (px, py, one), FP2_OPS)
    return inf | F.fp2_is_zero(total[2])


# --- decompression (plain versions) ----------------------------------------


def _rows_to_limbs(rows: torch.Tensor) -> torch.Tensor:
    """(…, 48) uint8 big-endian payload → (…, 24) canonical limbs."""
    b = rows.to(torch.int64).flip(-1).reshape(*rows.shape[:-1], 24, 2)
    return b[..., 0] | (b[..., 1] << 8)


def _flags(rows):
    f = rows[..., 0].to(torch.int64)
    c = (f & COMPRESSED_FLAG) != 0
    i = (f & INFINITY_FLAG) != 0
    s = (f & SIGN_FLAG) != 0
    payload = rows.clone()
    payload[..., 0] = payload[..., 0] & 0x1F
    return c, i, s, payload, (payload == 0).all(-1)


def _masks(c, i, s, pz, lt_p, y_ok):
    inf = c & i & ~s & pz
    bad_inf = c & i & ~inf
    bad_enc = ~c | (c & ~i & ~lt_p)
    bad_curve = c & ~i & lt_p & ~y_ok
    ok = inf | (c & ~i & lt_p & y_ok)
    return inf, ok, bad_enc, bad_curve, bad_inf


def g1_decompress_plain(rows: torch.Tensor):
    """(B, 48) uint8 → (x, y, inf, ok, bad_encoding, bad_curve,
    bad_infinity): x, y (B, 12) canonical words, zero on invalid or
    infinity rows; accept/reject exactly as crypto/bls.py g1_from_bytes
    without the subgroup check (grandine_tpu/tpu/curve.py
    g1_decompress_dev)."""
    c, i, s, payload, pz = _flags(rows)
    xc = _rows_to_limbs(payload)
    lt_p = ~L.geq_const(xc, P)
    x = L.to_mont(xc)
    b = L.const_fp(4, (), x.device)
    y2 = L.add_mod(L.montmul(L.montsq(x), x), b)
    y, y_ok = F.fq_sqrt(y2)
    larger = L.geq_const(L.from_mont(y), (P + 1) // 2)
    y = L.select(s != larger, L.neg_mod(y), y)
    inf, ok, be, bc, bi = _masks(c, i, s, pz, lt_p, y_ok)
    live = ok & ~inf
    x = L.select(live, L.from_mont(x), torch.zeros_like(x))
    y = L.select(live, L.from_mont(y), torch.zeros_like(y))
    return (L.limbs_to_words(x), L.limbs_to_words(y), inf, ok, be, bc, bi)


def g2_decompress_subgroup_plain(rows: torch.Tensor):
    """(B, 96) uint8 → (x, y, inf, ok, bad_encoding, bad_curve,
    bad_infinity, in_subgroup): x, y (B, 2, 12) canonical words (c1
    travels first on the wire), zero on invalid or infinity rows;
    in_subgroup is the ψ check, passing rows that are ∞ or invalid (they
    are masked out of the group law downstream, as in the JAX package)."""
    c, i, s, payload, pz = _flags(rows)
    x1c = _rows_to_limbs(payload[..., :48])
    x0c = _rows_to_limbs(payload[..., 48:])
    lt_p = ~L.geq_const(x0c, P) & ~L.geq_const(x1c, P)
    x = torch.stack([L.to_mont(x0c), L.to_mont(x1c)], -2)
    b2 = F.fp2_const(4, 4, (), x.device)
    y2 = L.add_mod(F.fp2_mul(F.fp2_sq(x), x), b2)
    y, y_ok = F.fq2_sqrt(y2)
    yc = L.from_mont(y)
    half = (P + 1) // 2
    larger = L.geq_const(yc[..., 1, :], half) | (
        L.is_zero(yc[..., 1, :]) & L.geq_const(yc[..., 0, :], half))
    y = L.select(s != larger, L.neg_mod(y), y)
    inf, ok, be, bc, bi = _masks(c, i, s, pz, lt_p, y_ok)
    live = ok & ~inf
    zero = torch.zeros_like(x)
    x = L.select(live, x, zero)
    y = L.select(live, y, zero)
    in_sub = psi_check(x, y, ~live)
    return (L.limbs_to_words(L.from_mont(x)), L.limbs_to_words(L.from_mont(y)),
            inf, ok, be, bc, bi, in_sub)


# --- kernel wrappers ----------------------------------------------------------


def _check_rows(rows, width):
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] != width:
        raise ValueError(f"rows must be (B, {width}) uint8, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    return rows.contiguous()


def g1_decompress(rows: torch.Tensor):
    """Batched G1 decompression. CUDA kernel `g1_decompress`
    (csrc/decompress.cu) on a CUDA tensor, `g1_decompress_plain` on a CPU
    tensor; outputs as `g1_decompress_plain`.

    Replaces the JAX program grandine_tpu/tpu/bls.py g1_decompress_kernel
    (grandine_tpu/tpu/curve.py g1_decompress_dev). One thread per 48-byte
    row. Bound: operations — the square root is a 381-bit fixed
    exponentiation (~610 Fp products a row) against 48 bytes in and 100
    out, so the kernel sits far above the card's byte rate; with one row
    per thread and no cross-thread traffic the design keeps every SM busy
    at registry sizes (65,536 rows = 512 blocks of 128)."""
    rows = _check_rows(rows, 48)
    if rows.device.type == "cpu":
        return g1_decompress_plain(rows)
    from grandine_tpu_torch.gpu import _build

    b = rows.shape[0]
    dev = rows.device
    x = torch.empty((b, 12), dtype=torch.int32, device=dev)
    y = torch.empty((b, 12), dtype=torch.int32, device=dev)
    flags = torch.empty((5, b), dtype=torch.bool, device=dev)
    _build.launch("g1_decompress", rows, x, y, flags, ctypes.c_int(b))
    g1_decompress.launches += 1
    return (x, y, *flags.unbind(0))


g1_decompress.launches = 0


def g2_decompress_subgroup(rows: torch.Tensor):
    """Batched G2 decompression fused with the ψ subgroup check. CUDA
    kernel `g2_decompress_subgroup` (csrc/decompress.cu) on a CUDA tensor,
    `g2_decompress_subgroup_plain` on a CPU tensor.

    Replaces grandine_tpu/tpu/curve.py g2_decompress_dev with
    grandine_tpu/tpu/field.py fq2_sqrt and grandine_tpu/tpu/bls.py
    `_psi_ladder_check` / `_fused_subgroup_mask`, which the JAX verify
    programs run inside their body. One warp a row, G2_DEC_WARPS
    (csrc/decompress.cu) rows a block. The square roots of `fq2_sqrt`'s norm/half algorithm run as
    exponentiations on pairs of lanes (one squares, one multiplies, least
    significant bit first: a chain of one Fp product a bit), the three of
    √c0, √−c0 and √norm at once, then both candidates at once, each by
    one exponentiation t^((p−3)/4) that gives its root and, where it is
    one, the root's inverse; then the ψ check runs its 64-step ladder by
    |x| and its complete addition as G2DBL / G2MADD / G2ADD warp programs
    (csrc/glv_halves.cuh warp_psi_check). Bound: operations — at the
    worse of the root's two branches three 381-bit exponentiations (√norm
    and one a candidate; √c0 and √−c0 where c1 = 0), a 63-doubling G2
    ladder (~3,400 Fp products a row) against 96 bytes in; the kernel
    also computes √c0 and √−c0 on every row, work no row with c1 ≠ 0
    needs. It is latency-bound on a row's chain: two exponentiations of
    ~379 Fp products each and ~68 warp programs."""
    rows = _check_rows(rows, 96)
    if rows.device.type == "cpu":
        return g2_decompress_subgroup_plain(rows)
    out = _g2_decompress_cuda(rows, None)
    g2_decompress_subgroup.launches += 1
    return out


g2_decompress_subgroup.launches = 0


def _g2_decompress_cuda(rows, clocks):
    from grandine_tpu_torch.gpu import _build

    b = rows.shape[0]
    dev = rows.device
    x = torch.empty((b, 2, 12), dtype=torch.int32, device=dev)
    y = torch.empty((b, 2, 12), dtype=torch.int32, device=dev)
    flags = torch.empty((6, b), dtype=torch.bool, device=dev)
    _build.launch("g2_decompress_subgroup", rows, x, y, flags,
                  ctypes.c_int(b), ctypes.c_void_p(
                      None if clocks is None else clocks.data_ptr()))
    return (x, y, *flags.unbind(0))


def g2_decompress_subgroup_split(rows: torch.Tensor):
    """(outputs, clocks) of one `g2_decompress_subgroup` launch on CUDA
    rows that also records each row's stage clocks (clock64 of its warp
    at the start, after the decompression, after the ψ check's stores):
    (B, 3) int64. A measurement: it does not count as a launch."""
    rows = _check_rows(rows, 96)
    clocks = torch.zeros((rows.shape[0], 3), dtype=torch.int64,
                         device=rows.device)
    return _g2_decompress_cuda(rows, clocks), clocks


def g2_decompress_subgroup_geometry(n: int):
    """(blocks, threads a block, shared memory bytes, blocks one SM holds
    at once) of the `g2_decompress_subgroup` launch over n rows, on the
    current CUDA device. A query: it launches nothing."""
    from grandine_tpu_torch.gpu import _build

    geometry = np.zeros((4,), np.int32)
    _build.launch("g2_decompress_subgroup_geometry", ctypes.c_int(n),
                  ctypes.c_void_p(geometry.ctypes.data))
    return tuple(int(v) for v in geometry)


def g2_subgroup_check_geometry(n: int):
    """(blocks, threads a block, shared memory bytes, blocks one SM holds
    at once) of the `g2_subgroup_check` launch over n rows, on the current
    CUDA device. A query: it launches nothing."""
    from grandine_tpu_torch.gpu import _build

    geometry = np.zeros((4,), np.int32)
    _build.launch("g2_subgroup_check_geometry", ctypes.c_int(n),
                  ctypes.c_void_p(geometry.ctypes.data))
    return tuple(int(v) for v in geometry)


def g2_subgroup_check_plain(sx, sy, s_inf):
    """Plain version of `g2_subgroup_check`: `psi_check` on canonical
    words."""
    return psi_check(L.from_words(sx), L.from_words(sy), s_inf)


def g2_subgroup_check(sx: torch.Tensor, sy: torch.Tensor,
                      s_inf: torch.Tensor) -> torch.Tensor:
    """ψ(P) + [|x|]P == ∞ for (N, 2, 12) affine canonical x, y of points on
    E2, with the (N,) mask s_inf; returns (N,) bool, ∞ rows passing (the
    caller rejects an infinity signature by policy). CUDA kernel
    `g2_subgroup_check` (csrc/decompress.cu) on CUDA tensors,
    `g2_subgroup_check_plain` on CPU tensors.

    Replaces the JAX program grandine_tpu/tpu/bls.py
    g2_subgroup_check_kernel (:919, `_psi_ladder_check` :208) and, on the
    uncompressed seams, the fused `_fused_subgroup_mask` (:237). One warp
    a row, G2_DEC_WARPS (csrc/decompress.cu) rows a block: the row's x, y
    into Montgomery form one value a lane, then the ψ check that
    `g2_decompress_subgroup` runs (csrc/glv_halves.cuh warp_psi_check),
    its ladder by |x| as G2DBL / G2MADD warp programs and its complete
    addition as G2ADD; an ∞ row runs no program. Bound: operations — 63
    doublings and 5 mixed additions in Fp2, the complete addition and
    ψ's two Fp2 products (~1,600 Fp products a row) against 194 bytes a
    row. The kernel is latency-bound on a row's chain of ~70 warp
    programs of a few rounds each; at the window's 1,048 rows (262
    blocks) two warps share a scheduler."""
    n = s_inf.shape[0]
    if sx.shape != (n, 2, 12) or sy.shape != (n, 2, 12):
        raise ValueError("g2_subgroup_check: sx, sy must be (N, 2, 12)")
    if s_inf.device.type == "cpu":
        return g2_subgroup_check_plain(sx, sy, s_inf)
    from grandine_tpu_torch.gpu import _build

    out = torch.empty((n,), dtype=torch.bool, device=s_inf.device)
    _build.launch("g2_subgroup_check", sx.contiguous(), sy.contiguous(),
                  s_inf.contiguous(), out, ctypes.c_int(n))
    g2_subgroup_check.launches += 1
    return out


g2_subgroup_check.launches = 0


# --- host helpers -----------------------------------------------------------


def compressed_rows(blobs, nbytes: int) -> np.ndarray:
    """List of `nbytes`-long byte strings → (N, nbytes) uint8 rows; length
    is the only property checked on the host."""
    for blob in blobs:
        if len(blob) != nbytes:
            raise ValueError(
                f"compressed row must be {nbytes} bytes, got {len(blob)}")
    if not blobs:
        return np.zeros((0, nbytes), np.uint8)
    return np.frombuffer(b"".join(blobs), np.uint8).reshape(len(blobs), nbytes)


def compressed_infinity_flags(rows: np.ndarray) -> np.ndarray:
    return (rows[:, 0] & INFINITY_FLAG) != 0


def jac_from_words(w: torch.Tensor, k: int):
    """(…, 3, [2,] 12) canonical words → (X, Y, Z) Montgomery limbs; k is
    1 for G1, 2 for G2."""
    m = L.from_words(w)
    return tuple(m.select(-1 - k, i) for i in range(3))


def jac_to_words(p, k: int) -> torch.Tensor:
    return L.to_words(torch.stack(p, -1 - k))


__all__ = [
    "FP_OPS", "FP2_OPS", "point_double", "point_madd_unsafe",
    "point_add_complete", "ladder", "scalar_mul",
    "scalar_mul_glv", "neg_psi",
    "scalar_mul_jac_glv", "scalar_mul_glv_split", "jac_ladder",
    "sum_points_grouped", "psi_check",
    "g1_decompress", "g1_decompress_plain", "g2_decompress_subgroup",
    "g2_decompress_subgroup_plain", "g2_decompress_subgroup_split",
    "g2_decompress_subgroup_geometry", "g2_subgroup_check",
    "g2_subgroup_check_geometry", "g2_subgroup_check_plain",
    "compressed_rows", "compressed_infinity_flags",
]
