"""Optimal ate pairing pieces on torch tensors (plain versions) and the
`miller_loop_pairs` kernel's wrapper.

Formulas are the JAX package's (grandine_tpu/tpu/pairing.py): the G2
loop point is homogeneous projective on the twist, the G1 point stays
Jacobian with its line scaling (ξ·yP·Zp³, xP·Zp³ folded into the line
coefficients), lines land in the sparse subspace {1, w³, w⁵}, and the
hard part of the final exponentiation is the x-chain
(x−1)²(x+p)(x²+p²−1)+3, so `final_exponentiation` returns FE(f)³ exactly
as the JAX package does. The CUDA kernels (csrc/bls12_381.cuh) run the
same steps, so a Miller-loop value agrees exactly between kernel, plain
version and the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from grandine_tpu_torch.crypto.constants import X
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import limbs as L

ABS_X = abs(X)
#: bits of |x| after its most significant one, MSB first
BITS_AFTER_MSB = [(ABS_X >> i) & 1 for i in range(62, -1, -1)]

add, sub = L.add_mod, L.sub_mod
mm2 = C.FP2_OPS.mul_many


def prepare_g1(P):
    """(ξ·yP as the Fp2 (Yp, Yp), −Xp·Zp, Zp³) of a Jacobian G1 point."""
    Xp, Yp, Zp = P
    XpZp, Zp2 = C.FP_OPS.mul_many([Xp, Zp], [Zp, Zp])
    Zp3 = L.montmul(Zp2, Zp)
    return torch.stack([Yp, Yp], -2), L.neg_mod(XpZp), Zp3


def _lines(la, lb_pre, lc_pre, g1c):
    xi_yp, neg_xpzp, zp3 = g1c
    (l_a,) = mm2([la], [xi_yp])
    l_b = F.fp2_mul_fp(lb_pre, zp3)
    l_c = F.fp2_mul_fp(lc_pre, neg_xpzp)
    return l_a, l_b, l_c


def double_step(T, g1c):
    """T ← 2T on the twist (homogeneous), with the evaluated line."""
    Xt, Yt, Zt = T
    X2 = F.fp2_sq(Xt)
    A = add(add(X2, X2), X2)
    YZ, AX = mm2([Yt, A], [Zt, Xt])
    B = add(YZ, YZ)
    YB, BZ, AZ, B2 = mm2([Yt, B, A, B], [B, Zt, Zt, B])
    line = _lines(BZ, sub(AX, YB), AZ, g1c)
    A2, XB2, B3 = mm2([A, Xt, B], [A, B2, B2])
    A2Z, YB3, Z2 = mm2([A2, Yt, B3], [Zt, B3, Zt])
    XB2_2 = add(XB2, XB2)
    XB2_3 = add(XB2_2, XB2)
    Xn, t = mm2([B, A], [sub(A2Z, XB2_2), sub(XB2_3, A2Z)])
    return (Xn, sub(t, YB3), Z2), line


def add_step(T, Q, g1c):
    """T ← T + Q (both homogeneous on the twist), with the line."""
    Xt, Yt, Zt = T
    Xq, Yq, Zq = Q
    YZq, YqZ, XZq, XqZ = mm2([Yt, Yq, Xt, Xq], [Zq, Zt, Zq, Zt])
    E = sub(YZq, YqZ)
    Fv = sub(XZq, XqZ)
    EXq, FYq, EZq, FZq, F2 = mm2([E, Fv, E, Fv, Fv], [Xq, Yq, Zq, Zq, Fv])
    line = _lines(FZq, sub(EXq, FYq), EZq, g1c)
    E2, F3, Fsum, XF2 = mm2([E, Fv, F2, F2], [E, F2, add(XZq, XqZ), Xt])
    E2Z, XF2Zq, YF3, F3Z = mm2([E2, XF2, F3, F3], [Zt, Zq, Yt, Zt])
    E2ZZq, YF3Zq, Z3 = mm2([E2Z, YF3, F3Z], [Zq, Zq, Zq])
    G = sub(E2ZZq, Fsum)
    X3, t = mm2([Fv, E], [G, sub(XF2Zq, G)])
    return (X3, sub(t, YF3Zq), Z3), line


def line_to_fp12(line):
    """(a, b, c) → the Fp12 a + b·w³ + c·w⁵ = ((a, 0, 0), (0, b, c))."""
    a, b, c = line
    z = torch.zeros_like(a)
    return torch.stack([torch.stack([a, z, z], -3),
                        torch.stack([z, b, c], -3)], -4)


def miller_loop(P_jac, Q_proj, inf):
    """f_{|x|,Q}(P), conjugated for the negative x; slots masked by `inf`
    give 1."""
    g1c = prepare_g1(P_jac)
    batch = inf.shape
    f = F.fp12_one(batch, inf.device)
    T = Q_proj
    for bit in BITS_AFTER_MSB:
        f = F.fp12_sq(f)
        T, line = double_step(T, g1c)
        f = F.fp12_mul(f, line_to_fp12(line))
        if bit:
            T, line = add_step(T, Q_proj, g1c)
            f = F.fp12_mul(f, line_to_fp12(line))
    f = F.fp12_conj(f)
    return L.select(inf, F.fp12_one(batch, inf.device), f)


def expx_abs(m):
    """m^|x|, MSB first."""
    acc = m
    for bit in bin(ABS_X)[3:]:
        acc = F.fp12_sq(acc)
        if bit == "1":
            acc = F.fp12_mul(acc, m)
    return acc


def _hard_part(m):
    conj, mul = F.fp12_conj, F.fp12_mul
    t1 = conj(mul(expx_abs(m), m))
    t2 = conj(mul(expx_abs(t1), t1))
    t3 = mul(conj(expx_abs(t2)), F.fp12_frobenius(t2))
    t4 = conj(expx_abs(conj(expx_abs(t3))))
    m3 = mul(mul(m, m), m)
    return mul(mul(mul(t4, F.fp12_frobenius_n(t3, 2)), conj(t3)), m3)


def final_exponentiation(f):
    """f^(3·(p¹²−1)/r) (the JAX package's FE(f)³)."""
    t = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))
    m = F.fp12_mul(F.fp12_frobenius_n(t, 2), t)
    return _hard_part(m)


def fp12_product(f):
    """Product of a (N, …) batch of Fp12 elements along axis 0."""
    while f.shape[0] > 1:
        if f.shape[0] % 2:
            f = torch.cat([f, F.fp12_one((1,), f.device)], 0)
        h = f.shape[0] // 2
        f = F.fp12_mul(f[:h], f[h:])
    return f[0]


def strided_tree_product(f, tree: int = 128):
    """Product of a (N, …) batch of Fp12 elements along axis 0 in the
    order of `rlc_finish`: thread t of a `tree`-wide block multiplies
    terms t, t + tree, … and the block then folds position t + s into t
    for s = tree/2 … 1. Each value is canonical and the product
    commutative, so any order gives the same words; this one is the
    kernel's."""
    n = f.shape[0]
    chunks = max(1, -(-n // tree))
    pad = chunks * tree - n
    if pad:
        f = torch.cat([f, F.fp12_one((pad,), f.device)], 0)
    acc = F.fp12_one((tree,), f.device)
    for c in range(chunks):
        acc = F.fp12_mul(acc, f[c * tree:(c + 1) * tree])
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = F.fp12_mul(acc[:h], acc[h:])
    return acc[0]


def jacobian_to_homogeneous(P):
    """(X, Y, Z) Jacobian → (XZ, Y, Z³) homogeneous, Fp2."""
    Xj, Yj, Zj = P
    XZ, Z2 = mm2([Xj, Zj], [Zj, Zj])
    return XZ, Yj, F.fp2_mul(Z2, Zj)


def miller_loop_pairs_plain(rpk, msg, pair_inf):
    """rpk (M, 3, 12) Jacobian G1 words, msg (M, 2, 2, 12) affine G2 words
    (x, y), pair_inf (M,) → f (M, 2, 3, 2, 12) canonical Fp12 words."""
    P_jac = C.jac_from_words(rpk, 1)
    m = L.from_words(msg)
    Q = (m[..., 0, :, :], m[..., 1, :, :],
         F.fp2_one(pair_inf.shape, pair_inf.device))
    return L.to_words(miller_loop(P_jac, Q, pair_inf))


def miller_loop_pairs(rpk, msg, pair_inf):
    """One Miller loop per (rᵢ·apkᵢ, H(mᵢ)) pair. CUDA kernel
    `miller_loop_pairs` (csrc/pairing.cu) on CUDA tensors,
    `miller_loop_pairs_plain` on CPU tensors.

    Replaces grandine_tpu/tpu/pairing.py miller_loop inside the JAX verify
    programs (tpu/bls.py `_rlc_pairing_check`). One thread per pair.
    Bound: operations — 63 doubling and 5 addition steps, each an Fp12
    square and one or two Fp12 line products (~10,700 Fp products a pair)
    against 576 bytes out; at M = 192 pairs the card holds two warps per
    SM at most, so the kernel is latency-bound and its per-thread Fp12
    state spills to local memory (L1-resident). A later PR spreads one
    pair over a warp."""
    if rpk.device.type == "cpu":
        return miller_loop_pairs_plain(rpk, msg, pair_inf)
    from grandine_tpu_torch.gpu import _build

    m = rpk.shape[0]
    if rpk.shape != (m, 3, 12) or msg.shape != (m, 2, 2, 12) or \
            pair_inf.shape != (m,):
        raise ValueError("miller_loop_pairs: shape mismatch")
    f = torch.empty((m, 2, 3, 2, 12), dtype=torch.int32, device=rpk.device)
    _build.launch("miller_loop_pairs", rpk.contiguous(), msg.contiguous(),
                  pair_inf.contiguous(), f, ctypes.c_int(m))
    miller_loop_pairs.launches += 1
    return f


miller_loop_pairs.launches = 0
