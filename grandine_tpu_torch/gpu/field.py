"""The Fp2/Fp6/Fp12 tower on torch tensors (plain versions).

Working layout (Montgomery limbs, see limbs.py): Fp2 ``(…, 2, 24)`` as
(c0, c1) with u² = −1; Fp6 ``(…, 3, 2, 24)`` over v³ = ξ = 1 + u; Fp12
``(…, 2, 3, 2, 24)`` over w² = v — the tower of crypto/fields.py and of
the CUDA header csrc/bls12_381.cuh. Every product of one tower operation
is stacked into ONE Montgomery-product call (an Fp12 product is one call
of 54 Fp products), so the op count stays flat whatever the batch.

Counterpart of grandine_tpu/tpu/field.py; ported here: the tower, its
Frobenius maps, conjugation, inversion and the batched square roots
(`fq_sqrt`, `fq2_sqrt`, which follow the JAX package's algorithm so the
same root comes back).
"""

from __future__ import annotations

import torch

from grandine_tpu_torch.crypto.fields import frobenius_coefficients
from grandine_tpu_torch.gpu import limbs as L

P = L.P


def _c(a, i):
    return a.select(-2, i)


def _stk(parts):
    return torch.stack(parts, dim=-2)


# --- Fp2 -------------------------------------------------------------------

add = L.add_mod  # componentwise on any tower level
sub = L.sub_mod
neg = L.neg_mod


def fp2_mul(a, b):
    """Karatsuba: 3 Fp products in one call."""
    a0, a1, b0, b1 = _c(a, 0), _c(a, 1), _c(b, 0), _c(b, 1)
    t = L.montmul(_stk([a0, a1, L.add_mod(a0, a1)]),
                  _stk([b0, b1, L.add_mod(b0, b1)]))
    t0, t1, t2 = _c(t, 0), _c(t, 1), _c(t, 2)
    return _stk([L.sub_mod(t0, t1), L.sub_mod(t2, L.add_mod(t0, t1))])


def fp2_sq(a):
    return fp2_mul(a, a)


def fp2_mul_fp(a, k):
    """Fp2 × Fp scalar (k of shape (…, 24))."""
    return L.montmul(a, k.unsqueeze(-2))


def fp2_conj(a):
    return _stk([_c(a, 0), L.neg_mod(_c(a, 1))])


def fp2_mul_by_xi(a):
    a0, a1 = _c(a, 0), _c(a, 1)
    return _stk([L.sub_mod(a0, a1), L.add_mod(a0, a1)])


def fp2_inv(a):
    a0, a1 = _c(a, 0), _c(a, 1)
    sq = L.montmul(_stk([a0, a1]), _stk([a0, a1]))
    ninv = L.inv_mod(L.add_mod(_c(sq, 0), _c(sq, 1)))
    return _stk([L.montmul(a0, ninv), L.neg_mod(L.montmul(a1, ninv))])


def fp2_is_zero(a):
    return L.is_zero(a).all(-1)


def fp2_const(c0: int, c1: int, shape=(), device="cpu"):
    return _stk([L.const_fp(c0, shape, device), L.const_fp(c1, shape, device)])


def fp2_one(shape=(), device="cpu"):
    return fp2_const(1, 0, shape, device)


# --- Fp6 -------------------------------------------------------------------


def _c6(a, i):
    return a.select(-3, i)


def _stk6(parts):
    return torch.stack(parts, dim=-3)


def fp6_mul(a, b):
    """Karatsuba-style: 6 Fp2 products in one call (crypto/fields.py Fq6)."""
    a0, a1, a2 = _c6(a, 0), _c6(a, 1), _c6(a, 2)
    b0, b1, b2 = _c6(b, 0), _c6(b, 1), _c6(b, 2)
    t = fp2_mul(
        _stk6([a0, a1, a2, add(a1, a2), add(a0, a1), add(a0, a2)]),
        _stk6([b0, b1, b2, add(b1, b2), add(b0, b1), add(b0, b2)]),
    )
    t0, t1, t2, t12, t01, t02 = (_c6(t, i) for i in range(6))
    c0 = add(t0, fp2_mul_by_xi(sub(t12, add(t1, t2))))
    c1 = add(sub(t01, add(t0, t1)), fp2_mul_by_xi(t2))
    c2 = add(sub(t02, add(t0, t2)), t1)
    return _stk6([c0, c1, c2])


def fp6_mul_by_v(a):
    return _stk6([fp2_mul_by_xi(_c6(a, 2)), _c6(a, 0), _c6(a, 1)])


def fp6_inv(a):
    a0, a1, a2 = _c6(a, 0), _c6(a, 1), _c6(a, 2)
    s = fp2_mul(_stk6([a0, a1, a2, a1, a0, a0]),
                _stk6([a0, a1, a2, a2, a1, a2]))
    a00, a11, a22, a12, a01, a02 = (_c6(s, i) for i in range(6))
    A = sub(a00, fp2_mul_by_xi(a12))
    B = sub(fp2_mul_by_xi(a22), a01)
    C = sub(a11, a02)
    t = fp2_mul(_stk6([a0, a2, a1]), _stk6([A, B, C]))
    Fv = add(_c6(t, 0), fp2_mul_by_xi(add(_c6(t, 1), _c6(t, 2))))
    finv = fp2_inv(Fv)
    return fp2_mul(_stk6([A, B, C]), finv.unsqueeze(-3))


# --- Fp12 ------------------------------------------------------------------


def _c12(a, i):
    return a.select(-4, i)


def _stk12(parts):
    return torch.stack(parts, dim=-4)


def fp12_mul(a, b):
    """Karatsuba over Fp6: 18 Fp2 products (54 Fp products) in one call."""
    a0, a1, b0, b1 = _c12(a, 0), _c12(a, 1), _c12(b, 0), _c12(b, 1)
    t = fp6_mul(torch.stack([a0, a1, add(a0, a1)], dim=-4),
                torch.stack([b0, b1, add(b0, b1)], dim=-4))
    t0, t1, t2 = _c12(t, 0), _c12(t, 1), _c12(t, 2)
    return _stk12([add(t0, fp6_mul_by_v(t1)), sub(t2, add(t0, t1))])


def fp12_sq(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    return _stk12([_c12(a, 0), L.neg_mod(_c12(a, 1))])


def fp12_inv(a):
    a0, a1 = _c12(a, 0), _c12(a, 1)
    s = fp6_mul(torch.stack([a0, a1], dim=-4), torch.stack([a0, a1], dim=-4))
    d = fp6_inv(sub(_c12(s, 0), fp6_mul_by_v(_c12(s, 1))))
    t = fp6_mul(torch.stack([a0, a1], dim=-4), d.unsqueeze(-4))
    return _stk12([_c12(t, 0), L.neg_mod(_c12(t, 1))])


def fp12_one(shape=(), device="cpu"):
    out = torch.zeros(*shape, 2, 3, 2, L.NLIMBS, dtype=torch.int64,
                      device=device)
    out[..., 0, 0, 0, :] = L.const_fp(1, (), device)
    return out


def fp12_is_one(a):
    one = fp12_one((), a.device)
    return (a == one).flatten(-4).all(-1)


_FROB = frobenius_coefficients()


def fp6_frobenius(a):
    g1 = fp2_const(*_FROB["fq6_g1"], device=a.device)
    g2 = fp2_const(*_FROB["fq6_g2"], device=a.device)
    c = fp2_conj(a)
    t = fp2_mul(_stk6([_c6(c, 1), _c6(c, 2)]), _stk6([g1, g2]))
    return _stk6([_c6(c, 0), _c6(t, 0), _c6(t, 1)])


def fp12_frobenius(a):
    gw = fp2_const(*_FROB["fq12_gw"], device=a.device)
    f = fp6_frobenius(a)  # both halves at once
    return _stk12([_c12(f, 0), fp2_mul(_c12(f, 1), gw)])


def fp12_frobenius_n(a, n: int):
    for _ in range(n % 12):
        a = fp12_frobenius(a)
    return a


# --- square roots (decompression) -------------------------------------------

def fq_sqrt(a):
    """(root, ok): root = a^((p+1)/4) (p ≡ 3 mod 4), ok ⇔ root² = a."""
    s = L.pow_fixed(a, (P + 1) // 4)
    return s, L.eq(L.montsq(s), a)


def fq2_sqrt(a):
    """((…, 2, 24) root, ok) — the JAX package's norm/half algorithm
    (grandine_tpu/tpu/field.py fq2_sqrt, crypto/fields.py Fq2.sqrt) with
    every branch computed and selected, so the same root comes back."""
    ca, cb = _c(a, 0), _c(a, 1)
    half = L.const_fp((P + 1) // 2, ca.shape[:-1], ca.device)
    sq = L.montmul(_stk([ca, cb]), _stk([ca, cb]))
    norm = L.add_mod(_c(sq, 0), _c(sq, 1))
    r1 = _stk([ca, L.neg_mod(ca), norm])
    s1, ok1 = fq_sqrt(r1)
    sa, sna, sn = _c(s1, 0), _c(s1, 1), _c(s1, 2)
    ok_a, ok_n = ok1[..., 0], ok1[..., 2]
    ok_na = ok1[..., 1]
    t2 = L.montmul(_stk([L.add_mod(ca, sn), L.sub_mod(ca, sn)]),
                   half.unsqueeze(-2))
    s2, ok2 = fq_sqrt(t2)
    ok2 = ok2 & ~L.is_zero(s2)
    inv2t = L.inv_mod(L.double_mod(s2))
    c1_both = L.montmul(_stk([cb, cb]), inv2t)
    sq = L.montmul(torch.cat([s2, c1_both, s2], -2),
                   torch.cat([s2, c1_both, c1_both], -2))
    sq0 = L.sub_mod(sq[..., 0:2, :], sq[..., 2:4, :])
    sq1 = L.double_mod(sq[..., 4:6, :])
    cand_ok = ok2 & L.eq(sq0, ca.unsqueeze(-2)) & L.eq(sq1, cb.unsqueeze(-2))
    use_pos = cand_ok[..., 0]
    gen_c0 = L.select(use_pos, _c(s2, 0), _c(s2, 1))
    gen_c1 = L.select(use_pos, _c(c1_both, 0), _c(c1_both, 1))
    gen_ok = ok_n & (cand_ok[..., 0] | cand_ok[..., 1])
    zero = torch.zeros_like(ca)
    emb_c0 = L.select(ok_a, sa, zero)
    emb_c1 = L.select(ok_a, zero, sna)
    emb_ok = ok_a | ok_na
    b_zero = L.is_zero(cb)
    c0 = L.select(b_zero, emb_c0, gen_c0)
    c1 = L.select(b_zero, emb_c1, gen_c1)
    return _stk([c0, c1]), torch.where(b_zero, emb_ok, gen_ok)
