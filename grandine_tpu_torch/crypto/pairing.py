"""Optimal ate pairing on BLS12-381 (pure-Python anchor).

e(P, Q) for P ∈ G1 ⊂ E(Fp), Q ∈ G2 ⊂ E'(Fp2): Q is untwisted into E(Fp12)
(D-twist: divide by w², w³) and the Miller loop runs in affine Fp12
coordinates — deliberately the clearest correct formulation rather than the
fastest; this file anchors the device pairing in grandine_tpu_torch/gpu/pairing.py.

The product structure mirrors the reference's batch verification: N Miller
loops, one shared final exponentiation (`multi_pairing`), which is exactly
what `Signature::multi_verify` exploits (reference: bls/src/signature.rs:96-129).
"""

from __future__ import annotations

from grandine_tpu_torch.crypto.constants import P, R, X
from grandine_tpu_torch.crypto.curves import Point
from grandine_tpu_torch.crypto.fields import Fq, Fq2, Fq6, Fq12

# Φ₁₂(p) = p⁴ - p² + 1 is divisible by r for BLS curves.
assert (P**4 - P**2 + 1) % R == 0
HARD_EXPONENT = (P**4 - P**2 + 1) // R

# Miller loop runs over |x|; x < 0 is handled by conjugating the result.
MILLER_BITS = bin(abs(X))[3:]  # bits below the MSB, msb-first

# w ∈ Fq12 with w² = v, w⁶ = ξ. Untwist divides by w², w³.
_W2 = Fq12(Fq6(Fq2.zero(), Fq2.one(), Fq2.zero()), Fq6.zero())  # = v
_W3 = Fq12(Fq6.zero(), Fq6(Fq2.zero(), Fq2.one(), Fq2.zero()))  # = v·w
_W2_INV = _W2.inv()
_W3_INV = _W3.inv()


def _embed_fq2(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


def _embed_fq(a: Fq) -> Fq12:
    return _embed_fq2(Fq2(a, Fq.zero()))


def untwist(q: Point[Fq2]) -> "tuple[Fq12, Fq12]":
    """Map an affine G2 point on the twist to affine coordinates on E(Fp12)."""
    aff = q.to_affine()
    assert aff is not None
    x, y = aff
    return (_embed_fq2(x) * _W2_INV, _embed_fq2(y) * _W3_INV)


def miller_loop(p: Point[Fq], q: Point[Fq2]) -> Fq12:
    """f_{|x|,Q}(P), conjugated for the negative BLS parameter.

    Returns 1 when either input is the identity (so products over batches
    treat infinity pairs as neutral, matching aggregate semantics).
    """
    if p.is_infinity() or q.is_infinity():
        return Fq12.one()
    p_aff = p.to_affine()
    assert p_aff is not None
    xp, yp = _embed_fq(p_aff[0]), _embed_fq(p_aff[1])
    xq, yq = untwist(q)

    f = Fq12.one()
    xt, yt = xq, yq
    for bit in MILLER_BITS:
        # Doubling step: line through (T, T) evaluated at P.
        lam = (xt.square() + xt.square() + xt.square()) * (yt + yt).inv()
        line = yp - yt - lam * (xp - xt)
        f = f.square() * line
        x2 = lam.square() - xt - xt
        yt = lam * (xt - x2) - yt
        xt = x2
        if bit == "1":
            # Addition step: line through (T, Q) evaluated at P.
            lam = (yq - yt) * (xq - xt).inv()
            line = yp - yt - lam * (xp - xt)
            f = f * line
            x2 = lam.square() - xt - xq
            yt = lam * (xt - x2) - yt
            xt = x2
    # x < 0: f_{x,Q} = conjugate(f_{|x|,Q})  (inverse on the unit cyclotomic
    # subgroup up to final exponentiation).
    return f.conjugate()


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p¹²-1)/r) via the easy part (Frobenius) and plain-pow hard part."""
    t = f.conjugate() * f.inv()  # f^(p⁶-1)
    t = t.frobenius_n(2) * t  # ^(p²+1)
    return t.pow(HARD_EXPONENT)  # ^((p⁴-p²+1)/r)


def pairing(p: Point[Fq], q: Point[Fq2]) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs: "list[tuple[Point[Fq], Point[Fq2]]]") -> Fq12:
    """∏ e(Pᵢ, Qᵢ) with one shared final exponentiation — the algebraic core
    of batch signature verification."""
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)


def pairing_check(pairs: "list[tuple[Point[Fq], Point[Fq2]]]") -> bool:
    """True iff ∏ e(Pᵢ, Qᵢ) == 1."""
    return multi_pairing(pairs).is_one()
