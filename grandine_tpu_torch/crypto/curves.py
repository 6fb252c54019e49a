"""BLS12-381 curve groups G1 (E/Fp: y²=x³+4) and G2 (E'/Fp2: y²=x³+4(1+u)).

Jacobian-coordinate point arithmetic generic over the coordinate field
(Fq for G1, Fq2 for G2), plus subgroup checks and cofactor clearing.

Reference equivalents: blst's G1/G2 ops wrapped by `bls/src/public_key.rs`
(aggregation :35-55, subgroup validate :21-27) and `bls/src/secret_key.rs:82-86`
(signing = G2 scalar-mul). The batched versions live in
grandine_tpu_torch/gpu/curve.py and csrc/bls12_381.cuh.
"""

from __future__ import annotations

from typing import Generic, TypeVar

from grandine_tpu_torch.crypto import constants
from grandine_tpu_torch.crypto.fields import Fq, Fq2

F = TypeVar("F", Fq, Fq2)


class Point(Generic[F]):
    """Jacobian point (X, Y, Z): affine (X/Z², Y/Z³); Z=0 ⇒ infinity.

    `b` is the curve coefficient (y² = x³ + b); carried on the point so G1
    and G2 share one implementation.
    """

    __slots__ = ("x", "y", "z", "b")

    def __init__(self, x: F, y: F, z: F, b: F) -> None:
        self.x = x
        self.y = y
        self.z = z
        self.b = b

    # -- constructors ------------------------------------------------------
    @staticmethod
    def infinity(b: F) -> "Point[F]":
        one = b.__class__.one()
        return Point(one, one, b.__class__.zero(), b)

    @staticmethod
    def from_affine(x: F, y: F, b: F) -> "Point[F]":
        return Point(x, y, b.__class__.one(), b)

    # -- predicates --------------------------------------------------------
    def is_infinity(self) -> bool:
        return self.z.is_zero()

    def is_on_curve(self) -> bool:
        """Jacobian curve equation: Y² = X³ + b·Z⁶."""
        if self.is_infinity():
            return True
        z2 = self.z.square()
        z6 = z2.square() * z2
        return self.y.square() == self.x.square() * self.x + self.b * z6

    # -- affine view -------------------------------------------------------
    def to_affine(self) -> "tuple[F, F] | None":
        if self.is_infinity():
            return None
        zinv = self.z.inv()
        zinv2 = zinv.square()
        return (self.x * zinv2, self.y * zinv2 * zinv)

    # -- group law ---------------------------------------------------------
    def double(self) -> "Point[F]":
        if self.is_infinity() or self.y.is_zero():
            return Point.infinity(self.b)
        x, y, z = self.x, self.y, self.z
        a = x.square()
        bq = y.square()
        c = bq.square()
        t = (x + bq).square() - a - c
        d = t + t  # 4·x·y²
        e = a + a + a  # 3x²  (curve a-coefficient is 0)
        f = e.square()
        x3 = f - d - d
        eight_c = c + c
        eight_c = eight_c + eight_c
        eight_c = eight_c + eight_c
        y3 = e * (d - x3) - eight_c
        z3 = (y * z) + (y * z)
        return Point(x3, y3, z3, self.b)

    def __add__(self, o: "Point[F]") -> "Point[F]":
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        z1z1 = self.z.square()
        z2z2 = o.z.square()
        u1 = self.x * z2z2
        u2 = o.x * z1z1
        s1 = self.y * o.z * z2z2
        s2 = o.y * self.z * z1z1
        if u1 == u2:
            if s1 == s2:
                return self.double()
            return Point.infinity(self.b)
        h = u2 - u1
        i = (h + h).square()
        j = h * i
        rr = (s2 - s1) + (s2 - s1)
        v = u1 * i
        x3 = rr.square() - j - v - v
        y3 = rr * (v - x3) - (s1 * j) - (s1 * j)
        z3 = ((self.z + o.z).square() - z1z1 - z2z2) * h
        return Point(x3, y3, z3, self.b)

    def __neg__(self) -> "Point[F]":
        return Point(self.x, -self.y, self.z, self.b)

    def __sub__(self, o: "Point[F]") -> "Point[F]":
        return self + (-o)

    def mul(self, k: int) -> "Point[F]":
        """Scalar multiplication (double-and-add; variable-time — fine for
        verification of public data; see SURVEY.md §7 on signing side-channels)."""
        if k < 0:
            return (-self).mul(-k)
        result = Point.infinity(self.b)
        base = self
        while k:
            if k & 1:
                result = result + base
            base = base.double()
            k >>= 1
        return result

    # -- subgroup ----------------------------------------------------------
    def in_subgroup(self) -> bool:
        """r-torsion membership via the endomorphism criteria (G1: GLV φ,
        G2: twist-ψ — Bowe, "Faster subgroup checks for BLS12-381", the
        checks blst ships): a 64/127-bit ladder + one endomorphism
        instead of a 255-bit ladder. `in_subgroup_slow` keeps the
        scalar-mul anchor for differential tests."""
        if isinstance(self.x, Fq2):
            return _g2_in_subgroup_fast(self)
        return _g1_in_subgroup_fast(self)

    def in_subgroup_slow(self) -> bool:
        return self.mul(constants.R).is_infinity()

    def __eq__(self, o: object) -> bool:
        if not isinstance(o, Point):
            return NotImplemented
        if self.is_infinity() or o.is_infinity():
            return self.is_infinity() and o.is_infinity()
        z1z1 = self.z.square()
        z2z2 = o.z.square()
        return (
            self.x * z2z2 == o.x * z1z1
            and self.y * o.z * z2z2 == o.y * self.z * z1z1
        )

    def __repr__(self) -> str:
        aff = self.to_affine()
        return f"Point({aff!r})"


# --- canonical generators and curve parameters -----------------------------

B1 = Fq(constants.B_G1)
B2 = Fq2.from_ints(*constants.B_G2)

G1 = Point.from_affine(Fq(constants.G1_X), Fq(constants.G1_Y), B1)
G2 = Point.from_affine(
    Fq2.from_ints(*constants.G2_X), Fq2.from_ints(*constants.G2_Y), B2
)


def g1_infinity() -> Point[Fq]:
    return Point.infinity(B1)


def g2_infinity() -> Point[Fq2]:
    return Point.infinity(B2)


def clear_cofactor_g1(p: Point[Fq]) -> Point[Fq]:
    return p.mul(constants.H1)


def clear_cofactor_g2(p: Point[Fq2]) -> Point[Fq2]:
    """h_eff·P per RFC 9380 §8.8.2 — NOT the full twist cofactor h2.

    Computed via the Budroni–Pintore ψ-endomorphism identity
        h_eff·P = [x²−x−1]·P + [x−1]·ψ(P) + ψ²([2]P)
    (two 64-bit scalar ladders + three ψ applications instead of one
    636-bit ladder — ~5× fewer point ops; this is also how blst clears
    the cofactor). Falls back to the literal h_eff scalar-mul if the ψ
    constants fail their self-check. The RFC 9380 official-vector tests
    pin the result either way."""
    psi = _psi_map()
    if psi is None:  # pragma: no cover — derivation self-check failed
        return p.mul(constants.H_EFF_G2)
    ax = -constants.X  # the BLS parameter is negative

    def mul_x(q: "Point[Fq2]") -> "Point[Fq2]":
        return -(q.mul(ax))  # [x]·q

    t1 = mul_x(p)
    psi_p = psi(p)
    t0 = psi(psi(p.double()))  # ψ²([2]P)
    t2 = mul_x(t1 + psi_p)  # [x²]P + [x]ψ(P)
    return t0 + t2 - t1 - psi_p - p


def _g1_in_subgroup_fast(p: "Point[Fq]") -> bool:
    """P ∈ G1 iff φ(P) == [x²]·P (φ = the cube-root GLV endomorphism,
    which acts as [λ] = [x² mod r] exactly on the r-subgroup)."""
    if p.is_infinity():
        return True
    bx, by = endo_constants()["g1"]
    aff = p.to_affine()
    phi = Point.from_affine(Fq(bx) * aff[0], Fq(by) * aff[1], p.b)
    return phi == p.mul(constants.X * constants.X)


def _g2_in_subgroup_fast(p: "Point[Fq2]") -> bool:
    """P ∈ G2 iff ψ(P) == [x]·P (ψ acts as [t−1] = [x] on the subgroup)."""
    if p.is_infinity():
        return True
    psi = _psi_map()
    if psi is None:  # pragma: no cover — derivation self-check failed
        return p.in_subgroup_slow()
    return psi(p) == -(p.mul(-constants.X))


# ψ = untwist–Frobenius–twist on E'/Fp2: ψ(x, y) = (c_x·x̄, c_y·ȳ) with
# x̄ the Fp2 conjugate. The constants are powers of (1+u); the exact
# power/inverse/sign choice is selected numerically by the Frobenius
# characteristic equation ψ² − [t]ψ + [p] = 0 (t = x+1) on the subgroup.
_PSI = None


def _fq2_pow(base: Fq2, e: int) -> Fq2:
    out = Fq2.from_ints(1, 0)
    while e:
        if e & 1:
            out = out * base
        base = base.square()
        e >>= 1
    return out


def _psi_map():
    global _PSI
    if _PSI is not None:
        return _PSI if _PSI != "failed" else None
    from .constants import P, R, X

    one_plus_u = Fq2.from_ints(1, 1)
    cx0 = _fq2_pow(one_plus_u, (P - 1) // 3)
    cy0 = _fq2_pow(one_plus_u, (P - 1) // 2)

    def conj(v: Fq2) -> Fq2:
        return Fq2(v.c0, -v.c1)

    def make_psi(cx: Fq2, cy: Fq2):
        def psi(pt: "Point[Fq2]") -> "Point[Fq2]":
            aff = pt.to_affine()
            if aff is None:
                return pt
            return Point.from_affine(
                cx * conj(aff[0]), cy * conj(aff[1]), pt.b
            )

        return psi

    for cx in (cx0, cx0.inv()):
        for cy in (cy0, cy0.inv(), -cy0, -(cy0.inv())):
            psi = make_psi(cx, cy)
            q = G2
            lhs = psi(psi(q)) + q.mul(P % R)
            rhs = psi(q).mul((X + 1) % R)
            if (
                lhs.is_on_curve()
                and lhs.to_affine() == rhs.to_affine()
            ):
                _PSI = psi
                global _PSI_CONSTS
                _PSI_CONSTS = (cx, cy)
                return psi
    _PSI = "failed"
    return None


_PSI_CONSTS: "tuple[Fq2, Fq2] | None" = None


def psi_constants_ints() -> "tuple[tuple[int, int], tuple[int, int]]":
    """The verified ψ coordinate-scaling constants as raw ints
    ((cx0, cx1), (cy0, cy1)) — consumed by the device subgroup-check
    kernel (gpu/curve.py and csrc/ ψ check)."""
    if _psi_map() is None:
        raise RuntimeError("psi derivation failed")
    cx, cy = _PSI_CONSTS
    return ((cx.c0.n, cx.c1.n), (cy.c0.n, cy.c1.n))


# --- GLV / psi² endomorphism constants --------------------------------------
#
# Both curves admit a degree-1 endomorphism that acts on the prime-order
# subgroup as multiplication by LAMBDA = x² mod r (x = the BLS parameter):
#   - on G1 it is P = (px, py) ↦ (βᵢ·px, ±py) (a cube-root-of-unity twist of
#     the classic GLV map — x² ≡ −λ² mod r for the cube root λ = x²−1);
#   - on G2 it is ψ² (untwist-Frobenius-twist squared), which collapses to
#     coordinate-wise Fp scalings because the Fp2 Frobenius squared is the
#     identity.
# The concrete constants are derived numerically below and asserted against
# scalar multiplication, so there is no sign/root-choice ambiguity to trust.
# They power the half-length dual-scalar ladders in the device kernels
# (gpu/curve.py scalar_mul_glv, csrc/bls12_381.cuh) and the host-side 2D scalar
# decomposition (decompose_glv).

LAMBDA = (constants.X * constants.X) % constants.R


def _derive_endo() -> "dict[str, tuple[int, int]]":
    from .constants import P

    # the two primitive cube roots of unity in Fp
    c = pow(2, (P - 1) // 3, P)
    while pow(c, 3, P) != 1 or c == 1:
        c = pow(c + 1, (P - 1) // 3, P)
    roots = [c, pow(c, 2, P)]
    out: dict = {}
    lam_g1 = G1.mul(LAMBDA).to_affine()
    for bx in roots:
        for by in (1, P - 1):
            cand = (Fq(bx * G1.x.n % P), Fq(by * G1.y.n % P))
            if (cand[0], cand[1]) == lam_g1:
                out["g1"] = (bx, by)
    lam_g2 = G2.mul(LAMBDA).to_affine()
    for bx in roots:
        for by in (1, P - 1):
            cand = (G2.x.scale(Fq(bx)), G2.y.scale(Fq(by)))
            if (cand[0], cand[1]) == lam_g2:
                out["g2"] = (bx, by)
    assert set(out) == {"g1", "g2"}, "endomorphism derivation failed"
    return out


_ENDO: "dict[str, tuple[int, int]] | None" = None


def endo_constants() -> "dict[str, tuple[int, int]]":
    """{'g1': (βx, βy), 'g2': (ωx, ωy)} with (βx·px, βy·py) = [LAMBDA]·P."""
    global _ENDO
    if _ENDO is None:
        _ENDO = _derive_endo()
    return _ENDO


def decompose_glv(k: int) -> "tuple[int, int, int, int]":
    """k ≡ k0 + k1·LAMBDA (mod r) with |k0|, |k1| < 2¹²⁹ (Babai rounding).

    LAMBDA = x² is a primitive SIXTH root of unity mod r (λ² − λ + 1 =
    x⁴ − x² + 1 = r exactly), so the lattice {(a, b) : a + b·λ ≡ 0 (mod r)}
    has the short basis v1 = (λ, −1), v2 = (1, λ − 1) with determinant
    exactly r. Returns (|k0|, sign0, |k1|, sign1) with signs ±1."""
    from .constants import R

    lam = LAMBDA

    def rnd(num: int, den: int) -> int:  # round-half-up, exact integers
        return (2 * num + den) // (2 * den)

    c1 = rnd(k * (lam - 1), R)
    c2 = rnd(k, R)
    k0 = k - c1 * lam - c2
    k1 = c1 - c2 * (lam - 1)
    assert (k0 + k1 * LAMBDA - k) % R == 0
    assert max(abs(k0), abs(k1)).bit_length() <= 129
    return (abs(k0), 1 if k0 >= 0 else -1, abs(k1), 1 if k1 >= 0 else -1)
