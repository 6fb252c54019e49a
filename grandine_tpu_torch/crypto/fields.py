"""BLS12-381 field tower: Fq, Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³-ξ),
Fq12 = Fq6[w]/(w²-v), with ξ = 1 + u.

Pure-Python arbitrary-precision reference implementation. This is the
correctness anchor for the limb-vectorized field arithmetic in
grandine_tpu_torch/gpu/ — every kernel is differentially tested against these
classes. (Reference equivalent: the Fp/Fp2/Fp12 arithmetic inside blst that
the reference's `bls` crate links; bls/src/signature.rs:3-7.)

Design notes:
  - Elements are immutable; operators return new objects.
  - Fq.sqrt uses p ≡ 3 (mod 4); Fq2.sqrt uses the norm/half trick.
  - Frobenius coefficients are computed once at import from ξ — not copied
    from tables — and are exported for the device backend via
    `frobenius_coefficients()`.
"""

from __future__ import annotations

from functools import lru_cache

from grandine_tpu_torch.crypto.constants import P


class Fq:
    """Base field element (mod P)."""

    __slots__ = ("n",)

    def __init__(self, n: int) -> None:
        self.n = n % P

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o: "Fq") -> "Fq":
        return Fq(self.n + o.n)

    def __sub__(self, o: "Fq") -> "Fq":
        return Fq(self.n - o.n)

    def __mul__(self, o: "Fq") -> "Fq":
        return Fq(self.n * o.n)

    def __neg__(self) -> "Fq":
        return Fq(-self.n)

    def square(self) -> "Fq":
        return Fq(self.n * self.n)

    def inv(self) -> "Fq":
        if self.n == 0:
            raise ZeroDivisionError("inverse of 0 in Fq")
        return Fq(pow(self.n, P - 2, P))

    def pow(self, e: int) -> "Fq":
        return Fq(pow(self.n, e, P))

    def conjugate(self) -> "Fq":
        return self

    def frobenius(self) -> "Fq":
        return self

    # -- predicates --------------------------------------------------------
    def is_zero(self) -> bool:
        return self.n == 0

    def is_square(self) -> bool:
        return self.n == 0 or pow(self.n, (P - 1) // 2, P) == 1

    def sqrt(self) -> "Fq | None":
        if self.n == 0:
            return Fq(0)
        s = pow(self.n, (P + 1) // 4, P)  # p ≡ 3 (mod 4)
        return Fq(s) if s * s % P == self.n else None

    def sgn0(self) -> int:
        return self.n & 1

    # -- misc --------------------------------------------------------------
    def __eq__(self, o: object) -> bool:
        return isinstance(o, Fq) and self.n == o.n

    def __hash__(self) -> int:
        return hash(("Fq", self.n))

    def __repr__(self) -> str:
        return f"Fq(0x{self.n:x})"

    @staticmethod
    def zero() -> "Fq":
        return Fq(0)

    @staticmethod
    def one() -> "Fq":
        return Fq(1)


class Fq2:
    """Fq2 = Fq[u] / (u² + 1); element c0 + c1·u."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq, c1: Fq) -> None:
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def from_ints(c0: int, c1: int) -> "Fq2":
        return Fq2(Fq(c0), Fq(c1))

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        return Fq2(a * c - b * d, a * d + b * c)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def square(self) -> "Fq2":
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), (a * b) + (a * b))

    def scale(self, k: Fq) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def inv(self) -> "Fq2":
        a, b = self.c0, self.c1
        norm_inv = (a * a + b * b).inv()
        return Fq2(a * norm_inv, -b * norm_inv)

    def pow(self, e: int) -> "Fq2":
        result, base = Fq2.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def frobenius(self) -> "Fq2":
        # x ↦ x^p is conjugation in Fq2.
        return self.conjugate()

    def mul_by_xi(self) -> "Fq2":
        """Multiply by ξ = 1 + u."""
        return Fq2(self.c0 - self.c1, self.c0 + self.c1)

    # -- predicates --------------------------------------------------------
    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def is_square(self) -> bool:
        # x^((q²-1)/2) = N(x)^((q-1)/2) for q = p, so x is a square in Fq2
        # iff its norm c0²+c1² is a quadratic residue in Fq.
        return (self.c0 * self.c0 + self.c1 * self.c1).is_square()

    def sqrt(self) -> "Fq2 | None":
        a, b = self.c0, self.c1
        if b.is_zero():
            s = a.sqrt()
            if s is not None:
                return Fq2(s, Fq.zero())
            s = (-a).sqrt()
            if s is not None:
                return Fq2(Fq.zero(), s)  # (s·u)² = -s² = a
            return None
        norm = a * a + b * b
        s = norm.sqrt()
        if s is None:
            return None
        half = _HALF
        for sign in (s, -s):
            t2 = (a + sign) * half
            t = t2.sqrt()
            if t is not None and not t.is_zero():
                cand = Fq2(t, b * (t + t).inv())
                if cand.square() == self:
                    return cand
        return None

    def sgn0(self) -> int:
        # RFC 9380 sgn0 for m=2.
        sign_0 = self.c0.n & 1
        zero_0 = self.c0.n == 0
        return sign_0 | (zero_0 & (self.c1.n & 1))

    # -- misc --------------------------------------------------------------
    def __eq__(self, o: object) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self) -> int:
        return hash(("Fq2", self.c0.n, self.c1.n))

    def __repr__(self) -> str:
        return f"Fq2(0x{self.c0.n:x}, 0x{self.c1.n:x})"

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(Fq.zero(), Fq.zero())

    @staticmethod
    def one() -> "Fq2":
        return Fq2(Fq.one(), Fq.zero())


#: 1/2 in Fq (used by Fq2.sqrt and the SvdW constants).
_HALF = Fq((P + 1) // 2)

#: ξ — the Fq6 non-residue (v³ = ξ).
XI = Fq2.from_ints(1, 1)


class Fq6:
    """Fq6 = Fq2[v] / (v³ - ξ); element c0 + c1·v + c2·v²."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2) -> None:
        self.c0 = c0
        self.c1 = c1
        self.c2 = c2

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_xi()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self) -> "Fq6":
        return self * self

    def scale2(self, k: Fq2) -> "Fq6":
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self) -> "Fq6":
        """Multiply by v (used by Fq12 multiplication)."""
        return Fq6(self.c2.mul_by_xi(), self.c0, self.c1)

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        A = a0.square() - (a1 * a2).mul_by_xi()
        B = a2.square().mul_by_xi() - a0 * a1
        C = a1.square() - a0 * a2
        F = a0 * A + (a2 * B + a1 * C).mul_by_xi()
        f_inv = F.inv()
        return Fq6(A * f_inv, B * f_inv, C * f_inv)

    def frobenius(self) -> "Fq6":
        g1, g2 = _FROB6_G1, _FROB6_G2
        return Fq6(
            self.c0.frobenius(),
            self.c1.frobenius() * g1,
            self.c2.frobenius() * g2,
        )

    # -- misc --------------------------------------------------------------
    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o: object) -> bool:
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __hash__(self) -> int:
        return hash(("Fq6", self.c0, self.c1, self.c2))

    def __repr__(self) -> str:
        return f"Fq6({self.c0!r}, {self.c1!r}, {self.c2!r})"

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())


class Fq12:
    """Fq12 = Fq6[w] / (w² - v); element c0 + c1·w."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6) -> None:
        self.c0 = c0
        self.c1 = c1

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        return self * self

    def inv(self) -> "Fq12":
        a0, a1 = self.c0, self.c1
        denom = (a0.square() - a1.square().mul_by_v()).inv()
        return Fq12(a0 * denom, -(a1 * denom))

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        result, base = Fq12.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def conjugate(self) -> "Fq12":
        """x ↦ x^(p⁶): negates the w-coefficient. For elements on the
        cyclotomic subgroup (unit norm) this is the inverse."""
        return Fq12(self.c0, -self.c1)

    def frobenius(self) -> "Fq12":
        gw = _FROB12_GW  # ξ^((p-1)/6) ∈ Fq2
        return Fq12(self.c0.frobenius(), self.c1.frobenius().scale2(gw))

    def frobenius_n(self, n: int) -> "Fq12":
        out = self
        for _ in range(n % 12):
            out = out.frobenius()
        return out

    # -- misc --------------------------------------------------------------
    def is_one(self) -> bool:
        return self == Fq12.one()

    def __eq__(self, o: object) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self) -> int:
        return hash(("Fq12", self.c0, self.c1))

    def __repr__(self) -> str:
        return f"Fq12({self.c0!r}, {self.c1!r})"

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())


# --- Frobenius coefficients (derived at import) ----------------------------

assert (P - 1) % 6 == 0
_FROB6_G1 = XI.pow((P - 1) // 3)
_FROB6_G2 = XI.pow(2 * (P - 1) // 3)
_FROB12_GW = XI.pow((P - 1) // 6)


@lru_cache(maxsize=None)
def frobenius_coefficients() -> dict:
    """Export the derived Frobenius coefficients (for the device backend).

    Returns integer pairs (c0, c1) for each Fq2 coefficient:
      fq6_g1 = ξ^((p-1)/3), fq6_g2 = ξ^(2(p-1)/3), fq12_gw = ξ^((p-1)/6)
    """
    return {
        "fq6_g1": (_FROB6_G1.c0.n, _FROB6_G1.c1.n),
        "fq6_g2": (_FROB6_G2.c0.n, _FROB6_G2.c1.n),
        "fq12_gw": (_FROB12_GW.c0.n, _FROB12_GW.c1.n),
    }


def batch_inverse(values, modulus):
    """Montgomery-trick batch inversion: ONE modular inverse for N values.
    Zeros map to zero (callers decide whether zero input is an error).
    Shared by the KZG Fr math and the host point-conversion paths."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v else 1) % modulus
    inv = pow(prefix[n], modulus - 2, modulus)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v:
            out[i] = prefix[i] * inv % modulus
            inv = inv * v % modulus
    return out
