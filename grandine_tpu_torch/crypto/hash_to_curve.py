"""Hash-to-curve for BLS12-381 G2 (and G1), following the RFC 9380 structure:

    hash_to_field (expand_message_xmd/SHA-256) → map_to_curve → clear_cofactor

G2 implements the canonical Ethereum suite BLS12381G2_XMD:SHA-256_SSWU_RO_
exactly: simplified SWU on the 3-isogenous curve E' (RFC 9380 §6.6.3,
constants §8.8.2 / Appendix E.3) followed by the published 3-isogeny back to
E and h_eff cofactor clearing. Known-answer conformance vectors:
tests/test_rfc9380_vectors.py (Appendix J.10.1 / K.1).

G1 keeps the derivable Shallue–van de Woestijne map (§6.6.1): the min_pk
ciphersuite never hashes to G1 (messages → G2, keys live unhashed in G1),
so G1 hashing is internal-only; the 11-isogeny SSWU tables can be slotted
in later without touching callers.

Reference equivalent: blst's hash-to-G2 invoked by `SecretKey::sign`
(bls/src/secret_key.rs:82-86) and by all verify paths.
"""

from __future__ import annotations

import hashlib
from typing import Union

from grandine_tpu_torch.crypto import constants
from grandine_tpu_torch.crypto.curves import B1, B2, Point, clear_cofactor_g1, clear_cofactor_g2
from grandine_tpu_torch.crypto.fields import Fq, Fq2

_B_IN_BYTES = 32  # SHA-256 output size
_R_IN_BYTES = 64  # SHA-256 block size
_L = 64  # ceil((381 + 128) / 8)


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd parameter out of range")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * _R_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    msg_prime = z_pad + msg + l_i_b_str + b"\x00" + dst_prime
    b0 = hashlib.sha256(msg_prime).digest()
    b = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    uniform = b
    prev = b
    for i in range(2, ell + 1):
        prev = hashlib.sha256(
            bytes(x ^ y for x, y in zip(b0, prev)) + i.to_bytes(1, "big") + dst_prime
        ).digest()
        uniform += prev
    return uniform[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, dst: bytes, count: int) -> "list[Fq2]":
    """RFC 9380 §5.2 hash_to_field with m=2, L=64."""
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        comps = []
        for j in range(2):
            off = _L * (j + i * 2)
            comps.append(int.from_bytes(uniform[off : off + _L], "big") % constants.P)
        out.append(Fq2.from_ints(*comps))
    return out


def hash_to_field_fq(msg: bytes, dst: bytes, count: int) -> "list[Fq]":
    len_in_bytes = count * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    return [
        Fq(int.from_bytes(uniform[_L * i : _L * (i + 1)], "big")) for i in range(count)
    ]


FieldElem = Union[Fq, Fq2]


class _SvdwConstants:
    """Derived SvdW constants for a curve y² = x³ + b (a = 0)."""

    def __init__(self, b: FieldElem, z: FieldElem) -> None:
        one = b.__class__.one()
        self.b = b
        self.z = z
        g = lambda x: x.square() * x + b  # noqa: E731
        gz = g(z)
        three_z2 = z.square() + z.square() + z.square()
        assert not gz.is_zero() and not three_z2.is_zero()
        self.c1 = gz
        half = Fq((constants.P + 1) // 2)
        if isinstance(z, Fq2):
            self.c2 = -z.scale(half)
        else:
            self.c2 = -(z * half)
        c3 = (-(gz * three_z2)).sqrt()
        assert c3 is not None, "SvdW Z admissibility: -g(Z)(3Z²) must be square"
        if c3.sgn0() == 1:
            c3 = -c3
        self.c3 = c3
        four = one + one + one + one
        self.c4 = -(four * gz) * three_z2.inv()
        # admissibility condition (iv)
        assert g(self.c2).is_square() or gz.is_square()


_SVDW_G1 = _SvdwConstants(B1, Fq(constants.SVDW_Z_G1))


def _cmov(a: FieldElem, b: FieldElem, c: bool) -> FieldElem:
    return b if c else a


def _map_to_curve_svdw(u: FieldElem, k: _SvdwConstants) -> "tuple[FieldElem, FieldElem]":
    """RFC 9380 SvdW straight-line program (a = 0 curves)."""
    one = u.__class__.one()
    g = lambda x: x.square() * x + k.b  # noqa: E731

    tv1 = u.square() * k.c1
    tv2 = one + tv1
    tv1 = one - tv1
    tv3 = tv1 * tv2
    tv3 = tv3.inv() if not tv3.is_zero() else tv3  # inv0
    tv4 = u * tv1 * tv3 * k.c3
    x1 = k.c2 - tv4
    gx1 = g(x1)
    e1 = gx1.is_square()
    x2 = k.c2 + tv4
    gx2 = g(x2)
    e2 = gx2.is_square() and not e1
    x3 = tv2.square() * tv3
    x3 = x3.square() * k.c4 + k.z
    x = _cmov(x3, x1, e1)
    x = _cmov(x, x2, e2)
    gx = g(x)
    y = gx.sqrt()
    assert y is not None  # guaranteed by construction
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


# --- G2: simplified SWU on E' + 3-isogeny (RFC 9380 §6.6.2/§6.6.3) --------

_SSWU_A = Fq2.from_ints(*constants.SSWU_A_G2)
_SSWU_B = Fq2.from_ints(*constants.SSWU_B_G2)
_SSWU_Z = Fq2.from_ints(*constants.SSWU_Z_G2)
_ISO3_K1 = tuple(Fq2.from_ints(*k) for k in constants.ISO3_K1)
_ISO3_K2 = tuple(Fq2.from_ints(*k) for k in constants.ISO3_K2)
_ISO3_K3 = tuple(Fq2.from_ints(*k) for k in constants.ISO3_K3)
_ISO3_K4 = tuple(Fq2.from_ints(*k) for k in constants.ISO3_K4)


def _map_to_curve_sswu_g2(u: Fq2) -> "tuple[Fq2, Fq2]":
    """RFC 9380 §6.6.2 simplified SWU onto E': y² = x³ + A'x + B'."""
    a, b, z = _SSWU_A, _SSWU_B, _SSWU_Z
    u2 = u.square()
    tv1 = z * u2
    tv2 = tv1.square() + tv1
    x1_num = b * (tv2 + Fq2.one())
    if tv2.is_zero():
        x1_den = a * z
    else:
        x1_den = -(a * tv2)
    # g(x) = x³ + a·x + b evaluated as fraction num/den³ to avoid inversions
    # is overkill for the anchor: invert directly (anchor favors clarity).
    x1 = x1_num * x1_den.inv()
    gx1 = x1.square() * x1 + a * x1 + b
    y = gx1.sqrt()
    if y is not None:
        x = x1
    else:
        x2 = tv1 * x1
        gx2 = x2.square() * x2 + a * x2 + b
        x, y = x2, gx2.sqrt()
    assert y is not None
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


def _horner(coeffs: "tuple[Fq2, ...]", x: Fq2) -> Fq2:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def _iso3_map(x: Fq2, y: Fq2) -> "tuple[Fq2, Fq2] | None":
    """The published 3-isogeny E' → E (RFC 9380 Appendix E.3).

    Returns None for inputs in the isogeny kernel (x_den/y_den = 0), which
    map to the identity — unreachable via hash_to_g2 (it would require
    inverting SHA-256) but map_to_curve_g2 accepts arbitrary field elements.
    """
    x_den = _horner(_ISO3_K2 + (Fq2.one(),), x)
    y_den = _horner(_ISO3_K4 + (Fq2.one(),), x)
    if x_den.is_zero() or y_den.is_zero():
        return None
    x_num = _horner(_ISO3_K1, x)
    y_num = _horner(_ISO3_K3, x)
    return x_num * x_den.inv(), y * y_num * y_den.inv()


def map_to_curve_g2(u: Fq2) -> Point[Fq2]:
    """SSWU + 3-isogeny — the BLS12381G2_XMD:SHA-256_SSWU_RO_ map."""
    xp, yp = _map_to_curve_sswu_g2(u)
    image = _iso3_map(xp, yp)
    if image is None:
        return Point.infinity(B2)
    x, y = image
    return Point.from_affine(x, y, B2)


def map_to_curve_g1(u: Fq) -> Point[Fq]:
    x, y = _map_to_curve_svdw(u, _SVDW_G1)
    return Point.from_affine(x, y, B1)


def hash_to_g2(msg: bytes, dst: bytes = constants.DST_SIGNATURE) -> Point[Fq2]:
    """hash_to_curve for G2 (random-oracle construction: two maps + add)."""
    u0, u1 = hash_to_field_fq2(msg, dst, 2)
    q = map_to_curve_g2(u0) + map_to_curve_g2(u1)
    return clear_cofactor_g2(q)


def hash_to_g1(msg: bytes, dst: bytes) -> Point[Fq]:
    u0, u1 = hash_to_field_fq(msg, dst, 2)
    q = map_to_curve_g1(u0) + map_to_curve_g1(u1)
    return clear_cofactor_g1(q)
