"""Host Ed25519 (RFC 8032): the scalar twin of the batched device kernel
in gpu/ed25519.py, the port's own copy of grandine_tpu/crypto/ed25519.py.

Pure-Python exact integer arithmetic over curve25519 in twisted-Edwards
form (a = −1, extended coordinates). This is the bisection leaf and the
degradation target for the `ed25519` scheduler lane, so the ONE verify
semantics both sides must agree on bit-for-bit is fixed here:

  COFACTORED verification —  [8][S]B == [8]R + [8][k]A

(the batch-friendly equation from the RFC 8032 security notes; it is
the only per-signature rule CONSISTENT with random-linear-combination
batching, because the RLC sum is taken before the shared ×8 cofactor
clearing kills small-order components). Decode rules are strict RFC
8032: non-canonical y (≥ p) rejected, S ≥ L rejected (malleability),
x = 0 with sign bit set rejected. Signatures that differ between
cofactored and cofactorless verification (torsion in R or A) ACCEPT
here, matching the device batch — the RFC permits either rule; the
plane just has to pick one and be consistent everywhere.

Point helpers (decompress/add/mul/neg) are exported for the tests that
craft torsion-edge specimens.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P

# base point: y = 4/5, x recovered with even parity
_BY = (4 * pow(5, P - 2, P)) % P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
#: extended-coordinate points are (X, Y, Z, T) with x = X/Z, y = Y/Z,
#: T = XY/Z
BASE = (_BX, _BY, 1, (_BX * _BY) % P)
IDENTITY = (0, 1, 1, 0)
#: the order-2 torsion point (0, −1) — torsion-edge specimen material
ORDER2 = (0, P - 1, 1, 0)


def sha512(s: bytes) -> bytes:
    return hashlib.sha512(s).digest()


def point_add(p, q):
    """Unified add-2008-hwcd-3 (a = −1): complete — also the doubling."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * D % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = (b - a) % P, (d - c) % P, (d + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_neg(p):
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def point_mul(s: int, p):
    """[s]P, double-and-add (host scalar path — exactness over speed)."""
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        s >>= 1
    return q


def point_equal(p, q) -> bool:
    # x1/z1 == x2/z2  ∧  y1/z1 == y2/z2, cross-multiplied
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


def point_compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_decompress(b: bytes):
    """32 bytes → extended point, or None (strict RFC 8032 decode)."""
    if len(b) != 32:
        return None
    enc = int.from_bytes(b, "little")
    sign = enc >> 255
    y = enc & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def secret_expand(secret: bytes):
    """32-byte seed → (clamped scalar a, prefix) — RFC 8032 §5.1.5."""
    if len(secret) != 32:
        raise ValueError("ed25519 secret must be 32 bytes")
    h = sha512(secret)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def secret_to_public(secret: bytes) -> bytes:
    a, _ = secret_expand(secret)
    return point_compress(point_mul(a, BASE))


def sign(secret: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6 (test-vector + bench traffic generation)."""
    a, prefix = secret_expand(secret)
    pk = point_compress(point_mul(a, BASE))
    r = int.from_bytes(sha512(prefix + msg), "little") % L
    r_enc = point_compress(point_mul(r, BASE))
    k = int.from_bytes(sha512(r_enc + pk + msg), "little") % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")


def verify(public: bytes, msg: bytes, signature: bytes) -> bool:
    """Cofactored single verify: [8][S]B == [8]R + [8][k]A, evaluated as
    8·(S·B − R − k·A) == identity — one exact host evaluation of the
    same group equation the device batch takes an RLC over."""
    if len(signature) != 64:
        return False
    a_pt = point_decompress(bytes(public))
    if a_pt is None:
        return False
    r_pt = point_decompress(signature[:32])
    if r_pt is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:  # malleability bound (RFC 8032 §5.1.7 step 1)
        return False
    k = int.from_bytes(
        sha512(bytes(signature[:32]) + bytes(public) + bytes(msg)), "little"
    ) % L
    acc = point_mul(s, BASE)
    acc = point_add(acc, point_neg(r_pt))
    acc = point_add(acc, point_neg(point_mul(k, a_pt)))
    return point_equal(point_mul(8, acc), IDENTITY)


def check_item(item) -> bool:
    """VerifyItem adapter (ed25519 lane geometry: message bytes, 64-byte
    signature, public_keys = (32-byte key,)) — the scheduler's bisection
    leaf and host degradation pass."""
    keys = item.public_keys
    if keys is None or len(keys) != 1:
        return False
    return verify(bytes(keys[0]), item.message, item.signature)


__all__ = [
    "P", "L", "D", "BASE", "IDENTITY", "ORDER2",
    "point_add", "point_neg", "point_mul", "point_equal",
    "point_compress", "point_decompress",
    "secret_expand", "secret_to_public", "sign", "verify", "check_item",
]
