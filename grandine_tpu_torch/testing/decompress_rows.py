"""G2 wire rows that reach `g2_decompress_subgroup`'s edges, shared by the
host harness (tests/test_torch_ladders.py), the card's tests
(tests/test_torch_cuda.py), the parity test against the JAX package
(tests/test_torch_curve.py) and chip_smoke.py. 96-byte rows (x1 first,
then x0, big-endian; flags in the top bits of byte 0) as a host numpy
array, with a name a row."""

from __future__ import annotations

import numpy as np

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, P
from grandine_tpu_torch.crypto.fields import Fq2
from grandine_tpu_torch.crypto.hash_to_curve import (
    hash_to_field_fq2, hash_to_g2, map_to_curve_g2)

#: x = (x0, x1) whose y² = x³ + 4(1 + u) has c1 = 0 (the decompression's
#: c1 = 0 branch): x0² = (x1³ − 4) / (3·x1) for seeded x1 (random.Random
#: (0xC10)); the first with c0 a square (√c0 is the root), the first with
#: −c0 a square (√−c0·u is)
C1_ZERO_X = tuple((int(x0, 16), int(x1, 16)) for x0, x1 in (
    ("172a2a4181edd891bd35dc1dd3118e62b1afd59e0d72e967"
     "dc6d86d2e93c7499ec417380421e63958d489826af01ac16",
     "19f6c4cff5548f7c0d92f6f884d744f3501a9159145e0a28"
     "ebccdfbfea22419f5a99a4c26617fd72a6c2eb4b4d686ae4"),
    ("1407dca290ef730b4dc95fe1503ab6e3fcb176f9273e7c35"
     "e3153daf6bb8cdb95b5403300057fd7e45f9136ac19830fd",
     "0962a605de6da49d1af2629008cc955a4c56e883a078a559"
     "43d1862e83f4e13b76757a15b02e718f62b65b6d6b0c7f0b")))

COMPRESSED, INFINITY, SIGN = 0x80, 0x40, 0x20


def _row(x0: int, x1: int, flags: int) -> bytes:
    r = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    r[0] |= flags
    return bytes(r)


def _no_y_x() -> "tuple[int, int]":
    """The first x = (c, 3) over which E2 has no point."""
    c = 0
    while True:
        c += 1
        x = Fq2.from_ints(c, 3)
        if (x * x * x + Fq2.from_ints(4, 4)).sqrt() is None:
            return c, 3


def edge_rows() -> "tuple[np.ndarray, list[str]]":
    """(rows (N, 96) uint8, names): G2 points with both sign bits; the
    c1 = 0 rows with both sign bits, one on each root; a point on E2
    outside G2; an x with no point over it; x0 ≥ p and x1 ≥ p; a G2 row
    with the compression flag clear; ∞, ∞ with a payload, ∞ with the sign
    bit; the all-zero row."""
    pts = [hash_to_g2(b"decompress-%d" % i, DST_SIGNATURE) for i in range(2)]
    rows = [(A.g2_to_bytes(pts[0]), "G2 point"),
            (A.g2_to_bytes(-pts[0]), "G2 point, its negation"),
            (A.g2_to_bytes(pts[1]), "G2 point")]
    for (x0, x1), name in zip(C1_ZERO_X, ("√c0", "√−c0")):
        for sign in (0, SIGN):
            rows.append((_row(x0, x1, COMPRESSED | sign),
                         f"y² with c1 = 0, root {name}"))
    outside = map_to_curve_g2(hash_to_field_fq2(b"ng-0", b"SGT", 1)[0])
    rows.append((A.g2_to_bytes(outside), "on E2 outside G2"))
    rows.append((_row(*_no_y_x(), COMPRESSED), "no y"))
    rows.append((_row(P + 2, 1, COMPRESSED), "x0 ≥ p"))
    rows.append((_row(1, P + 2, COMPRESSED), "x1 ≥ p"))
    clear = bytearray(rows[0][0])
    clear[0] &= 0x7F
    rows.append((bytes(clear), "compression flag clear"))
    rows.append((bytes([COMPRESSED | INFINITY]) + bytes(95), "∞"))
    payload = bytearray(rows[0][0])
    payload[0] |= INFINITY
    rows.append((bytes(payload), "∞ with a payload"))
    rows.append((bytes([COMPRESSED | INFINITY | SIGN]) + bytes(95),
                 "∞ with the sign bit"))
    rows.append((bytes(96), "all zero"))
    return (np.frombuffer(b"".join(r for r, _ in rows), np.uint8)
            .reshape(-1, 96).copy(), [n for _, n in rows])


#: (ok, in_subgroup) of each row of `edge_rows`, by name
EXPECTED = {
    "G2 point": (True, True), "G2 point, its negation": (True, True),
    "y² with c1 = 0, root √c0": (True, False),
    "y² with c1 = 0, root √−c0": (True, False),
    "on E2 outside G2": (True, False), "no y": (False, True),
    "x0 ≥ p": (False, True), "x1 ≥ p": (False, True),
    "compression flag clear": (False, True), "∞": (True, True),
    "∞ with a payload": (False, True), "∞ with the sign bit": (False, True),
    "all zero": (False, True),
}
