"""Affine G2 rows that reach `g2_subgroup_check`'s edges, shared by the
host harness (tests/test_torch_ladders.py), the card's tests
(tests/test_torch_cuda.py) and chip_smoke.py: (sx, sy, s_inf) host numpy
arrays in the wrapper's layout (canonical words, zero on ∞ rows), a name
a row and the verdict each row must get."""

from __future__ import annotations

import numpy as np

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, R
from grandine_tpu_torch.crypto.curves import (
    G2, clear_cofactor_g2, g2_infinity)
from grandine_tpu_torch.crypto.hash_to_curve import (
    hash_to_field_fq2, hash_to_g2, map_to_curve_g2)
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.testing import decompress_rows as DR


def edge_points() -> "tuple[list, list[str]]":
    """(host points, names): G2 points and a negation; the generator; a
    point of E2 outside G2; [r]Q, a point of the cofactor's torsion (in
    no coset of G2 but its own, outside G2); a G2 point plus that
    torsion; the cofactor cleared ([h_eff]Q, in G2); ∞; and the points
    that the rows of testing/decompress_rows.py decode to (∞ included)."""
    h = [hash_to_g2(b"subgroup-%d" % i, DST_SIGNATURE) for i in range(2)]
    q = map_to_curve_g2(hash_to_field_fq2(b"sg-0", b"SGT", 1)[0])
    torsion = q.mul(R)
    pts = [(h[0], "G2 point"), (-h[0], "G2 point, its negation"),
           (h[1], "G2 point"), (G2, "the generator"),
           (q, "on E2 outside G2"), (torsion, "[r]Q: cofactor torsion"),
           (h[0] + torsion, "G2 point plus torsion"),
           (clear_cofactor_g2(q), "[h_eff]Q: in G2"),
           (g2_infinity(), "∞")]
    rows, names = DR.edge_rows()
    for row, name in zip(rows, names):
        try:
            p = A.g2_from_bytes(bytes(row), subgroup_check=False)
        except A.BlsError:
            continue
        pts.append((p, f"decompression corpus: {name}"))
    return [p for p, _ in pts], [n for _, n in pts]


def edge_rows() -> tuple:
    """(sx, sy, s_inf, names, verdicts) of `edge_points`: each verdict is
    ∞ or membership by [r]P = ∞ on the host."""
    pts, names = edge_points()
    sx, sy, inf = B.g2_affine_words_many(pts)
    want = [p.is_infinity() or p.in_subgroup_slow() for p in pts]
    return sx, sy, inf, names, want
