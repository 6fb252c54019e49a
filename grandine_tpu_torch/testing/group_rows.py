"""Seeded operands of `g1_group_sum`, `g2_group_sum` and `multi_rlc_scale`
on their edges, shared by the host harness (tests/test_torch_ladders.py),
the card's tests (tests/test_torch_cuda.py), chip_smoke.py and
ladder_timing.py. Host numpy arrays of canonical words, the wrappers'
layouts; and `multi_launch`, multi_rlc_scale's C entry in either G2
form."""

from __future__ import annotations

import ctypes
import random

import numpy as np
import torch

from grandine_tpu_torch.crypto.curves import G1, G2
from grandine_tpu_torch.crypto.constants import R
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import limbs as L


def jacobian_words(points, k: int) -> np.ndarray:
    """Host points as (N, 3, [2,] 12) Jacobian canonical words with their
    own Z (a point after additions has Z ≠ 1; ∞ keeps its (1, 1, 0))."""
    ints = []
    for p in points:
        for c in (p.x, p.y, p.z):
            ints += [c.n] if k == 1 else [c.c0.n, c.c1.n]
    shape = (len(points), 3, 12) if k == 1 else (len(points), 3, 2, 12)
    return L.ints_to_words(ints).reshape(shape)


def progression(base, step, n: int):
    """base, base + step, … (n host points, additions only)."""
    out = [base]
    for _ in range(n - 1):
        out.append(out[-1] + step)
    return out


def group_cases(tile: int):
    """The group-sum edges as (name, the group's rows as indices into
    `group_rows`' seeded points, −1 an ∞ row, −2 the negation of point
    5): empty groups, an all-∞ group, one row, exactly GROUP_CHUNK rows
    and GROUP_CHUNK + 1, a group spanning tiles (more than tile ·
    GROUP_CHUNK rows, so a second pass), a group summing to ∞ (P and −P),
    a group whose fold doubles (the same point twice), and many groups of
    4 rows (the mesh's reduction shape)."""
    chunk = B.GROUP_CHUNK
    span = tile * chunk + 3
    return ([("empty", []), ("all ∞", [-1, -1, -1]), ("one row", [0]),
             (f"{chunk} rows", list(range(1, 1 + chunk))),
             (f"{chunk + 1} rows", list(range(2, 3 + chunk))),
             ("empty", []),
             (f"{span} rows: two passes", list(range(span))),
             ("P and −P", [5, -2]), ("P twice", [7, 7]),
             ("∞ and P", [-1, 3])]
            + [("mesh 4", list(range(4 * i, 4 * i + 4))) for i in range(6)])


def group_rows(k: int, seed: int, tile: int):
    """(rows (N, 3, [2,] 12) int32, offsets, names) of `group_cases` in
    G1 (k = 1) or G2 (k = 2): seeded points in progression with their own
    Z; an ∞ row holds a live point's X, Y with Z = 0."""
    g = random.Random(seed)
    gen = G1 if k == 1 else G2
    cases = group_cases(tile)
    n_pts = max(max(c[1], default=0) for c in cases) + 1
    pts = progression(gen.mul(g.randrange(1, R)), gen.mul(g.randrange(1, R)),
                      n_pts)
    neg = -pts[5]
    words = jacobian_words(pts + [neg], k)
    inf = np.array(words[0])
    inf[2] = 0  # Z = 0 with the X, Y of a live point: ∞ all the same
    rows, offsets, names = [], [0], []
    for name, members in cases:
        for j in members:
            rows.append(inf if j == -1 else words[-1] if j == -2
                        else words[j])
        offsets.append(offsets[-1] + len(members))
        names.append(name)
    return np.stack(rows).astype(np.int32), offsets, names


#: multi_rlc_scale's edges as (key row, (r0, r1), signature masked) over
#: `multi_rows`' keys and signatures
MULTI_EDGES = [
    (0, (0, 0x9E3779B9), False),            # r0 = 0
    (1, (0x7F4A7C15, 0), False),            # r1 = 0
    (2, (1, 0), False),                     # r = 1
    (3, (2**32 - 1, 2**32 - 1), False),     # halves 0xFFFFFFFF
    (4, (0xCAFEBABE, 0x8BADF00D), True),    # masked signature
    (5, (0x12345678, 0x9ABCDEF0), False),   # the same key in three sets
    (5, (0x0F0F0F0F, 0xF0F0F0F0), False),
    (5, (0xA5A5A5A5, 0x5A5A5A5A), True),
    (6, (0, 0), False),                     # r = 0
]


def multi_rows(cases, seed: int, n_keys: int = 8):
    """multi_rlc_scale operands (src_x, src_y, idx, sig_x, sig_y, sig_mask,
    r01) for `cases` of (key row, (r0, r1), masked): n_keys seeded keys in
    progression, a progression of seeded G2 points as signatures."""
    g = random.Random(seed)
    keys = progression(G1.mul(g.randrange(1, R)), G1.mul(g.randrange(1, R)),
                       n_keys)
    sx, sy = B.g1_affine_words(keys)
    sigs = progression(G2.mul(g.randrange(1, R)), G2.mul(g.randrange(1, R)),
                       len(cases))
    gx, gy, _ = B.g2_affine_words_many(sigs)
    idx = np.array([c[0] for c in cases], np.int32)
    mask = np.array([c[2] for c in cases])
    r01 = B.rlc_pairs_words([c[1] for c in cases])
    return [np.array(a) for a in (sx, sy, idx, gx, gy, mask, r01)]


def seeded_multi_cases(seed: int, n: int, n_keys: int = 8):
    """n seeded multi_rlc_scale cases over n_keys keys, one in five
    signatures masked."""
    g = random.Random(seed)
    return [(g.randrange(n_keys), (g.getrandbits(32), g.getrandbits(32)),
             i % 5 == 4) for i in range(n)]


def multi_launch(args, g2_lanes: bool):
    """multi_rlc_scale's C entry on CUDA operands `args` (the wrapper's)
    in the given G2 form, where the wrapper takes `multi_g2_lanes(N)`'s:
    (rpk, rsig). Lets the card's tests and ladder_timing.py run the form
    the rule does not choose; counts no launch."""
    from grandine_tpu_torch.gpu import _build

    src_x, src_y, idx, sig_x, sig_y, sig_mask, r01 = args
    n, dev = idx.shape[0], idx.device
    rpk = torch.empty((n, 3, 12), dtype=torch.int32, device=dev)
    rsig = torch.empty((n, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.launch("multi_rlc_scale", src_x, src_y, idx, ctypes.c_int(n),
                  ctypes.c_int(int(g2_lanes)), sig_x, sig_y, sig_mask, r01,
                  rpk, rsig)
    return rpk, rsig
