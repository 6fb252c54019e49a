"""Window totals that reach `msm_horner`'s edges, shared by the host
harness (tests/test_torch_ladders.py), the card's tests
(tests/test_torch_cuda.py) and chip_smoke.py: (G·W, 3, [2,] 12) Jacobian
canonical words, W windows a group (section g·W + win), with a name a
group and the host anchor's sum Σ_win 2^(w·win)·T_win a group."""

from __future__ import annotations

import random

import numpy as np

from grandine_tpu_torch.crypto.constants import P, R
from grandine_tpu_torch.crypto.curves import G1, G2, Point
from grandine_tpu_torch.crypto.fields import Fq, Fq2
from grandine_tpu_torch.testing.group_rows import jacobian_words

#: the group cases (`_sequence` gives each one's totals)
HORNER_CASES = ("no entry", "∞ at the top", "∞ as X, Y, 0 at the top",
                "∞ in the middle", "a doubling", "opposite points",
                "a sum to ∞", "one total, the lowest", "seeded")


def _rescale(p, lam):
    """The same point in another Jacobian form: (λ²X, λ³Y, λZ)."""
    l2 = lam * lam
    return Point(p.x * l2, p.y * l2 * lam, p.z * lam, p.b)


def _sequence(case, W, w, fresh):
    """The totals of `case` from the top window down (host points, None
    for ∞ (1, 1, 0), ("zxy", p) for p's X, Y with Z = 0)."""
    seq = [fresh() for _ in range(W)]
    if case == "no entry":
        seq = [None] * W
    elif case == "∞ at the top":
        seq[0] = seq[1] = None
    elif case == "∞ as X, Y, 0 at the top":
        seq[0] = ("zxy", seq[0])
    elif case == "∞ in the middle":
        seq[2] = None
    elif case == "a doubling":  # the sum meets itself: G2ADD's H = r = 0
        seq[1] = seq[0].mul(1 << w)
    elif case == "opposite points":  # H = 0, r ≠ 0: ∞, no doublings after
        seq[1] = -seq[0].mul(1 << w)
    elif case == "a sum to ∞":
        seq[-1] = -_horner(seq[:-1], w, seq[0]).mul(1 << w)
    elif case == "one total, the lowest":
        seq = [None] * (W - 1) + [seq[-1]]
    return seq


def _point(t, inf):
    return inf if t is None else inf if isinstance(t, tuple) else t


def _horner(seq, w, like):
    inf = Point.infinity(like.b)
    acc = inf
    for t in seq:
        acc = acc.mul(1 << w) + _point(t, inf)
    return acc


def horner_totals(k: int, w: int, seed: int):
    """(totals (G·W, 3, [2,] 12) int32, names, sums): the HORNER_CASES in
    G1 (k = 1) or G2 (k = 2) at w-bit windows, W = ⌈32/w⌉ ≥ 3; each live
    total seeded, in a Jacobian form of its own (Z ≠ 1); `sums` the host
    anchor's point a group."""
    W = (32 + w - 1) // w
    rng = random.Random(seed)
    gen = G1 if k == 1 else G2

    def lam():
        v = rng.randrange(2, P)
        return Fq(v) if k == 1 else Fq2.from_ints(v, rng.randrange(P))

    def fresh():
        return gen.mul(rng.randrange(1, R))

    inf = Point.infinity(gen.b)
    rows, sums = [], []
    for case in HORNER_CASES:
        seq = _sequence(case, W, w, fresh)
        sums.append(_horner(seq, w, gen))
        for t in reversed(seq):  # window 0 first
            if t is None:
                rows.append(jacobian_words([inf], k)[0])
            elif isinstance(t, tuple):
                word = jacobian_words([_rescale(t[1], lam())], k)[0].copy()
                word[2] = 0
                rows.append(word)
            else:
                rows.append(jacobian_words([_rescale(t, lam())], k)[0])
    return np.stack(rows).astype(np.int32), list(HORNER_CASES), sums
