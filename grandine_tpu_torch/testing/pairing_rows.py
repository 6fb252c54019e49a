"""Seeded operands of `miller_loop_pairs` and `aggregate_rlc_scale` on their
edges and at the gossip slot's shape, shared by the host harnesses
(tests/test_torch_finish_tail.py, tests/test_torch_ladders.py), the card's
tests (tests/test_torch_cuda.py) and the timing scripts
(gpu/tail_bench.py, ladder_timing.py). Host numpy arrays of canonical
words, the wrappers' layouts."""

from __future__ import annotations

import random

import numpy as np

from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, P, R
from grandine_tpu_torch.crypto.curves import G1, G2
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import limbs as L

#: distinct rows of `miller_rows` (tiled past them: row i is row i mod
#: PAIR_KINDS, so neighbouring pairs differ and a plain check runs
#: PAIR_KINDS loops, ~0.33 s each on one CPU core)
PAIR_KINDS = 10


def miller_rows(n: int, seed: int):
    """n miller_loop_pairs rows over min(n, PAIR_KINDS) distinct ones,
    cycling through: P with a random Z ≠ 1 and Q a hashed message; P with
    Z = 1 and Q = the G2 generator; P = −g1 (affine) and a second message;
    a pair_inf row; P with a random Z and Q = the generator. Returns (rpk
    (d, 3, 12), msg (d, 2, 2, 12), pair_inf (d,)) of the d distinct rows
    and `tile`, the distinct row of each of the n."""
    tile = np.arange(n) % PAIR_KINDS
    d = min(n, PAIR_KINDS)
    g = random.Random(seed)
    msgs = [B.g2_affine_words(pt)[0] for pt in
            (hash_to_g2(b"pairs-%d" % seed, DST_SIGNATURE),
             hash_to_g2(b"pairs-%d-b" % seed, DST_SIGNATURE), G2)]
    neg = (-G1).to_affine()
    rv, mv, inf = [], [], np.zeros(d, bool)
    for i in range(d):
        kind = i % 5
        if kind == 2:
            x, y = neg[0].n, neg[1].n
        else:
            a = G1.mul(g.randrange(1, R)).to_affine()
            x, y = a[0].n, a[1].n
        z = 1 if kind in (1, 2) else g.randrange(2, P)
        rv += [x * z * z % P, y * z * z * z % P, z]
        mv.append(msgs[(0, 2, 1, 0, 2)[kind]])
        inf[i] = kind == 3
    rpk = L.ints_to_words(rv).astype(np.int32).reshape(d, 3, 12)
    return rpk, np.stack(mv), inf, tile


#: aggregate_rlc_scale's edges as (members, (r0, r1), signature masked)
#: over `aggregate_rows`' keys (row 140 the negation of row 0)
AGGREGATE_EDGES = [
    (list(range(87)), (0, 0x9E3779B9), False),           # r0 = 0
    (list(range(87, 140)), (0x7F4A7C15, 0), False),      # r1 = 0
    (list(range(10, 51)), (1, 0), False),                # r = 1
    (list(range(130)), (2**32 - 1, 2**32 - 1), False),   # 130 members
    ([0, 140], (0xA5A5A5A5, 0x5A5A5A5A), False),         # sums to ∞
    ([1, 1], (0x12345678, 0x9ABCDEF0), False),           # the doubling
    ([2], (0x0F0F0F0F, 0xF0F0F0F0), False),              # one member
    ([3, 4, 5], (0xCAFEBABE, 0x8BADF00D), True),         # masked
    ([0, 140], (0, 0), True),                            # r = 0, ∞, masked
]


def gossip_cases(seed: int, m: int = 192, n_keys: int = 4096):
    """The gossip slot's shape as `aggregate_rows` cases: m aggregates of
    87–130 members drawn from n_keys keys, seeded RLC halves, no signature
    masked."""
    g = random.Random(seed)
    return [(sorted(g.sample(range(n_keys), g.randint(87, 130))),
             (g.getrandbits(32), g.getrandbits(32)), False)
            for _ in range(m)]


def aggregate_rows(cases, seed: int, n_keys: int = 140):
    """aggregate_rlc_scale operands (src_x, src_y, idx, cnt, sig_x, sig_y,
    sig_mask, r01) for `cases` of (members, (r0, r1), masked): n_keys
    seeded keys in progression (additions, no ladders) and row n_keys, the
    negation of key 0; the multiples 1, 2, … of a seeded G2 point as
    signatures."""
    g = random.Random(seed)
    step, acc, keys = G1.mul(g.randrange(1, R)), G1.mul(g.randrange(1, R)), []
    for _ in range(n_keys):
        keys.append(acc)
        acc = acc + step
    keys.append(-keys[0])
    sx, sy = B.g1_affine_words(keys)
    m, k = len(cases), max(len(c[0]) for c in cases)
    idx = np.zeros((m, k), np.int32)
    for i, (mem, _, _) in enumerate(cases):
        idx[i, :len(mem)] = mem
    cnt = np.array([len(c[0]) for c in cases], np.int32)
    base, sigs = G2.mul(g.randrange(1, R)), []
    for _ in range(m):
        sigs.append(base if not sigs else sigs[-1] + base)
    gx, gy, _ = B.g2_affine_words_many(sigs)
    mask = np.array([c[2] for c in cases])
    r01 = B.rlc_pairs_words([c[1] for c in cases])
    return [np.array(a) for a in (sx, sy, idx, cnt, gx, gy, mask, r01)]
