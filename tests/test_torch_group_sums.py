"""The plain orders of the group sums and of `multi_rlc_scale` on the CPU
against the JAX package, as affine points (canonical ints): the plan-based
`g1_group_sum_plain` / `g2_group_sum_plain` against
grandine_tpu/tpu/curve.py sum_points_contiguous and sum_points_grouped
(the JAX programs jitted on the CPU), and against host sums on groups that
take two passes of the plan; `multi_rlc_scale_plain` (its GLV halves
apart, joined by one complete addition) against curve.py scalar_mul_glv on
both groups over the edge scalars of testing/group_rows.py."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto.constants import P, R
from grandine_tpu.crypto.curves import G1, G2, endo_constants
from grandine_tpu.crypto.fields import Fq2
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import curve as JC
from grandine_tpu.tpu import limbs as JL
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.testing import group_rows as GR

rng = random.Random(0x65D)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _affine(words, k):
    """(N, 3, [2,] 12) Jacobian words → affine canonical ints per row
    (None: ∞)."""
    out = []
    for row in np.asarray(words):
        x, y, z = (L.words_to_ints(row[i].reshape(-1, 12)) for i in range(3))
        if not any(z):
            out.append(None)
        elif k == 1:
            zi = pow(z[0], -1, P)
            out.append((x[0] * zi * zi % P, y[0] * zi ** 3 % P))
        else:
            X, Y, Z = (Fq2.from_ints(*v) for v in (x, y, z))
            zi = Z.inv()
            ax, ay = X * zi * zi, Y * zi * zi * zi
            out.append(((ax.c0.n, ax.c1.n), (ay.c0.n, ay.c1.n)))
    return out


def _host(p, k):
    a = p.to_affine()
    if a is None:
        return None
    if k == 1:
        return (a[0].n, a[1].n)
    return ((a[0].c0.n, a[0].c1.n), (a[1].c0.n, a[1].c1.n))


def _groups(k):
    """4 groups of 8 host points: seeded; P, −P and ∞ rows among seeded;
    the same point twice among seeded; all ∞."""
    gen = G1 if k == 1 else G2
    pts = [gen.mul(rng.randrange(1, R)) for _ in range(20)]
    inf = gen.mul(0)
    return [pts[:8],
            [pts[8], -pts[8], inf, pts[9], inf, pts[10], pts[11], pts[12]],
            [pts[13], pts[13], pts[14], pts[15], pts[16], pts[17], pts[18],
             pts[19]],
            [inf] * 8]


def _jax_points(flat, k):
    """Host points → JAX Jacobian limb planes, Z = 1 or (1, 1, 0) for ∞."""
    if k == 1:
        x, y, inf = JC.g1_points_to_dev(flat)
        X, Y = JL.split(jnp.asarray(x)), JL.split(jnp.asarray(y))
        ops = JC.FP_OPS
    else:
        x, y, inf = JC.g2_points_to_dev(flat)
        X, Y = JB._g2_in(x, y)
        ops = JC.FP2_OPS
    one, zero = ops.one_like(X), ops.zeros_like(X)
    inf = jnp.asarray(inf)
    return (ops.select(inf, one, X), ops.select(inf, one, Y),
            ops.select(inf, zero, one)), ops


def _jax_affine(p, n, k):
    out = []
    for i in range(n):
        if k == 1:
            pt = JC.dev_to_g1_point(*(JL.merge_np(c)[i] for c in p))
        else:
            pt = JC.dev_to_g2_point(*(np.stack([JL.merge_np(c[0])[i],
                                                JL.merge_np(c[1])[i]])
                                      for c in p))
        out.append(_host(pt, k))
    return out


@pytest.mark.parametrize("layout", ["contiguous", "grouped"])
@pytest.mark.parametrize("k", [1, 2])
def test_group_sum_plain_matches_jax(k, layout):
    groups = _groups(k)
    m, s = len(groups), len(groups[0])
    flat = [p for grp in groups for p in grp]
    rows = GR.jacobian_words(flat, k)  # the same ints in both packages
    plain = B.g1_group_sum_plain if k == 1 else B.g2_group_sum_plain
    got = _affine(plain(torch.from_numpy(rows), range(0, m * s + 1, s)), k)
    if layout == "contiguous":
        pts, ops = _jax_points(flat, k)
        ref = jax.jit(lambda p: JC.sum_points_contiguous(p, s, ops))(pts)
    else:  # k-major: index j·M + g
        pts, ops = _jax_points([groups[g][j] for j in range(s)
                                for g in range(m)], k)
        ref = jax.jit(lambda p: JC.sum_points_grouped(p, s, ops))(pts)
    assert got == _jax_affine(ref, m, k)
    assert got[3] is None
    assert got[1] == _host(groups[1][3] + groups[1][5] + groups[1][6]
                           + groups[1][7], k)


@pytest.mark.parametrize("k", [1, 2])
def test_group_sum_plain_two_passes_matches_host(k):
    """Groups past one tile of the plan (a second pass) and a group of one
    point beside them, against host sums."""
    tile = B.group_tile(k)
    span = tile * B.GROUP_CHUNK + 5
    gen = G1 if k == 1 else G2
    step = gen.mul(rng.randrange(1, R))
    pts = GR.progression(gen.mul(rng.randrange(1, R)), step, span)
    groups = [pts, pts[:1], pts[3:span - 1]]
    flat = [p for grp in groups for p in grp]
    rows = GR.jacobian_words(flat, k)  # the same ints in both packages
    off = np.cumsum([0] + [len(g) for g in groups])
    assert len(B.group_sum_plan(off, tile)) == 2
    plain = B.g1_group_sum_plain if k == 1 else B.g2_group_sum_plain
    got = _affine(plain(torch.from_numpy(rows), off), k)
    want = []
    for grp in groups:
        acc = gen.mul(0)
        for p in grp:
            acc = acc + p
        want.append(_host(acc, k))
    assert got == want


def _jax_endo(n, group):
    a, b = endo_constants()[group]
    fa = JL.const_fp([int(d) for d in JL.to_mont(a)], (n,))
    fb = JL.const_fp([int(d) for d in JL.to_mont(b)], (n,))
    if group == "g1":
        return fa, fb
    z = JL.zeros_fp((n,))
    return (fa, z), (fb, z)


def test_multi_rlc_scale_plain_edges_match_jax():
    """The edge sets (r0 = 0, r1 = 0, r = 1, r = 0, halves 0xFFFFFFFF, a
    masked signature, one key in three sets) and seeded ones: rᵢ·pkᵢ and
    rᵢ·sigᵢ against JAX scalar_mul_glv on FP_OPS and FP2_OPS."""
    cases = GR.MULTI_EDGES + GR.seeded_multi_cases(0x65E, 3)
    n = len(cases)
    args = GR.multi_rows(cases, 0x65F)
    rpk, rsig = B.multi_rlc_scale_plain(*(torch.from_numpy(a) for a in args))
    sx, sy, idx, gx, gy, mask, r01 = args
    r0 = [c[1][0] for c in cases]
    r1 = [c[1][1] for c in cases]
    lo = jnp.asarray(JC.scalars_to_bits_msb(r0, 32)).T
    hi = jnp.asarray(JC.scalars_to_bits_msb(r1, 32)).T

    def to_mont(words):  # canonical words → the JAX package's limb planes
        ints = L.words_to_ints(words.reshape(-1, 12))
        return np.stack([JL.to_mont(v) for v in ints]).reshape(
            words.shape[:-1] + (-1,))

    px, py = to_mont(sx[idx]), to_mont(sy[idx])
    qx, qy = to_mont(gx), to_mont(gy)
    j1 = jax.jit(lambda x, y, a, b: JC.scalar_mul_glv(
        JL.split(x), JL.split(y), jnp.zeros((n,), bool), a, b,
        _jax_endo(n, "g1"), JC.FP_OPS))(px, py, lo, hi)
    j2 = jax.jit(lambda x, y, qi, a, b: JC.scalar_mul_glv(
        JB._g2_in(x, y)[0], JB._g2_in(x, y)[1], qi, a, b,
        _jax_endo(n, "g2"), JC.FP2_OPS))(qx, qy, jnp.asarray(mask), lo, hi)
    got1, got2 = _affine(rpk, 1), _affine(rsig, 2)
    assert got1 == _jax_affine(j1, n, 1)
    assert got2 == _jax_affine(j2, n, 2)
    assert got1[8] is None and got2[8] is None  # r = 0
    assert [got2[i] is None for i in range(n)] == [
        c[1] == (0, 0) or c[2] for c in cases]
