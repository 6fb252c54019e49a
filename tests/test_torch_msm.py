"""The port's Pippenger bucket MSM (grandine_tpu_torch/gpu/msm.py) on the
CPU against the JAX package (grandine_tpu/tpu/msm.py and the window
selection of grandine_tpu/tpu/bls.py), exact:

- `plan_msm` gives the reference's arrays element for element, for every
  window width, one group and five with one empty, with ∞ points, zero
  scalar halves and a duplicated point; `sharded_msm_plans` too at D = 2
  and 4;
- `pick_msm_window` picks the reference's width with no table and with
  the same table installed on both;
- the composed plain MSM (`msm_bucket_sum` on CPU tensors) gives the same
  affine points as `expand_glv_points` + `msm_bucket_scan` jitted on the
  CPU and as the host anchor Σ (r0 + r1·λ)·P, for G1 with groups and for
  G2; the port's φ-expanded rows are the reference's (r = r0 + r1·λ).

The JAX programs run jitted on the CPU at lanes = 64 and n = 17–37, as
tests/test_tpu_msm.py runs them, once a case."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto.constants import P, R
from grandine_tpu.crypto.curves import (
    G1, G2, LAMBDA, g1_infinity, g2_infinity)
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import curve as JC
from grandine_tpu.tpu import field as JF
from grandine_tpu.tpu import limbs as JL
from grandine_tpu.tpu import msm as JM
from grandine_tpu_torch.crypto.fields import Fq2
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm as M


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scalars(rng, n):
    """(r_lo, r_hi) with a zero scalar (set 4) and a zero low half (set
    6)."""
    lo = [rng.randrange(0, 1 << 32) for _ in range(n)]
    hi = [rng.randrange(0, 1 << 32) for _ in range(n)]
    lo[4] = hi[4] = 0
    lo[6] = 0
    return lo, hi


# --- the host plan ------------------------------------------------------------


def _plan_inputs(n_groups):
    rng = random.Random(0x91A0 + n_groups)
    n = 41
    lo, hi = _scalars(rng, n)
    lo[7], hi[7] = lo[3], hi[3]  # a duplicated point: the same buckets
    inf = np.zeros(n, bool)
    inf[[2, 9]] = True
    groups = [rng.randrange(0, max(1, n_groups - 1)) for _ in range(n)]
    return lo, hi, inf, (None if n_groups == 1 else groups)


@pytest.mark.parametrize("n_groups", [1, 5])
@pytest.mark.parametrize("w", [4, 5, 6, 7, 8])
def test_plan_arrays_equal_the_reference(w, n_groups):
    """The same (S, T) lane grid, flushes and (J, n_sec, B) gathers; group
    4 of 5 holds no point; lanes = 64 and the default lane count."""
    lo, hi, inf, groups = _plan_inputs(n_groups)
    for lanes in (64, None):
        got = M.plan_msm(lo, hi, inf, groups, n_groups, window_bits=w,
                         lanes=lanes)
        want = JM.plan_msm(lo, hi, inf, groups, n_groups, window_bits=w,
                           lanes=lanes)
        assert (got.n_groups, got.windows, got.window_bits) == (
            want.n_groups, want.windows, want.window_bits)
        for a, b in zip(got.arrays, want.arrays, strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert M.MSM_LANES == 8192


@pytest.mark.parametrize("n, n_groups, w", [
    (1562, 12, 4),   # the unaggregated slot's key plan
    (1562, 1, 8),    # its signature plan
    (512, 1, 4),     # the sync slot's key plan
    (3000, 300, 8),  # 307,200 buckets: keys past 16 bits
    (200, 3, 6),     # every point ∞: no entry
])
def test_plan_arrays_equal_the_reference_at_route_sizes(n, n_groups, w):
    """Seeded halves at the route's sizes (and past the 16-bit keys of the
    radix sort) give the reference's arrays, ∞ rows and zero halves
    among them."""
    rng = np.random.default_rng(n + n_groups + w)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    lo[::7] = 0
    inf = rng.random(n) < 0.05 if n != 200 else np.ones(n, bool)
    groups = (None if n_groups == 1 else
              np.sort(rng.integers(0, n_groups, size=n)))
    got = M.plan_msm(lo, hi, inf, groups, n_groups, window_bits=w)
    want = JM.plan_msm(lo, hi, inf, groups, n_groups, window_bits=w)
    for a, b in zip(got.arrays, want.arrays, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture
def same_tables():
    """Drop both packages' cached tables afterwards (the next lookup
    reads each package's file again)."""
    yield
    B.set_msm_tuning(None)
    JB.set_msm_tuning(None)


_SHAPES = [(n, g) for n in (1, 5, 17, 64, 200, 512, 1562, 2048, 9000)
           for g in (1, 3, 4, 16, 64)]


def test_window_equals_the_reference_without_a_table(same_tables):
    B.set_msm_tuning({})
    JB.set_msm_tuning({})
    assert B.load_msm_tuning() is None
    got = [B.pick_msm_window(n, g) for n, g in _SHAPES]
    assert got == [JB.pick_msm_window(n, g) for n, g in _SHAPES]
    assert set(got) > {4}  # the op model moves with the shape


def test_window_equals_the_reference_with_one_table(same_tables, tmp_path):
    """The same table on both: its keys quantised to the pow-2 buckets
    (1,562 points in 12 groups is "2048:16"), the model elsewhere; a file
    table drops entries outside 4–8 and is read from the port's own path
    only."""
    table = {"2048:16": 7, "512:1": 8, "64:4": 5}
    B.set_msm_tuning(table)
    JB.set_msm_tuning(table)
    got = [B.pick_msm_window(n, g) for n, g in _SHAPES + [(1562, 12)]]
    assert got == [JB.pick_msm_window(n, g) for n, g in _SHAPES
                   + [(1562, 12)]]
    assert got[-1] == 7
    path = tmp_path / "msm_tune.json"
    path.write_text('{"windows": {"64:1": 6, "128:1": 9, "256:1": "x"}}')
    assert B.load_msm_tuning(str(path)) == {"64:1": 6}
    assert B.msm_tune_path().endswith("grandine_tpu_torch/gpu/msm_tune.json")


def test_autotune_writes_the_table_pick_msm_window_reads(same_tables,
                                                         tmp_path):
    """gpu/autotune.py's table round-trips through load_msm_tuning and
    drops the cache; its default cells are the grouped route's keys; a
    measurement without a card raises instead of timing the CPU."""
    from grandine_tpu_torch.gpu import autotune

    path = autotune.write_tuning({"2048:16": 4, "2048:1": 8},
                                 path=str(tmp_path / "t.json"))
    assert B.load_msm_tuning(path) == {"2048:16": 4, "2048:1": 8}
    keys = {"%d:%d" % (B._bucket(n), B._bucket(g, lo=1))
            for n, g, _ in autotune.DEFAULT_SHAPES}
    assert keys == {"2048:16", "512:4", "2048:1", "512:1"}
    with pytest.raises(RuntimeError):
        autotune.time_window(64, 1, 4, device="cpu")


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_plans_equal_the_reference(d, same_tables):
    """(M, K) = (4, 8) with ∞ keys and signatures: every shard's stacked
    arrays (J padded to the fleet's largest) and plan 0's shape."""
    B.set_msm_tuning({})
    JB.set_msm_tuning({})
    rng = random.Random(0x5EA0 + d)
    m, k = 4, 8
    lo, hi = _scalars(rng, m * k)
    pk_inf = np.zeros((m, k), bool)
    pk_inf[1, 5:] = True
    sig_inf = pk_inf.copy()
    sig_inf[0, 2] = True
    got = B.sharded_msm_plans(lo, hi, pk_inf, sig_inf, d)
    want = JB.sharded_msm_plans(lo, hi, pk_inf, sig_inf, d)
    for g_arr, w_arr in zip(got[:2], want[:2], strict=True):
        for a, b in zip(g_arr, w_arr, strict=True):
            assert a.shape[0] == d and np.array_equal(a, b)
    for gp, wp in zip(got[2:], want[2:]):
        assert (gp.n_groups, gp.windows, gp.window_bits) == (
            wp.n_groups, wp.windows, wp.window_bits)


# --- the composed MSM ---------------------------------------------------------


def _host_msm(points, lo, hi, groups, n_groups, infinity):
    acc = [infinity() for _ in range(n_groups)]
    for p, a, b, g in zip(points, lo, hi, groups):
        acc[g] = acc[g] + p.mul((int(a) + int(b) * LAMBDA) % R)
    return acc


def _case(k, n, n_groups, w, seed):
    rng = random.Random(seed)
    gen = G1 if k == 1 else G2
    points = [gen.mul(rng.randrange(1, 1 << 64)) for _ in range(n)]
    points[3] = points[5]  # duplicates
    points[9 % n] = g1_infinity() if k == 1 else g2_infinity()
    lo, hi = _scalars(rng, n)
    groups = [rng.randrange(0, max(1, n_groups - 1)) for _ in range(n)]
    inf = np.array([p.is_infinity() for p in points])
    plan = M.plan_msm(lo, hi, inf, groups, n_groups, window_bits=w, lanes=64)
    return points, lo, hi, groups, plan


def _jax_msm(k, points, plan):
    """expand_glv_points + msm_bucket_scan jitted on the CPU (the JAX
    package's own test harness, tests/test_tpu_msm.py)."""
    n = len(points)
    if k == 1:
        x, y, inf = JC.g1_points_to_dev(points)
        split, merge, endo, ops = (JL.split, JL.merge, JB._g1_endo,
                                   JC.FP_OPS)
        to_point = JC.dev_to_g1_point
    else:
        x, y, inf = JC.g2_points_to_dev(points)
        split, merge, endo, ops = (JF.fp2_split, JF.fp2_merge, JB._g2_endo,
                                   JC.FP2_OPS)
        to_point = JC.dev_to_g2_point

    def kern(x, y, inf, *arrs):
        px, py = split(jnp.asarray(x)), split(jnp.asarray(y))
        epx, epy, elive = JM.expand_glv_points(px, py, jnp.asarray(inf),
                                               endo(n), ops)
        out = JM.msm_bucket_scan(
            epx, epy, elive, *arrs, windows=plan.windows,
            window_bits=plan.window_bits, n_groups=plan.n_groups, ops=ops)
        return tuple(merge(e) for e in out), tuple(merge(e) for e in (epx,
                                                                     epy))

    (X, Y, Z), (ex, ey) = jax.jit(kern)(x, y, inf, *plan.arrays)
    sums = [to_point(np.asarray(X)[i], np.asarray(Y)[i], np.asarray(Z)[i])
            for i in range(plan.n_groups)]
    return sums, np.asarray(ex), np.asarray(ey)


#: (field, points, groups, window bits, seed): G1 over five groups (group
#: 4 empty), G2 in one — each against the JAX program too — and G1 in one
#: at w = 8 (256 digits a section) against the host anchor only (a JAX
#: compile costs ~30 s of one core)
_CASES = {"g1_groups": (1, 37, 5, 4, 11), "g2_one": (2, 17, 1, 5, 13),
          "g1_one": (1, 23, 1, 8, 7)}
_JAX_CASES = ("g1_groups", "g2_one")


def _reference(name):
    """A case's inputs, the host anchor's sums and, where run, the JAX
    program's sums and expanded rows."""
    k, n, g, w, seed = _CASES[name]
    points, lo, hi, groups, plan = _case(k, n, g, w, seed)
    host = _host_msm(points, lo, hi, groups, g,
                     g1_infinity if k == 1 else g2_infinity)
    sums, ex, ey = (_jax_msm(k, points, plan) if name in _JAX_CASES
                    else (host, None, None))
    return points, plan, sums, host, ex, ey


def _port_words(k, points):
    """Host points → (N, [2,] 12) affine words, zero words on ∞ rows."""
    inf = np.array([p.is_infinity() for p in points])
    if k == 2:
        x, y, _ = B.g2_affine_words_many(points)
        return torch.from_numpy(x), torch.from_numpy(y), inf
    x = np.zeros((len(points), 12), np.int32)
    y = np.zeros((len(points), 12), np.int32)
    x[~inf], y[~inf] = B.g1_affine_words([p for p in points
                                         if not p.is_infinity()])
    return torch.from_numpy(x), torch.from_numpy(y), inf


def _affine(k, words):
    """(G, 3, [2,] 12) Jacobian words → affine canonical ints (None: ∞)."""
    out = []
    for row in words:
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


def _host_affine(k, p):
    a = p.to_affine()
    if a is None:
        return None
    if k == 1:
        return (a[0].n, a[1].n)
    return ((a[0].c0.n, a[0].c1.n), (a[1].c0.n, a[1].c1.n))


@pytest.mark.parametrize("name", list(_CASES))
def test_plain_msm_equals_the_reference_and_the_anchor(name):
    """The three plain stages composed, on the reference's plan: the JAX
    program's affine sums (where run) and the host anchor's, group for
    group; the empty group is ∞ on all three. Where the JAX program runs,
    the φ-half of its expanded batch (rows N … 2N − 1 of
    expand_glv_points) is the port's endomorphism of the same points, the
    one its kernels apply at load: r = r0 + r1·λ has one meaning in both.
    A plan of (r0, r1) = (0, 1) sums to Σ λ·P. (One test a case: each JAX
    compile costs ~30 s of one core, and a fixture shared between tests
    would be computed again on every worker that runs one of them.)"""
    k = _CASES[name][0]
    points, plan, sums, host, ex, ey = _reference(name)
    x, y, inf = _port_words(k, points)
    live = torch.from_numpy(~inf)
    got = _affine(k, M.msm_bucket_sum(x, y, live, plan))
    assert got == [_host_affine(k, p) for p in sums]
    assert got == [_host_affine(k, p) for p in host]
    if name == "g1_groups":
        assert got[4] is None
    if ex is None:
        return
    n = len(points)
    ops = C.FP_OPS if k == 1 else C.FP2_OPS
    endo = C.g1_endo("cpu") if k == 1 else C.g2_endo("cpu")
    px, py = ops.mul_many([L.from_words(x), L.from_words(y)], list(endo))
    for port, ref in ((px, ex), (py, ey)):
        assert np.array_equal(L.to_words(port)[live].numpy(),
                              _jax_words(ref, n)[~inf])
    lam = M.plan_msm(np.zeros(n), np.ones(n), inf, None, 1, window_bits=4,
                     lanes=64)
    want = (g1_infinity if k == 1 else g2_infinity)()
    for p in points:
        want = want + p.mul(LAMBDA)
    assert _affine(k, M.msm_bucket_sum(x, y, live, lam)) == [
        _host_affine(k, want)]


def _jax_words(rows, n):
    """The φ rows (N … 2N − 1) of the reference's merged expanded batch,
    (2N, [2,] 26) Montgomery digits, as (N, [2,] 12) canonical words."""
    rows = np.asarray(rows)[n:]
    vals = [JL.from_mont(r) % P for r in rows.reshape(-1, rows.shape[-1])]
    return L.ints_to_words(vals).reshape(rows.shape[:-1] + (12,))
