"""The port's message-grouped route of `multi_verify_async` and its group
reductions on the CPU, against the JAX package, exact (canonical ints and
verdicts): the plain versions of `g1_group_sum` and of the group-indexed
`rlc_finish` (with fp12_product_tree_grouped and sum_points_contiguous)
against the JAX programs and host anchors, the grouped verdicts against
the JAX host `multi_verify`, and the route itself — taken exactly where
the JAX package takes it, decided without running a kernel."""

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import DST_SIGNATURE, P, R
from grandine_tpu.crypto.curves import G1, G2
from grandine_tpu.crypto.fields import Fq2
from grandine_tpu.crypto.hash_to_curve import (
    hash_to_field_fq2, hash_to_g2, map_to_curve_g2)
from grandine_tpu.tpu import field as JF
from grandine_tpu.tpu import limbs as JL
from grandine_tpu.tpu import pairing as JP
from grandine_tpu.tpu.bls import TpuBlsBackend
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm
from grandine_tpu_torch.gpu import pairing as TP

rng = random.Random(0x6A0)


def _bits(seed):
    """random.Random behind the `randbits` of `secrets` (rng=)."""
    return SimpleNamespace(randbits=random.Random(seed).getrandbits)


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


def _host(p, k):
    a = p.to_affine()
    if a is None:
        return None
    if k == 1:
        return (a[0].n, a[1].n)
    return ((a[0].c0.n, a[0].c1.n), (a[1].c0.n, a[1].c1.n))


def _jac_rows_g1(points):
    """Host G1 points → (N, 3, 12) Jacobian words with Z = 1 (∞: 1, 1, 0)."""
    vals = []
    for p in points:
        a = p.to_affine()
        vals += [1, 1, 0] if a is None else [a[0].n, a[1].n, 1]
    return torch.from_numpy(L.ints_to_words(vals).reshape(-1, 3, 12).copy())


# --- the group reductions -------------------------------------------------------


def test_g1_group_sum_plain_matches_host_sums():
    """Offsets with an empty group, a group past the kernel's 128 threads
    (the strided loop's second pass), a doubling and a cancellation."""
    base = [G1.mul(rng.randrange(1, R)) for _ in range(4)]
    groups = [[base[0], base[1], base[0], -base[0]], [],
              [base[2]], [base[(i * 7) % 4] for i in range(130)], [base[3]]]
    flat = [p for grp in groups for p in grp]
    offsets = np.cumsum([0] + [len(grp) for grp in groups])
    got = _affine(B.g1_group_sum(_jac_rows_g1(flat), offsets), 1)
    want = []
    for grp in groups:
        acc = G1.mul(0)
        for p in grp:
            acc = acc + p
        want.append(_host(acc, 1))
    assert got == want
    assert got[1] is None  # the empty group is ∞
    with pytest.raises(ValueError):
        B.g1_group_sum(_jac_rows_g1(flat), [0, 3, 2, len(flat)])


def _port_fp12(f_ints):
    return L.from_words(torch.from_numpy(
        L.ints_to_words(f_ints).copy()).reshape(-1, 2, 3, 2, 12))


def _jax_fp12(f_ints):
    n = len(f_ints) // 12
    rows = np.stack([JL.to_mont(v) for v in f_ints]).reshape(n, 2, 3, 2, -1)
    return JF.fp12_split(jnp.asarray(rows))


def _jax_fp12_ints(f):
    arr = JF.fp12_merge_np(f)
    return [JL.from_mont(r) % P for r in arr.reshape(-1, arr.shape[-1])]


@pytest.mark.parametrize("tree", [1, 32, 96])
def test_group_reductions_match_jax(tree):
    """fp12_product_tree_grouped against the JAX program over its
    contiguous groups of 4 (16 terms), and sum_points_contiguous against
    the JAX host sums, at thread counts rlc_finish launches with (96: a
    tree that is not a power of two); the port's offsets also take a
    ragged split with an empty group."""
    vals = [rng.randrange(P) for _ in range(16 * 12)]
    got = TP.fp12_product_tree_grouped(_port_fp12(vals), [0, 4, 8, 12, 16],
                                       tree)
    ref = jax.jit(lambda f: JP.fp12_product_tree_grouped(f, 4))(
        _jax_fp12(vals))
    assert L.words_to_ints(L.to_words(got)) == _jax_fp12_ints(ref)
    pts = [G2.mul(rng.randrange(1, R)) for _ in range(8)]
    pts[5] = G2.mul(0)
    sx, sy, sinf = B.g2_affine_words_many(pts)
    jac = (L.from_words(torch.from_numpy(sx)), L.from_words(torch.from_numpy(
        sy)), C.FP2_OPS.one((8,), "cpu"))
    jac = C._mask_inf(jac, torch.from_numpy(sinf), C.FP2_OPS)
    sums = msm.sum_points_contiguous(jac, [0, 4, 8], C.FP2_OPS, tree)
    want = []
    for lo in (0, 4):
        acc = G2.mul(0)
        for p in pts[lo:lo + 4]:
            acc = acc + p
        want.append(_host(acc, 2))
    assert _affine(C.jac_to_words(sums, 2), 2) == want
    ragged = msm.sum_points_contiguous(jac, [0, 1, 1, 8], C.FP2_OPS, tree)
    assert _affine(C.jac_to_words(ragged, 2), 2)[1] is None


# --- the group-indexed finish ---------------------------------------------------

N_KEYS = 8


@pytest.fixture(scope="module")
def sets():
    """8 sets over 2 messages, 4 signers each, as host objects of both
    packages (the same secret keys and signatures)."""
    sks = [rng.randrange(1, R) for _ in range(N_KEYS)]
    msgs = [b"grouped-%d" % (i % 2) + bytes(22) for i in range(N_KEYS)]
    sig_bytes = [JA.g2_to_bytes(hash_to_g2(m, DST_SIGNATURE).mul(k))
                 for m, k in zip(msgs, sks)]
    pkb = [JA.g1_to_bytes(G1.mul(k)) for k in sks]
    return msgs, sig_bytes, pkb


def _port(sets_, sig_bytes=None, subgroup_check=True):
    msgs, sb, pkb = sets_
    return (msgs, [PA.Signature(PA.g2_from_bytes(s, subgroup_check))
                   for s in (sig_bytes or sb)],
            [PA.PublicKey.from_bytes(k) for k in pkb])


def _jax(sets_, sig_bytes=None):
    msgs, sb, pkb = sets_
    return (msgs, [JA.Signature(JA.g2_from_bytes(s, subgroup_check=False))
                   for s in (sig_bytes or sb)],
            [JA.PublicKey.from_bytes(k) for k in pkb])


def test_rlc_finish_plain_group_verdicts(sets):
    """One finish over 5 groups of a flat pass — sets {0, 1}, none (a dead
    group), {2, 3}, {4 forged}, {5, 6, 7} — against the JAX host anchor's
    verdict for each group's sets; a dead group is True without work;
    offsets that do not tile are refused."""
    msgs, sigs, pks = _port(sets)
    sigs = list(sigs)
    sigs[4] = sigs[5]
    fx, fy = B.g1_affine_words([pk.point for pk in pks])
    sx, sy, sinf = B.g2_affine_words_many([s.point for s in sigs])
    pairs = [B.TorchBlsBackend._rlc_pair(_bits(4)) for _ in range(N_KEYS)]
    rpk, rsig = B.multi_rlc_scale(
        torch.from_numpy(fx.copy()), torch.from_numpy(fy.copy()),
        torch.arange(N_KEYS, dtype=torch.int32), torch.from_numpy(sx),
        torch.from_numpy(sy), torch.from_numpy(sinf),
        torch.from_numpy(B.rlc_pairs_words(pairs)))
    msg = torch.from_numpy(np.stack([B.g2_affine_words(
        hash_to_g2(m, DST_SIGNATURE))[0] for m in msgs]))
    no = torch.zeros((N_KEYS,), dtype=torch.bool)
    f = TP.miller_loop_pairs_plain(rpk, msg, no)
    off = [0, 2, 2, 4, 5, 8]
    got = B.rlc_finish(f, rsig, no, ~no, ~no, off, off).tolist()
    _, jsigs, jpks = _jax(sets)
    jsigs = list(jsigs)
    jsigs[4] = jsigs[5]
    want = [JA.multi_verify(msgs[a:b], jsigs[a:b], jpks[a:b], rng=_bits(5))
            if b > a else True for a, b in zip(off, off[1:])]
    assert got == [int(w) for w in want] == [1, 1, 1, 0, 1]
    assert B.finish_groups(f, rsig, off, off)[2].tolist() == [0, 2, 3, 4]
    with pytest.raises(ValueError):
        B.rlc_finish(f, rsig, no, ~no, ~no, [0, 4], [0, 3, 8])


def test_finish_threads_follow_the_span():
    # rlc_finish: one warp a group up to a span of 32 (warp 0 runs every
    # group's tail), one warp more a 32 terms, at most four
    assert B.finish_threads([]) == 32
    assert B.finish_threads([1, 1, 0]) == 32
    assert B.finish_threads([4, 2]) == 32
    assert B.finish_threads([9]) == 32
    assert B.finish_threads([32]) == 32
    assert B.finish_threads([33, 4]) == 64
    assert B.finish_threads([65]) == 96
    assert B.finish_threads([1562]) == 128
    # rlc_partial: the group sums' plan at PARTIAL_WARPS units of
    # GROUP_CHUNK terms a tile, a pass a launch, until each group is one
    # tile (one a group, an empty one too, in the last pass)
    tile = B.PARTIAL_WARPS * B.GROUP_CHUNK
    assert tile == 16

    def passes(spans):
        off = np.concatenate([[0], np.cumsum(spans)])
        return [p.shape[0] for p in B.group_sum_plan(off, B.PARTIAL_WARPS)]
    assert passes([0]) == [1]
    assert passes([4, 2, 0, 8]) == [4]
    assert passes([tile]) == [1]
    assert passes([tile + 1, 1]) == [3, 2]
    assert passes([64]) == [4, 1]
    assert passes([512]) == [32, 2, 1]
    assert passes([1562]) == [98, 7, 1]


# --- the grouped route end to end -----------------------------------------------


_NONSUB = JA.g2_to_bytes(map_to_curve_g2(
    hash_to_field_fq2(b"grouped-ng", b"SGT", 1)[0]))


@pytest.mark.parametrize("variant", ["valid", "forged", "cross_group_swap",
                                     "inf_key", "outside_g2"])
def test_grouped_verdicts_match_jax_host(sets, variant):
    """multi_verify on 8 sets over 2 messages takes the grouped route and
    gives the JAX host multi_verify's verdict: valid True, a signature
    forged within its message group False, two signatures swapped across
    the groups False, a signature outside G2 False (the route's fused
    subgroup check); an ∞ key is refused by both before any route."""
    msgs, sb, pkb = sets
    sig_bytes = list(sb)
    if variant == "forged":
        sig_bytes[2] = sb[4]
    elif variant == "cross_group_swap":
        sig_bytes[0], sig_bytes[1] = sb[1], sb[0]
    elif variant == "outside_g2":
        sig_bytes[5] = _NONSUB
    port = _port(sets, sig_bytes, subgroup_check=False)
    jax_ = _jax(sets, sig_bytes)
    if variant == "inf_key":
        port[2][3] = PA.PublicKey(PA.PublicKey.aggregate([]).point)
        jax_[2][3] = JA.PublicKey(G1.mul(0))
    be = B.TorchBlsBackend(device="cpu")
    taken = []
    grouped = be._grouped_multi_verify_async
    be._grouped_multi_verify_async = lambda *a: taken.append(1) or grouped(*a)
    got = be.multi_verify(*port, rng=_bits(6))
    want = JA.multi_verify(*jax_, rng=_bits(7))
    assert bool(taken) is (variant != "inf_key")
    assert got is want is (variant == "valid")


def test_grouped_route_runs_the_bucket_msm(sets, monkeypatch):
    """The route's launches, kernels stood in by shape-only stubs: the
    bucket MSM once a plane — the keys in message order with their
    message as group, the signatures in one group — on the plans of the
    drawn pairs at the reference's windows (pick_msm_window(n, bm) and
    pick_msm_window(n, 1)), then M Miller loops and one finish over M
    message terms and one signature term with the rows' flags folded; no
    ladder and no group sum."""
    calls = {}

    def rec(name, out):
        def fn(*args):
            calls.setdefault(name, []).append(args)
            return out(*args)
        return fn

    monkeypatch.setattr(msm, "msm_bucket_sum", rec(
        "msm_bucket_sum", lambda px, py, live, plan: torch.ones(
            (plan.n_groups, 3) + tuple(px.shape[1:]), dtype=torch.int32)))
    monkeypatch.setattr(TP, "miller_loop_pairs", rec(
        "miller_loop_pairs", lambda g, m, i: torch.zeros(
            (g.shape[0], 2, 3, 2, 12), dtype=torch.int32)))
    monkeypatch.setattr(B, "rlc_finish", rec(
        "rlc_finish", lambda *a: torch.ones((1,), dtype=torch.uint8)))
    for name in ("multi_rlc_scale", "g1_group_sum", "g2_group_sum"):
        monkeypatch.setattr(B, name, rec(name, None))
    msgs, sigs, pks = _port(sets)
    assert B.TorchBlsBackend(device="cpu").multi_verify(
        msgs, sigs, pks, rng=_bits(8)) is True
    order = [i for i in range(N_KEYS) if msgs[i] == msgs[0]] + [
        i for i in range(N_KEYS) if msgs[i] != msgs[0]]
    draw = _bits(8)
    pairs = [B.TorchBlsBackend._rlc_pair(draw) for _ in order]
    lo, hi = (np.array(c, np.uint64) for c in zip(*pairs))
    n, bm = N_KEYS, B._bucket(2)
    (g1x, _, g1_live, g1), (g2x, _, _, g2) = calls["msm_bucket_sum"]
    want = (msm.plan_msm(lo, hi, np.zeros(n, bool), [0] * 4 + [1] * 4, 2,
                         window_bits=B.pick_msm_window(n, bm)),
            msm.plan_msm(lo, hi, np.zeros(n, bool), None, 1,
                         window_bits=B.pick_msm_window(n, 1)))
    for got_p, want_p in zip((g1, g2), want):
        assert (got_p.n_groups, got_p.window_bits) == (want_p.n_groups,
                                                       want_p.window_bits)
        for a, b in zip(got_p.arrays, want_p.arrays, strict=True):
            assert np.array_equal(a, b)
    fx, _ = B.g1_affine_words([pks[i].point for i in order])
    assert np.array_equal(g1x.numpy(), fx) and g1_live.all()
    assert g2x.shape == (n, 2, 12)
    (gpk, _, _), = calls["miller_loop_pairs"]
    assert gpk.shape == (2, 3, 12)
    (_f, ssum, _ai, ok, sub), = calls["rlc_finish"]
    assert ssum.shape == (1, 3, 2, 12) and ok.shape == sub.shape == (1,)
    assert set(calls) == {"msm_bucket_sum", "miller_loop_pairs",
                          "rlc_finish"}


class _Route(Exception):
    pass


def _jax_route(backend, msgs, sigs, pks, monkeypatch):
    def grouped(*a, **kw):
        raise _Route("grouped")

    def flat(*a, **kw):
        raise _Route("flat")

    monkeypatch.setattr(backend, "_grouped_multi_verify_async", grouped)
    monkeypatch.setattr(backend, "_jitted_msm", flat)
    with pytest.raises(_Route) as e:
        backend.multi_verify(msgs, sigs, pks)
    return str(e.value)


def _port_route(msgs, sigs, pks, seam="multi_verify", registry=None):
    be = B.TorchBlsBackend(device="cpu")

    def grouped(*a, **kw):
        raise _Route("grouped")

    def flat(*a, **kw):
        raise _Route("flat")

    be._grouped_multi_verify_async = grouped
    be._flat_multi_verify_async = flat
    with pytest.raises(_Route) as e:
        if registry is None:
            getattr(be, seam)(msgs, sigs, pks)
        else:
            be.multi_verify_indexed(msgs, sigs, pks, registry)
    return str(e.value)


#: (sets, sets a message): the sync-committee slot, the unaggregated slot
#: at 50,000 validators, mixed widths, distinct messages, and one past the
#: padding rule (9 messages, one of 32 sets: 16 · 32 > 4 · 64)
_SHAPES = [
    ("2_messages", [4, 4]),
    ("distinct", [1, 1, 1, 1]),
    ("sync_committee", [512]),
    ("unaggregated_slot", [131] * 2 + [130] * 10),
    ("mixed", [8, 1, 1, 1, 1]),
    ("padding_rule_refuses", [32] + [1] * 8),
    ("half_distinct", [2, 1, 1, 1]),
]


@pytest.mark.parametrize("name,widths", _SHAPES)
def test_route_matches_jax_without_kernels(sets, name, widths, monkeypatch):
    """The port takes the grouped route exactly where the JAX package
    does, for each shape, both decided at the launch seam before any
    kernel runs; the compressed seam never groups."""
    _, js, jk = _jax(sets)
    _, ps, pk = _port(sets)
    order = [j for j, w in enumerate(widths) for _ in range(w)]
    messages = [b"route-%d" % j + bytes(24) for j in order]
    pick = [i % N_KEYS for i in range(len(order))]
    want = _jax_route(TpuBlsBackend(), messages, [js[i] for i in pick],
                      [jk[i] for i in pick], monkeypatch)
    got = _port_route(messages, [ps[i] for i in pick], [pk[i] for i in pick])
    n, m = len(order), len(widths)
    assert got == want == ("grouped" if B.grouped_route(m, max(widths), n)
                           else "flat")
    assert _port_route(messages, [s.to_bytes() for s in
                                  (ps[i] for i in pick)],
                       [pk[i] for i in pick],
                       seam="multi_verify_compressed") == "flat"
