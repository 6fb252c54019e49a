"""The port's sharded verify programs on virtual CPU shards, against the JAX
package, exact: `rlc_partial_plain` against the JAX package's
fp12_product_tree; the flat and grouped routes of
`TorchBlsBackend(mesh=VerifyMesh.build(D, platform="cpu"))` at D = 2 and
4 on seeded cases (valid, a forged signature, swapped messages, a
signature outside G2; ∞ padding and empty shards in every one), each
verdict the port's single-device route's and the JAX host
`multi_verify`'s; the route each batch takes, decided before any kernel,
the JAX `TpuBlsBackend(mesh=…)`'s; and, in the slow tier, the JAX sharded
programs themselves on 8 virtual devices beside the port on 8 virtual
shards."""

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import DST_SIGNATURE, P, R
from grandine_tpu.crypto.curves import G1
from grandine_tpu.crypto.hash_to_curve import (
    hash_to_field_fq2, hash_to_g2, map_to_curve_g2)
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import field as JF
from grandine_tpu.tpu import limbs as JL
from grandine_tpu.tpu import pairing as JP
from grandine_tpu.tpu.mesh import VerifyMesh as JaxMesh
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu.mesh import VerifyMesh

rng = random.Random(0x5A4D)


def _bits(seed):
    """random.Random behind the `randbits` of `secrets` (rng=)."""
    return SimpleNamespace(randbits=random.Random(seed).getrandbits)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- rlc_partial ---------------------------------------------------------------


def _jax_fp12(f_ints):
    n = len(f_ints) // 12
    rows = np.stack([JL.to_mont(v) for v in f_ints]).reshape(n, 2, 3, 2, -1)
    return JF.fp12_split(jnp.asarray(rows))


def _jax_fp12_ints(f):
    arr = JF.fp12_merge_np(f)
    return [JL.from_mont(r) % P for r in arr.reshape(-1, arr.shape[-1])]


ONE12 = [1] + [0] * 11


@pytest.mark.parametrize("spans", [[16, 0, 4, 1], [9, 2]])
def test_rlc_partial_plain_matches_jax_product_tree(spans):
    """Per group the product of its seeded Fp12 terms, exactly the JAX
    package's jitted fp12_product_tree over them (padded with ones to its
    16-term batch; an empty group is one); the flag byte is any agg_inf
    (bit 0) and all sig_ok & sig_sub (bit 1) of the group's rows. A span
    of 16 or 9 runs the 32-thread tree, spans up to 8 one thread a
    group."""
    total = sum(spans)
    vals = [rng.randrange(P) for _ in range(total * 12)]
    f = torch.from_numpy(L.ints_to_words(vals).copy()).reshape(
        total, 2, 3, 2, 12)
    flags_rng = np.random.default_rng(len(spans))
    agg_inf = torch.from_numpy(flags_rng.random(total) < 0.1)
    sig_ok = torch.from_numpy(flags_rng.random(total) < 0.9)
    sig_sub = torch.from_numpy(flags_rng.random(total) < 0.9)
    off = np.concatenate([[0], np.cumsum(spans)])
    prod, flags = B.rlc_partial(f, agg_inf, sig_ok, sig_sub, off, off)
    tree = jax.jit(JP.fp12_product_tree)
    for g, (lo, hi) in enumerate(zip(off, off[1:])):
        terms = vals[lo * 12: hi * 12] + ONE12 * (16 - (hi - lo))
        want = _jax_fp12_ints(tree(_jax_fp12(terms)))
        assert L.words_to_ints(prod[g].reshape(-1, 12)) == want
        inf = bool(agg_inf[lo:hi].any())
        ok = bool((sig_ok[lo:hi] & sig_sub[lo:hi]).all())
        assert int(flags[g]) == int(inf) | 2 * int(ok)
    agg, sig = B.partial_flags(flags)
    assert agg.tolist() == [bool(v & 1) for v in flags.tolist()]
    assert sig.tolist() == [bool(v & 2) for v in flags.tolist()]


def test_rlc_partial_plain_without_terms_is_one():
    """A shard past the real rows: no term, no signature row; every group
    writes Fp12 one and flags 2 (no ∞, nothing refused)."""
    f = torch.zeros((0, 2, 3, 2, 12), dtype=torch.int32)
    none = torch.zeros((0,), dtype=torch.bool)
    prod, flags = B.rlc_partial(f, none, none, none, [0, 0, 0], [0, 0, 0])
    assert [L.words_to_ints(p.reshape(-1, 12)) for p in prod] == [ONE12] * 2
    assert flags.tolist() == [2, 2]
    one = F.fp12_one((1,), "cpu")
    assert torch.equal(prod[:1], L.to_words(one))


# --- the sharded routes' verdicts --------------------------------------------------

#: 5 sets over distinct messages (bucket 8: at D = 4 shard 3 holds only
#: padding, at D = 2 shard 1 one real row and three ∞ pads)
FLAT = [1] * 5
#: 8 sets over 3 messages (bm = 4, bk = 8): at D = 4 shard 3 owns no
#: member of any group and pairs no message, group 2 has one member
GROUPED = [5, 2, 1]


def _world(widths, tag):
    sks = [rng.randrange(1, R) for _ in range(sum(widths))]
    msgs = [tag + b"-%d" % j + bytes(24)
            for j, w in enumerate(widths) for _ in range(w)]
    sigs = [JA.g2_to_bytes(hash_to_g2(m, DST_SIGNATURE).mul(k))
            for m, k in zip(msgs, sks)]
    return msgs, sigs, [JA.g1_to_bytes(G1.mul(k)) for k in sks]


@pytest.fixture(scope="module")
def worlds():
    return {"flat": _world(FLAT, b"flat"), "grouped": _world(GROUPED, b"grp")}


OUTSIDE_G2 = JA.g2_to_bytes(map_to_curve_g2(
    hash_to_field_fq2(b"sharded-ng", b"SGT", 1)[0]))


def _variant(world, variant):
    msgs, sigs, pks = (list(x) for x in world)
    if variant == "forged":
        sigs[1] = sigs[2]
    elif variant == "swapped":  # across groups in the grouped world
        j = len(msgs) - 2
        msgs[0], msgs[j] = msgs[j], msgs[0]
    elif variant == "outside_g2":
        sigs[3] = OUTSIDE_G2
    return msgs, sigs, pks


def _port(msgs, sigs, pks):
    return (msgs, [PA.Signature(PA.g2_from_bytes(s, subgroup_check=False))
                   for s in sigs], [PA.PublicKey.from_bytes(k) for k in pks])


def _jax(msgs, sigs, pks):
    return (msgs, [JA.Signature(JA.g2_from_bytes(s, subgroup_check=False))
                   for s in sigs], [JA.PublicKey.from_bytes(k) for k in pks])


@pytest.mark.parametrize("route,d,variant", [
    ("flat", 4, "valid"), ("flat", 2, "forged"), ("flat", 4, "swapped"),
    ("flat", 2, "outside_g2"), ("grouped", 4, "valid"),
    ("grouped", 2, "forged"), ("grouped", 4, "swapped"),
])
def test_sharded_verdict_matches_single_and_jax_host(worlds, route, d,
                                                     variant):
    """The sharded route over D virtual CPU shards gives the port's
    single-device verdict and the JAX host multi_verify's under the same
    seeded draws; the batch took the sharded route (one rlc_partial a
    shard, empty shards included) and its finish saw D terms of each
    kind."""
    msgs, sigs, pks = _variant(worlds[route], variant)
    calls = {"partial": 0, "finish": []}
    partial, finish = B.rlc_partial, B.rlc_finish

    def counting_partial(*a):
        calls["partial"] += 1
        return partial(*a)

    def recording_finish(f, rsig, *a):
        calls["finish"].append((f.shape[0], rsig.shape[0]))
        return finish(f, rsig, *a)

    mesh = VerifyMesh.build(d, platform="cpu")
    sharded = B.TorchBlsBackend(device="cpu", mesh=mesh)
    B.rlc_partial, B.rlc_finish = counting_partial, recording_finish
    try:
        got = sharded.multi_verify(*_port(msgs, sigs, pks), rng=_bits(11))
    finally:
        B.rlc_partial, B.rlc_finish = partial, finish
    assert calls["partial"] == d and calls["finish"] == [(d, d)]
    single = B.TorchBlsBackend(device="cpu").multi_verify(
        *_port(msgs, sigs, pks), rng=_bits(11))
    host = JA.multi_verify(*_jax(msgs, sigs, pks), rng=_bits(12))
    assert got is single is host is (variant == "valid")


# --- the route each batch takes --------------------------------------------------


class _Route(Exception):
    pass


def _raise(name):
    def fn(*a, **kw):
        raise _Route(name)
    return fn


def _jax_route(d, msgs, sigs, pks, monkeypatch):
    backend = JB.TpuBlsBackend(mesh=JaxMesh.build(d, platform="cpu"))
    monkeypatch.setattr(JB, "sharded_multi_verify", _raise("sharded_flat"))
    monkeypatch.setattr(JB, "sharded_multi_verify_msm",
                        _raise("sharded_grouped"))

    def jitted(name, *a, **kw):
        raise _Route("grouped" if name.startswith("grouped") else "flat")

    monkeypatch.setattr(backend, "_jitted_msm", jitted)
    with pytest.raises(_Route) as e:
        backend.multi_verify(msgs, sigs, pks)
    return str(e.value)


def _port_route(d, msgs, sigs, pks, monkeypatch):
    backend = B.TorchBlsBackend(device="cpu",
                                mesh=VerifyMesh.build(d, platform="cpu"))
    # the single-device routes run the ψ check before their launch seam:
    # a stand-in keeps the route decision free of plain kernels
    monkeypatch.setattr(B, "signature_plane",
                        lambda sx, sy, inf: (sx, sy, inf, inf, inf))
    monkeypatch.setattr(B, "sharded_multi_verify", _raise("sharded_flat"))
    monkeypatch.setattr(B, "sharded_multi_verify_msm",
                        _raise("sharded_grouped"))
    monkeypatch.setattr(B, "verify_sets", _raise("flat"))
    monkeypatch.setattr(B, "verify_grouped", _raise("grouped"))
    with pytest.raises(_Route) as e:
        backend.multi_verify(msgs, sigs, pks)
    return str(e.value)


#: sets a message: distinct messages at buckets 4, 8 and 256 (the block),
#: the grouped shapes of the sync slot (bm = 4, bk = 512), the
#: unaggregated slot (bm = 16, bk = 256), 2 × 4 and a mixed slot
_SHAPES = [
    ("distinct_3", [1] * 3),
    ("distinct_5", [1] * 5),
    ("block", [1] * 131),
    ("2_messages", [4, 4]),
    ("mixed", [8, 1, 1, 1, 1]),
    ("sync_committee", [512]),
    ("unaggregated_slot", [131] * 2 + [130] * 10),
]


@pytest.fixture(scope="module")
def signers():
    """8 signers' signatures and keys in both packages."""
    sks = [rng.randrange(1, R) for _ in range(8)]
    h = hash_to_g2(b"route", DST_SIGNATURE)
    sigs = [JA.g2_to_bytes(h.mul(k)) for k in sks]
    pks = [JA.g1_to_bytes(G1.mul(k)) for k in sks]
    return ([JA.Signature.from_bytes(s) for s in sigs],
            [JA.PublicKey.from_bytes(k) for k in pks],
            [PA.Signature.from_bytes(s) for s in sigs],
            [PA.PublicKey.from_bytes(k) for k in pks])


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("name,widths", _SHAPES)
def test_route_matches_jax_mesh_backend(signers, name, widths, d,
                                        monkeypatch):
    """The port over D virtual shards takes the JAX TpuBlsBackend(mesh=)'s
    route for each shape — sharded flat where the mesh divides the bucket
    b and b ≥ 2·D, sharded grouped where D divides both grouped buckets,
    else the single-device flat or grouped program — both decided before
    any kernel runs."""
    js, jk, ps, pk = signers
    order = [j for j, w in enumerate(widths) for _ in range(w)]
    msgs = [b"route-%d" % j + bytes(24) for j in order]
    pick = [i % len(js) for i in range(len(order))]
    want = _jax_route(d, msgs, [js[i] for i in pick], [jk[i] for i in pick],
                      monkeypatch)
    got = _port_route(d, msgs, [ps[i] for i in pick], [pk[i] for i in pick],
                      monkeypatch)
    assert got == want


# --- the JAX sharded programs themselves (slow) ---------------------------------


def _words(rows):
    """JAX rest-format Montgomery digit rows (…, 26) → canonical words."""
    flat = np.asarray(rows).reshape(-1, np.asarray(rows).shape[-1])
    return L.ints_to_words([JL.from_mont(r) % P for r in flat]).reshape(
        *np.asarray(rows).shape[:-1], 12)


def _r01(lo, hi):
    return np.stack([np.asarray(lo, np.uint64), np.asarray(hi, np.uint64)],
                    -1).astype(np.uint32).view(np.int32)


@pytest.mark.kernel
@pytest.mark.slow
def test_sharded_programs_match_jax_on_8_devices():
    """tests/test_sharded.py's seeded inputs through the JAX sharded
    programs on XLA's 8 virtual CPU devices and through the port's on 8
    virtual CPU shards: the same verdicts — flat (5 real sets in a bucket
    of 16) valid, a corrupted signature limb, swapped messages; grouped
    (8 messages × 16 members, 40 real) valid and a corrupted signature."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    from __graft_entry__ import _example_batch
    from test_sharded import _grouped_batch

    devices = jax.devices()[:8]
    jmesh = Mesh(np.array(devices), ("batch",))
    mesh = VerifyMesh.build(8, platform="cpu")
    batch = NamedSharding(jmesh, PS("batch"))

    valid = list(_example_batch(5, 16))
    bad = [np.copy(a) for a in valid]
    bad[3][3, 0, 0] ^= 1
    swapped = [np.copy(a) for a in valid]
    for a in (swapped[6], swapped[7]):
        a[[0, 1]] = a[[1, 0]]
    flat_jax = JB.make_sharded_multi_verify(jmesh, axis="batch")
    flat_port = B.make_sharded_multi_verify(mesh)
    for args in (valid, bad, swapped):
        want = bool(jax.device_get(flat_jax(*(
            jax.device_put(a, batch) for a in args))))
        pk_x, pk_y, _pi, sig_x, sig_y, sig_inf, msg_x, msg_y, msg_inf, rb = (
            np.asarray(a) for a in args)
        n = 5
        msg = np.stack([_words(msg_x[:n]), _words(msg_y[:n])], 1)
        r01 = np.array([[int("".join(map(str, row[:32])), 2),
                         int("".join(map(str, row[32:])), 2)]
                        for row in rb[:n]], np.uint32).view(np.int32)
        got = flat_port(_words(pk_x[:n]), _words(pk_y[:n]),
                        _words(sig_x[:n]), _words(sig_y[:n]), sig_inf[:n],
                        msg, msg_inf[:n], r01, 16)
        assert bool(got.item()) is want
    assert want is False

    m, k = 8, 16
    args, r_lo, r_hi = _grouped_batch(m=m, k=k)
    g1_stack, g2_stack, g1_p0, g2_p0 = JB.sharded_msm_plans(
        r_lo, r_hi, args[2], args[5], 8)
    grouped_jax = JB.make_sharded_multi_verify_msm(
        jmesh, g1_windows=g1_p0.windows, g1_wbits=g1_p0.window_bits,
        g2_windows=g2_p0.windows, g2_wbits=g2_p0.window_bits)
    grouped_port = B.make_sharded_multi_verify_msm(mesh)
    member = NamedSharding(jmesh, PS(None, "batch"))
    repl = NamedSharding(jmesh, PS())
    plan = NamedSharding(jmesh, PS("batch"))
    sig_bad = np.copy(args[3])
    sig_bad[1, 2, 0, 0] ^= 1
    results = []
    for sig_x in (args[3], sig_bad):
        a = (args[0], args[1], args[2], sig_x) + args[4:]
        want = bool(jax.device_get(grouped_jax(
            *(jax.device_put(x, member) for x in a[:6]),
            *(jax.device_put(x, repl) for x in a[6:9]),
            *(jax.device_put(x, plan) for x in g1_stack + g2_stack))))
        pk_x, pk_y, pk_inf, sx, sy, sinf, msg_x, msg_y, msg_inf = a
        live = ~pk_inf  # members fill each group's first slots
        counts = live.sum(1)
        rows = [(j, kk) for j in range(m) for kk in range(counts[j])]
        sel = tuple(np.array(v) for v in zip(*rows))
        flat_r = [kk * m + j for j, kk in rows]
        got = grouped_port(
            _words(pk_x[sel]), _words(pk_y[sel]), _words(sx[sel]),
            _words(sy[sel]), sinf[sel], np.concatenate([[0], np.cumsum(
                counts)]), np.stack([_words(msg_x), _words(msg_y)], 1),
            msg_inf, _r01(r_lo[flat_r], r_hi[flat_r]), m, k)
        assert bool(got.item()) is want
        results.append(want)
    assert results == [True, False]


def test_sharded_programs_refuse_batches_past_their_buckets():
    """A batch wider than the buckets it is given would leave sets
    unverified: both callables raise before any launch."""
    mesh = VerifyMesh.build(2, platform="cpu")
    z = np.zeros
    with pytest.raises(ValueError):
        B.make_sharded_multi_verify(mesh)(
            z((5, 12), np.int32), z((5, 12), np.int32),
            z((5, 2, 12), np.int32), z((5, 2, 12), np.int32),
            z((5,), bool), z((5, 2, 2, 12), np.int32), z((5,), bool),
            z((5, 2), np.int32), 4)
    grouped = B.make_sharded_multi_verify_msm(mesh)
    for offsets, bm, bk in (([0, 3, 5], 2, 2), ([0, 1, 2, 3, 5], 2, 4)):
        with pytest.raises(ValueError):
            grouped(z((5, 12), np.int32), z((5, 12), np.int32),
                    z((5, 2, 12), np.int32), z((5, 2, 12), np.int32),
                    z((5,), bool), offsets, z((len(offsets) - 1, 2, 2, 12),
                                             np.int32),
                    z((len(offsets) - 1,), bool), z((5, 2), np.int32), bm,
                    bk)
