"""The port's mesh seam on virtual CPU shards, against the JAX package's
(tests/test_mesh.py's tier-1 cases): VerifyMesh topology, layouts and
validation, the degenerate-mesh collapse, the row-sharded registry's
lifecycle equal to the plain one, a JAX `DevicePubkeyRegistry(mesh=…)`'s
state carried across, the capacity floor, the flight recorder's `devices`
field, the mesh threading through `VerifyScheduler` to every lane's
backend, the indexed seam over a sharded registry, and the placement of
every shard's operands on its own device."""

import random

import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import DST_SIGNATURE, R
from grandine_tpu.crypto.curves import G1
from grandine_tpu.crypto.hash_to_curve import hash_to_g2
from grandine_tpu.tpu.mesh import VerifyMesh as JaxMesh
from grandine_tpu.tpu.registry import DevicePubkeyRegistry as JaxRegistry
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import pairing as TP
from grandine_tpu_torch.gpu import schemes
from grandine_tpu_torch.gpu.mesh import (
    BATCH_AXIS, VerifyMesh, mesh_or_none)
from grandine_tpu_torch.gpu.registry import (
    DevicePubkeyRegistry, registry_from_jax_arrays)
from grandine_tpu_torch.runtime.flight import FlightRecorder
from grandine_tpu_torch.runtime.thread_pool import Priority
from grandine_tpu_torch.runtime.verify_scheduler import (
    LaneConfig, VerifyItem, VerifyScheduler)
from grandine_tpu_torch.testing.chaos import KnownAnswerBackend

rng = random.Random(0x6E52)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def keypairs():
    """20 keys: enough for an append that crosses a block edge and a
    capacity doubling."""
    sks = [rng.randrange(1, R) for _ in range(20)]
    return sks, tuple(JA.g1_to_bytes(G1.mul(k)) for k in sks)


# --- topology ---------------------------------------------------------------


def test_build_topology_and_layouts():
    m = VerifyMesh.build(2, platform="cpu")
    jm = JaxMesh.build(2, platform="cpu")
    assert m.device_count == jm.device_count == 2
    assert not m.is_single
    assert m.describe() == jm.describe() == "batch:2"
    assert m.axis == BATCH_AXIS == jm.axis
    assert [m.divides(n) for n in range(40)] == [jm.divides(n)
                                                 for n in range(40)]
    # P("batch") on a length-8 axis, P(None, "batch") on 16 members
    assert [m.shard_range(8, d) for d in range(2)] == [(0, 4), (4, 8)]
    assert m.member_range(16, 1) == (8, 16)
    with pytest.raises(ValueError):
        m.shard_range(3, 0)
    a, t = m.put([np.arange(3), torch.ones(2)], 1)
    assert a.device == t.device == m.devices[1]
    assert a.tolist() == [0, 1, 2]
    g = m.gather([torch.zeros(2), torch.ones(1)])
    assert g.tolist() == [0.0, 0.0, 1.0] and g.device == m.devices[0]


def test_build_validation_and_default_count():
    with pytest.raises(ValueError):
        VerifyMesh.build(3, platform="cpu")  # not a power of two
    with pytest.raises(ValueError):
        VerifyMesh.build(0, platform="cpu")
    with pytest.raises(ValueError):
        VerifyMesh([])
    with pytest.raises(ValueError):
        VerifyMesh.build(2, platform="tpu")
    # a list may repeat a device: virtual shards
    assert VerifyMesh(["cpu"] * 4).device_count == 4
    assert VerifyMesh.build(platform="cpu").device_count == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            VerifyMesh.build(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            VerifyMesh(["cuda:0", "cuda:0"])


def test_mesh_or_none_collapses_the_degenerate_mesh():
    assert mesh_or_none(None) is None
    single = VerifyMesh.build(1, platform="cpu")
    assert single.is_single and mesh_or_none(single) is None
    two = VerifyMesh.build(2, platform="cpu")
    assert mesh_or_none(two) is two
    assert B.TorchBlsBackend(device="cpu", mesh=single).mesh is None
    assert DevicePubkeyRegistry(device="cpu", mesh=single).mesh is None
    with pytest.raises(ValueError):  # not the mesh's first device
        B.TorchBlsBackend(device="meta", mesh=two)


# --- registry row sharding --------------------------------------------------


def _rows(reg):
    x, y, _ = reg.arrays()
    if isinstance(x, tuple):
        return torch.cat(x), torch.cat(y)
    return x, y


def test_registry_sharded_lifecycle_matches_plain(keypairs):
    """Refresh, identity hit, an append that crosses the block edge, a
    capacity doubling and a full refresh: the sharded registry holds the
    plain one's rows as D blocks, with its count, capacity, stats and
    host keys; `rows_for` gathers a batch's rows as the plain registry
    holds them."""
    sks, pkb = keypairs
    mesh = VerifyMesh.build(2, platform="cpu")
    plain = DevicePubkeyRegistry(device="cpu")
    shard = DevicePubkeyRegistry(mesh=mesh)

    def assert_mirrored():
        px, py = _rows(plain)
        sx, sy = _rows(shard)
        assert torch.equal(px, sx) and torch.equal(py, sy)
        x, _, n = shard.arrays()
        assert len(x) == 2 and x[0].shape == x[1].shape
        assert shard.capacity == plain.capacity and n == plain.count
        assert shard.capacity % mesh.device_count == 0
        assert shard.stats == plain.stats
        idx = np.array([[0, n - 1, 1], [n // 2, 0, n - 1]])
        gx, gy, remap = shard.rows_for(idx, torch.device("cpu"))
        assert torch.equal(gx[torch.from_numpy(remap).long()],
                           px[torch.from_numpy(idx)])
        assert torch.equal(gy[torch.from_numpy(remap).long()],
                           py[torch.from_numpy(idx)])
        assert gx.shape[0] == len(np.unique(idx))

    head = pkb[:5]
    assert plain.ensure(head) and shard.ensure(head)
    assert shard.stats["refreshes"] == 1
    assert_mirrored()
    assert shard.ensure(head) and shard.stats["hits"] == 1  # identity
    assert plain.ensure(head)
    assert_mirrored()
    grown = pkb[:12]  # rows 5–11: block 0 up to 7, block 1 from 8
    assert plain.ensure(grown) and shard.ensure(grown)
    assert shard.stats["appends"] == 1 and shard.capacity == 16
    assert_mirrored()
    assert plain.ensure(pkb) and shard.ensure(pkb)  # 20 keys: capacity 32
    assert shard.capacity == 32 and shard.stats["appends"] == 2
    assert_mirrored()
    assert plain.ensure(pkb[1:]) and shard.ensure(pkb[1:])  # full refresh
    assert shard.stats["refreshes"] == 2
    assert_mirrored()
    assert [k.to_bytes() for k in shard.public_keys([0, 18])] == [
        pkb[1], pkb[19]]
    shard.invalidate()
    assert shard.count == 0 and shard.arrays()[0] is None


def test_registry_carried_across_from_a_jax_mesh_registry(keypairs):
    """A JAX DevicePubkeyRegistry on a 2-device mesh, read back whole,
    becomes a sharded port registry equal to one the port built itself."""
    _, pkb = keypairs
    keys = pkb[:6]
    jreg = JaxRegistry(mesh=JaxMesh.build(2, platform="cpu"))
    assert jreg.ensure(keys)
    jx, jy, n = jreg.arrays()
    mesh = VerifyMesh.build(2, platform="cpu")
    carried = registry_from_jax_arrays(np.asarray(jx), np.asarray(jy), n,
                                       jreg._hraw, mesh=mesh)
    built = DevicePubkeyRegistry(mesh=mesh)
    assert built.ensure(keys)
    assert carried.count == built.count == 6
    assert carried.capacity == built.capacity == jreg.capacity
    cx, cy, _ = carried.arrays()
    bx, by, _ = built.arrays()
    assert len(cx) == 2
    assert all(torch.equal(a, b) for a, b in zip(cx + cy, bx + by))
    assert carried.ensure(keys) and carried.stats["uploaded_bytes"] == 0
    with pytest.raises(ValueError):  # a capacity the mesh cannot split
        registry_from_jax_arrays(np.asarray(jx)[:6], np.asarray(jy)[:6], n,
                                 jreg._hraw,
                                 mesh=VerifyMesh.build(4, platform="cpu"))


def test_registry_capacity_floor_covers_wide_meshes(keypairs):
    _, pkb = keypairs
    mesh = VerifyMesh.build(8, platform="cpu")
    reg = DevicePubkeyRegistry(mesh=mesh)
    assert reg.ensure(pkb[:1])
    assert reg.capacity >= mesh.device_count
    assert reg.capacity % mesh.device_count == 0
    assert reg.capacity & (reg.capacity - 1) == 0
    x, y, remap = reg.rows_for([0, 0], torch.device("cpu"))
    assert x.shape == (1, 12) and remap.tolist() == [0, 0]


def test_indexed_seam_over_a_sharded_registry(keypairs):
    """The gossip seam over a registry sharded 4 ways (16 rows, blocks
    of 4; committees that span blocks): the sharded gather gives the
    single-device registry's verdict on the valid batch, and the JAX host
    anchor's on it and on a forged one."""
    sks, pkb = keypairs
    committees = [[0, 5, 9], [3, 14, 15, 2], [12]]
    msgs = [bytes([0x30 + i]) * 32 for i in range(3)]
    sigs = [JA.g2_to_bytes(hash_to_g2(m, DST_SIGNATURE).mul(
        sum(sks[j] for j in c) % R)) for m, c in zip(msgs, committees)]
    plain = DevicePubkeyRegistry(device="cpu")
    shard = DevicePubkeyRegistry(mesh=VerifyMesh.build(4, platform="cpu"))
    backend = B.TorchBlsBackend(device="cpu")
    for sl, regs in ((sigs, (plain, shard)),
                     ([sigs[0], sigs[0], sigs[2]], (shard,))):
        items = [VerifyItem(m, s, member_indices=c, pubkey_columns=pkb[:16])
                 for m, s, c in zip(msgs, sl, committees)]
        verdicts = {schemes.dispatch_bls_compressed(items, backend, reg)()
                    for reg in regs}
        host = all(JA.Signature.from_bytes(s).fast_aggregate_verify(
            m, [JA.PublicKey.from_bytes(pkb[j]) for j in c])
            for m, s, c in zip(msgs, sl, committees))
        assert verdicts == {host} == {sl is sigs}
    assert shard.capacity == 16 and len(shard.arrays()[0]) == 4


# --- flight + scheduler threading -------------------------------------------


def test_flight_record_devices_field():
    fl = FlightRecorder()
    rec = fl.begin_batch("block", "multi_verify", 4, devices=2)
    assert rec.record.devices == 2
    rec.finish(True)
    rec1 = fl.begin_batch("block", "multi_verify", 4)
    assert rec1.record.devices == 1
    rec1.finish(True)
    assert [r.devices for r in fl.snapshot(lane="block")] == [2, 1]


def test_scheduler_threads_the_mesh_to_every_lane_backend(monkeypatch):
    """Every lane's backend is built with the scheduler's mesh (the BLS
    backend keeps it, Ed25519 and blob KZG accept it), and a 1-device
    mesh reaches them as None."""
    seen = []
    for name in schemes.names():
        row = schemes.get(name)
        make = row.make_backend

        def recording(*, _make=make, _name=name, **kw):
            seen.append((_name, kw["mesh"]))
            return _make(**kw)

        monkeypatch.setattr(row, "make_backend", recording)
    for mesh, want in ((VerifyMesh.build(2, platform="cpu"), "same"),
                       (VerifyMesh.build(1, platform="cpu"), None)):
        sched = VerifyScheduler(device="cpu", mesh=mesh)
        try:
            want_mesh = mesh if want == "same" else None
            assert sched.mesh is want_mesh
            seen.clear()
            for lane in sched.lanes.values():
                backend = sched._backend_for(lane)
                if lane.scheme == "bls":
                    assert backend.mesh is want_mesh
                    assert backend.device.type == "cpu"
            assert {n for n, _ in seen} == {"bls", "ed25519", "blob_kzg"}
            assert all(m is want_mesh for _, m in seen)
        finally:
            sched.stop()
    s2 = VerifyScheduler(use_device=False,
                         mesh=VerifyMesh.build(2, platform="cpu"))
    try:
        assert s2.mesh.device_count == 2
    finally:
        s2.stop()


def _mixed_items(n_valid=3):
    """n_valid real signatures + one forgery (a real G2 point over the
    wrong message)."""
    sk = PA.SecretKey(rng.randrange(1, R))
    msgs = [bytes([0x40 + i]) * 32 for i in range(n_valid + 1)]
    sigs = [sk.sign(m).to_bytes() for m in msgs[:n_valid]]
    sigs.append(sigs[0])
    items = [VerifyItem(m, s, public_keys=(sk.public_key(),))
             for m, s in zip(msgs, sigs)]
    return items, {bytes(m): True for m in msgs[:n_valid]}, \
        [True] * n_valid + [False]


def test_mesh_vs_single_verdicts_through_the_scheduler():
    """The scheduler at mesh widths {None, 1, 2} over a known-answer
    backend: identical per-item verdicts on a mixed batch, and every batch
    flight record carries the width it dispatched over."""
    items, truth, expect = _mixed_items()
    lanes = (LaneConfig("sync_message", Priority.LOW, 128, 0.05, 100, True),)
    for mesh, devices in ((None, 1),
                          (VerifyMesh.build(1, platform="cpu"), 1),
                          (VerifyMesh.build(2, platform="cpu"), 2)):
        sched = VerifyScheduler(backend=KnownAnswerBackend(truth),
                                lanes=lanes, mesh=mesh)
        try:
            tickets = [sched.submit("sync_message", [it]) for it in items]
            assert [t.result(60.0) for t in tickets] == expect
            recs = sched.flight.snapshot(kind="batch")
            assert recs and all(r.devices == devices for r in recs)
        finally:
            sched.stop()


# --- shard placement ---------------------------------------------------------


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class _Shard(torch.Tensor):
    """A tensor that carries the shard it was put on; every torch call on
    it passes the tag on, and a call mixing two shards' tensors fails."""

    shard = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tags = {t.shard for t in _tensors((args, kwargs))
                if isinstance(t, _Shard) and t.shard is not None}
        if len(tags) > 1:
            raise AssertionError(f"{func} mixes shards {sorted(tags)}")
        out = super().__torch_function__(func, types, args, kwargs)
        if tags:
            for t in _tensors(out):
                if isinstance(t, _Shard):
                    t.shard = next(iter(tags))
        return out


def _tag(t, d):
    t = t.as_subclass(_Shard)
    t.shard = d
    return t


def _untag(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("route", ["flat", "grouped"])
def test_every_shard_operand_sits_on_its_shard(route, monkeypatch):
    """Indices, not values: every operand a shard's kernels take was put
    on `mesh.devices[d]` by `VerifyMesh.put(…, d)` (or derives from such
    operands only), the finish takes only what the gather brought to the
    first device, and each shard of D = 4 launches its kernels — kernels
    stood in by shape-only stubs that check the tags."""
    mesh = VerifyMesh.build(4, platform="cpu")
    put, gather = mesh.put, mesh.gather
    monkeypatch.setattr(mesh, "put", lambda ts, d: tuple(
        _tag(t, d) for t in put([_untag(t) for t in ts], d)))
    monkeypatch.setattr(mesh, "gather", lambda parts: _tag(
        gather([_untag(p) for p in parts]), 0))
    seen = []

    def stub(name, shapes, module):
        def fn(*args):
            tensors = list(_tensors(args))
            tags = {getattr(t, "shard", None) for t in tensors}
            assert len(tags) == 1 and None not in tags, (name, tags)
            (d,) = tags
            assert all(t.device == mesh.devices[d] for t in tensors)
            seen.append((name, d))
            n = tensors[0].shape[0]
            outs = tuple(_tag(torch.zeros(s(n, args), dtype=dt), d)
                         for s, dt in shapes)
            return outs if len(outs) > 1 else outs[0]
        monkeypatch.setattr(module, name, fn)

    rows = lambda n, a: (n,)  # noqa: E731
    groups = lambda n, a: (len(np.asarray(a[-1])) - 1,)  # noqa: E731
    stub("g2_subgroup_check", [(rows, torch.bool)], C)
    stub("multi_rlc_scale", [(lambda n, a: (n, 3, 12), torch.int32),
                             (lambda n, a: (n, 3, 2, 12), torch.int32)], B)
    stub("miller_loop_pairs", [(lambda n, a: (n, 2, 3, 2, 12),
                                torch.int32)], TP)
    stub("rlc_partial", [(lambda n, a: (1, 2, 3, 2, 12), torch.int32),
                         (lambda n, a: (1,), torch.uint8)], B)
    stub("g1_group_sum", [(lambda n, a: groups(n, a) + (3, 12),
                           torch.int32)], B)
    stub("g2_group_sum", [(lambda n, a: (1, 3, 2, 12), torch.int32)], B)
    stub("rlc_finish", [(lambda n, a: (1,), torch.uint8)], B)
    widths = [1] * 5 if route == "flat" else [5, 2, 1]
    sks = [rng.randrange(1, R) for _ in range(sum(widths))]
    msgs = [b"place-%d" % j + bytes(24)
            for j, w in enumerate(widths) for _ in range(w)]
    from grandine_tpu_torch.crypto.curves import G1 as PG1
    from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2 as ph2c

    sigs = [PA.Signature(ph2c(m, DST_SIGNATURE).mul(k))
            for m, k in zip(msgs, sks)]
    pks = [PA.PublicKey(PG1.mul(k)) for k in sks]
    backend = B.TorchBlsBackend(device="cpu", mesh=mesh)
    backend.multi_verify(msgs, sigs, pks)
    by = {}
    for name, d in seen:
        by.setdefault(name, []).append(d)
    assert by["rlc_partial"] == [0, 1, 2, 3]
    assert by["rlc_finish"] == [0]
    if route == "flat":  # bucket 8: rows 0-1, 2-3, 4 and none
        for name in ("g2_subgroup_check", "multi_rlc_scale",
                     "miller_loop_pairs"):
            assert by[name] == [0, 1, 2], name
        assert by["g2_group_sum"] == [0, 1, 2, 3]
    else:  # bk = 8: members 0-1, 2-3, 4 and none; bm = 4: groups 0, 1, 2
        assert by["multi_rlc_scale"] == [0, 1, 2]
        assert by["g1_group_sum"] == [0, 1, 2, 3, 0]  # then the reduction
        assert by["miller_loop_pairs"] == [0, 1, 2]
