"""The port's verify scheduler on the CPU against the JAX package's: the
lane table, then the reference's fake-backend scenarios
(tests/test_scheduler.py) run on both schedulers with the same fakes and
the same submissions — deadline flush, max_batch, HIGH over LOW, shed
oldest, backpressure, bisection, settle and dispatch faults,
`DeferredVerifier` — with equal verdicts and `stats` counters; the
`ed25519`, `blob_kzg` and `bls` lanes on the plain versions
(`device="cpu"`) against `use_device=False`; a device fault in
`ed25519_verify` counted, never hidden; the reputation table against the
reference on seeded event sequences; the canary probe. Every wait on a
ticket has its own timeout."""

import random
import threading
import time

import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import DST_SIGNATURE
from grandine_tpu.crypto.hash_to_curve import hash_to_g2
from grandine_tpu.crypto.curves import G1
from grandine_tpu.metrics import Metrics
from grandine_tpu.runtime import health as JH
from grandine_tpu.runtime import isolation as jiso
from grandine_tpu.runtime import verify_scheduler as jvs
from grandine_tpu.runtime.thread_pool import Priority as JPriority
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.crypto import ed25519 as HE
from grandine_tpu_torch.gpu import ed25519 as E
from grandine_tpu_torch.gpu import schemes
from grandine_tpu_torch.runtime import health as H
from grandine_tpu_torch.runtime import isolation as iso
from grandine_tpu_torch.runtime import verify_scheduler as pvs
from grandine_tpu_torch.runtime.thread_pool import Priority
from grandine_tpu_torch.testing import chaos as pchaos

#: one real signature over a fixed message: the host-decompress route
#: decodes it; the verdicts come from the fakes' truth tables
_SK = 0x5C4ED
_SIG = JA.g2_to_bytes(hash_to_g2(b"scheduler", DST_SIGNATURE).mul(_SK))
_JPK = JA.PublicKey(G1.mul(_SK))
_PPK = PA.PublicKey.from_bytes(_JPK.to_bytes())

BOTH = {"jax": (jvs, JPriority), "port": (pvs, Priority)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _lanes(who, *rows):
    mod, prio = BOTH[who]
    return tuple(mod.LaneConfig(name, getattr(prio, p), mb, mw, mq, shed=sh)
                 for name, p, mb, mw, mq, sh in rows)


def _stub_item(mod, tag: bytes):
    """Key material is never touched when host_check_item is stubbed."""
    return mod.VerifyItem(tag.ljust(32, b"\x00"), tag.ljust(96, b"\x00"),
                          public_keys=("stub",))


def _stub(monkeypatch, fn):
    monkeypatch.setattr(jvs, "host_check_item", fn)
    monkeypatch.setattr(pvs, "host_check_item", fn)


def test_default_lanes_match_jax():
    def rows(lanes):
        return [(c.name, int(c.priority), c.max_batch, c.max_wait_s,
                 c.max_queue, c.shed, c.scheme) for c in lanes]

    assert rows(pvs.DEFAULT_LANES) == rows(jvs.DEFAULT_LANES)
    assert len(pvs.DEFAULT_LANES) == 10
    for lane in pvs.DEFAULT_LANES:
        row = schemes.get(lane.scheme)
        assert callable(row.device_dispatch) and callable(row.host_check)
    assert schemes.get("bls").canary and not schemes.get("ed25519").canary
    assert schemes.get("ed25519").kernel_label(None) == "ed25519_verify"


# --- lane semantics: the same submissions on both schedulers -----------------


def test_deadline_flush_matches_jax(monkeypatch):
    _stub(monkeypatch, lambda it: True)
    stats = {}
    for who, (mod, _) in BOTH.items():
        s = mod.VerifyScheduler(
            lanes=_lanes(who, ("low", "LOW", 1000, 0.05, 100, True)),
            use_device=False)
        try:
            t0 = time.monotonic()
            assert s.submit("low", [_stub_item(mod, b"a")]).result(5.0)
            assert 0.04 <= time.monotonic() - t0 < 2.0
            stats[who] = s.stats
        finally:
            s.stop()
    assert stats["port"] == stats["jax"]
    assert stats["port"]["low"]["batches"] == 1


def test_max_batch_matches_jax(monkeypatch):
    _stub(monkeypatch, lambda it: True)
    stats = {}
    for who, (mod, _) in BOTH.items():
        s = mod.VerifyScheduler(
            lanes=_lanes(who, ("low", "LOW", 4, 60.0, 100, True)),
            use_device=False)
        try:
            tickets = [s.submit("low", [_stub_item(mod, bytes([i]))])
                       for i in range(4)]
            assert [t.result(5.0) for t in tickets] == [True] * 4
            stats[who] = s.stats
        finally:
            s.stop()
    assert stats["port"] == stats["jax"]
    assert stats["port"]["low"]["max_batch_items"] == 4


def test_high_lane_picked_over_low_matches_jax(monkeypatch):
    _stub(monkeypatch, lambda it: True)
    for who, (mod, _) in BOTH.items():
        s = mod.VerifyScheduler(lanes=_lanes(
            who, ("high", "HIGH", 64, 0.01, 100, False),
            ("low", "LOW", 64, 0.001, 100, True)), use_device=False)
        try:
            with s._cond:  # parks the dispatcher: the queues are ours
                t_low = s.submit("low", [_stub_item(mod, b"l")])
                t_high = s.submit("high", [_stub_item(mod, b"h")])
                t_low.enqueued_at -= 10.0  # low is MORE overdue
                t_high.enqueued_at -= 1.0
                assert s._pick_lane(time.monotonic()) == "high", who
            s.flush(10.0)
            assert t_high.ok and t_low.ok
        finally:
            s.stop()


def test_shed_oldest_matches_jax(monkeypatch):
    _stub(monkeypatch, lambda it: True)
    out = {}
    for who, (mod, _) in BOTH.items():
        s = mod.VerifyScheduler(
            lanes=_lanes(who, ("low", "LOW", 10_000, 60.0, 4, True)),
            use_device=False)
        tickets = [s.submit("low", [_stub_item(mod, bytes([i]))])
                   for i in range(6)]
        try:
            early = [(t.done(), t.dropped, t.ok) for t in tickets]
            stats = {k: dict(v) for k, v in s.stats.items()}
        finally:
            s.stop()
        late = [(t.done(), t.dropped, t.ok) for t in tickets]
        out[who] = (early, stats, late)
    assert out["port"] == out["jax"]
    early, stats, late = out["port"]
    assert early[:2] == [(True, True, False)] * 2
    assert not any(done for done, _, _ in early[2:])
    assert stats["low"]["shed"] == 2
    assert late == [(True, True, False)] * 6


def test_high_lane_backpressure_matches_jax(monkeypatch):
    _stub(monkeypatch, lambda it: True)
    for who, (mod, _) in BOTH.items():
        s = mod.VerifyScheduler(
            lanes=_lanes(who, ("high", "HIGH", 10_000, 60.0, 1, False)),
            use_device=False)
        first = s.submit("high", [_stub_item(mod, b"a")])
        blocked = []
        th = threading.Thread(target=lambda: blocked.append(
            s.submit("high", [_stub_item(mod, b"b")])))
        th.start()
        time.sleep(0.3)
        assert th.is_alive(), who  # backpressured, not shed
        assert s.stats["high"]["shed"] == 0
        s.stop()
        th.join(5.0)
        assert not th.is_alive()
        assert first.done() and first.dropped
        assert blocked[0].done() and blocked[0].dropped


# --- the fake device backend: bisection and faults ---------------------------


class _FakeAsyncBackend:
    """The reference tests' async-seam double: verdicts from a truth table
    keyed by message bytes, verify-batch sizes recorded, dispatch-time or
    settle-time faults injected."""

    def __init__(self, truth=None, fail_dispatch=False, fail_settle=False):
        self.truth = dict(truth or {})
        self.batches: "list[int]" = []
        self.fail_dispatch = fail_dispatch
        self.fail_settle = fail_settle

    def g2_subgroup_check_batch_async(self, points):
        if self.fail_dispatch:
            raise RuntimeError("injected dispatch fault")
        out = np.ones(len(points), dtype=bool)

        def settle():
            if self.fail_settle:
                raise RuntimeError("injected settle fault")
            return out

        return settle

    def fast_aggregate_verify_batch_async(self, messages, signatures, keys):
        if self.fail_dispatch:
            raise RuntimeError("injected dispatch fault")
        self.batches.append(len(messages))
        ok = all(self.truth.get(bytes(m), False) for m in messages)

        def settle():
            if self.fail_settle:
                raise RuntimeError("injected settle fault")
            return ok

        return settle


def _real_items(mod, pk, n):
    msgs = [bytes([i]) * 32 for i in range(n)]
    return msgs, [mod.VerifyItem(m, _SIG, public_keys=(pk,)) for m in msgs]


def _run_fake(who, lane, n, truth_of, **fake):
    """n single-item jobs on `lane` through a fake backend; returns the
    verdicts, the batch sizes, the stats and the lane-batch metrics."""
    mod, _ = BOTH[who]
    msgs, items = _real_items(mod, _JPK if who == "jax" else _PPK, n)
    backend = _FakeAsyncBackend(truth={m: truth_of(i)
                                       for i, m in enumerate(msgs)}, **fake)
    m = Metrics()
    s = mod.VerifyScheduler(backend=backend, lanes=_lanes(who, lane),
                            use_device=True, metrics=m)
    try:
        tickets = [s.submit(lane[0], [it]) for it in items]
        verdicts = [t.result(60.0) for t in tickets]
        stats = {k: dict(v) for k, v in s.stats.items()}
    finally:
        s.stop()
    batches = {r: m.verify_lane_batches.value(lane[0], r)
               for r in ("ok", "invalid", "degraded")}
    return verdicts, backend.batches, stats, batches


def test_bisection_matches_jax(monkeypatch):
    """One forged item in a coalesced batch of 4: the batch fails, only
    the failing half descends, the good items still verify."""
    _stub(monkeypatch, lambda it: it.message != bytes([3]) * 32)
    lane = ("sync_message", "LOW", 128, 0.05, 100, True)
    runs = {who: _run_fake(who, lane, 4, lambda i: i != 3) for who in BOTH}
    assert runs["port"] == runs["jax"]
    verdicts, batches, stats, lane_batches = runs["port"]
    assert verdicts == [True, True, True, False]
    assert batches == [4, 2, 2, 1, 1]
    assert stats["sync_message"]["accepted"] == 3
    assert lane_batches["invalid"] == 1.0


@pytest.mark.parametrize("fault", ["fail_settle", "fail_dispatch"])
def test_device_fault_degrades_like_jax(monkeypatch, fault):
    """A backend that faults at readback or at dispatch: the batch gets
    one retry, then degrades to the host twin, counted; nothing drops."""
    _stub(monkeypatch, lambda it: True)
    lane = ("exit", "LOW", 16, 0.01, 100, True)
    runs = {who: _run_fake(who, lane, 1, lambda i: True, **{fault: True})
            for who in BOTH}
    assert runs["port"] == runs["jax"]
    verdicts, _batches, stats, lane_batches = runs["port"]
    assert verdicts == [True]
    assert stats["exit"]["device_faults"] == 1
    assert stats["exit"]["retries"] == 1
    assert lane_batches["degraded"] == 1.0


def test_deferred_verifier_matches_jax(monkeypatch):
    _stub(monkeypatch, lambda it: False)
    out = {}
    for who, (mod, _) in BOTH.items():
        s = mod.VerifyScheduler(
            lanes=_lanes(who, ("block", "HIGH", 64, 0.002, 100, False)),
            use_device=False)
        try:
            v = s.deferred("block", timeout=10.0)
            v.verify_singular(b"\x00" * 32, b"\x00" * 96, "k")
            with pytest.raises(Exception, match="failed block-lane") as e:
                v.finish()
            assert type(e.value).__name__ == "SignatureInvalid"
            out[who] = s.stats["block"]
        finally:
            s.stop()
    assert out["port"] == out["jax"]
    assert out["port"]["rejected"] == 1


def test_quarantined_origin_reroutes_like_jax(monkeypatch):
    """A rejected job files its origin; the origin's next sheddable job
    rides the quarantine lane."""
    _stub(monkeypatch, lambda it: it.message[:1] != b"x")
    out = {}
    for who, (mod, _) in BOTH.items():
        s = mod.VerifyScheduler(lanes=_lanes(
            who, ("sync_message", "LOW", 8, 0.01, 100, True),
            ("quarantine", "LOW", 8, 0.01, 100, True)), use_device=False)
        try:
            bad = s.submit("sync_message", [_stub_item(mod, b"x")],
                           origin="peer:7")
            assert bad.result(5.0) is False
            again = s.submit("sync_message", [_stub_item(mod, b"y")],
                             origin="peer:7")
            assert again.result(5.0) is True
            out[who] = (again.lane, {k: dict(v) for k, v in s.stats.items()},
                        s.reputation.snapshot()[0]["failures"])
        finally:
            s.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == "quarantine"


# --- lanes on the plain versions ---------------------------------------------


def _ed_items(mod, n, forged=()):
    rng = random.Random(0x5CED)
    items = []
    for i in range(n):
        sk = rng.randbytes(32)
        msg = rng.randbytes(12)
        sig = HE.sign(sk, msg)
        items.append(mod.VerifyItem(msg + (b"!" if i in forged else b""), sig,
                                    public_keys=(HE.secret_to_public(sk),)))
    return items


def _lane_verdicts(sched, lane, jobs, timeout=120.0):
    tickets = [sched.submit(lane, job) for job in jobs]
    return [t.result(timeout) for t in tickets]


def test_ed25519_lane_on_the_plain_versions():
    """The `ed25519` lane through Ed25519Backend(device="cpu"): a valid
    job, a job with a forged item and a torsion specimen give the
    verdicts of use_device=False, the failed batch bisects to the forged
    item, and no device fault is filed."""
    items = _ed_items(pvs, 4, forged={2})
    a, prefix = HE.secret_expand(b"\x07" * 32)
    r = int.from_bytes(HE.sha512(prefix + b"t"), "little") % HE.L
    r_enc = HE.point_compress(HE.point_add(HE.point_mul(r, HE.BASE),
                                           HE.ORDER2))
    pk = HE.secret_to_public(b"\x07" * 32)
    k = int.from_bytes(HE.sha512(r_enc + pk + b"t"), "little") % HE.L
    torsion = pvs.VerifyItem(b"t", r_enc + ((r + k * a) % HE.L).to_bytes(
        32, "little"), public_keys=(pk,))
    jobs = [[items[0], items[1]], [items[2]], [items[3], torsion]]
    lane = (pvs.LaneConfig("ed25519", Priority.LOW, 63, 0.05, 2048,
                           shed=True, scheme="ed25519"),)
    host = pvs.VerifyScheduler(lanes=lane, use_device=False)
    dev = pvs.VerifyScheduler(lanes=lane, device="cpu",
                              settle_timeout_s=120.0)
    try:
        want = _lane_verdicts(host, "ed25519", jobs)
        launches = E.ed25519_verify.launches
        with dev._cond:  # one batch: all three jobs coalesce
            tickets = [dev.submit("ed25519", job) for job in jobs]
        got = [t.result(120.0) for t in tickets]
        st = dev.stats["ed25519"]
    finally:
        host.stop()
        dev.stop()
    assert got == want == [True, False, True]
    assert st["batches"] == 1 and st["device_faults"] == 0
    assert st["retries"] == st["breaker_skips"] == 0
    assert E.ed25519_verify.launches == launches  # plain: no kernel launch
    recs = [r for r in dev.flight.snapshot("ed25519") if r.note != "shed"]
    assert recs[-1].kernel == "ed25519_verify" and recs[-1].fault is None


def test_ed25519_device_fault_is_counted_not_hidden(monkeypatch):
    """A launch error inside ed25519_verify raises through the backend;
    the scheduler — the one place that catches it — files a device
    fault, retries once and degrades the batch to the host twin."""
    def failing(*args):
        raise RuntimeError("CUDA kernel ed25519_verify failed to launch")

    monkeypatch.setattr(E, "ed25519_verify", failing)
    lane = (pvs.LaneConfig("ed25519", Priority.LOW, 63, 0.01, 100, shed=True,
                           scheme="ed25519"),)
    s = pvs.VerifyScheduler(lanes=lane, device="cpu")
    try:
        assert s.submit("ed25519", _ed_items(pvs, 1)).result(30.0) is True
        st = dict(s.stats["ed25519"])
        rec = [r for r in s.flight.snapshot("ed25519")][-1]
    finally:
        s.stop()
    assert st["device_faults"] == 1 and st["retries"] == 1
    assert rec.fault == "dispatch" and rec.retries == 1


def test_ed25519_chaos_wrong_verdict_degrades_by_bisection():
    """The device says False on a valid batch: bisection against the host
    twin admits every item and files one `verdict` fault."""
    items = _ed_items(pvs, 3)
    truth = {bytes(it.message): True for it in items}
    chaos = pchaos.ChaosBackend(pchaos.KnownAnswerBackend(truth),
                                pchaos.FaultPlan(["wrong_verdict"]))
    lane = (pvs.LaneConfig("ed25519", Priority.LOW, 63, 0.01, 100, shed=True,
                           scheme="ed25519"),)
    s = pvs.VerifyScheduler(backend=chaos, lanes=lane)
    try:
        with s._cond:
            tickets = [s.submit("ed25519", [it]) for it in items]
        assert [t.result(30.0) for t in tickets] == [True] * 3
        faults = s.health.breaker.stats["faults"]
    finally:
        s.stop()
    assert chaos.plan.injected["wrong_verdict"] == 1
    assert faults["verdict"] == 1 and faults["dispatch"] == 0


def test_blob_kzg_lane_on_the_plain_versions():
    """Two width-4 blobs on the dev setup through the `blob_kzg` lane on
    the plain versions: the verdict of use_device=False."""
    from grandine_tpu_torch.kzg import eip4844 as K
    from grandine_tpu_torch.kzg.setup import dev_setup

    setup = dev_setup(4)
    rng = random.Random(0xB10B)
    blobs = [b"".join(rng.randrange(2**250).to_bytes(32, "big")
                      for _ in range(4)) for _ in range(2)]
    comms = [K.blob_to_kzg_commitment(b, setup, "cpu") for b in blobs]
    proofs = [K.compute_blob_kzg_proof(b, c, setup, "cpu")
              for b, c in zip(blobs, comms)]
    items = [pvs.VerifyItem(b, p, public_keys=(c,))
             for b, c, p in zip(blobs, comms, proofs)]
    lane = (pvs.LaneConfig("blob_kzg", Priority.LOW, 8, 0.01, 1024,
                           shed=True, scheme="blob_kzg"),)
    host = pvs.VerifyScheduler(lanes=lane, use_device=False)
    dev = pvs.VerifyScheduler(lanes=lane, device="cpu",
                              settle_timeout_s=120.0)
    try:
        want = host.submit("blob_kzg", items).result(120.0)
        got = dev.submit("blob_kzg", items).result(120.0)
        st = dict(dev.stats["blob_kzg"])
    finally:
        host.stop()
        dev.stop()
    assert got is want is True
    assert st["device_faults"] == 0 and st["accepted"] == 1


def test_bls_lane_on_the_plain_versions():
    """One small batch on the `exit` lane through TorchBlsBackend(device=
    "cpu") (the compressed-ingest route): a valid job and a forged one
    give use_device=False's verdicts."""
    keys = [PA.SecretKey.keygen(bytes([i + 1]) * 32) for i in range(2)]
    msgs = [b"exit-%d" % i + bytes(26) for i in range(2)]
    good = pvs.VerifyItem(msgs[0], keys[0].sign(msgs[0]).to_bytes(),
                          public_keys=(keys[0].public_key(),))
    forged = pvs.VerifyItem(msgs[1], keys[0].sign(msgs[1]).to_bytes(),
                            public_keys=(keys[1].public_key(),))
    lane = (pvs.LaneConfig("exit", Priority.LOW, 16, 0.01, 512, shed=True),)
    host = pvs.VerifyScheduler(lanes=lane, use_device=False)
    dev = pvs.VerifyScheduler(lanes=lane, device="cpu", use_isolation=False,
                              settle_timeout_s=300.0)
    try:
        want = [host.submit("exit", [good]).result(120.0),
                host.submit("exit", [forged]).result(120.0)]
        got = [dev.submit("exit", [good]).result(300.0),
               dev.submit("exit", [forged]).result(300.0)]
        st = dict(dev.stats["exit"])
    finally:
        host.stop()
        dev.stop()
    assert got == want == [True, False]
    assert st["device_faults"] == 0 and st["batches"] == 2
    assert [r.kernel for r in dev.flight.snapshot("exit")] == [
        "fast_aggregate_fused"] * 2


# --- isolation and health ----------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reputation_table_matches_jax(seed):
    rng = random.Random(seed)
    clocks = (_Clock(), _Clock())
    tables = [mod.ReputationTable(capacity=6, exit_clean=2, decay_s=5.0,
                                  clock=c)
              for mod, c in ((iso, clocks[0]), (jiso, clocks[1]))]
    for _ in range(400):
        op = rng.choice(["submit", "fail", "clean", "tick", "query", "rate"])
        origin = f"peer:{rng.randrange(10)}"
        outs = []
        for table, clock in zip(tables, clocks):
            if op == "submit":
                table.note_submitted(origin)
            elif op == "fail":
                table.note_failure(origin)
            elif op == "clean":
                table.note_clean_batch(origin)
            elif op == "tick":
                clock.t += 1.5
            elif op == "query":
                outs.append(table.is_quarantined(origin))
            else:
                outs.append(table.failure_rate(origin, min_observed=2))
        assert len(set(map(repr, outs))) <= 1, op
        assert tables[0].snapshot() == tables[1].snapshot()


def test_canary_probe_matches_jax():
    """The default specimens are the reference's (same key, messages and
    signature bytes); the probe passes a healthy backend and fails a
    stuck-at-True or raising one with the reference's fault kinds."""
    port, jax = H.default_specimens(), JH.default_specimens()
    assert [(s.message, s.expected) for s in port] == \
        [(s.message, s.expected) for s in jax]
    assert [PA.g2_to_bytes(s.signature.point) for s in port] == \
        [JA.g2_to_bytes(s.signature.point) for s in jax]
    assert [s.public_keys[0].to_bytes() for s in port] == \
        [s.public_keys[0].to_bytes() for s in jax]

    class Stuck(pchaos.KnownAnswerBackend):
        def fast_aggregate_verify_batch_async(self, m, s, k):
            return lambda: True

    class Raising(pchaos.KnownAnswerBackend):
        def fast_aggregate_verify_batch_async(self, m, s, k):
            raise RuntimeError("dispatch")

    good = {port[0].message: True}
    for backend, want in ((pchaos.KnownAnswerBackend(good), (True, None)),
                          (Stuck(good), (False, "verdict")),
                          (Raising(good), (False, "dispatch")),
                          (object(), (False, "dispatch"))):
        assert H.run_canary_detail(backend, port, timeout_s=5.0) == want
        assert JH.run_canary_detail(backend, jax, timeout_s=5.0) == want
    probe = H.make_canary_probe(pchaos.KnownAnswerBackend(good))
    assert probe() is True and probe.last_fault is None
    sup = H.BackendHealthSupervisor(fault_threshold=1, backoff_initial_s=0.0,
                                    jitter_frac=0.0)
    sup.ensure_probe(H.make_canary_probe(Stuck(good)))
    sup.record_fault("settle")
    assert sup.allow_device() is False and sup.breaker.stats[
        "probes_failed"] == 1
