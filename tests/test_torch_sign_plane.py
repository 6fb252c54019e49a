"""The port's signing plane (runtime/sign_plane.py) on the CPU: coalescing,
ticket futures, the release gate, breaker degradation and the slashing
interlock, on a known-answer backend (no kernels, the same plane code
paths) — plus one round on `TorchBlsBackend(device="cpu")` and one with the
port's `ChaosBackend`. Released bytes are held against the JAX package's
host anchor `SecretKey.sign`; the interlock's persisted watermarks carry
across the two packages in both directions."""

import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.runtime import health as JH
from grandine_tpu.runtime.sign_plane import SignInterlock as JaxInterlock
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.gpu import schemes
from grandine_tpu_torch.runtime import health as H
from grandine_tpu_torch.runtime.flight import FlightRecorder
from grandine_tpu_torch.runtime.sign_plane import (
    DEFAULT_SIGN_LANES, SignInterlock, SignLaneConfig, SignRefused,
    SignTicket, SigningPlane)
from grandine_tpu_torch.runtime.thread_pool import Priority
from grandine_tpu_torch.testing.chaos import ChaosBackend, FaultPlan

SCALARS = [0x7E57_0001 + 0x1357 * i for i in range(8)]
SKS = [PA.SecretKey(k) for k in SCALARS]
PKS = [sk.public_key() for sk in SKS]
ROOTS = [bytes([i + 1]) * 32 for i in range(8)]
#: the JAX package's host anchor
ANCHORS = [JA.SecretKey(k).sign(r).to_bytes() for k, r in zip(SCALARS, ROOTS)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiny_lanes(max_batch=8, shed=False, max_queue=64):
    return (
        SignLaneConfig("attestation", Priority.HIGH, max_batch, 0.002,
                       max_queue, shed=shed),
        SignLaneConfig("block", Priority.HIGH, 1, 0.001, 8, shed=False),
        SignLaneConfig("other", Priority.LOW, max_batch, 0.002,
                       max_queue, shed=True),
    )


class FakeSignBackend:
    """Known-answer sign-side seam: batch_sign returns the host anchors of
    ROOTS × SKS (or a corruption while `corrupt_first` lasts, or raises
    while `fail_batches` lasts); multi_verify is an honest truth table."""

    def __init__(self, corrupt_first: int = 0, fail_batches: int = 0):
        self.truth = {(r, pk.to_bytes()): a
                      for pk, r, a in zip(PKS, ROOTS, ANCHORS)}
        # the anchors by (message, scalar): a batch costs no host signing,
        # so it settles well inside any watchdog
        self.signed = {(r, k): PA.Signature.from_bytes(a)
                       for k, r, a in zip(SCALARS, ROOTS, ANCHORS)}
        self.corrupt_first = corrupt_first
        self.fail_batches = fail_batches
        self.sign_calls = 0
        self.verify_calls = 0

    def batch_sign(self, messages, secret_keys):
        self.sign_calls += 1
        if self.fail_batches > 0:
            self.fail_batches -= 1
            raise RuntimeError("injected device fault")
        sigs = [self.signed[(bytes(m), sk.scalar)]
                for sk, m in zip(secret_keys, messages)]
        if self.corrupt_first > 0:
            self.corrupt_first -= 1
            sigs[0] = secret_keys[0].sign(b"WRONG MESSAGE")
        return sigs

    def multi_verify(self, messages, signatures, public_keys):
        self.verify_calls += 1
        return all(self.truth.get((bytes(m), pk.to_bytes())) == s.to_bytes()
                   for m, s, pk in zip(messages, signatures, public_keys))


class DictDb:
    """The `get` / `put` surface the interlock persists through."""

    def __init__(self):
        self.kv = {}

    def get(self, key):
        return self.kv.get(key)

    def put(self, key, value):
        self.kv[key] = value


# --- tickets ------------------------------------------------------------------


def test_ticket_resolve_and_callbacks():
    t = SignTicket("attestation")
    seen = []
    t.add_callback(lambda tk: seen.append(tk.dropped))
    assert not t.done()
    with pytest.raises(TimeoutError):
        t.result(timeout=0.01)
    t._resolve(b"sig")
    assert t.done() and t.result(0.1) == b"sig"
    assert seen == [False]
    t.add_callback(lambda tk: seen.append("late"))
    t._resolve(b"other")  # a second resolve is a no-op
    assert t.result(0.1) == b"sig" and seen == [False, "late"]


def test_ticket_dropped_raises():
    t = SignTicket("other")
    t._resolve(None, dropped=True)
    assert t.dropped
    with pytest.raises(RuntimeError):
        t.result(0.1)


# --- the host plane -------------------------------------------------------------


def test_host_plane_byte_identical_to_jax_anchor():
    plane = SigningPlane(use_device=False, lanes=_tiny_lanes())
    try:
        out = plane.sign_many(list(zip(ROOTS, SKS)), duty_kind="attestation")
        assert out == ANCHORS
        st = plane.stats()["attestation"]
        assert st["signed"] == 8 and st["host_batches"] >= 1
        assert st["device_batches"] == 0
    finally:
        plane.stop()


def test_flush_and_stop_drain():
    plane = SigningPlane(use_device=False, lanes=_tiny_lanes())
    tk = plane.submit(ROOTS[0], SKS[0], duty_kind="attestation")
    assert plane.flush(5.0)
    assert tk.result(0.1) == ANCHORS[0]
    plane.stop()
    # a submit after stop settles dropped instead of hanging the caller
    assert plane.submit(ROOTS[1], SKS[1], duty_kind="attestation").dropped


def test_low_lane_sheds_oldest():
    lanes = (SignLaneConfig("other", Priority.LOW, 64, 10.0, 2, shed=True),)
    plane = SigningPlane(use_device=False, lanes=lanes)
    try:
        tickets = [plane.submit(ROOTS[i], SKS[i], duty_kind="other")
                   for i in range(4)]
        dropped = [t for t in tickets if t._event.wait(0.5) and t.dropped]
        assert len(dropped) >= 1
        assert plane.stats()["other"]["dropped"] >= 1
    finally:
        plane.stop()


def test_expired_ticket_signs_on_host_and_is_recorded():
    flight = FlightRecorder()
    plane = SigningPlane(backend=FakeSignBackend(), lanes=_tiny_lanes(),
                         flight=flight)
    try:
        tk = plane.submit(ROOTS[2], SKS[2], duty_kind="attestation",
                          deadline_s=0.0)
        assert tk.result(5.0) == ANCHORS[2] and not tk.dropped
        assert plane.stats()["attestation"]["expired"] == 1
        shed = [r for r in flight.snapshot("attestation") if r.note == "shed"]
        assert shed and shed[0].slo_cause == "expired"
    finally:
        plane.stop()


# --- the release gate -----------------------------------------------------------


def test_release_gate_catches_wrong_signature():
    """A device batch with one wrong signature is never released: the
    batch is re-signed on the host and the breaker hears a verdict
    fault."""
    backend = FakeSignBackend(corrupt_first=1)
    plane = SigningPlane(backend=backend, lanes=_tiny_lanes(),
                         settle_timeout_s=30.0)
    try:
        out = plane.sign_many(list(zip(ROOTS, SKS)), duty_kind="attestation",
                              timeout=30.0)
        assert out == ANCHORS
        st = plane.stats()["attestation"]
        assert st["gate_failures"] >= 1 and st["degraded"] >= 1
        assert plane.health.breaker.stats["faults"]["verdict"] >= 1
        out2 = plane.sign_many(list(zip(ROOTS, SKS)), duty_kind="attestation",
                               timeout=30.0)
        assert out2 == ANCHORS
        assert plane.stats()["attestation"]["device_batches"] >= 1
    finally:
        plane.stop()


def test_device_fault_degrades_and_breaker_opens():
    backend = FakeSignBackend(fail_batches=10)
    lanes = (SignLaneConfig("attestation", Priority.HIGH, 1, 0.0005, 64,
                            shed=False),)
    plane = SigningPlane(backend=backend, lanes=lanes, settle_timeout_s=30.0)
    try:
        out = plane.sign_many(list(zip(ROOTS, SKS)), duty_kind="attestation",
                              timeout=30.0)
        assert out == ANCHORS  # every duty still signed, on the host
        st = plane.stats()["attestation"]
        assert st["device_faults"] >= 3
        assert plane.health.state != "closed"
        assert st["breaker_skips"] >= 1
    finally:
        plane.stop()


def test_release_gate_off_trusts_device():
    backend = FakeSignBackend()
    plane = SigningPlane(backend=backend, lanes=_tiny_lanes(),
                         release_gate=False, settle_timeout_s=30.0)
    try:
        out = plane.sign_many(list(zip(ROOTS, SKS)), duty_kind="attestation",
                              timeout=30.0)
        assert out == ANCHORS
        assert backend.verify_calls == 0
    finally:
        plane.stop()


def test_chaos_wrong_signature_releases_no_bad_signature():
    chaos = ChaosBackend(FakeSignBackend(),
                         FaultPlan(script=["wrong_signature"]))
    plane = SigningPlane(backend=chaos, lanes=_tiny_lanes(),
                         settle_timeout_s=30.0)
    try:
        out = plane.sign_many(list(zip(ROOTS, SKS)), duty_kind="attestation",
                              timeout=30.0)
        assert out == ANCHORS
        st = plane.stats()["attestation"]
        assert st["gate_failures"] == 1 and st["degraded"] == 1
        assert chaos.plan.injected["wrong_signature"] == 1
    finally:
        plane.stop()


@pytest.mark.parametrize("kind", ["raise_dispatch", "hang"])
def test_chaos_dispatch_faults_degrade_to_host(kind):
    chaos = ChaosBackend(FakeSignBackend(), FaultPlan(script=[kind]))
    plane = SigningPlane(backend=chaos, lanes=_tiny_lanes(),
                         settle_timeout_s=0.2)
    try:
        out = plane.sign_many(list(zip(ROOTS, SKS)), duty_kind="attestation",
                              timeout=30.0)
        assert out == ANCHORS
        st = plane.stats()["attestation"]
        assert st["device_faults"] == 1 and st["degraded"] == 1
        want = "watchdog" if kind == "hang" else "dispatch"
        assert plane.health.breaker.stats["faults"][want] == 1
    finally:
        chaos.release_hangs()
        plane.stop()


def test_plane_round_on_the_cpu_backend():
    """The real backend with device="cpu" (the kernels' plain versions):
    a batch of 4 through batch_sign and the release gate's multi_verify,
    released byte for byte as the JAX anchor."""
    lanes = (SignLaneConfig("attestation", Priority.HIGH, 4, 0.05, 64,
                            shed=False),)
    plane = SigningPlane(lanes=lanes, device="cpu", settle_timeout_s=300.0)
    try:
        tickets = [plane.submit(ROOTS[i], SKS[i], duty_kind="attestation",
                                public_key=PKS[i]) for i in range(4)]
        assert [t.result(300.0) for t in tickets] == ANCHORS[:4]
        st = plane.stats()["attestation"]
        assert st["device_batches"] == st["batches"] == 1
        assert st["gate_failures"] == st["degraded"] == 0
    finally:
        plane.stop()


# --- the interlock --------------------------------------------------------------


def test_interlock_refuses_regressions_and_persists():
    db = DictDb()
    il = SignInterlock(db=db)
    pk = PKS[0].to_bytes()
    assert il.check_and_advance(pk, "block", 10) is None
    assert il.check_and_advance(pk, "block", 10) == "block_regression"
    assert il.check_and_advance(pk, "block", 9) == "block_regression"
    assert il.check_and_advance(pk, "block", 11) is None
    assert il.check_and_advance(pk, "attestation", 3) is None
    assert il.check_and_advance(pk, "attestation", 3) == \
        "attestation_regression"
    assert il.check_and_advance(pk, "randao", 1) is None
    assert il.check_and_advance(pk, "block", None) is None
    il2 = SignInterlock(db=db)
    assert il2.check_and_advance(pk, "block", 11) == "block_regression"
    assert il2.watermark(pk, "block") == 11
    assert il2.check_and_advance(pk, "block", 12) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_interlock_state_carries_across_packages(writer):
    """Watermarks written by one package's interlock are refused by the
    other's over the same db (the same keys and encoding)."""
    db = DictDb()
    first, second = ((JaxInterlock, SignInterlock) if writer == "jax"
                     else (SignInterlock, JaxInterlock))
    pk = PKS[3].to_bytes()
    a = first(db=db)
    assert a.check_and_advance(pk, "block", 40) is None
    assert a.check_and_advance(pk, "attestation", 7) is None
    b = second(db=db)
    assert b.check_and_advance(pk, "block", 40) == "block_regression"
    assert b.check_and_advance(pk, "attestation", 6) == \
        "attestation_regression"
    assert b.check_and_advance(pk, "attestation", 8) is None
    assert first(db=db).watermark(pk, "attestation") == 8


def test_plane_refuses_before_kernel_and_counts():
    backend = FakeSignBackend()
    plane = SigningPlane(backend=backend, lanes=_tiny_lanes(),
                         settle_timeout_s=30.0)
    try:
        plane.submit(ROOTS[0], SKS[0], duty_kind="block", index=5)
        with pytest.raises(SignRefused) as exc:
            plane.submit(ROOTS[1], SKS[0], duty_kind="block", index=5)
        assert exc.value.reason == "block_regression"
        assert plane.stats()["block"]["refused"] == 1
        assert plane.flush(10.0)
        assert backend.sign_calls <= 1  # the refused one never signed
    finally:
        plane.stop()


# --- the breaker, the scheme table, the lanes -------------------------------


def test_breaker_walks_the_jax_state_sequence():
    """The port's breaker and the JAX package's, fed the same outcomes under
    one fake clock, pass through the same states."""
    now = [0.0]

    def walk(mod):
        import random
        now[0] = 0.0
        sup = mod.BackendHealthSupervisor(
            fault_threshold=2, backoff_initial_s=1.0, jitter_frac=0.0,
            clock=lambda: now[0], rng=random.Random(0))
        seen = []
        for step in ["fault", "fault", "allow", "tick", "allow", "fault",
                     "tick", "tick", "allow", "success", "allow"]:
            if step == "fault":
                sup.record_fault("dispatch")
            elif step == "success":
                sup.record_success()
            elif step == "tick":
                now[0] += 1.5
            else:
                seen.append(sup.allow_device())
            seen.append(sup.state)
        return seen

    assert walk(H) == walk(JH)


def test_scheme_table_and_lanes():
    bls = schemes.get("bls")
    assert bls.signing is not None and bls.field_bits == 381
    assert schemes.names() == ["blob_kzg", "bls", "ed25519"]
    assert schemes.get("ed25519").signing is None
    with pytest.raises(KeyError):
        schemes.get("secp256k1")
    from grandine_tpu.runtime.sign_plane import DEFAULT_SIGN_LANES as JL
    assert [(c.name, int(c.priority), c.max_batch, c.max_wait_s, c.max_queue,
             c.shed) for c in DEFAULT_SIGN_LANES] == [
        (c.name, int(c.priority), c.max_batch, c.max_wait_s, c.max_queue,
         c.shed) for c in JL]
