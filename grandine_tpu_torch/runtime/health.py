"""Backend health supervision for the device planes (counterpart of
grandine_tpu/runtime/health.py): an accelerator can fault on dispatch,
fault on readback, hang a settle forever, or return wrong verdicts while
raising nothing. Three cooperating pieces:

  circuit breaker — CLOSED → OPEN (consecutive-fault threshold or a full
      window's fault rate) → HALF_OPEN (after a capped, jittered
      exponential backoff) → CLOSED. While OPEN the plane skips the device
      and goes straight to the host path.
  canary probes — HALF_OPEN re-promotion is gated on known-answer batches
      holding BOTH a valid and a forged BLS specimen, run through the same
      async seam as real traffic, so a stuck-at-True device stays out.
      The verify scheduler installs one (`make_canary_probe`) for the
      first backend of a canary scheme (the `bls` row of gpu/schemes.py).
  settle watchdog — `run_with_deadline` bounds a device settle on an
      expendable daemon thread; on expiry the caller abandons it, degrades
      to the host path and files a breaker fault.

The verify scheduler and the signing plane each build a supervisor unless
one is injected; `metrics` and `flight` are fed where the reference feeds
them (the port has no metrics sink yet, so `metrics` may be None).
Import-light: the canary builds its specimens on first probe.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

# ---------------------------------------------------------------- states

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: gauge encoding for verify_breaker_state (README "Fault tolerance")
STATE_CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

#: breaker fault taxonomy (the `kind` label on verify_breaker_faults)
FAULT_KINDS = ("dispatch", "settle", "watchdog", "verdict")

# ------------------------------------------------------- async-seam shape

#: the canonical async device seam: a backend offering BOTH of these is
#: device-dispatchable by the verify plane (gpu/bls.py TorchBlsBackend
#: implements both; test fakes and the chaos wrapper implement them
#: structurally)
REQUIRED_SEAM_METHODS = (
    "fast_aggregate_verify_batch_async",
    "g2_subgroup_check_batch_async",
)


def has_async_seam(backend) -> bool:
    """True when `backend` structurally implements the async device
    seam the verify plane dispatches through."""
    return backend is not None and all(
        hasattr(backend, m) for m in REQUIRED_SEAM_METHODS
    )


# -------------------------------------------------------- settle watchdog

OK = "ok"
FAULT = "fault"
TIMEOUT = "timeout"


class SettleOutcome:
    """Result of a deadline-bounded settle: OK carries the value, FAULT
    carries the exception, TIMEOUT carries neither (the settle thread was
    abandoned and may still be running)."""

    __slots__ = ("status", "value", "error")

    def __init__(self, status: str, value=None, error=None) -> None:
        self.status = status
        self.value = value
        self.error = error

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SettleOutcome({self.status!r}, {self.value!r}, {self.error!r})"


def run_with_deadline(fn: Callable[[], object],
                      timeout_s: "Optional[float]",
                      thread_name: str = "settle-watchdog") -> SettleOutcome:
    """Run zero-arg `fn` with a hard deadline on an expendable daemon
    thread. On expiry the thread is ABANDONED (a hung device readback
    cannot be interrupted from Python) — it stays a daemon so it never
    blocks interpreter exit, and the caller gets TIMEOUT immediately.

    `timeout_s=None` runs inline with no watchdog (still converting an
    exception into a FAULT outcome)."""
    if timeout_s is None:
        try:
            return SettleOutcome(OK, value=fn())
        except Exception as e:
            return SettleOutcome(FAULT, error=e)
    box: dict = {}
    settled = threading.Event()

    def _run() -> None:
        # watchdog thread: sole writer of `box`; the caller reads it
        # only after `settled` fires (or abandons it on timeout)
        try:
            box["value"] = fn()
        except BaseException as e:
            box["error"] = e
        finally:
            settled.set()

    t = threading.Thread(target=_run, name=thread_name, daemon=True)
    t.start()
    if not settled.wait(timeout_s):
        return SettleOutcome(TIMEOUT)
    if "error" in box:
        return SettleOutcome(FAULT, error=box["error"])
    return SettleOutcome(OK, value=box["value"])


# ---------------------------------------------------------- canary probes


class CanarySpecimen:
    """One known-answer check: a message, a signature, the signer set,
    and the verdict a HEALTHY device must return. Probes always pair a
    valid specimen (expected True) with a forged one (expected False) so
    a stuck-at-True device fails re-promotion."""

    __slots__ = ("message", "signature", "public_keys", "expected")

    def __init__(self, message: bytes, signature, public_keys,
                 expected: bool) -> None:
        self.message = bytes(message)
        self.signature = signature
        self.public_keys = list(public_keys)
        self.expected = bool(expected)


def default_specimens() -> "list[CanarySpecimen]":
    """A real valid/forged specimen pair under the interop key of index 0
    (the reference's `interop_secret_key(0)`: keygen of the index's 32
    little-endian bytes with key info b"interop"), built lazily so
    importing this module never touches the crypto stack."""
    from grandine_tpu_torch.crypto import bls as A

    sk = A.SecretKey.keygen((0).to_bytes(32, "little"), b"interop")
    pk = sk.public_key()
    good_msg = b"\x2a" * 32
    sig_bytes = sk.sign(good_msg).to_bytes()
    # decompress WITHOUT the host subgroup check — the geometry the
    # scheduler hands the uncompressed device seam
    sig = A.Signature(A.g2_from_bytes(sig_bytes, subgroup_check=False))
    return [
        CanarySpecimen(good_msg, sig, [pk], expected=True),
        # the same (valid, in-subgroup) signature against a different
        # message: a pairing-skipping or stuck-verdict device answers
        # True here and fails the probe
        CanarySpecimen(b"\x2b" * 32, sig, [pk], expected=False),
    ]


def run_canary_detail(backend, specimens: "Sequence[CanarySpecimen]",
                      timeout_s: float = 5.0) -> "tuple[bool, Optional[str]]":
    """`run_canary` plus the FAULT_KINDS attribution of the first
    failure: (passed, None) on success, else (False, kind) where kind
    names what broke — dispatch exception, settle fault, watchdog
    expiry, or a wrong verdict. The flight recorder files the kind so a
    failed probe reads like the batch faults that provoked it."""
    if not has_async_seam(backend):
        return False, "dispatch"
    for spec in specimens:
        try:
            settle = backend.fast_aggregate_verify_batch_async(
                [spec.message], [spec.signature], [spec.public_keys]
            )
        except Exception:
            return False, "dispatch"
        outcome = run_with_deadline(settle, timeout_s, "canary-probe")
        if outcome.status == TIMEOUT:
            return False, "watchdog"
        if outcome.status != OK:
            return False, "settle"
        if bool(outcome.value) != spec.expected:
            return False, "verdict"
    return True, None


def run_canary(backend, specimens: "Sequence[CanarySpecimen]",
               timeout_s: float = 5.0) -> bool:
    """Dispatch each specimen through the backend's async seam and
    require the exact expected verdict within the deadline. Any dispatch
    exception, settle fault, timeout, or wrong verdict fails the probe."""
    return run_canary_detail(backend, specimens, timeout_s=timeout_s)[0]


def make_canary_probe(backend, specimens=None,
                      timeout_s: float = 5.0) -> Callable[[], bool]:
    """A zero-arg probe closure for CircuitBreaker(probe=...). Specimen
    construction is deferred to first probe so wiring a probe at
    scheduler construction costs nothing until the breaker half-opens.
    The closure exposes `last_fault` (a FAULT_KINDS member or None) so
    the breaker can attribute a failed probe in the flight timeline."""
    state: dict = {"specimens": specimens}

    def probe() -> bool:
        if state["specimens"] is None:
            state["specimens"] = default_specimens()
        passed, fault = run_canary_detail(
            backend, state["specimens"], timeout_s=timeout_s
        )
        probe.last_fault = fault
        return passed

    probe.last_fault = None
    return probe


# --------------------------------------------------------- circuit breaker


class CircuitBreaker:
    """CLOSED → OPEN → HALF_OPEN → CLOSED with canary-gated
    re-promotion.

    Opens on `fault_threshold` consecutive faults, or when a FULL
    sliding window of the last `window` outcomes shows a fault rate of
    at least `fault_rate` (a partial window never opens the breaker — a
    single early fault is not a rate). While OPEN, `allow()` is False
    until the capped, jittered exponential backoff expires; the first
    `allow()` after that moves to HALF_OPEN and runs the canary probe
    (pass → CLOSED, fail → re-OPEN with doubled backoff). With no probe
    configured, HALF_OPEN grants exactly one trial dispatch whose
    record_success/record_fault closes or re-opens the breaker.

    `clock` and `rng` are injectable for deterministic tests."""

    def __init__(
        self,
        name: str = "device",
        fault_threshold: int = 3,
        window: int = 16,
        fault_rate: float = 0.5,
        backoff_initial_s: float = 1.0,
        backoff_max_s: float = 60.0,
        jitter_frac: float = 0.1,
        probe: "Optional[Callable[[], bool]]" = None,
        metrics=None,
        flight=None,
        clock: Callable[[], float] = time.monotonic,
        rng: "Optional[random.Random]" = None,
    ) -> None:
        self.name = name
        self.fault_threshold = int(fault_threshold)
        self.window_size = int(window)
        self.fault_rate = float(fault_rate)
        self.backoff_initial_s = float(backoff_initial_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter_frac = float(jitter_frac)
        self.probe = probe
        self.metrics = metrics
        #: optional FlightRecorder: breaker transitions and canary
        #: probes land in the same timeline as the batches around them
        self.flight = flight
        self.clock = clock
        self.rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._window: deque = deque(maxlen=self.window_size)
        self._backoff_s = 0.0
        self._retry_at = 0.0
        self._probing = False  # one prober at a time
        self._trial = False  # probe-less HALF_OPEN: one trial dispatch
        self.stats = {
            "opens": 0, "closes": 0, "probes_passed": 0,
            "probes_failed": 0,
            "faults": {k: 0 for k in FAULT_KINDS},
        }
        self._publish_state(CLOSED, transition=False)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller dispatch to the device right now? Runs the
        canary probe (outside the lock) when the breaker is due for
        HALF_OPEN re-promotion."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock() < self._retry_at:
                    return False
                self._enter(HALF_OPEN)
            # HALF_OPEN from here on
            if self.probe is None:
                if self._trial:
                    return False
                self._trial = True
                return True
            if self._probing:
                return False
            self._probing = True
            probe = self.probe
        t_probe = time.perf_counter()
        try:
            passed = bool(probe())
        except Exception:
            passed = False
        if self.flight is not None:
            self.flight.record_canary(
                self.name, passed,
                duration_s=time.perf_counter() - t_probe,
                fault=None if passed else getattr(
                    probe, "last_fault", None
                ),
            )
        with self._lock:
            self._probing = False
            if self._state != HALF_OPEN:
                # a concurrent record_fault re-opened us mid-probe
                return False
            if passed:
                self.stats["probes_passed"] += 1
                self._count_probe("pass")
                self._close()
                return True
            self.stats["probes_failed"] += 1
            self._count_probe("fail")
            self._reopen()
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._window.append(False)
            if self._state == HALF_OPEN:
                self._close()

    def ensure_probe(self, probe: "Callable[[], bool]") -> None:
        """Install `probe` if none is configured yet — first writer wins,
        atomically. Concurrent lazy backend builds race to register their
        canary; `allow()` reads `probe` under the same lock."""
        with self._lock:
            if self.probe is None:
                self.probe = probe

    def record_fault(self, kind: str = "settle") -> None:
        with self._lock:
            faults = self.stats["faults"]
            faults[kind] = faults.get(kind, 0) + 1
            if self.metrics is not None:
                self.metrics.verify_breaker_faults.inc(self.name, kind)
            self._consecutive += 1
            self._window.append(True)
            if self._state == HALF_OPEN:
                self._reopen()
                return
            if self._state != CLOSED:
                return
            full = len(self._window) == self.window_size
            rate = (
                sum(self._window) / len(self._window) if self._window else 0.0
            )
            if self._consecutive >= self.fault_threshold or (
                full and rate >= self.fault_rate
            ):
                self._reopen()

    # ------------------------------------------------- internal (locked)

    def _close(self) -> None:
        self._consecutive = 0
        self._window.clear()
        self._backoff_s = 0.0
        self._trial = False
        self.stats["closes"] += 1
        self._enter(CLOSED)

    def _reopen(self) -> None:
        if self._backoff_s <= 0.0:
            self._backoff_s = self.backoff_initial_s
        else:
            self._backoff_s = min(self._backoff_s * 2.0, self.backoff_max_s)
        jitter = 1.0 + self.jitter_frac * (2.0 * self.rng.random() - 1.0)
        self._retry_at = self.clock() + self._backoff_s * jitter
        self._trial = False
        self.stats["opens"] += 1
        self._enter(OPEN)

    def _enter(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        self._publish_state(state, transition=True)
        if self.flight is not None:
            self.flight.record_breaker(self.name, state)

    def _publish_state(self, state: str, transition: bool) -> None:
        if self.metrics is None:
            return
        name = self.name
        self.metrics.verify_breaker_state.set(
            name, value=STATE_CODES[state]
        )
        if transition:
            self.metrics.verify_breaker_transitions.inc(name, state)

    def _count_probe(self, result: str) -> None:
        if self.metrics is not None:
            self.metrics.verify_canary_probes.inc(self.name, result)


# ----------------------------------------------------- health supervisor


class BackendHealthSupervisor:
    """The one object the verify plane talks to: breaker gating
    (`allow_device`), fault/success accounting, and deadline-bounded
    settles (`guard_settle`). One supervisor may be shared by several
    planes, so that a fault on either quarantines the device for both."""

    def __init__(
        self,
        metrics=None,
        settle_timeout_s: float = 5.0,
        probe: "Optional[Callable[[], bool]]" = None,
        name: str = "device",
        fault_threshold: int = 3,
        window: int = 16,
        fault_rate: float = 0.5,
        backoff_initial_s: float = 1.0,
        backoff_max_s: float = 60.0,
        jitter_frac: float = 0.1,
        flight=None,
        clock: Callable[[], float] = time.monotonic,
        rng: "Optional[random.Random]" = None,
    ) -> None:
        self.metrics = metrics
        self.flight = flight
        self.settle_timeout_s = float(settle_timeout_s)
        self.breaker = CircuitBreaker(
            name=name,
            fault_threshold=fault_threshold,
            window=window,
            fault_rate=fault_rate,
            backoff_initial_s=backoff_initial_s,
            backoff_max_s=backoff_max_s,
            jitter_frac=jitter_frac,
            probe=probe,
            metrics=metrics,
            flight=flight,
            clock=clock,
            rng=rng,
        )

    @property
    def state(self) -> str:
        return self.breaker.state

    def allow_device(self) -> bool:
        return self.breaker.allow()

    def record_success(self) -> None:
        self.breaker.record_success()

    def record_fault(self, kind: str = "settle") -> None:
        self.breaker.record_fault(kind)

    def ensure_probe(self, probe: Callable[[], bool]) -> None:
        """Install a canary probe if none is configured yet (the lazily
        built real backend registers itself here; injected test backends
        keep whatever the test wired). Delegates to the breaker so the
        check-then-set is atomic under the breaker's lock."""
        self.breaker.ensure_probe(probe)

    def guard_settle(self, settle: Callable[[], object],
                     timeout_s: "Optional[float]" = None,
                     thread_name: str = "verify-settle-watchdog"
                     ) -> SettleOutcome:
        """Run a device settle under the watchdog deadline."""
        if timeout_s is None:
            timeout_s = self.settle_timeout_s
        return run_with_deadline(settle, timeout_s, thread_name)


__all__ = [
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
    "STATE_CODES",
    "FAULT_KINDS",
    "REQUIRED_SEAM_METHODS",
    "OK",
    "FAULT",
    "TIMEOUT",
    "BackendHealthSupervisor",
    "CanarySpecimen",
    "CircuitBreaker",
    "SettleOutcome",
    "default_specimens",
    "has_async_seam",
    "make_canary_probe",
    "run_canary",
    "run_canary_detail",
    "run_with_deadline",
]
