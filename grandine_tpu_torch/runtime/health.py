"""Backend health supervision (counterpart of grandine_tpu/runtime/
health.py:68-524): the circuit breaker and the settle watchdog that the
signing plane consults before and around each device batch.

  circuit breaker — CLOSED → OPEN (consecutive-fault threshold or a full
      window's fault rate) → HALF_OPEN (after a capped, jittered
      exponential backoff) → CLOSED. While OPEN the plane skips the device
      and signs on the host.
  settle watchdog — `run_with_deadline` bounds a device call on an
      expendable daemon thread; on expiry the caller abandons it, degrades
      to the host path and files a breaker fault.

Re-promotion from HALF_OPEN runs the breaker's `probe` when one is given,
else grants one trial dispatch. The JAX package's known-answer canary
probes (grandine_tpu/runtime/health.py:139-233) come with the verify
scheduler's wiring; no metrics sink is ported yet, so `metrics` is
accepted and may be None.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: breaker fault taxonomy
FAULT_KINDS = ("dispatch", "settle", "watchdog", "verdict")

# -------------------------------------------------------- settle watchdog

OK = "ok"
FAULT = "fault"
TIMEOUT = "timeout"


class SettleOutcome:
    """Result of a deadline-bounded settle: OK carries the value, FAULT
    the exception, TIMEOUT neither (the settle thread was abandoned and
    may still be running)."""

    __slots__ = ("status", "value", "error")

    def __init__(self, status: str, value=None, error=None) -> None:
        self.status = status
        self.value = value
        self.error = error


def run_with_deadline(fn: Callable[[], object],
                      timeout_s: "Optional[float]",
                      thread_name: str = "settle-watchdog") -> SettleOutcome:
    """Run zero-arg `fn` with a hard deadline on an expendable daemon
    thread; on expiry the thread is abandoned (a hung device readback
    cannot be interrupted from Python) and the caller gets TIMEOUT at
    once. `timeout_s=None` runs inline, still turning an exception into
    FAULT."""
    if timeout_s is None:
        try:
            return SettleOutcome(OK, value=fn())
        except Exception as e:
            return SettleOutcome(FAULT, error=e)
    box: dict = {}
    settled = threading.Event()

    def _run() -> None:
        # the sole writer of `box`; the caller reads it after `settled`
        try:
            box["value"] = fn()
        except BaseException as e:
            box["error"] = e
        finally:
            settled.set()

    threading.Thread(target=_run, name=thread_name, daemon=True).start()
    if not settled.wait(timeout_s):
        return SettleOutcome(TIMEOUT)
    if "error" in box:
        return SettleOutcome(FAULT, error=box["error"])
    return SettleOutcome(OK, value=box["value"])


# --------------------------------------------------------- circuit breaker


class CircuitBreaker:
    """CLOSED → OPEN → HALF_OPEN → CLOSED.

    Opens on `fault_threshold` consecutive faults, or when a FULL sliding
    window of the last `window` outcomes shows a fault rate of at least
    `fault_rate`. While OPEN, `allow()` is False until the backoff
    expires; the first `allow()` after that moves to HALF_OPEN and runs
    `probe` (pass → CLOSED, fail → OPEN with doubled backoff), or with no
    probe grants exactly one trial dispatch whose outcome closes or
    re-opens the breaker. `clock` and `rng` are injectable for tests."""

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
            "opens": 0, "closes": 0, "probes_passed": 0, "probes_failed": 0,
            "faults": {k: 0 for k in FAULT_KINDS},
        }

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller dispatch to the device now? Runs the probe
        (outside the lock) when the breaker is due for re-promotion."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock() < self._retry_at:
                    return False
                self._state = HALF_OPEN
            if self.probe is None:
                if self._trial:
                    return False
                self._trial = True
                return True
            if self._probing:
                return False
            self._probing = True
            probe = self.probe
        try:
            passed = bool(probe())
        except Exception:
            passed = False
        with self._lock:
            self._probing = False
            if self._state != HALF_OPEN:
                return False  # a concurrent record_fault re-opened us
            if passed:
                self.stats["probes_passed"] += 1
                self._close()
                return True
            self.stats["probes_failed"] += 1
            self._reopen()
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._window.append(False)
            if self._state == HALF_OPEN:
                self._close()

    def record_fault(self, kind: str = "settle") -> None:
        with self._lock:
            faults = self.stats["faults"]
            faults[kind] = faults.get(kind, 0) + 1
            self._consecutive += 1
            self._window.append(True)
            if self._state == HALF_OPEN:
                self._reopen()
                return
            if self._state != CLOSED:
                return
            full = len(self._window) == self.window_size
            rate = sum(self._window) / len(self._window)
            if self._consecutive >= self.fault_threshold or (
                    full and rate >= self.fault_rate):
                self._reopen()

    # -- under the lock --------------------------------------------------

    def _close(self) -> None:
        self._consecutive = 0
        self._window.clear()
        self._backoff_s = 0.0
        self._trial = False
        self.stats["closes"] += 1
        self._state = CLOSED

    def _reopen(self) -> None:
        self._backoff_s = (self.backoff_initial_s if self._backoff_s <= 0.0
                           else min(self._backoff_s * 2.0, self.backoff_max_s))
        jitter = 1.0 + self.jitter_frac * (2.0 * self.rng.random() - 1.0)
        self._retry_at = self.clock() + self._backoff_s * jitter
        self._trial = False
        self.stats["opens"] += 1
        self._state = OPEN


class BackendHealthSupervisor:
    """What the signing plane talks to: breaker gating (`allow_device`),
    fault and success accounting, and deadline-bounded device calls
    (`guard_settle`)."""

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
        clock: Callable[[], float] = time.monotonic,
        rng: "Optional[random.Random]" = None,
    ) -> None:
        self.metrics = metrics
        self.settle_timeout_s = float(settle_timeout_s)
        self.breaker = CircuitBreaker(
            name=name, fault_threshold=fault_threshold, window=window,
            fault_rate=fault_rate, backoff_initial_s=backoff_initial_s,
            backoff_max_s=backoff_max_s, jitter_frac=jitter_frac,
            probe=probe, clock=clock, rng=rng)

    @property
    def state(self) -> str:
        return self.breaker.state

    def allow_device(self) -> bool:
        return self.breaker.allow()

    def record_success(self) -> None:
        self.breaker.record_success()

    def record_fault(self, kind: str = "settle") -> None:
        self.breaker.record_fault(kind)

    def guard_settle(self, settle: Callable[[], object],
                     timeout_s: "Optional[float]" = None,
                     thread_name: str = "verify-settle-watchdog"
                     ) -> SettleOutcome:
        """Run a device call under the watchdog deadline."""
        return run_with_deadline(
            settle, self.settle_timeout_s if timeout_s is None else timeout_s,
            thread_name)


__all__ = [
    "CLOSED", "OPEN", "HALF_OPEN", "FAULT_KINDS", "OK",
    "FAULT", "TIMEOUT", "BackendHealthSupervisor", "CircuitBreaker",
    "SettleOutcome", "run_with_deadline",
]
