"""Flight recorder (counterpart of grandine_tpu/runtime/flight.py
`BatchRecord` :124, `FlightRecorder` :313), cut to what the signing plane
calls: `begin_batch` opens a batch's record, `record_shed` files jobs
that never reached the device, and `device_enter` / `device_exit`
bracket device work so the recorder integrates the time with a batch on
the device (`duty_cycle`). Records land in a bounded ring (`snapshot`).
The SLO attribution, canary and breaker events, fill histograms, origin
table and metrics of the JAX recorder come with the verify scheduler's
wiring.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

#: records the ring keeps
CAPACITY = 4096


class BatchRecord:
    """One batch on the timeline: its lane, kernel, size, where its time
    went, its fault and verdict; a shed record names its cause."""

    __slots__ = ("seq", "t", "lane", "kernel", "items", "queue_wait_s",
                 "device_s", "host_s", "verdict", "fault", "breaker_state",
                 "slo_cause", "note")

    def __init__(self, lane: str) -> None:
        self.seq = 0
        self.t = 0.0
        self.lane = lane
        self.kernel = ""
        self.items = 0
        self.queue_wait_s = 0.0
        self.device_s = 0.0
        self.host_s = 0.0
        self.verdict: "Optional[bool]" = None
        self.fault: "Optional[str]" = None
        self.breaker_state = ""
        self.slo_cause: "Optional[str]" = None
        self.note = ""


class BatchFlight:
    """One batch's record while the batch runs; `finish` commits it once.
    Called from the one thread that owns the batch, so no lock here."""

    __slots__ = ("record", "_recorder", "_done")

    def __init__(self, recorder: "FlightRecorder", record: BatchRecord) -> None:
        self.record = record
        self._recorder = recorder
        self._done = False

    def note_device(self, seconds: float) -> None:
        self.record.device_s += max(0.0, seconds)

    def note_host(self, seconds: float) -> None:
        self.record.host_s += max(0.0, seconds)

    def note_fault(self, kind: str) -> None:
        # the first fault names what pushed the batch off the fast path
        if self.record.fault is None:
            self.record.fault = kind
        else:
            note = self.record.note
            self.record.note = f"{note}+{kind}" if note else f"also_{kind}"

    def finish(self, verdict: "Optional[bool]") -> None:
        if self._done:
            return
        self._done = True
        self.record.verdict = verdict
        self._recorder._append(self.record)


class FlightRecorder:
    """The bounded ring of batch records and the device's busy time."""

    def __init__(self) -> None:
        self._ring: "list[Optional[BatchRecord]]" = [None] * CAPACITY
        self._lock = threading.Lock()
        self._seq = 0
        self._t0 = time.monotonic()
        self._inflight = 0
        self._busy_since = 0.0
        self._busy_total = 0.0

    def begin_batch(self, lane: str, kernel: str, items: int,
                    queue_wait_s: float = 0.0,
                    breaker_state: str = "") -> BatchFlight:
        """Open one batch's record at dispatch time."""
        rec = BatchRecord(lane)
        rec.kernel = kernel
        rec.items = int(items)
        rec.queue_wait_s = max(0.0, float(queue_wait_s))
        rec.breaker_state = breaker_state
        return BatchFlight(self, rec)

    def record_shed(self, lane: str, items: int, cause: str) -> None:
        """Jobs that never reached a device dispatch, e.g. a deadline
        expiry (`cause="expired"`)."""
        rec = BatchRecord(lane)
        rec.items = int(items)
        rec.verdict = False
        rec.slo_cause = cause
        rec.note = "shed"
        self._append(rec)

    def device_enter(self) -> None:
        """One batch entered the device."""
        now = time.monotonic()
        with self._lock:
            if self._inflight == 0:
                self._busy_since = now
            self._inflight += 1

    def device_exit(self) -> None:
        """One batch left the device."""
        now = time.monotonic()
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1
                if self._inflight == 0:
                    self._busy_total += now - self._busy_since

    def duty_cycle(self) -> float:
        """Share of the wall time since construction with at least one
        batch between `device_enter` and `device_exit`."""
        now = time.monotonic()
        with self._lock:
            busy = self._busy_total + (now - self._busy_since
                                       if self._inflight else 0.0)
        elapsed = now - self._t0
        return min(1.0, busy / elapsed) if elapsed > 0 else 0.0

    def _append(self, rec: BatchRecord) -> None:
        with self._lock:
            rec.seq = self._seq
            rec.t = time.monotonic() - self._t0
            self._ring[self._seq % CAPACITY] = rec
            self._seq += 1

    def snapshot(self, lane: "Optional[str]" = None) -> "list[BatchRecord]":
        """The newest records, oldest first, optionally of one lane."""
        with self._lock:
            seq, ring = self._seq, list(self._ring)
        out = []
        for s in range(seq - min(seq, CAPACITY), seq):
            rec = ring[s % CAPACITY]
            if rec is not None and rec.seq == s and (
                    lane is None or rec.lane == lane):
                out.append(rec)
        return out


__all__ = ["CAPACITY", "BatchFlight", "BatchRecord", "FlightRecorder"]
