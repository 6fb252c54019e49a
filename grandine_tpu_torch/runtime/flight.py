"""Verify-plane flight recorder (counterpart of grandine_tpu/runtime/
flight.py): one bounded timeline of per-batch `BatchRecord`s for the
verify scheduler and the signing plane, with the health plane's canary and
breaker events in the SAME timeline, so a fault → breaker-open → probe →
re-close sequence reads as consecutive records. On top of the ring:

  SLO tracker      — each settled batch is compared against its lane's
                     deadline budget; a miss names its dominant cause
                     (queue_wait, device, bisection, breaker_open; sheds
                     carry expired or brownout) — a closed enum,
                     SLO_CAUSES.
  fill accounting  — each record's items against the pow-2 bucket the
                     batch pads into (fill and padding waste metrics).
  origin table     — failing jobs attribute their gossip peer/validator
                     origin into a bounded top-K table (space-saving
                     eviction). Origins live only here, never in a metric
                     label.
  duty cycle       — device_enter/device_exit bracket on-device work; the
                     recorder integrates busy time and in-flight depth.

`metrics` is fed exactly where the reference feeds it; the port has no
metrics sink yet, so it may be None. Left out: the reference's per-record
`recompile` flag (`_recompile_count`, a count of the JAX shape ledger's
post-warmup recompiles: the port compiles its kernels once, at build
time, and has no counterpart), its kernel-profiler hook, and the
`summary()` aggregates and `as_dict` rows of its bench line and debug
endpoint, which the port has neither of.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# ------------------------------------------------------------------ enums

#: records the ring keeps by default
CAPACITY = 4096

#: record kinds sharing the flight timeline
BATCH = "batch"
CANARY = "canary"
BREAKER = "breaker"
RECORD_KINDS = (BATCH, CANARY, BREAKER)

#: the CLOSED cause enum on verify_slo_miss_total: `_slo_cause` below
#: can only return members, and `record_shed` maps any other to
#: "brownout".
#: `expired` = a ticket's absolute deadline passed before dispatch and
#: it was shed un-dispatched; `brownout` = overload control shed it —
#: shed-oldest overflow, or a CRITICAL-level submit refusal.
SLO_CAUSES = ("queue_wait", "device", "bisection", "breaker_open",
              "expired", "brownout")

#: per-lane deadline budgets (seconds, enqueue→settle). HIGH scheduler
#: lanes sit on the block-import path; the attestation budget is the
#: spec's 4 s gossip propagation window; replay windows are wall-time
#: bounded only by throughput targets.
DEFAULT_SLO_BUDGETS = {
    "block": 0.5,
    "blob_header": 0.5,
    "sync_contribution": 0.5,
    "sync_message": 1.0,
    "slashing": 2.0,
    "exit": 2.0,
    "bls_change": 2.0,
    # suspect-origin traffic: correctness matters, latency does not —
    # small batches from quarantined origins may wait behind every
    # honest lane
    "quarantine": 5.0,
    "attestation": 4.0,
    "replay": 120.0,
    # slasher span ingestion: keep-up is throughput-gated (span-update
    # rate ≥ attestation arrival rate), but any single batch blowing the
    # gossip window means detections lag the chain
    "slasher": 4.0,
}
DEFAULT_SLO_BUDGET_S = 4.0  # unknown lanes


def bucket_of(items: int) -> int:
    """The pow-2 device bucket `items` pads into (the shape the kernel
    buckets; the card pads its batches the same way)."""
    n = max(1, int(items))
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------- records


class BatchRecord:
    """One flight-timeline event. `kind=BATCH` rows carry the full
    per-batch story; CANARY/BREAKER rows reuse the shape (lane="health",
    fault/verdict describing the probe or the entered state) so the
    whole verify plane reads as one ordered sequence."""

    __slots__ = (
        "seq", "t", "kind", "lane", "kernel", "items", "bucket", "fill",
        "queue_wait_s", "device_s", "host_s", "bisect_s", "verdict",
        "fault", "retries", "bisect_depth", "breaker_state",
        "slo_miss", "slo_cause", "origin", "note", "devices",
        "quarantined", "brownout",
    )

    def __init__(self, kind: str, lane: str) -> None:
        self.seq = 0
        self.t = 0.0
        self.kind = kind
        self.lane = lane
        self.kernel = ""
        self.items = 0
        self.bucket = 0
        self.fill = 0.0
        self.queue_wait_s = 0.0
        self.device_s = 0.0
        self.host_s = 0.0
        self.bisect_s = 0.0
        self.verdict: "Optional[bool]" = None
        self.fault: "Optional[str]" = None
        self.retries = 0
        self.bisect_depth = 0
        self.breaker_state = ""
        self.slo_miss = False
        self.slo_cause: "Optional[str]" = None
        self.origin: "Optional[str]" = None
        self.note = ""
        #: mesh width the batch dispatched over (a record FIELD, never a
        #: Prometheus label — per-device label cardinality is forbidden)
        self.devices = 1
        #: True for quarantine-lane batches (suspect-origin traffic
        #: isolated from honest batches — runtime/isolation.py)
        self.quarantined = False
        #: the brownout level ("normal" until a brownout controller sets
        #: `FlightRecorder.brownout_level`) in force when
        #: the record committed — every shed reads its causing level
        #: straight off the timeline
        self.brownout = "normal"

    def total_s(self) -> float:
        return self.queue_wait_s + self.device_s + self.host_s + self.bisect_s



class BatchFlight:
    """Mutable per-batch accumulator the emission sites thread through a
    batch's life (dispatch → settle → bisection → deliver); `finish`
    hands the completed record to the recorder exactly once. All methods
    are called from the single thread that owns the batch at that stage,
    so no locking here."""

    __slots__ = ("record", "_recorder", "_done")

    def __init__(self, recorder: "FlightRecorder", record: BatchRecord) -> None:
        self.record = record
        self._recorder = recorder
        self._done = False

    def note_device(self, seconds: float) -> None:
        self.record.device_s += max(0.0, seconds)

    def note_host(self, seconds: float) -> None:
        self.record.host_s += max(0.0, seconds)

    def note_bisect(self, seconds: float, depth: int = 0) -> None:
        self.record.bisect_s += max(0.0, seconds)
        self.record.bisect_depth = max(self.record.bisect_depth, int(depth))

    def note_retry(self) -> None:
        self.record.retries += 1

    def note_fault(self, kind: str) -> None:
        # first fault wins the record's `fault` field (it names what
        # pushed the batch off the fast path); a secondary fault — a
        # hang on the RETRY of an already-faulted batch — stays visible
        # in the note and in the recorder's aggregate fault counts
        if self.record.fault is None:
            self.record.fault = kind
        else:
            note = self.record.note
            self.record.note = f"{note}+{kind}" if note else f"also_{kind}"

    def note_origin_failure(self, origin: "Optional[str]") -> None:
        if origin:
            self.record.origin = origin
            self._recorder.note_origin_failure(origin)

    def finish(self, verdict: "Optional[bool]") -> None:
        if self._done:
            return
        self._done = True
        self.record.verdict = verdict
        self._recorder._commit(self.record)


class OriginTable:
    """Bounded top-K failing-origin counters with space-saving (Misra-
    Gries) eviction: a NEW origin arriving at capacity replaces the
    minimum-count entry and inherits its count (+1), so the true
    heaviest offenders survive adversarial churn of one-shot origins and
    the table never exceeds `capacity` entries. `error` on a snapshot
    row bounds the inherited over-count."""

    __slots__ = ("capacity", "_counts", "_errors", "_lock")

    def __init__(self, capacity: int = 32) -> None:
        self.capacity = max(1, int(capacity))
        self._counts: "dict[str, int]" = {}
        self._errors: "dict[str, int]" = {}
        self._lock = threading.Lock()

    def note_failure(self, origin: str, count: int = 1) -> None:
        origin = str(origin)
        with self._lock:
            if origin in self._counts:
                self._counts[origin] += count
                return
            if len(self._counts) < self.capacity:
                self._counts[origin] = count
                self._errors[origin] = 0
                return
            victim = min(self._counts, key=self._counts.__getitem__)
            floor = self._counts.pop(victim)
            self._errors.pop(victim, None)
            self._counts[origin] = floor + count
            self._errors[origin] = floor

    def snapshot(self) -> "list[dict]":
        with self._lock:
            rows = [
                {"origin": o, "failures": c, "error": self._errors.get(o, 0)}
                for o, c in self._counts.items()
            ]
        rows.sort(key=lambda r: (-r["failures"], r["origin"]))
        return rows

    def __len__(self) -> int:
        with self._lock:
            return len(self._counts)


# --------------------------------------------------------------- recorder


class FlightRecorder:
    """The bounded flight-timeline ring plus the SLO/fill/origin/duty
    derivations. One recorder can be shared by the verify scheduler, the
    signing plane and the health supervisor; each constructs a private one
    when none is injected, so recording is always on."""

    def __init__(
        self,
        capacity: int = CAPACITY,
        metrics=None,
        slo_budgets: "Optional[dict]" = None,
        default_budget_s: float = DEFAULT_SLO_BUDGET_S,
        origin_top_k: int = 32,
        clock=time.monotonic,
    ) -> None:
        self.capacity = max(16, int(capacity))
        self.metrics = metrics
        self.clock = clock
        self.slo_budgets = dict(DEFAULT_SLO_BUDGETS)
        if slo_budgets:
            self.slo_budgets.update(
                {str(k): float(v) for k, v in slo_budgets.items()}
            )
        self.default_budget_s = float(default_budget_s)
        self.origins = OriginTable(origin_top_k)
        #: the brownout level stamped on every committed record — poked
        #: by the BrownoutController on each transition (a torn read
        #: only mis-stamps one record's level by one tick)
        self.brownout_level = "normal"
        #: ring storage: preallocated slots, one short-hold lock around
        #: index bumps and duty-cycle accounting — record assembly and
        #: SLO attribution happen outside it
        self._ring: "list[Optional[BatchRecord]]" = [None] * self.capacity
        self._lock = threading.Lock()
        self._seq = 0
        #: duty cycle / occupancy integrals
        self._t0 = self.clock()
        self._inflight = 0
        self._busy_since = 0.0
        self._busy_total = 0.0
        self._occ_mark = self._t0
        self._occ_integral = 0.0

    # ------------------------------------------------------------ batches

    def begin_batch(self, lane: str, kernel: str, items: int,
                    queue_wait_s: float = 0.0,
                    breaker_state: str = "",
                    devices: int = 1,
                    quarantined: bool = False) -> BatchFlight:
        """Open one batch's flight context at dispatch time. Fill/waste
        are derived from the pow-2 bucket the device actually pads to."""
        rec = BatchRecord(BATCH, lane)
        rec.kernel = kernel
        rec.items = int(items)
        rec.bucket = bucket_of(items)
        rec.fill = rec.items / rec.bucket if rec.bucket else 0.0
        rec.queue_wait_s = max(0.0, float(queue_wait_s))
        rec.breaker_state = breaker_state
        rec.devices = max(1, int(devices))
        rec.quarantined = bool(quarantined)
        return BatchFlight(self, rec)

    def _slo_cause(self, rec: BatchRecord) -> str:
        """Attribute a miss to its dominant component. Breaker-open
        skips win outright (the batch never had a device chance); a
        device fault's forced host pass charges to "device" (the device
        caused it), bisection time to "bisection"."""
        if rec.breaker_state == "open" and rec.device_s == 0.0:
            return "breaker_open"
        exec_s = rec.device_s + rec.host_s
        if rec.bisect_s > exec_s and rec.bisect_s > rec.queue_wait_s:
            return "bisection"
        if exec_s >= rec.queue_wait_s:
            return "device"
        return "queue_wait"

    def _commit(self, rec: BatchRecord) -> None:
        """Finalize one batch record: SLO attribution, fill/waste
        accounting, metrics, and the ring append."""
        budget = self.slo_budgets.get(rec.lane, self.default_budget_s)
        if rec.total_s() > budget:
            rec.slo_miss = True
            rec.slo_cause = self._slo_cause(rec)
        m = self.metrics
        if m is not None:
            if rec.slo_miss:
                m.verify_slo_miss.inc(rec.lane, rec.slo_cause)
            if rec.kernel:
                m.verify_bucket_fill.observe(rec.kernel, value=rec.fill)
                m.verify_padding_waste.inc(
                    rec.kernel, amount=rec.bucket - rec.items
                )
        with self._lock:
            self._append_locked(rec)

    # ------------------------------------------------- health-plane events

    def record_canary(self, backend: str, passed: bool,
                      duration_s: float = 0.0,
                      fault: "Optional[str]" = None) -> None:
        """A HALF_OPEN canary probe, in the same timeline as the batches
        whose faults provoked it."""
        rec = BatchRecord(CANARY, "health")
        rec.kernel = backend
        rec.device_s = max(0.0, float(duration_s))
        rec.verdict = bool(passed)
        rec.fault = fault
        rec.note = "probe_pass" if passed else "probe_fail"
        with self._lock:
            self._append_locked(rec)

    def record_breaker(self, backend: str, state: str) -> None:
        """A breaker state transition (entered `state`)."""
        rec = BatchRecord(BREAKER, "health")
        rec.kernel = backend
        rec.breaker_state = state
        rec.note = f"breaker_{state}"
        with self._lock:
            self._append_locked(rec)

    def note_origin_failure(self, origin: str, count: int = 1) -> None:
        self.origins.note_failure(origin, count)

    def record_shed(self, lane: str, items: int, cause: str) -> None:
        """One shed event: jobs that never reached a device dispatch —
        a deadline expiry (`cause="expired"`) or an overload-control
        drop (`cause="brownout"`). The record joins the timeline with
        the brownout level stamped on, so every shed is attributable,
        and feeds the SLO-miss aggregates (the brownout controller's
        own escalation feed) — but not the dispatched-batch count."""
        rec = BatchRecord(BATCH, lane)
        rec.items = int(items)
        rec.verdict = False
        rec.slo_miss = True
        rec.slo_cause = cause if cause in SLO_CAUSES else "brownout"
        rec.note = "shed"
        m = self.metrics
        if m is not None:
            m.verify_slo_miss.inc(rec.lane, rec.slo_cause)
        with self._lock:
            self._append_locked(rec)

    # -------------------------------------------------- duty cycle gauges

    def device_enter(self) -> None:
        """One batch entered the device (dispatch handed off)."""
        now = self.clock()
        with self._lock:
            self._occ_integral += self._inflight * (now - self._occ_mark)
            self._occ_mark = now
            if self._inflight == 0:
                self._busy_since = now
            self._inflight += 1

    def device_exit(self) -> None:
        """One batch left the device (settle forced)."""
        now = self.clock()
        with self._lock:
            self._occ_integral += self._inflight * (now - self._occ_mark)
            self._occ_mark = now
            if self._inflight > 0:
                self._inflight -= 1
                if self._inflight == 0:
                    self._busy_total += now - self._busy_since
            duty = self._duty_locked(now)
            occ = self._occupancy_locked(now)
        if self.metrics is not None:
            self.metrics.verify_device_duty_cycle.set(duty)
            self.metrics.verify_pipeline_occupancy.set(occ)

    def _duty_locked(self, now: float) -> float:
        elapsed = now - self._t0
        if elapsed <= 0.0:
            return 0.0
        busy = self._busy_total
        if self._inflight > 0:
            busy += now - self._busy_since
        return min(1.0, busy / elapsed)

    def _occupancy_locked(self, now: float) -> float:
        elapsed = now - self._t0
        if elapsed <= 0.0:
            return 0.0
        return (
            self._occ_integral + self._inflight * (now - self._occ_mark)
        ) / elapsed

    def duty_cycle(self) -> float:
        with self._lock:
            return self._duty_locked(self.clock())

    def occupancy(self) -> float:
        with self._lock:
            return self._occupancy_locked(self.clock())

    # ----------------------------------------------------------- the ring

    def _append_locked(self, rec: BatchRecord) -> None:
        rec.seq = self._seq
        rec.t = self.clock() - self._t0
        rec.brownout = self.brownout_level
        self._ring[self._seq % self.capacity] = rec
        self._seq += 1

    def snapshot(self, lane: "Optional[str]" = None,
                 n: "Optional[int]" = None,
                 kind: "Optional[str]" = None) -> "list[BatchRecord]":
        """The newest records, oldest-first, optionally filtered by lane
        and/or kind and truncated to the newest `n` AFTER filtering.
        Safe against concurrent recording: the slot list is copied under
        the lock; records are immutable once committed."""
        with self._lock:
            seq = self._seq
            ring = list(self._ring)
        count = min(seq, self.capacity)
        out: "list[BatchRecord]" = []
        for s in range(seq - count, seq):
            rec = ring[s % self.capacity]
            # a slot being overwritten mid-copy shows a newer seq; skip
            # anything that does not match its expected position
            if rec is None or rec.seq != s:
                continue
            if lane is not None and rec.lane != lane:
                continue
            if kind is not None and rec.kind != kind:
                continue
            out.append(rec)
        if n is not None:
            n = max(0, int(n))
            out = out[-n:] if n else []
        return out

__all__ = [
    "BATCH",
    "CAPACITY",
    "BREAKER",
    "CANARY",
    "BatchFlight",
    "BatchRecord",
    "DEFAULT_SLO_BUDGETS",
    "FlightRecorder",
    "OriginTable",
    "RECORD_KINDS",
    "SLO_CAUSES",
    "bucket_of",
]
