"""Fault localization of a failed verify batch on the card and per-origin
quarantine reputation (counterpart of grandine_tpu/runtime/isolation.py
FANOUT, ladder, max_device_passes, FaultLocalizer and ReputationTable;
the AdmissionController comes with the rest of the overload plane).

A gossip batch's verdict is one bool: one forged aggregate rejects the
whole batch. `FaultLocalizer.localize` turns the failed batch into
per-item verdicts with a bounded number of device passes — one per-item
G2 subgroup pass (`g2_subgroup_check_batch_async`), then a fixed-fanout
descent of `rlc_partition_verify_async` passes over group counts
FANOUT, FANOUT², … up to the bucket (`ladder`) — and host checks of only
the leaves the device named bad at the per-item rung, so a trickle of
forgeries costs a few device passes rather than host verification of
every item.

As in the reference, a device fault mid-descent — a dispatch or settle
that raises, a watchdog expiry, an open breaker — files the fault with
the health supervisor (`health=`) and sweeps the remaining suspects on the
host, the plane's degradation target everywhere; so does an expired
deadline. Each sweep is counted (`passes["host"]`), so a caller that
requires the card can see that it was bypassed; the fault itself is
raised by the seam, never swapped inside a wrapper for its plain version.

`ReputationTable` holds the decaying per-origin quarantine state the
verify scheduler routes on: an origin named bad by localization enters
quarantine, and its sheddable traffic then rides the small-batch
`quarantine` lane until K clean batches or time decay release it.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Callable, Optional

import numpy as np

from grandine_tpu_torch.consensus.verifier import SignatureInvalid
from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.gpu.bls import _bucket
from grandine_tpu_torch.runtime import health as _health

#: descent fanout: each device pass splits every still-suspect group into
#: FANOUT sub-groups
FANOUT = 8

#: quarantine exits after this many consecutive clean batches
DEFAULT_EXIT_CLEAN = 3
#: …or after this long without a new failure (decay), whichever first
DEFAULT_DECAY_S = 60.0
#: minimum submitted jobs before an origin's failure rate is trusted
TRUST_MIN_OBSERVED = 32
#: rolling-rate horizon: both traffic counters halve when `submitted`
#: reaches this, so the rate tracks recent behaviour
_TRAFFIC_HALF_AT = 4096


def ladder(bucket: int, fanout: int = FANOUT) -> "list[int]":
    """The group counts one localization runs: fanout, fanout², … capped
    at (and always ending with) the bucket — the last rung is per item."""
    out: "list[int]" = []
    g = fanout if fanout < bucket else bucket
    while True:
        out.append(g)
        if g >= bucket:
            return out
        g = g * fanout if g * fanout < bucket else bucket


def max_device_passes(items: int, fanout: int = FANOUT) -> int:
    """Upper bound on the device passes of one localization: the subgroup
    pass plus the whole ladder."""
    return 1 + len(ladder(_bucket(max(1, int(items))), fanout))


def _one_key(keys: list) -> list:
    """An item's member keys as the partition seam will sum them: their
    aggregate alone where the seam would compute that same key (several
    keys, none the identity, a sum that is not ∞), else the list as it
    is, so that every pass of a localization reuses one host sum."""
    if len(keys) < 2 or any(pk.point.is_infinity() for pk in keys):
        return keys
    agg = A.PublicKey.aggregate(keys)
    return keys if agg.point.is_infinity() else [agg]


class FaultLocalizer:
    """On-device localization of a failed verify batch.

    `passes` counts the passes of every localization this instance ran,
    by kind: "g2_subgroup", "rlc_partition" and "host" (a sweep). With a
    `health` supervisor every settle runs under its watchdog and feeds its
    breaker; without one a settle runs inline and a fault still sweeps."""

    def __init__(self, health: "Optional[_health.BackendHealthSupervisor]"
                 = None, metrics=None,
                 host_check: "Optional[Callable]" = None,
                 fanout: int = FANOUT) -> None:
        assert fanout >= 2 and fanout & (fanout - 1) == 0
        self.health = health
        self.metrics = metrics
        self.fanout = fanout
        #: None → runtime/verify_scheduler.py host_check_item, looked up
        #: at each call (monkeypatched truth tables reach every leaf)
        self.host_check = host_check
        self.passes: Counter = Counter()
        self._lock = threading.Lock()

    def _leaf_check(self, item) -> bool:
        if self.host_check is not None:
            return bool(self.host_check(item))
        from grandine_tpu_torch.runtime import verify_scheduler as _vs

        return bool(_vs.host_check_item(item))

    @staticmethod
    def supports(backend) -> bool:
        """True when `backend` offers the RLC-partition seam (test fakes
        without it bisect on the host in the scheduler)."""
        return backend is not None and hasattr(
            backend, "rlc_partition_verify_async")

    def _count_pass(self, kind: str) -> None:
        with self._lock:
            self.passes[kind] += 1
        if self.metrics is not None:
            self.metrics.verify_isolation_passes.labels(kind).inc()

    def _budget(self, deadline: "Optional[float]") -> "Optional[float]":
        budget = (self.health.settle_timeout_s if self.health is not None
                  else None)
        if deadline is not None:
            remaining = deadline - time.monotonic()
            budget = remaining if budget is None else min(budget, remaining)
        return budget

    def _guard(self, settle, budget: "Optional[float]"):
        """Watchdog-bounded settle with breaker accounting: (status,
        value) as health.guard_settle gives them, with or without a
        supervisor."""
        if self.health is not None:
            outcome = self.health.guard_settle(settle, timeout_s=budget)
            if outcome.status == _health.OK:
                self.health.record_success()
            elif outcome.status == _health.TIMEOUT:
                self.health.record_fault("watchdog")
            else:
                self.health.record_fault("settle")
            return outcome.status, outcome.value
        try:
            return _health.OK, settle()
        except Exception:
            return _health.FAULT, None

    def _device_ok(self) -> bool:
        return self.health is None or self.health.allow_device()

    def _pass(self, dispatch, budget):
        """One device pass: (True, value) or (False, None) after a
        dispatch fault (filed with the breaker), a settle fault or a
        watchdog expiry."""
        try:
            settle = dispatch()
        except Exception:
            if self.health is not None:
                self.health.record_fault("dispatch")
            return False, None
        status, value = self._guard(settle, budget)
        return status == _health.OK, value

    def localize(self, backend, items, deadline: "Optional[float]" = None,
                 fl=None) -> "list[bool]":
        """Per-item verdicts for a batch the device called invalid.

        A host pre-pass names the items that cannot reach the device (an
        undecodable or ∞ signature, no usable keys) and takes the host
        check's verdict for them; one device pass gives per-item subgroup
        verdicts (a named-bad item becomes a host leaf); then the
        partition descent narrows the suspects to the per-item rung,
        whose named-bad leaves the host confirms. An item of a group the
        device clears is True. Device passes: at most
        `max_device_passes(len(items))`. A device fault, a watchdog
        expiry, an open breaker or an expired deadline before a pass
        sweeps the remaining suspects on the host (one "host" pass)."""
        n = len(items)
        verdicts: "list[Optional[bool]]" = [None] * n
        points: list = [None] * n
        keys: list = [None] * n
        for i, it in enumerate(items):
            try:
                p = A.g2_from_bytes(it.signature, subgroup_check=False)
                if p.is_infinity():
                    raise A.BlsError("infinity signature")
                keys[i] = it.resolve_keys()
                points[i] = p
            except (A.BlsError, SignatureInvalid):
                verdicts[i] = self._leaf_check(it)
        live = [i for i in range(n) if verdicts[i] is None]
        if not live:
            return [bool(v) for v in verdicts]
        budget = self._budget(deadline)
        if (budget is not None and budget <= 0) or not self._device_ok():
            return self._host_sweep(items, verdicts, live)

        # device pass 0: per-item subgroup verdicts
        ok, flags = self._pass(lambda: backend.g2_subgroup_check_batch_async(
            [points[i] for i in live]), budget)
        if not ok:
            return self._host_sweep(items, verdicts, live)
        self._count_pass("g2_subgroup")
        if fl is not None:
            fl.note_bisect(0.0, 1)
        flags = np.asarray(flags, bool)
        for pos, idx in enumerate(live):
            if not flags[pos]:
                verdicts[idx] = self._leaf_check(items[idx])
        live = [i for i in live if verdicts[i] is None]
        if not live:
            return [bool(v) for v in verdicts]

        # the partition descent: every pass the same items, group counts
        # fanout → … → per item; only the items of bad groups stay suspect
        messages = [items[i].message for i in live]
        signatures = [A.Signature(points[i]) for i in live]
        member_keys = [_one_key(keys[i]) for i in live]
        b = _bucket(len(live))
        suspects = set(range(len(live)))
        for depth, groups in enumerate(ladder(b, self.fanout), start=2):
            if not suspects:
                break
            remaining = [live[p] for p in sorted(suspects)]
            budget = self._budget(deadline)
            if (budget is not None and budget <= 0) or not self._device_ok():
                return self._host_sweep(items, verdicts, remaining)
            ok, group_verdicts = self._pass(
                lambda g=groups: backend.rlc_partition_verify_async(
                    messages, signatures, member_keys, g), budget)
            if not ok:
                return self._host_sweep(items, verdicts, remaining)
            self._count_pass("rlc_partition")
            if fl is not None:
                fl.note_bisect(0.0, depth)
            group_verdicts = np.asarray(group_verdicts, bool)
            span = b // groups
            for p in sorted(suspects):
                if group_verdicts[p // span]:
                    verdicts[live[p]] = True
                    suspects.discard(p)
            if groups >= b:
                # per-item rung: the device named these bad; the host
                # confirms each
                for p in sorted(suspects):
                    verdicts[live[p]] = self._leaf_check(items[live[p]])
                suspects.clear()
        return [True if v is None else bool(v) for v in verdicts]

    def _host_sweep(self, items, verdicts, remaining) -> "list[bool]":
        """The degradation target: the host checks every undecided item."""
        self._count_pass("host")
        for i in remaining:
            verdicts[i] = self._leaf_check(items[i])
        return [bool(v) if v is not None else False for v in verdicts]


class ReputationTable:
    """Bounded, decaying per-origin quarantine state.

    Entry: any localization-attributed failure. Exit: `exit_clean`
    CONSECUTIVE clean quarantine batches, or `decay_s` without a new
    failure. Bounded at `capacity` origins — at capacity a new offender
    evicts the entry with the stalest failure (closest to decaying out
    anyway), so adversarial origin churn cannot grow the table."""

    def __init__(self, capacity: int = 256,
                 exit_clean: int = DEFAULT_EXIT_CLEAN,
                 decay_s: float = DEFAULT_DECAY_S,
                 clock=time.monotonic) -> None:
        self.capacity = max(1, int(capacity))
        self.exit_clean = max(1, int(exit_clean))
        self.decay_s = float(decay_s)
        self.clock = clock
        self._lock = threading.Lock()
        #: origin -> [failures, consecutive_clean, last_bad_t]
        self._entries: "dict[str, list]" = {}
        #: origin -> [submitted, failed] rolling job counters feeding
        #: `failure_rate` (admission quotas key off the RATE, not raw
        #: submission share — a high-volume honest aggregator stays
        #: unclamped). Bounded like _entries; at capacity the lowest-
        #: volume origin is evicted, so sybil churn cannot displace the
        #: heavy hitters whose rates matter.
        self._traffic: "dict[str, list]" = {}

    def _traffic_entry(self, origin: str) -> list:
        # caller holds self._lock
        t = self._traffic.get(origin)
        if t is None:
            if len(self._traffic) >= self.capacity:
                victim = min(
                    self._traffic, key=lambda o: self._traffic[o][0]
                )
                del self._traffic[victim]
            t = self._traffic[origin] = [0, 0]
        return t

    def note_submitted(self, origin: "Optional[str]",
                       jobs: int = 1) -> None:
        """One (or `jobs`) verify job(s) submitted by `origin` — the
        denominator of its failure rate."""
        if not origin:
            return
        with self._lock:
            t = self._traffic_entry(str(origin))
            t[0] += max(1, int(jobs))
            if t[0] >= _TRAFFIC_HALF_AT:
                t[0] //= 2
                t[1] //= 2

    def failure_rate(self, origin: "Optional[str]",
                     min_observed: int = TRUST_MIN_OBSERVED
                     ) -> "Optional[float]":
        """Attributed-failure fraction of `origin`'s submitted jobs, or
        None while the origin has fewer than `min_observed` submissions
        (too little evidence to trust the rate either way)."""
        if not origin:
            return None
        with self._lock:
            t = self._traffic.get(str(origin))
            if t is None or t[0] < min_observed:
                return None
            return min(1.0, t[1] / t[0])

    def note_failure(self, origin: "Optional[str]") -> None:
        if not origin:
            return
        origin = str(origin)
        now = self.clock()
        with self._lock:
            self._traffic_entry(origin)[1] += 1
            ent = self._entries.get(origin)
            if ent is not None:
                ent[0] += 1
                ent[1] = 0
                ent[2] = now
                return
            if len(self._entries) >= self.capacity:
                victim = min(self._entries, key=lambda o: self._entries[o][2])
                del self._entries[victim]
            self._entries[origin] = [1, 0, now]

    def note_clean_batch(self, origin: "Optional[str]") -> None:
        """One quarantine-lane batch from `origin` settled fully valid."""
        if not origin:
            return
        with self._lock:
            ent = self._entries.get(str(origin))
            if ent is None:
                return
            ent[1] += 1
            if ent[1] >= self.exit_clean:
                del self._entries[str(origin)]

    def is_quarantined(self, origin: "Optional[str]") -> bool:
        if not origin:
            return False
        now = self.clock()
        with self._lock:
            ent = self._entries.get(str(origin))
            if ent is None:
                return False
            if now - ent[2] > self.decay_s:
                del self._entries[str(origin)]
                return False
            return True

    def snapshot(self) -> "list[dict]":
        with self._lock:
            rows = [
                {"origin": o, "failures": e[0], "clean": e[1],
                 "age_s": round(self.clock() - e[2], 3)}
                for o, e in self._entries.items()
            ]
        rows.sort(key=lambda r: (-r["failures"], r["origin"]))
        return rows

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------- persistence

    #: K-V row holding the serialized table (storage.Database seam)
    DB_KEY = b"rep:table"

    def save(self, db) -> None:
        """Serialize quarantine + traffic state through the node's K-V
        store so a reboot does not hand every quarantined origin a clean
        slate. `last_bad_t` rides as AGE (the clock is time.monotonic,
        meaningless across processes) and is rebased on load."""
        import json

        now = self.clock()
        with self._lock:
            blob = {
                "v": 1,
                "entries": {
                    o: [e[0], e[1], round(now - e[2], 3)]
                    for o, e in self._entries.items()
                },
                "traffic": {o: list(t) for o, t in self._traffic.items()},
            }
        db.put(self.DB_KEY, json.dumps(blob, sort_keys=True).encode())

    def load(self, db) -> int:
        """Restore state saved by `save`; returns the number of
        quarantine entries restored (0 on missing/corrupt rows — a fresh
        table, never a crash at node start). Ages past `decay_s` are
        dropped on the spot rather than resurrected."""
        import json

        raw = db.get(self.DB_KEY)
        if raw is None:
            return 0
        try:
            blob = json.loads(bytes(raw).decode())
            entries = blob.get("entries", {})
            traffic = blob.get("traffic", {})
        except (ValueError, AttributeError):
            return 0
        now = self.clock()
        restored = 0
        with self._lock:
            for o, row in entries.items():
                try:
                    failures, clean, age = (
                        int(row[0]), int(row[1]), float(row[2])
                    )
                except (TypeError, ValueError, IndexError):
                    continue
                if age > self.decay_s or len(self._entries) >= self.capacity:
                    continue
                self._entries[str(o)] = [failures, clean, now - age]
                restored += 1
            for o, row in traffic.items():
                if len(self._traffic) >= self.capacity:
                    break
                try:
                    self._traffic[str(o)] = [int(row[0]), int(row[1])]
                except (TypeError, ValueError, IndexError):
                    continue
        return restored


__all__ = ["DEFAULT_DECAY_S", "DEFAULT_EXIT_CLEAN", "FANOUT", "FaultLocalizer",
           "ReputationTable", "TRUST_MIN_OBSERVED", "ladder",
           "max_device_passes"]
