"""The verify scheduler, the verify plane's entry point (counterpart of
grandine_tpu/runtime/verify_scheduler.py): every signed-object kind
funnels into one multi-lane batch-verification plane.

  lanes     — each kind gets a LaneConfig (DEFAULT_LANES: blocks, blob
              headers, sync contributions HIGH; sync messages, slashings,
              exits, BLS changes, quarantine, ed25519, blob_kzg LOW): a
              flush policy (max_batch or max_wait, whichever first), a
              bounded queue, and the scheme it serves. Under overload LOW
              lanes shed oldest-first with a counted drop; HIGH lanes
              backpressure the producer instead.
  tickets   — `submit` returns a VerifyTicket future; callers wait
              (`result`) or attach a callback. Shed tickets resolve False
              with `dropped=True`. A ticket may carry a deadline budget:
              past it, the job sheds before any device dispatch.
  batches   — a dispatcher thread coalesces each lane into ONE device
              batch through the lane's scheme row (gpu/schemes.py: the
              BLS kernels of gpu/bls.py, `ed25519_verify` of
              gpu/ed25519.py, the blob-KZG pass of gpu/kzg.py); same-scheme
              lanes may merge into one dispatch. Dispatch is async and
              two deep; a completion thread settles verdicts under the
              health supervisor's watchdog.
  failure   — a failed BLS batch is localized on the card
              (runtime/isolation.py FaultLocalizer), any other scheme's
              bisected down to its host twin; a device fault gets one
              retry, then the batch degrades to the host twin, counted
              (`stats[lane]["device_faults"]`, "retries", "breaker_skips",
              flight records, the breaker). Origins named bad go to the
              quarantine lane (ReputationTable).

`DeferredVerifier` adapts the scheduler to the `Verifier` seam
(consensus/verifier.py), so block signature batches reach the `block`
lane unchanged.

An injected `VerifyMesh` (gpu/mesh.py; a 1-device mesh is no mesh)
reaches every lane's backend, and every flight record carries its width
as `devices`. The lanes' BLS dispatch goes through the fast-aggregate
seams, so a mesh scheduler reads a row-sharded registry through its
gather; callers of `multi_verify_async` (TorchVerifier, the replay
window, the release gate) reach the sharded programs.

Differences from the reference: `device=` is passed to every lane's
backend (CUDA unless "cpu" is given, the mesh's first device with a
mesh; a lane's backend raises at construction with no card); `metrics=`
is fed where the reference feeds it but may be None
(the port has no metrics sink yet); `tracer=` defaults to the port's null
tracer (grandine_tpu_torch/tracing.py).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

from grandine_tpu_torch.consensus.keys import decompress_pubkey
from grandine_tpu_torch.consensus.verifier import (
    SignatureInvalid, SingleVerifier, Verifier)
from grandine_tpu_torch.crypto import bls as _A
from grandine_tpu_torch.gpu import schemes as _schemes
from grandine_tpu_torch.gpu.bls import resolve_device
from grandine_tpu_torch.gpu.mesh import resolve_mesh
from grandine_tpu_torch.runtime import flight as _flight
from grandine_tpu_torch.runtime import health as _health
from grandine_tpu_torch.runtime import isolation as _isolation
from grandine_tpu_torch.runtime.thread_pool import Priority
from grandine_tpu_torch.tracing import NULL_TRACER


class LaneConfig:
    """One lane's flush/backpressure policy."""

    __slots__ = ("name", "priority", "max_batch", "max_wait_s",
                 "max_queue", "shed", "scheme")

    def __init__(self, name: str, priority: Priority, max_batch: int,
                 max_wait_s: float, max_queue: int, shed: bool,
                 scheme: str = "bls") -> None:
        self.name = name
        self.priority = priority
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        #: LOW lanes shed oldest-first at max_queue; HIGH lanes block
        #: the submitter (bounded producer) and never drop
        self.shed = bool(shed)
        #: verification scheme served by this lane — a key into the
        #: gpu/schemes.py table (backend factory, device
        #: dispatch, host twin, kernel label all resolve through it)
        self.scheme = str(scheme)


#: the lane table (README "Verify scheduler" section mirrors this)
DEFAULT_LANES = (
    LaneConfig("block", Priority.HIGH, 64, 0.002, 8192, shed=False),
    LaneConfig("blob_header", Priority.HIGH, 32, 0.005, 4096, shed=False),
    LaneConfig("sync_contribution", Priority.HIGH, 32, 0.025, 4096,
               shed=False),
    LaneConfig("sync_message", Priority.LOW, 128, 0.050, 2048, shed=True),
    LaneConfig("slashing", Priority.LOW, 16, 0.100, 512, shed=True),
    LaneConfig("exit", Priority.LOW, 16, 0.100, 512, shed=True),
    LaneConfig("bls_change", Priority.LOW, 32, 0.100, 1024, shed=True),
    # quarantined-origin traffic: small batches so one forgery poisons
    # little, sheddable so a hostile origin only backpressures itself
    LaneConfig("quarantine", Priority.LOW, 8, 0.050, 512, shed=True),
    # non-BLS schemes (gpu/schemes.py): execution-layer / non-Ethereum
    # Ed25519 traffic and the blob-sidecar KZG-proof gossip check.
    # max_batch 63 keeps the Ed25519 MSM inside the 128-point ladder
    # bucket (2·63+1 = 127); sheddable — a dropped ticket degrades the
    # caller to its host path, it never loses the object.
    LaneConfig("ed25519", Priority.LOW, 63, 0.050, 2048, shed=True,
               scheme="ed25519"),
    LaneConfig("blob_kzg", Priority.LOW, 8, 0.025, 1024, shed=True,
               scheme="blob_kzg"),
)


class VerifyItem:
    """A 32-byte signing root, a 96-byte compressed signature, and the
    signer set — either materialized `public_keys`, or `member_indices`
    into the state's compressed `pubkey_columns`, so the device path can
    gather keys from the registry without the host decompressing them."""

    __slots__ = ("message", "signature", "public_keys", "member_indices",
                 "pubkey_columns")

    def __init__(self, message: bytes, signature: bytes,
                 public_keys: "Optional[Sequence]" = None,
                 member_indices: "Optional[Sequence[int]]" = None,
                 pubkey_columns=None) -> None:
        self.message = bytes(message)
        self.signature = bytes(signature)
        self.public_keys = (
            tuple(public_keys) if public_keys is not None else None)
        self.member_indices = (
            tuple(int(i) for i in member_indices)
            if member_indices is not None else None)
        self.pubkey_columns = pubkey_columns

    def resolve_keys(self) -> list:
        """Materialize the signer keys (registry keys through the
        process-wide decompression cache, consensus/keys.py); raises
        SignatureInvalid when the item carries no usable keys."""
        if self.public_keys is not None:
            if not self.public_keys:
                raise SignatureInvalid("aggregate with no public keys")
            return list(self.public_keys)
        if self.member_indices is None or self.pubkey_columns is None:
            raise SignatureInvalid("verify item has no key material")
        if not self.member_indices:
            raise SignatureInvalid("aggregate with no public keys")
        try:
            return [decompress_pubkey(self.pubkey_columns[i], trusted=True)
                    for i in self.member_indices]
        except (IndexError, _A.BlsError) as e:
            raise SignatureInvalid(f"bad member index/pubkey: {e}") from e


def host_check_item(item: VerifyItem) -> bool:
    """The eager host path, SingleVerifier semantics (full decompression
    and subgroup checks): the `bls` row's host twin — the bisection leaf,
    the degradation target and the fault localizer's leaf check."""
    sv = SingleVerifier()
    try:
        resolved = item.resolve_keys()
        if len(resolved) == 1:
            sv.verify_singular(item.message, item.signature, resolved[0])
        else:
            sv.verify_aggregate(item.message, item.signature, resolved)
    except SignatureInvalid:
        return False
    return True


class VerifyTicket:
    """Future handed back by `submit`: resolves True (all the job's items
    verified), or False (some item invalid — or `dropped` when the job
    was shed under overload / at shutdown, so callers can count an
    "ignore" rather than a "reject")."""

    __slots__ = ("lane", "origin", "enqueued_at", "settled_at", "dropped",
                 "deadline", "_ok", "_event", "_callbacks", "_lock")

    def __init__(self, lane: str, origin: "Optional[str]" = None,
                 deadline: "Optional[float]" = None) -> None:
        self.lane = lane
        #: gossip peer / validator attribution ("peer:<id>",
        #: "validator:<index>", …) — a rejected job files it into the
        #: flight recorder's bounded top-K failing-origin table (the
        #: quarantine lane's feed); NEVER a Prometheus label value
        self.origin = origin
        #: absolute monotonic deadline (end-to-end budget, stamped at
        #: submit): past it the ticket sheds BEFORE any device dispatch
        #: is spent on it; None = only the lane's max_wait governs
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self.settled_at: "Optional[float]" = None
        self.dropped = False
        # _resolve writes _ok under _lock before _event.set(); readers
        # gate on the Event — the happens-before edge
        self._ok = False
        self._event = threading.Event()
        self._callbacks: "list[Callable]" = []
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def ok(self) -> bool:
        """The settled verdict (False until resolved). Safe bare read:
        _resolve writes _ok before _event.set(), and the advertised
        contract is done()-then-ok."""
        return self._ok

    def result(self, timeout: "Optional[float]" = None) -> bool:
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.lane} verify ticket not settled")
        # Event.wait() is the happens-before edge for the _ok write
        return self._ok

    def add_callback(self, fn: "Callable[[VerifyTicket], None]") -> None:
        """Run fn(ticket) once settled (immediately if already done)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, ok: bool, dropped: bool = False) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._ok = bool(ok)
            self.dropped = dropped
            self.settled_at = time.monotonic()
            callbacks, self._callbacks = self._callbacks, []
            self._event.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                pass  # a consumer's callback must not break settling


class _Job:
    __slots__ = ("items", "ticket")

    def __init__(self, items, ticket) -> None:
        self.items = tuple(items)
        self.ticket = ticket


class VerifyScheduler:
    """The central lane scheduler: submit → coalesce → device batch →
    settle. One dispatcher thread forms batches (HIGH-priority lanes flush
    first among due lanes); a completion thread forces async device
    verdicts so dispatch overlaps execution, two deep."""

    def __init__(
        self,
        backend=None,
        registry=None,
        lanes: "Optional[Sequence[LaneConfig]]" = None,
        use_device: bool = True,
        pipeline_depth: int = 2,
        metrics=None,
        tracer=None,
        health: "Optional[_health.BackendHealthSupervisor]" = None,
        settle_timeout_s: float = 5.0,
        flight: "Optional[_flight.FlightRecorder]" = None,
        device=None,
        mesh=None,
        reputation: "Optional[_isolation.ReputationTable]" = None,
        use_isolation: bool = True,
        merge_window_s: float = 0.0,
        merge_max_items: int = 128,
        deadline_margin_s: float = 0.05,
    ) -> None:
        self.metrics = metrics
        self.tracer = tracer or NULL_TRACER
        self.use_device = use_device
        #: cross-lane batch merging: when > 0, a due lane's flush also
        #: collects other lanes whose head deadline falls within the
        #: window, collapsing them into ONE RLC dispatch (one Miller
        #: loop, one final exp) with per-lane verdict slices and
        #: per-lane flight records. 0 disables (per-lane batches only).
        #: The quarantine lane never merges — either side — so forgeries
        #: cannot share a batch (nor a localization descent) with
        #: honest traffic.
        self.merge_window_s = float(merge_window_s)
        #: cap on a merged dispatch's total items, keeping merged
        #: batches inside the lanes' device buckets
        self.merge_max_items = int(merge_max_items)
        #: brownout plane (a brownout controller pokes these, always as
        #: whole-object frozenset swaps — a torn read sees either the
        #: old or the new set): lanes routed to the host twin at B3 so
        #: the device serves HIGH only, and lanes whose submits resolve
        #: dropped at the door under CRITICAL
        self.brownout_route_host: "frozenset[str]" = frozenset()
        self.brownout_shed_lanes: "frozenset[str]" = frozenset()
        #: safety margin subtracted from a ticket's absolute deadline
        #: when computing its effective flush due-time, so a near-
        #: deadline head still has a chance to dispatch AND settle
        self.deadline_margin_s = float(deadline_margin_s)
        #: injected VerifyMesh threaded into every lane's backend; None /
        #: 1-device collapses to the single-device plane
        self.mesh, device = resolve_mesh(mesh, device)
        #: the device every lane's backend runs on: CUDA unless "cpu" is
        #: passed (the mesh's first device with a mesh), and with no card
        #: the scheduler raises here rather than degrade every batch to the
        #: host (an injected backend, or use_device=False, needs no card)
        self.device = (resolve_device(device)
                       if use_device and backend is None else device)
        #: flight recorder — always-on (a private ring when none is
        #: injected; one can be shared across the verify plane)
        self.flight = (
            flight if flight is not None
            else _flight.FlightRecorder(metrics=metrics)
        )
        #: breaker + settle watchdog + canary gating; one supervisor can
        #: be shared with another plane, so a fault on either quarantines
        #: the device for both
        self.health = (
            health if health is not None
            else _health.BackendHealthSupervisor(
                metrics=metrics, settle_timeout_s=settle_timeout_s,
                flight=self.flight,
            )
        )
        if self.health.flight is None:
            # an injected supervisor without its own recorder joins this
            # scheduler's timeline (breaker + canary events interleave
            # with the batches that provoked them)
            self.health.flight = self.flight
            self.health.breaker.flight = self.flight
        #: a shared injected backend (tests: fault injection) or one
        #: lazily built backend per lane from the lane's scheme row, so
        #: device stage spans attribute to the dispatching lane (the
        #: kernel library is loaded once per process)
        #: decaying per-origin quarantine state (runtime/isolation.py);
        #: one table can be shared between scheduler and gossip plane
        self.reputation = (
            reputation if reputation is not None
            else _isolation.ReputationTable()
        )
        #: on-device fault localization of failed batches; None reverts
        #: _isolate to the legacy host bisection (--no-isolation knob)
        self._localizer = (
            # host_check unset → the localizer resolves this module's
            # host_check_item per call, so monkeypatched truth tables
            # reach the leaves the same way they reach _bisect
            _isolation.FaultLocalizer(health=self.health, metrics=metrics)
            if use_isolation else None
        )
        self._shared_backend = backend
        self._backends: dict = {}
        self._backend_lock = threading.Lock()  # lazy per-lane build
        self.registry = registry
        self.lanes = {l.name: l for l in (lanes or DEFAULT_LANES)}
        self._queues = {n: deque() for n in self.lanes}
        self._item_counts = {n: 0 for n in self.lanes}
        self._cond = threading.Condition()
        self._stop = False
        self._pending = 0  # submitted jobs not yet settled (flush barrier)
        self.stats = {
            n: {
                "submitted": 0, "batches": 0, "accepted": 0,
                "rejected": 0, "shed": 0, "device_faults": 0,
                "breaker_skips": 0, "retries": 0,
                "max_batch_items": 0, "merged": 0,
            }
            for n in self.lanes
        }
        #: guards every `stats` counter bump — the caller (submit/shed),
        #: dispatcher, settle, and watchdog threads all mutate them
        self._stats_lock = threading.Lock()

        self.pipeline_depth = max(1, int(pipeline_depth))
        self._sem = threading.BoundedSemaphore(self.pipeline_depth)
        self._completion: "queue.Queue" = queue.Queue()
        # construct BOTH threads before starting either: a started
        # thread must never observe a half-initialized scheduler
        self._completion_thread = threading.Thread(
            target=self._complete, name="verify-settle", daemon=True
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="verify-scheduler", daemon=True
        )
        self._completion_thread.start()
        self._dispatcher.start()

    # ------------------------------------------------------------ submit

    def submit(self, lane_name: str, items: "Sequence[VerifyItem]",
               callback=None, origin: "Optional[str]" = None,
               deadline: "Optional[float]" = None,
               deadline_s: "Optional[float]" = None) -> VerifyTicket:
        """Queue one job (all `items` must verify for the ticket to
        resolve True). Returns immediately; LOW lanes shed oldest-first
        at capacity, HIGH lanes block the caller until there is room.
        `origin` attributes a rejected job to its gossip peer/validator
        in the flight recorder's failing-origin table.

        `deadline` (absolute monotonic) or `deadline_s` (relative to
        now) stamps an end-to-end budget on the ticket: past it the job
        sheds before any device dispatch is spent on it, and a near-
        deadline head preempts max_wait/merge-window batching.

        A quarantined origin's SHEDDABLE traffic is rerouted into the
        small-batch quarantine lane so it never shares a batch (nor a
        localization descent) with honest traffic; HIGH lanes are never
        rerouted — block import correctness beats isolation."""
        lane = self.lanes[lane_name]
        # feed the failure-rate denominator: admission quotas trust an
        # origin by its attributed-failure RATE, which needs the
        # submission count alongside _deliver's failure count
        self.reputation.note_submitted(origin)
        if (
            origin is not None and lane.shed
            and lane_name != "quarantine" and "quarantine" in self.lanes
            and self.reputation.is_quarantined(origin)
        ):
            lane_name = "quarantine"
            lane = self.lanes[lane_name]
        if deadline is None and deadline_s is not None:
            deadline = time.monotonic() + float(deadline_s)
        ticket = VerifyTicket(lane_name, origin=origin, deadline=deadline)
        if callback is not None:
            ticket.add_callback(callback)
        if lane.shed and lane_name in self.brownout_shed_lanes:
            # CRITICAL brownout: sheddable lanes drop at the door, with
            # full accounting — HIGH lanes (shed=False) never take this
            # path, the device keeps serving them
            with self._stats_lock:
                self.stats[lane_name]["submitted"] += 1
            self._count_shed(lane_name)
            self.flight.record_shed(lane_name, len(items), "brownout")
            ticket._resolve(False, dropped=True)
            return ticket
        job = _Job(items, ticket)
        shed: "list[_Job]" = []
        with self._cond:
            if self._stop:
                ticket._resolve(False, dropped=True)
                return ticket
            q = self._queues[lane_name]
            if lane.shed:
                while len(q) >= lane.max_queue:
                    old = q.popleft()
                    self._item_counts[lane_name] -= len(old.items)
                    self._pending -= 1
                    shed.append(old)
            else:
                while len(q) >= lane.max_queue and not self._stop:
                    self._cond.wait(0.05)
                if self._stop:
                    ticket._resolve(False, dropped=True)
                    return ticket
            q.append(job)
            self._item_counts[lane_name] += len(job.items)
            self._pending += 1
            with self._stats_lock:
                self.stats[lane_name]["submitted"] += 1
            self._set_depth(lane_name)
            self._cond.notify_all()
        for old in shed:
            self._count_shed(lane_name)
            # shed-oldest is the overload-control valve: the timeline
            # attributes it to the brownout plane at whatever level is
            # in force (level "normal" = plain pre-controller overflow)
            self.flight.record_shed(lane_name, len(old.items), "brownout")
            old.ticket._resolve(False, dropped=True)
        return ticket

    def deferred(self, lane: str = "block",
                 timeout: float = 30.0) -> "DeferredVerifier":
        return DeferredVerifier(self, lane=lane, timeout=timeout)

    def verifier_factory(self, lane: str = "block", timeout: float = 30.0):
        """A `Controller(verifier_factory=...)`-shaped callable routing
        block signature batches through `lane`."""
        return lambda: DeferredVerifier(self, lane=lane, timeout=timeout)

    # -------------------------------------------------------- dispatcher

    def _effective_due(self, ticket: VerifyTicket,
                       lane: LaneConfig) -> float:
        """When a lane's head must flush: the lane's max_wait, or —
        when the ticket carries an absolute deadline budget — early
        enough (deadline minus the dispatch/settle margin) that a
        near-deadline head preempts max_wait/merge-window batching."""
        due = ticket.enqueued_at + lane.max_wait_s
        if ticket.deadline is not None:
            due = min(due, ticket.deadline - self.deadline_margin_s)
        return due

    def _pick_lane(self, now: float) -> "Optional[str]":
        """The due lane to flush next: full (max_batch) or overdue
        (past its head's effective due-time); HIGH priority wins, then
        the most-overdue lane."""
        best, best_key = None, None
        for name, lane in self.lanes.items():
            q = self._queues[name]
            if not q:
                continue
            overdue = now - self._effective_due(q[0].ticket, lane)
            if self._item_counts[name] >= lane.max_batch or overdue >= 0:
                key = (int(lane.priority), -overdue)
                if best_key is None or key < best_key:
                    best, best_key = name, key
        return best

    def _nearest_deadline(self, now: float) -> "Optional[float]":
        soonest = None
        for name, lane in self.lanes.items():
            q = self._queues[name]
            if not q:
                continue
            wait = self._effective_due(q[0].ticket, lane) - now
            if soonest is None or wait < soonest:
                soonest = wait
        if soonest is None:
            return None
        return max(soonest, 0.0)

    def _pop_batch(self, lane: LaneConfig, cap: "Optional[int]" = None,
                   allow_oversize: bool = True) -> "list[_Job]":
        q = self._queues[lane.name]
        jobs, n_items = [], 0
        limit = lane.max_batch if cap is None else min(lane.max_batch, cap)
        # peek before popping: taking a job that would push the batch
        # past max_batch overflows into the NEXT device bucket (for the
        # ed25519 lane, past the 128-row ladder bucket: a host
        # degradation). An oversized single job still goes alone (the
        # backend chunks it) — except under a merge cap, where it stays
        # queued for its own flush instead.
        while q and n_items + len(q[0].items) <= limit:
            jobs.append(q.popleft())
            n_items += len(jobs[-1].items)
        if q and not jobs and allow_oversize:
            jobs.append(q.popleft())
            n_items += len(jobs[-1].items)
        self._item_counts[lane.name] -= n_items
        self._set_depth(lane.name)
        return jobs

    def _collect_merge(self, primary: LaneConfig, n_primary: int,
                       now: float) -> "list[tuple]":
        """Cross-lane batch merging (runs under _cond, dispatcher thread
        only): other non-quarantine lanes whose OLDEST job's deadline
        falls inside the merge window join the primary lane's dispatch —
        their Miller loops and the shared final exponentiation ride one
        device pass instead of flushing separately moments later.
        Returns [(lane, jobs), ...]; per-lane verdict slices and flight
        records are preserved downstream (_deliver_segments)."""
        merged: "list[tuple]" = []
        if self.merge_window_s <= 0 or primary.name == "quarantine":
            return merged
        room = self.merge_max_items - n_primary
        for name, lane in self.lanes.items():
            if room <= 0:
                break
            if name == primary.name or name == "quarantine":
                continue
            # cross-SCHEME merging is meaningless: the batches run on
            # different kernels (an Ed25519 lane cannot ride a BLS RLC
            # dispatch) — only same-scheme lanes share a device pass
            if lane.scheme != primary.scheme:
                continue
            # a brownout-routed lane runs on the host twin: merging it
            # into a device dispatch would defeat the routing
            if name in self.brownout_route_host:
                continue
            q = self._queues[name]
            if not q:
                continue
            deadline = self._effective_due(q[0].ticket, lane)
            if deadline > now + self.merge_window_s:
                continue
            jobs = self._pop_batch(lane, cap=room, allow_oversize=False)
            if jobs:
                merged.append((lane, jobs))
                room -= sum(len(j.items) for j in jobs)
        return merged

    def _dispatch_loop(self) -> None:
        """Runs ONLY on the dispatcher thread: owns lane queues (under
        _cond), batch formation, and device dispatch."""
        while True:
            # crash containment: one poisoned batch must not kill the
            # dispatcher — resolve its tickets dropped, account the
            # failure, keep scheduling (thread-crash-containment rule)
            jobs: "list[_Job]" = []
            merged: "list[tuple]" = []
            try:
                with self._cond:
                    while not self._stop:
                        name = self._pick_lane(time.monotonic())
                        if name is not None:
                            break
                        self._cond.wait(
                            self._nearest_deadline(time.monotonic())
                        )
                    if self._stop:
                        # drain: everything still queued resolves
                        # dropped=True — no result() caller hangs to its
                        # full timeout during shutdown, and no verify
                        # work runs against torn-down state
                        to_drop = []
                        for lname in self.lanes:
                            q = self._queues[lname]
                            to_drop.extend(q)
                            q.clear()
                            self._item_counts[lname] = 0
                            self._set_depth(lname)
                    else:
                        to_drop = None
                        lane = self.lanes[name]
                        jobs = self._pop_batch(lane)
                        if jobs:
                            merged = self._collect_merge(
                                lane,
                                sum(len(j.items) for j in jobs),
                                time.monotonic(),
                            )
                        # wake HIGH-lane submitters blocked on a full
                        # queue
                        self._cond.notify_all()
                # decide from the state observed UNDER the lock:
                # re-reading self._stop bare here could see a stop()
                # that landed after the lock was released, with
                # `to_drop` never built
                if to_drop is not None:
                    # tickets resolve outside _cond: a resolve callback
                    # may re-enter the scheduler
                    for job in to_drop:
                        job.ticket._resolve(False, dropped=True)
                    with self._cond:
                        self._pending -= len(to_drop)
                        self._cond.notify_all()
                    return
                if jobs:
                    self._flush(lane, jobs, merged)
            except Exception:
                self._count_daemon_failure("verify-scheduler")
                self._abandon_jobs(
                    jobs + [j for _, mjobs in merged for j in mjobs]
                )

    def _abandon_jobs(self, jobs: "list[_Job]") -> None:
        """Containment cleanup: resolve a failed batch's unsettled
        tickets dropped and release their flush barrier."""
        undelivered = [j for j in jobs if not j.ticket.done()]
        for job in undelivered:
            job.ticket._resolve(False, dropped=True)
        if undelivered:
            with self._cond:
                self._pending -= len(undelivered)
                self._cond.notify_all()

    # ------------------------------------------------------------- flush

    @contextmanager
    def _stage(self, lane: LaneConfig, stage: str, **attrs):
        """A host stage's span and timer (`verify_stage_seconds`),
        lane-attributed."""
        t0 = time.perf_counter()
        with self.tracer.span(stage, attrs or None):
            yield
        if self.metrics is not None:
            self.metrics.verify_stage_seconds.labels(
                stage, lane.name
            ).observe(time.perf_counter() - t0)

    def _set_depth(self, lane_name: str) -> None:
        if self.metrics is not None:
            depth = len(self._queues[lane_name])
            self.metrics.verify_lane_depth.labels(lane_name).set(depth)
            if lane_name == "quarantine":
                self.metrics.verify_quarantine_lane_depth.set(depth)

    def _count_batch(self, lane: LaneConfig, result: str) -> None:
        if self.metrics is not None:
            self.metrics.verify_lane_batches.labels(lane.name, result).inc()

    def _count_shed(self, lane_name: str) -> None:
        with self._stats_lock:
            self.stats[lane_name]["shed"] += 1
        if self.metrics is not None:
            self.metrics.verify_lane_dropped.labels(lane_name).inc()

    def _count_watchdog(self, lane_name: str) -> None:
        if self.metrics is not None:
            self.metrics.verify_watchdog_fired.inc(lane_name)

    def _count_retry(self, lane_name: str) -> None:
        if self.metrics is not None:
            self.metrics.verify_retry.inc(lane_name)

    def _count_daemon_failure(self, thread: str) -> None:
        if self.metrics is not None:
            self.metrics.daemon_loop_failures.inc(thread)

    def _scheme_for(self, lane: LaneConfig) -> "_schemes.Scheme":
        return _schemes.get(getattr(lane, "scheme", "bls"))

    def _backend_for(self, lane: LaneConfig):
        if self._shared_backend is not None:
            return self._shared_backend
        # dispatcher AND settle-thread bisection both build lazily; the
        # lock keeps the per-lane backend a singleton (no double compile
        # cache, no torn publication)
        with self._backend_lock:
            backend = self._backends.get(lane.name)
            if backend is None:
                scheme = self._scheme_for(lane)
                backend = self._backends[lane.name] = scheme.make_backend(
                    metrics=self.metrics, tracer=self.tracer, lane=lane.name,
                    device=self.device, mesh=self.mesh,
                )
                # the first real canary-capable backend also answers
                # probes for HALF_OPEN re-promotion (injected backends
                # keep whatever probe the caller wired — tests drive
                # their own canaries)
                if scheme.canary:
                    self.health.ensure_probe(_health.make_canary_probe(
                        backend, timeout_s=self.health.settle_timeout_s
                    ))
        return backend

    def _retry_dispatch(self, lane: LaneConfig, items, fl=None):
        """Bounded transient retry: ONE immediate re-dispatch after a
        dispatch/settle fault, breaker permitting. The retry's faults
        feed the breaker but not the per-lane `device_faults` stat (the
        batch's first failure already counted)."""
        if not self.health.allow_device():
            return None
        with self._stats_lock:
            self.stats[lane.name]["retries"] += 1
        self._count_retry(lane.name)
        if fl is not None:
            fl.note_retry()
        t0 = time.perf_counter()
        try:
            return self._device_dispatch(lane, items)
        except Exception:
            self.health.record_fault("dispatch")
            if fl is not None:
                fl.note_fault("dispatch")
            return None
        finally:
            if fl is not None:
                fl.note_device(time.perf_counter() - t0)

    def _shed_expired(self, lane: LaneConfig, jobs: "list[_Job]") -> None:
        """Deadline-budget enforcement: jobs whose absolute deadline
        already passed resolve dropped BEFORE the batch spends a device
        dispatch on them; the shed lands on the flight timeline with
        cause="expired" and the in-force brownout level stamped on."""
        n_items = sum(len(j.items) for j in jobs)
        for job in jobs:
            self._count_shed(lane.name)
            if self.metrics is not None:
                self.metrics.verify_expired.inc(lane.name)
            job.ticket._resolve(False, dropped=True)
        self.flight.record_shed(lane.name, n_items, "expired")
        with self._cond:
            self._pending -= len(jobs)
            self._cond.notify_all()

    def _flush(self, lane: LaneConfig, jobs: "list[_Job]",
               merged: "list[tuple]" = ()) -> None:
        now = time.monotonic()
        # deadline-budget gate: already-expired jobs shed here, before
        # the batch spends a device dispatch (or a host pass) on them.
        # Merged lanes are same-scheme, so any surviving segment can be
        # promoted to primary when the original primary fully expired.
        live_pairs: "list[tuple]" = []
        for seg_lane, seg_jobs in [(lane, jobs)] + list(merged):
            live, expired = [], []
            for j in seg_jobs:
                t = j.ticket.deadline
                (expired if (t is not None and now >= t) else live).append(j)
            if expired:
                self._shed_expired(seg_lane, expired)
            if live:
                live_pairs.append((seg_lane, live))
        if not live_pairs:
            return
        (lane, jobs), merged = live_pairs[0], live_pairs[1:]
        # segments: the primary lane's batch first, then any merged
        # lanes' batches. Each keeps its own flight record so per-lane
        # SLO/failure attribution survives the shared device pass.
        segments = []
        for seg_lane, seg_jobs in [(lane, jobs)] + list(merged):
            seg_items = [it for j in seg_jobs for it in j.items]
            if self.metrics is not None:
                waits = self.metrics.verify_lane_wait_seconds.labels(
                    seg_lane.name
                )
                for j in seg_jobs:
                    waits.observe(now - j.ticket.enqueued_at)
            with self._stats_lock:
                st = self.stats[seg_lane.name]
                st["batches"] += 1
                st["max_batch_items"] = max(
                    st["max_batch_items"], len(seg_items)
                )
                if merged:
                    st["merged"] += 1
            # jobs pop FIFO, so jobs[0] is the oldest: its wait is the
            # batch's queue_wait component for SLO attribution
            seg_fl = self.flight.begin_batch(
                seg_lane.name, "", len(seg_items),
                queue_wait_s=now - seg_jobs[0].ticket.enqueued_at,
                breaker_state=self.health.state if self.use_device else "",
                devices=(
                    self.mesh.device_count if self.mesh is not None else 1
                ),
                quarantined=(seg_lane.name == "quarantine"),
            )
            if seg_lane.name == "quarantine" and self.metrics is not None:
                self.metrics.verify_quarantine_batches.inc()
            segments.append((seg_lane, seg_jobs, seg_items, seg_fl))
        items = [it for _, _, seg_items, _ in segments for it in seg_items]
        fl = segments[0][3]
        with self._stats_lock:
            st = self.stats[lane.name]
        settle = None
        device_allowed = False
        with self.tracer.span(
            "verify_lane_flush",
            {"lane": lane.name, "jobs": len(jobs), "items": len(items)},
        ):
            if self.use_device:
                if lane.name in self.brownout_route_host:
                    # B3 brownout routing: this lane runs on the host
                    # twin so the device serves HIGH lanes only — this
                    # is policy, not a fault, so no breaker accounting
                    pass
                elif not (device_allowed := self.health.allow_device()):
                    # breaker OPEN: no per-batch device fault tax —
                    # straight to the host path, zero dispatch attempts
                    with self._stats_lock:
                        st["breaker_skips"] += 1
                else:
                    t0 = time.perf_counter()
                    try:
                        settle = self._device_dispatch(lane, items)
                        fl.note_device(time.perf_counter() - t0)
                    except Exception:
                        fl.note_device(time.perf_counter() - t0)
                        with self._stats_lock:
                            st["device_faults"] += 1
                        fl.note_fault("dispatch")
                        self.health.record_fault("dispatch")
                        # bounded transient retry: one immediate
                        # re-dispatch before paying a full host pass
                        settle = self._retry_dispatch(lane, items, fl)
            if settle is None:
                # graceful degradation: brownout host routing, breaker-
                # open, no device/async seam, or a faulted dispatch →
                # the eager host path
                if self.use_device:
                    routed = lane.name in self.brownout_route_host
                    for seg_lane, _, _, _ in segments:
                        self._count_batch(
                            seg_lane,
                            "degraded" if device_allowed
                            else ("brownout" if routed else "breaker_open"),
                        )
                t0 = time.perf_counter()
                verdicts = self._host_check_all(lane, items)
                fl.note_host(time.perf_counter() - t0)
                if not self.use_device:
                    i = 0
                    for seg_lane, _, seg_items, _ in segments:
                        seg_v = verdicts[i:i + len(seg_items)]
                        i += len(seg_items)
                        self._count_batch(
                            seg_lane, "ok" if all(seg_v) else "invalid"
                        )
                self._deliver_segments(segments, verdicts)
                return
            ctx = self.tracer.capture()
        backend = self._backend_for(lane)
        kernel = self._scheme_for(lane).kernel_label(backend)
        for _, _, _, seg_fl in segments:
            seg_fl.record.kernel = kernel
        # two-deep pipelined handoff (backpressure bounds device
        # residency); the slot is released on the settle thread in
        # _complete's finally, so a `with` cannot express it
        self._sem.acquire()
        self.flight.device_enter()
        self._completion.put((lane, segments, items, settle, ctx, fl))

    def _device_dispatch(self, lane: LaneConfig, items):
        """Host prep + async device dispatch of one coalesced batch;
        returns a zero-arg settle callable (the batch verdict) or None
        when no async device seam is available. The per-scheme body
        lives in the gpu/schemes.py table; this method is only the lane →
        scheme route."""
        return self._scheme_for(lane).device_dispatch(
            self, lane, self._backend_for(lane), items
        )

    def _sync_registry(self, lane: LaneConfig, items):
        """The shared device pubkey registry, brought up to date against
        the batch's pubkey columns (gpu/schemes.py sync_registry, timed as
        a host_prep stage); None → indexed items take the keyed seam with
        host-resolved keys."""
        if self.registry is None:
            return None
        with self._stage(lane, "host_prep", op="registry_sync"):
            return _schemes.sync_registry(self.registry, items)

    # ------------------------------------------------------------ settle

    def _complete(self) -> None:
        """Runs ONLY on the completion thread: forces device verdicts in
        dispatch order, settles tickets, releases the pipeline slot."""
        while True:
            entry = self._completion.get()
            if entry is None:
                return
            lane, segments, items, settle, ctx, fl = entry
            try:
                with self.tracer.attach(ctx):
                    self._settle_batch(lane, segments, items, settle, fl)
            except Exception:
                # the settle thread must survive anything; no ticket may
                # hang — degrade the whole batch to the host path
                try:
                    self._deliver_segments(
                        segments, self._host_check_all(lane, items)
                    )
                except Exception:
                    for _, seg_jobs, _, _ in segments:
                        for j in seg_jobs:
                            j.ticket._resolve(False, dropped=True)
                for _, _, _, seg_fl in segments:
                    seg_fl.finish(None)
            finally:
                self.flight.device_exit()
                self._sem.release()

    def _guarded_settle(self, lane: LaneConfig, settle, fl=None,
                        count_stats: bool = True) -> "_health.SettleOutcome":
        """One watchdog-bounded settle with breaker accounting: OK
        records a success; a fault or watchdog expiry files the breaker
        fault (and, for the batch's FIRST failure, the per-lane stat)."""
        t0 = time.perf_counter()
        outcome = self.health.guard_settle(settle)
        if fl is not None:
            fl.note_device(time.perf_counter() - t0)
        if outcome.status == _health.OK:
            self.health.record_success()
            return outcome
        if outcome.status == _health.TIMEOUT:
            # abandon the hung settle: its daemon thread is expendable,
            # the pipeline slot is released by _complete's finally
            self._count_watchdog(lane.name)
            self.health.record_fault("watchdog")
            if fl is not None:
                fl.note_fault("watchdog")
        else:
            self.health.record_fault("settle")
            if fl is not None:
                fl.note_fault("settle")
        if count_stats:
            with self._stats_lock:
                self.stats[lane.name]["device_faults"] += 1
        return outcome

    def _settle_batch(self, lane, segments, items, settle,
                      fl=None) -> None:
        if fl is None:
            fl = self.flight.begin_batch(lane.name, "", len(items))
        outcome = self._guarded_settle(lane, settle, fl)
        if outcome.status == _health.FAULT:
            # fast fault: one bounded re-dispatch before degrading. A
            # TIMEOUT never retries — the ticket already spent its
            # watchdog budget, the host pass must start now.
            retry = self._retry_dispatch(lane, items, fl)
            if retry is not None:
                outcome = self._guarded_settle(lane, retry, fl,
                                               count_stats=False)
        if outcome.status != _health.OK:
            for seg_lane, _, _, _ in segments:
                self._count_batch(seg_lane, "degraded")
            t0 = time.perf_counter()
            verdicts = self._host_check_all(lane, items)
            fl.note_host(time.perf_counter() - t0)
            self._deliver_segments(segments, verdicts)
            return
        if bool(outcome.value):
            for seg_lane, _, _, _ in segments:
                self._count_batch(seg_lane, "ok")
            self._deliver_segments(segments, [True] * len(items))
            return
        with self._stage(lane, "fallback", items=len(items)):
            # the bisection shares ONE watchdog budget so a failed
            # batch still meets the deadline + one-host-pass bound
            deadline = time.monotonic() + self.health.settle_timeout_s
            t0 = time.perf_counter()
            verdicts = self._isolate(lane, list(items), deadline, fl)
            fl.note_bisect(time.perf_counter() - t0)
        if verdicts and all(verdicts):
            # device said "invalid", host verified every item: a
            # wrong-verdict device — the fault kind only canary probes
            # catch at re-promotion time
            self.health.record_fault("verdict")
            fl.note_fault("verdict")
        i = 0
        for seg_lane, _, seg_items, _ in segments:
            seg_v = verdicts[i:i + len(seg_items)]
            i += len(seg_items)
            self._count_batch(seg_lane, "ok" if all(seg_v) else "invalid")
        self._deliver_segments(segments, verdicts)

    def _isolate(self, lane: LaneConfig, items,
                 deadline: "Optional[float]" = None,
                 fl=None) -> "list[bool]":
        """Per-item verdicts for a failed batch. Preferred path: the
        on-device fault localizer (runtime/isolation.py) — O(log n)
        RLC-partition passes, host work bounded by named-bad leaves.
        Fallback (no localizer, no partition seam, breaker open): the
        legacy recursive host bisection."""
        if (
            self._localizer is not None and self.use_device
            # the RLC-partition localizer is a BLS seam (its host leaves
            # are SingleVerifier semantics); other schemes bisect, with
            # their own host twin at the leaf
            and self._scheme_for(lane).name == "bls"
            and self.health.allow_device()
        ):
            backend = self._backend_for(lane)
            if _isolation.FaultLocalizer.supports(backend):
                return self._localizer.localize(
                    backend, items, deadline=deadline, fl=fl
                )
        return self._bisect(lane, items, deadline, fl, 1)

    def _bisect(self, lane: LaneConfig, items,
                deadline: "Optional[float]" = None, fl=None,
                depth: int = 1) -> "list[bool]":
        """Recursive bisection of a failed batch — batch-check halves,
        descend only into failing halves, SingleVerifier at the leaf —
        so k bad items cost O(k·log n) checks, not n."""
        if fl is not None:
            fl.note_bisect(0.0, depth)
        if len(items) == 1:
            return [self._scheme_for(lane).host_check(items[0])]
        mid = len(items) // 2
        out: "list[bool]" = []
        for half in (items[:mid], items[mid:]):
            try:
                ok = self._batch_check(lane, half, deadline)
            except Exception:
                with self._stats_lock:
                    self.stats[lane.name]["device_faults"] += 1
                ok = False  # descend; leaves verify on the host
            out.extend(
                [True] * len(half)
                if ok else self._bisect(lane, half, deadline, fl, depth + 1)
            )
        return out

    def _batch_check(self, lane: LaneConfig, items,
                     deadline: "Optional[float]" = None) -> bool:
        """Bisection probe of one half: device when the breaker allows
        and the shared time budget has room, host otherwise."""
        if self.use_device and self.health.allow_device():
            budget = self.health.settle_timeout_s
            if deadline is not None:
                budget = min(budget, deadline - time.monotonic())
            if budget > 0:
                try:
                    settle = self._device_dispatch(lane, items)
                except Exception:
                    self.health.record_fault("dispatch")
                    raise
                if settle is not None:
                    outcome = self.health.guard_settle(
                        settle, timeout_s=budget
                    )
                    if outcome.status == _health.OK:
                        self.health.record_success()
                        return bool(outcome.value)
                    if outcome.status == _health.TIMEOUT:
                        self._count_watchdog(lane.name)
                        self.health.record_fault("watchdog")
                    else:
                        self.health.record_fault("settle")
                    # fall through: host verdict for this half
        hc = self._scheme_for(lane).host_check
        return all(hc(it) for it in items)

    def _host_check_all(self, lane: LaneConfig, items) -> "list[bool]":
        hc = self._scheme_for(lane).host_check
        with self._stage(lane, "execute", path="host", items=len(items)):
            return [hc(it) for it in items]

    def _deliver_segments(self, segments, verdicts) -> None:
        """Slice one merged dispatch's verdict vector back into its
        per-lane segments: each lane's jobs settle against its own
        slice and its own flight record — attribution is never blurred
        by the shared device pass."""
        i = 0
        for seg_lane, seg_jobs, seg_items, seg_fl in segments:
            seg_v = verdicts[i:i + len(seg_items)]
            i += len(seg_items)
            self._deliver(seg_lane, seg_jobs, seg_v)
            seg_fl.finish(all(seg_v))

    def _deliver(self, lane: LaneConfig, jobs, verdicts) -> None:
        i = 0
        for job in jobs:
            n = len(job.items)
            ok = all(verdicts[i:i + n])
            i += n
            with self._stats_lock:
                self.stats[lane.name]["accepted" if ok else "rejected"] += 1
            if not ok and job.ticket.origin is not None:
                # localization named this job's items bad: attribute the
                # failure to its gossip origin (bounded top-K table) and
                # quarantine it
                self.flight.note_origin_failure(job.ticket.origin)
                self.reputation.note_failure(job.ticket.origin)
            elif (
                ok and lane.name == "quarantine"
                and job.ticket.origin is not None
            ):
                # a clean quarantine batch steps the origin toward exit
                self.reputation.note_clean_batch(job.ticket.origin)
            job.ticket._resolve(ok)
        with self._cond:
            self._pending -= len(jobs)
            self._cond.notify_all()

    # ----------------------------------------------------------- control

    def device_degraded(self) -> bool:
        """True while the device plane is quarantined (breaker not
        CLOSED) — lets gossip shed accounting (p2p/network.py) tell
        overload-under-degradation from plain overload."""
        return self.use_device and self.health.state != _health.CLOSED

    def lane_pressure(self) -> "dict[str, float]":
        """Queue fullness per lane (queued jobs over max_queue) — the
        brownout controller's depth feed, read under _cond so the
        snapshot is coherent with in-flight shed decisions."""
        with self._cond:
            return {
                n: (len(self._queues[n]) / lane.max_queue
                    if lane.max_queue else 0.0)
                for n, lane in self.lanes.items()
            }

    def flush(self, timeout: float = 30.0) -> None:
        """Test barrier: wait until every submitted job has settled.
        Condition-variable wait, no polling: every _pending decrement
        (_deliver, stop-drain, containment) notifies _cond."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._cond.notify_all()  # nudge the dispatcher awake
            while self._pending != 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("verify scheduler did not drain")
                self._cond.wait(remaining)

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._dispatcher.join(timeout=10)
        # sentinel queues BEHIND pending settles so they drain first
        self._completion.put(None)
        self._completion_thread.join(timeout=10)


class DeferredVerifier(Verifier):
    """The `Verifier`-seam adapter: accumulate items, then `finish()`
    submits ONE job to the configured lane and waits the ticket
    (`finish_async` returns the zero-arg settle, preserving the
    verify-∥-process overlap). Aggregates keep their signer sets so the
    device kernel — not the host — does the key aggregation."""

    def __init__(self, scheduler: VerifyScheduler, lane: str = "block",
                 timeout: float = 30.0) -> None:
        self.scheduler = scheduler
        self.lane = lane
        self.timeout = timeout
        self.items: "list[VerifyItem]" = []

    def verify_singular(self, message, signature, public_key) -> None:
        self.items.append(
            VerifyItem(message, signature, public_keys=(public_key,))
        )

    def verify_aggregate(self, message, signature, public_keys) -> None:
        if not public_keys:
            raise SignatureInvalid("aggregate with no public keys")
        self.items.append(
            VerifyItem(message, signature, public_keys=public_keys)
        )

    def verify_aggregate_indexed(
        self, message, signature, member_indices, pubkey_columns
    ) -> None:
        if not member_indices:
            raise SignatureInvalid("aggregate with no public keys")
        self.items.append(
            VerifyItem(message, signature, member_indices=member_indices,
                       pubkey_columns=pubkey_columns)
        )

    def extend(self, triples) -> None:
        for t in triples:
            self.verify_singular(t.message, t.signature, t.public_key)

    def finish(self) -> None:
        self.finish_async()()

    def finish_async(self):
        if not self.items:
            return lambda: None
        items, self.items = self.items, []
        n = len(items)
        lane = self.lane
        ticket = self.scheduler.submit(lane, items)
        timeout = self.timeout

        def settle() -> None:
            if not ticket.result(timeout):
                raise SignatureInvalid(
                    f"batch of {n} failed {lane}-lane verification"
                )

        return settle


__all__ = [
    "DEFAULT_LANES",
    "DeferredVerifier",
    "LaneConfig",
    "VerifyItem",
    "VerifyScheduler",
    "VerifyTicket",
    "host_check_item",
]
