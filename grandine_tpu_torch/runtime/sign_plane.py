"""The device signing plane (counterpart of grandine_tpu/runtime/
sign_plane.py): every validator duty signature funnels into one
multi-lane batch-signing plane. `submit` coalesces (signing root, secret
key, duty kind) requests under a deadline-or-max_batch policy per lane
into `batch_sign` launches on the card (gpu/bls.py, one dual 128-bit GLV
ladder a signature), hands back ticket futures, and `pipeline_depth`
worker threads overlap one batch's host work with another's device run.

  release gate — before any caller sees a device-produced batch, the plane
      batch-verifies it against the callers' public keys in one RLC
      `multi_verify` on the card (`SigningDescriptor.release_verify`). A
      batch that fails is re-signed on the host anchor and files a
      `verdict` fault with the health supervisor: no bad signature is
      released.
  slashing interlock — a per-pubkey monotonic (duty kind, slot/epoch)
      low-watermark (`SignInterlock`) refuses a regressing block or
      attestation request before it reaches a kernel.

Degradation: a breaker-open device, a watchdog-expired dispatch or a
failed gate all fall back to the host `sk.sign` anchor (byte-identical by
contract), so a device fault never misses a duty. Scheme resolution goes
through the gpu/schemes.py table only. The backend runs on the card unless
the plane is built with `device="cpu"`. `metrics` is accepted and handed
to the health supervisor; the port has no metrics sink yet.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.gpu import schemes as _schemes
from grandine_tpu_torch.runtime import flight as _flight
from grandine_tpu_torch.runtime import health as _health
from grandine_tpu_torch.runtime.thread_pool import Priority

#: slashing-interlock refusal reasons (a closed set)
REFUSAL_REASONS = ("block_regression", "attestation_regression")

#: duty kinds the interlock watermark applies to → refusal reason.
#: Everything else (randao, sync messages, selection proofs, aggregate
#: proofs) is not slashable and passes through uncounted.
SLASHABLE_KINDS = {
    "block": "block_regression",
    "attestation": "attestation_regression",
}


class SignRefused(Exception):
    """The slashing interlock refused this request (regressing block
    slot / attestation target epoch for the pubkey's watermark)."""

    def __init__(self, reason: str, duty_kind: str, index: int) -> None:
        super().__init__(
            f"signing refused ({reason}): {duty_kind} at {index} does "
            f"not advance the pubkey's low-watermark"
        )
        self.reason = reason
        self.duty_kind = duty_kind
        self.index = index


class SignInterlock:
    """Minimal slashing-protection interlock in front of the plane: a
    per-pubkey monotonic (duty_kind, slot/epoch) low-watermark. A
    request whose index does not strictly advance the watermark is
    refused — conservatively including re-signing the SAME slot/epoch,
    which the full SlashingProtection store would allow for identical
    data; the plane's interlock is a last-line device-side guard, not a
    replacement for validator/slashing_protection.py.

    Watermarks persist through any `db` with `get(key)` / `put(key,
    value)` (the JAX package's `storage.Database` key format: prefix
    ``sgn:w:``, then duty kind, ``:`` and pubkey, an 8-byte little-endian
    index), with a write-through in-memory mirror so the hot path pays one
    dict probe. All state is guarded by `_lock` (submit arrives from every
    validator thread at once)."""

    _PREFIX = b"sgn:w:"

    def __init__(self, db=None) -> None:
        self._db = db
        self._lock = threading.Lock()
        self._marks: "dict[tuple[str, bytes], int]" = {}

    def _key(self, duty_kind: str, pubkey: bytes) -> bytes:
        return self._PREFIX + duty_kind.encode() + b":" + pubkey

    def check_and_advance(
        self, pubkey: bytes, duty_kind: str, index: "Optional[int]"
    ) -> "Optional[str]":
        """None when the request is allowed (watermark advanced and
        persisted); the refusal reason string otherwise. Non-slashable
        duty kinds and index-less requests always pass."""
        reason = SLASHABLE_KINDS.get(duty_kind)
        if reason is None or index is None:
            return None
        index = int(index)
        with self._lock:
            mark = self._marks.get((duty_kind, pubkey))
            if mark is None and self._db is not None:
                raw = self._db.get(self._key(duty_kind, pubkey))
                if raw is not None:
                    mark = int.from_bytes(raw, "little")
            if mark is not None and index <= mark:
                return reason
            self._marks[(duty_kind, pubkey)] = index
            if self._db is not None:
                self._db.put(
                    self._key(duty_kind, pubkey), index.to_bytes(8, "little")
                )
        return None

    def watermark(
        self, pubkey: bytes, duty_kind: str
    ) -> "Optional[int]":
        with self._lock:
            mark = self._marks.get((duty_kind, pubkey))
            if mark is None and self._db is not None:
                raw = self._db.get(self._key(duty_kind, pubkey))
                if raw is not None:
                    mark = int.from_bytes(raw, "little")
            return mark


class SignLaneConfig:
    """One signing lane's flush/backpressure policy (the sign-side
    LaneConfig)."""

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
        #: LOW lanes shed oldest-first at max_queue (a dropped ticket
        #: degrades the caller to its host path — the duty is never
        #: lost); HIGH lanes block the submitter instead
        self.shed = bool(shed)
        self.scheme = str(scheme)


#: the signing lane table (the JAX package's). Block/randao flush almost
#: immediately (a proposal is one signature on a hard deadline);
#: attestation/sync-message lanes coalesce the per-slot many-validator
#: burst into big batches.
DEFAULT_SIGN_LANES = (
    SignLaneConfig("block", Priority.HIGH, 4, 0.001, 256, shed=False),
    SignLaneConfig("randao", Priority.HIGH, 8, 0.001, 256, shed=False),
    SignLaneConfig("attestation", Priority.HIGH, 512, 0.020, 16384,
                   shed=False),
    SignLaneConfig("sync_message", Priority.HIGH, 512, 0.020, 16384,
                   shed=False),
    SignLaneConfig("aggregate", Priority.HIGH, 64, 0.010, 4096,
                   shed=False),
    SignLaneConfig("sync_contribution", Priority.HIGH, 64, 0.010, 4096,
                   shed=False),
    SignLaneConfig("selection_proof", Priority.LOW, 64, 0.010, 4096,
                   shed=True),
    SignLaneConfig("other", Priority.LOW, 64, 0.025, 4096, shed=True),
)


class SignTicket:
    """Future handed back by `submit`: resolves to the wire-encoded
    signature bytes, or `dropped=True` when the request was shed at
    shutdown/overload (the caller degrades to its own host path)."""

    __slots__ = ("lane", "enqueued_at", "settled_at", "dropped",
                 "deadline", "_sig", "_event", "_callbacks", "_lock")

    def __init__(self, lane: str,
                 deadline: "Optional[float]" = None) -> None:
        self.lane = lane
        #: absolute monotonic deadline (the duty's proposal/attestation
        #: window, stamped at submit): past it the job skips device
        #: batching and degrades straight to the host anchor — the duty
        #: is still produced, the device dispatch is not wasted
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self.settled_at: "Optional[float]" = None
        self.dropped = False
        # _resolve writes it under _lock before _event.set(); readers gate
        # on the Event — the happens-before edge
        self._sig: "Optional[bytes]" = None
        self._event = threading.Event()
        self._callbacks: "list[Callable]" = []
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: "Optional[float]" = None) -> bytes:
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.lane} sign ticket not settled")
        # Event.wait() is the happens-before edge for the _sig write
        if self._sig is None:
            raise RuntimeError(
                f"{self.lane} sign request dropped at shutdown"
            )
        return self._sig

    def add_callback(self, fn: "Callable[[SignTicket], None]") -> None:
        """Run fn(ticket) once settled (immediately if already done)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, sig: "Optional[bytes]",
                 dropped: bool = False) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._sig = sig
            self.dropped = dropped
            self.settled_at = time.monotonic()
            callbacks, self._callbacks = self._callbacks, []
            self._event.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                pass  # a consumer's callback must not break settling


class _SignJob:
    __slots__ = ("signing_root", "secret_key", "public_key", "duty_kind",
                 "ticket")

    def __init__(self, signing_root: bytes, secret_key, public_key,
                 duty_kind: str, ticket: SignTicket) -> None:
        self.signing_root = bytes(signing_root)
        self.secret_key = secret_key
        self.public_key = public_key
        self.duty_kind = duty_kind
        self.ticket = ticket


class SigningPlane:
    """submit → coalesce → device batch_sign → release gate → release.

    One dispatcher thread forms batches (HIGH lanes flush first among
    due lanes); `pipeline_depth` worker threads run the blocking device
    dispatch + release gate so two batches overlap (host prep of one
    against device execute of the other). The breaker
    (`BackendHealthSupervisor`) gates device use; every degradation lands
    on the host `sk.sign` anchor so a duty deadline is never missed.
    `device` is the card the scheme backend is built on (None: CUDA;
    "cpu": the kernels' plain versions). Unless a backend is given or
    `use_device` is off, the backend and its kernels are built here, so a
    missing card or a failed build raises from the constructor; only a
    fault after a good build degrades to the host."""

    def __init__(
        self,
        backend=None,
        lanes: "Optional[Sequence[SignLaneConfig]]" = None,
        use_device: bool = True,
        pipeline_depth: int = 2,
        metrics=None,
        health: "Optional[_health.BackendHealthSupervisor]" = None,
        settle_timeout_s: float = 5.0,
        flight: "Optional[_flight.FlightRecorder]" = None,
        interlock: "Optional[SignInterlock]" = None,
        db=None,
        release_gate: bool = True,
        deadline_margin_s: float = 0.05,
        device=None,
    ) -> None:
        self.metrics = metrics
        self.device = device
        self.use_device = bool(use_device)
        #: release-gate toggle — ONLY for benches measuring the gate's
        #: overhead; production keeps it on (the plane's core promise)
        self.release_gate = bool(release_gate)
        self.lanes = {
            lane.name: lane
            for lane in (lanes if lanes is not None else DEFAULT_SIGN_LANES)
        }
        self.health = (
            health if health is not None
            else _health.BackendHealthSupervisor(
                metrics=metrics, settle_timeout_s=settle_timeout_s,
                name="sign-device",
            )
        )
        self.flight = (
            flight if flight is not None
            else _flight.FlightRecorder()
        )
        self.interlock = (
            interlock if interlock is not None else SignInterlock(db=db)
        )
        #: safety margin subtracted from a ticket's absolute deadline
        #: when computing its effective flush due-time — a near-deadline
        #: head flushes early enough to dispatch AND settle in-window
        self.deadline_margin_s = float(deadline_margin_s)
        self._injected_backend = backend
        self._backends: "dict[str, object]" = {}
        if self.use_device and backend is None:
            # built here, outside the watchdog: a missing card or a kernel
            # that does not build raises now, never as a quiet host degrade
            # of every batch
            for name in {lane.scheme for lane in self.lanes.values()}:
                if _schemes.get(name).signing is not None:
                    self._backends[name] = _schemes.get(name).make_backend(
                        device=device)
        #: pubkey-by-scalar cache for submitters that pass no
        #: public_key: deriving pk = [sk]g1 on the host costs a scalar
        #: mul, paid once per key per process. In-process only — the
        #: keys already live in this address space. All access stays
        #: inside _pk_lock.
        self._pk_lock = threading.Lock()
        self._pk_cache: "dict[int, object]" = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: "dict[str, deque]" = {
            name: deque() for name in self.lanes
        }
        self._pending = 0
        self._stop = False
        self._stats_lock = threading.Lock()
        self._stats = {
            name: {
                "submitted": 0, "batches": 0, "signed": 0, "refused": 0,
                "dropped": 0, "device_batches": 0, "degraded": 0,
                "host_batches": 0, "breaker_skips": 0, "device_faults": 0,
                "gate_failures": 0, "max_batch_items": 0, "expired": 0,
            }
            for name in self.lanes
        }
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(pipeline_depth))
        )
        # threads are constructed before ANY starts so a worker can
        # never observe a half-built plane (init-escape lint)
        self._workers = [
            threading.Thread(
                target=self._worker_loop, name=f"sign-plane-worker-{i}",
                daemon=True,
            )
            for i in range(max(1, int(pipeline_depth)))
        ]
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="sign-plane-dispatch",
            daemon=True,
        )
        self._dispatcher.start()
        for t in self._workers:
            t.start()

    # ------------------------------------------------------------ submit

    def _lane_for(self, duty_kind: str) -> SignLaneConfig:
        lane = self.lanes.get(duty_kind)
        if lane is None:
            lane = self.lanes.get("other")
        if lane is None:  # custom lane tables without a catch-all
            lane = next(iter(self.lanes.values()))
        return lane

    def _public_key_for(self, secret_key, public_key):
        if public_key is not None:
            if isinstance(public_key, (bytes, bytearray)):
                return A.PublicKey.from_bytes(bytes(public_key))
            return public_key
        scalar = secret_key.scalar
        with self._pk_lock:
            pk = self._pk_cache.get(scalar)
            if pk is None:
                pk = secret_key.public_key()
                if len(self._pk_cache) >= 1 << 17:
                    self._pk_cache.clear()  # bounded; refill is cheap
                self._pk_cache[scalar] = pk
            return pk

    def submit(
        self,
        signing_root: bytes,
        secret_key,
        duty_kind: str = "other",
        public_key=None,
        index: "Optional[int]" = None,
        deadline: "Optional[float]" = None,
        deadline_s: "Optional[float]" = None,
    ) -> SignTicket:
        """Enqueue one signing request; returns a SignTicket future.

        `index` is the duty's slot (block) or target epoch
        (attestation): the slashing interlock refuses a request that
        does not strictly advance the pubkey's watermark, raising
        SignRefused BEFORE anything reaches a kernel.

        `deadline` (absolute monotonic) or `deadline_s` (relative to
        now) stamps the duty's window — the slot's proposal window for
        a block, the attestation broadcast window for attestations. A
        request overtaken by its window degrades to the host anchor
        (the duty is STILL produced) instead of riding a device batch
        it can no longer benefit from."""
        public_key = self._public_key_for(secret_key, public_key)
        reason = None
        if duty_kind in SLASHABLE_KINDS and index is not None:
            # only a watermarked request needs the key's encoding
            reason = self.interlock.check_and_advance(
                public_key.to_bytes(), duty_kind, index
            )
        lane = self._lane_for(duty_kind)
        if reason is not None:
            with self._stats_lock:
                self._stats[lane.name]["refused"] += 1
            raise SignRefused(reason, duty_kind, index)
        if deadline is None and deadline_s is not None:
            deadline = time.monotonic() + float(deadline_s)
        ticket = SignTicket(lane.name, deadline=deadline)
        job = _SignJob(signing_root, secret_key, public_key, duty_kind,
                       ticket)
        shed_job = None
        with self._lock:
            if self._stop:
                ticket._resolve(None, dropped=True)
                return ticket
            q = self._queues[lane.name]
            if len(q) >= lane.max_queue:
                if lane.shed:
                    shed_job = q.popleft()
                else:
                    # HIGH lane backpressure: bounded producer, never
                    # a dropped duty
                    while len(q) >= lane.max_queue and not self._stop:
                        self._cond.wait(0.005)
                    if self._stop:
                        ticket._resolve(None, dropped=True)
                        return ticket
            q.append(job)
            self._pending += 1
            self._cond.notify_all()
        if shed_job is not None:
            shed_job.ticket._resolve(None, dropped=True)
            self._count_shed(lane, 1)
            with self._lock:
                self._pending -= 1
        with self._stats_lock:
            self._stats[lane.name]["submitted"] += 1
        return ticket

    def _count_shed(self, lane: SignLaneConfig, n: int) -> None:
        """Every shed or drop is counted here."""
        with self._stats_lock:
            self._stats[lane.name]["dropped"] += n

    def sign_many(
        self,
        requests: "Sequence[tuple]",
        duty_kind: str = "other",
        timeout: "Optional[float]" = 30.0,
    ) -> "list[bytes]":
        """Convenience batch submit-and-wait: requests are
        (signing_root, secret_key) pairs; returns wire signatures in
        order. One plane flush covers the whole slot's duty burst."""
        tickets = [
            self.submit(root, sk, duty_kind=duty_kind)
            for root, sk in requests
        ]
        return [t.result(timeout) for t in tickets]

    # --------------------------------------------------------- scheduling

    def _effective_due(self, ticket: SignTicket,
                       lane: SignLaneConfig) -> float:
        """When a lane's head must flush: the lane's max_wait, or —
        when the ticket carries a duty-window deadline — early enough
        (deadline minus the dispatch/settle margin) that a near-
        deadline head preempts coalescing."""
        due = ticket.enqueued_at + lane.max_wait_s
        if ticket.deadline is not None:
            due = min(due, ticket.deadline - self.deadline_margin_s)
        return due

    def _pick_lane(self) -> "Optional[SignLaneConfig]":
        """Called under _lock: a lane that is full or overdue — HIGH
        priority first, then the most-overdue head."""
        now = time.monotonic()
        best = None
        best_key = None
        for lane in self.lanes.values():
            q = self._queues[lane.name]
            if not q:
                continue
            overdue = now - self._effective_due(q[0].ticket, lane)
            if len(q) >= lane.max_batch or overdue >= 0.0:
                key = (lane.priority != Priority.HIGH, -overdue)
                if best is None or key < best_key:
                    best, best_key = lane, key
        return best

    def _nearest_deadline(self) -> "Optional[float]":
        """Called under _lock: seconds until the next lane flush is due,
        or None when every queue is empty."""
        now = time.monotonic()
        nearest = None
        for lane in self.lanes.values():
            q = self._queues[lane.name]
            if not q:
                continue
            due = self._effective_due(q[0].ticket, lane) - now
            if nearest is None or due < nearest:
                nearest = due
        return nearest

    def _pop_batch(self, lane: SignLaneConfig) -> "list[_SignJob]":
        """Called under _lock."""
        q = self._queues[lane.name]
        out = []
        while q and len(out) < lane.max_batch:
            out.append(q.popleft())
        return out

    def _dispatch_loop(self) -> None:
        """Dispatcher daemon: coalesce queues into batches and hand them
        to the worker pool. Crash containment per iteration — one bad
        batch must not kill the plane."""
        while True:
            try:
                if self._dispatch_once():
                    return
            except Exception:
                time.sleep(0.005)  # containment: never spin hot

    def _dispatch_once(self) -> bool:
        """One dispatcher iteration; True means stop-drain finished."""
        to_drop = None
        batch = None
        lane = None
        with self._lock:
            # _stop is re-read under the SAME lock that guarded the
            # queue reads: a stop() landing after release cannot be
            # half-observed
            if self._stop:
                to_drop = [
                    job for q in self._queues.values() for job in q
                ]
                for q in self._queues.values():
                    q.clear()
            else:
                lane = self._pick_lane()
                if lane is None:
                    due = self._nearest_deadline()
                    self._cond.wait(
                        0.05 if due is None else max(0.0005, due)
                    )
                    return False
                batch = self._pop_batch(lane)
        if to_drop is not None:
            for job in to_drop:
                job.ticket._resolve(None, dropped=True)
            if to_drop:
                by_lane: "dict[str, int]" = {}
                for job in to_drop:
                    by_lane[job.ticket.lane] = (
                        by_lane.get(job.ticket.lane, 0) + 1
                    )
                for name, n in by_lane.items():
                    self._count_shed(self.lanes[name], n)
                with self._lock:
                    self._pending -= len(to_drop)
                    self._cond.notify_all()
            return True
        if batch:
            self._inflight.put((lane, batch))
        return False

    def _worker_loop(self) -> None:
        """Worker daemon: full batch life (device sign → release gate →
        resolve), one batch at a time; pipeline_depth workers give the
        two-deep overlap. Crash containment: an unexpected error
        degrades the batch to the host anchor rather than dropping it."""
        while True:
            handoff = self._inflight.get()
            if handoff is None:
                return
            lane, jobs = handoff
            try:
                self._process_batch(lane, jobs)
            except Exception:
                try:
                    self._resolve_on_host(lane, jobs, note_fault=True)
                except Exception:
                    for job in jobs:  # last resort: never hang a caller
                        job.ticket._resolve(None, dropped=True)
            finally:
                with self._lock:
                    self._pending -= len(jobs)
                    self._cond.notify_all()

    # ---------------------------------------------------------- batch life

    def _backend_for(self, lane: SignLaneConfig):
        """The injected backend, or the lane's scheme backend built at
        construction (table-resolved only)."""
        if self._injected_backend is not None:
            return self._injected_backend
        return self._backends[lane.scheme]

    def _host_sign_all(self, signing, jobs: "list[_SignJob]"
                       ) -> "list[bytes]":
        return [
            signing.host_sign(job.signing_root, job.secret_key)
            for job in jobs
        ]

    def _shed_expired(self, lane: SignLaneConfig, signing,
                      jobs: "list[_SignJob]") -> None:
        """Deadline-budget expiry on the sign side: the duty's window
        closed while the job sat in the lane, so it skips the device
        batch entirely — but the duty is STILL produced, on the host
        anchor (a late signature beats a missed one). The shed lands on
        the flight timeline with cause="expired"."""
        with self._stats_lock:
            self._stats[lane.name]["expired"] += len(jobs)
        self.flight.record_shed(lane.name, len(jobs), "expired")
        if signing is None:
            for job in jobs:
                job.ticket._resolve(None, dropped=True)
            return
        for job in jobs:
            job.ticket._resolve(
                signing.host_sign(job.signing_root, job.secret_key)
            )

    def _process_batch(self, lane: SignLaneConfig,
                       jobs: "list[_SignJob]") -> None:
        signing = _schemes.get(lane.scheme).signing
        now = time.monotonic()
        # deadline-budget gate: window-expired jobs resolve on the host
        # anchor here, before the batch spends a device dispatch — the
        # worker's _pending accounting still covers them (they remain
        # part of this handoff)
        live: "list[_SignJob]" = []
        expired: "list[_SignJob]" = []
        for job in jobs:
            t = job.ticket.deadline
            (expired if (t is not None and now >= t) else live).append(job)
        if expired:
            self._shed_expired(lane, signing, expired)
            if not live:
                return
            jobs = live
        queue_wait = max(
            0.0, now - min(job.ticket.enqueued_at for job in jobs)
        )
        result = "host"
        sigs: "Optional[list[bytes]]" = None
        fl = self.flight.begin_batch(
            lane.name, "batch_sign", len(jobs),
            queue_wait_s=queue_wait, breaker_state=self.health.state,
        )
        device_wanted = (
            self.use_device and signing is not None
        )
        if device_wanted and not self.health.allow_device():
            device_wanted = False
            with self._stats_lock:
                self._stats[lane.name]["breaker_skips"] += 1
        backend = self._backend_for(lane) if device_wanted else None
        if backend is not None:
            messages = [job.signing_root for job in jobs]
            sks = [job.secret_key for job in jobs]
            self.flight.device_enter()
            try:
                t0 = time.perf_counter()
                outcome = self.health.guard_settle(
                    lambda: signing.batch_sign(backend, messages, sks),
                    thread_name="sign-settle-watchdog",
                )
                if outcome.status == _health.OK:
                    fl.note_device(time.perf_counter() - t0)
                    produced = outcome.value
                    if self.release_gate:
                        t1 = time.perf_counter()
                        gate_ok = signing.release_verify(
                            backend, messages, produced,
                            [job.public_key for job in jobs],
                        )
                        fl.note_device(time.perf_counter() - t1)
                        if gate_ok:
                            sigs = produced
                            result = "device"
                            self.health.record_success()
                        else:
                            # the core promise: a batch that fails the
                            # gate is NEVER released — host re-sign, and
                            # the breaker hears about the bad verdict
                            self.health.record_fault("verdict")
                            fl.note_fault("verdict")
                            with self._stats_lock:
                                self._stats[lane.name]["gate_failures"] += 1
                                self._stats[lane.name]["device_faults"] += 1
                            result = "degraded"
                    else:
                        sigs = produced
                        result = "device"
                        self.health.record_success()
                elif outcome.status == _health.TIMEOUT:
                    self.health.record_fault("watchdog")
                    fl.note_fault("watchdog")
                    with self._stats_lock:
                        self._stats[lane.name]["device_faults"] += 1
                    result = "degraded"
                else:
                    self.health.record_fault("dispatch")
                    fl.note_fault("dispatch")
                    with self._stats_lock:
                        self._stats[lane.name]["device_faults"] += 1
                    result = "degraded"
            finally:
                self.flight.device_exit()
        if sigs is None:
            if signing is None:
                # no sign-side scheme row: nothing to anchor against —
                # refuse by dropping (callers keep their own host path)
                for job in jobs:
                    job.ticket._resolve(None, dropped=True)
                fl.finish(False)
                return
            t0 = time.perf_counter()
            sigs = self._host_sign_all(signing, jobs)
            fl.note_host(time.perf_counter() - t0)
        for job, sig in zip(jobs, sigs):
            job.ticket._resolve(sig)
        fl.finish(True)
        with self._stats_lock:
            st = self._stats[lane.name]
            st["batches"] += 1
            st["signed"] += len(jobs)
            st["max_batch_items"] = max(st["max_batch_items"], len(jobs))
            if result == "device":
                st["device_batches"] += 1
            elif result == "degraded":
                st["degraded"] += 1
            else:
                st["host_batches"] += 1

    def _resolve_on_host(self, lane: SignLaneConfig,
                         jobs: "list[_SignJob]",
                         note_fault: bool = False) -> None:
        """Containment path: resolve every ticket on the host anchor."""
        signing = _schemes.get(lane.scheme).signing
        if signing is None:
            for job in jobs:
                job.ticket._resolve(None, dropped=True)
            return
        if note_fault:
            self.health.record_fault("dispatch")
            with self._stats_lock:
                self._stats[lane.name]["device_faults"] += 1
                self._stats[lane.name]["degraded"] += 1
        for job in jobs:
            job.ticket._resolve(
                signing.host_sign(job.signing_root, job.secret_key)
            )

    # ------------------------------------------------------------ control

    def flush(self, timeout: "Optional[float]" = None) -> bool:
        """Block until every submitted request has settled (or timeout);
        True when fully drained."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        with self._lock:
            while self._pending > 0:
                wait = 0.05
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                self._cond.wait(wait)
        return True

    def stop(self, timeout: float = 5.0) -> None:
        """Drain in-flight batches, drop queued requests (tickets settle
        dropped=True), and join the plane's threads."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
            self._cond.notify_all()
        self._dispatcher.join(timeout)
        for _ in self._workers:
            self._inflight.put(None)
        for t in self._workers:
            t.join(timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                name: dict(st) for name, st in self._stats.items()
            }


__all__ = [
    "DEFAULT_SIGN_LANES",
    "REFUSAL_REASONS",
    "SLASHABLE_KINDS",
    "SignInterlock",
    "SignLaneConfig",
    "SignRefused",
    "SignTicket",
    "SigningPlane",
]
