"""Scripted fault injection on the device seams (counterpart of
grandine_tpu/testing/chaos.py): `ChaosBackend` wraps a backend and injects
the faults a `FaultPlan` script lists, call by call.

  raise_dispatch  — the seam call itself raises (a dispatch fault)
  raise_settle    — the call returns, its settle raises (a readback fault)
  hang            — the settle (on `batch_sign`, the call) blocks until
                    `release_hangs()` (a wedged device; pairs with the
                    settle watchdog)
  wrong_verdict   — dispatch and settle succeed but the verdict comes back
                    inverted (a silently corrupt accelerator): only host
                    bisection and canary probes catch it
  wrong_signature — `batch_sign` returns its first signature
                    valid-looking but wrong (signed over another
                    message): it decodes cleanly, and only the release
                    gate catches it

The seams it wraps (VERIFY_SEAMS) are the ones the verify scheduler and
the fault localizer call: the BLS aggregate seams, compressed and not,
the subgroup and partition seams, the `ed25519` row's
`verify_batch_async` and the `blob_kzg` row's `verify_blobs_async` — each
only where the inner backend has it; the sign side's is `batch_sign`.
Everything else delegates to the inner backend, so the real kernels run
underneath.
The JAX wrapper's seeded rate plans are not ported: a plan here is a
script.

`KnownAnswerBackend` is the truth-table stub the scheduler tests run
underneath: verdicts come from a dict keyed by message bytes, so the
fault-free expectation is known exactly.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

#: injectable fault kinds
FAULT_KINDS = ("raise_dispatch", "raise_settle", "hang", "wrong_verdict",
               "wrong_signature")


def _not(verdict):
    return not verdict


def _invert_flags(flags):
    return ~np.asarray(flags)


#: the verify seams a ChaosBackend wraps, each with how `wrong_verdict`
#: inverts its settled value
VERIFY_SEAMS = {
    "fast_aggregate_verify_batch_async": _not,
    "fast_aggregate_verify_batch_indexed_async": _not,
    "fast_aggregate_verify_batch_compressed_async": _not,
    "fast_aggregate_verify_batch_indexed_compressed_async": _not,
    "g2_subgroup_check_batch_async": _invert_flags,
    "rlc_partition_verify_async": _invert_flags,
    "verify_batch_async": _not,  # the ed25519 row
    "verify_blobs_async": _not,  # the blob_kzg row
}


class ChaosFault(RuntimeError):
    """The injected failure (distinguishable from real bugs in logs)."""


class FaultPlan:
    """Deterministic fault schedule over seam calls: `script[i]` is the
    fault kind, or None, of the i-th call; calls past the script are
    fault-free. `injected` counts faults per kind."""

    def __init__(self, script: "Sequence[Optional[str]]") -> None:
        for kind in script:
            if kind is not None and kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
        self.script = list(script)
        self.calls = 0
        self.injected = {k: 0 for k in FAULT_KINDS}
        self._lock = threading.Lock()

    def next_fault(self) -> "Optional[str]":
        with self._lock:
            i = self.calls
            self.calls += 1
            kind = self.script[i] if i < len(self.script) else None
            if kind is not None:
                self.injected[kind] += 1
            return kind


class ChaosBackend:
    """Seam wrapper injecting `plan`-scheduled faults around an inner
    backend: each VERIFY_SEAMS method the inner has, and `batch_sign`;
    every other attribute is the inner backend's."""

    def __init__(self, inner, plan: FaultPlan) -> None:
        self.inner = inner
        self.plan = plan
        self.dispatches = 0  # seam calls that reached the wrapper
        self._lock = threading.Lock()
        self._hung: "list[threading.Event]" = []

    def __getattr__(self, name):
        # a verify seam is wrapped when, and only when, the inner backend
        # has it, so the scheduler's feature detection sees the inner's
        # seams
        attr = getattr(self.inner, name)
        invert = VERIFY_SEAMS.get(name)
        if invert is None:
            return attr
        return lambda *args: self._wrap(name, invert, args)

    def release_hangs(self) -> None:
        """Unblock every injected hang (teardown: lets abandoned watchdog
        threads finish)."""
        with self._lock:
            hung, self._hung = self._hung, []
        for ev in hung:
            ev.set()

    def _hang(self, method: str) -> None:
        ev = threading.Event()
        with self._lock:
            self._hung.append(ev)
        ev.wait()
        raise ChaosFault(f"released injected hang on {method}")

    def _wrap(self, method: str, invert, args):
        with self._lock:
            self.dispatches += 1
        kind = self.plan.next_fault()
        if kind == "raise_dispatch":
            raise ChaosFault(f"injected dispatch fault on {method}")
        inner_settle = getattr(self.inner, method)(*args)

        def settle():
            if kind == "raise_settle":
                raise ChaosFault(f"injected settle fault on {method}")
            if kind == "hang":
                self._hang(method)
            value = inner_settle()
            return invert(value) if kind == "wrong_verdict" else value

        return settle

    # --- the sign seam --------------------------------------------------------

    def batch_sign(self, messages, secret_keys):
        """The signing plane's device seam (blocking), with this call's
        scripted fault."""
        with self._lock:
            self.dispatches += 1
        kind = self.plan.next_fault()
        if kind in ("raise_dispatch", "raise_settle"):
            raise ChaosFault("injected dispatch fault on batch_sign")
        if kind == "hang":
            self._hang("batch_sign")
        sigs = self.inner.batch_sign(messages, secret_keys)
        if kind in ("wrong_signature", "wrong_verdict") and sigs:
            sigs = list(sigs)
            sigs[0] = secret_keys[0].sign(
                b"chaos: wrong message " + bytes(messages[0])
            )
        return sigs


class KnownAnswerBackend:
    """Truth-table async seam: the batch verdict is the AND of
    `truth[message_bytes]` over the batch (missing messages are invalid).
    Subgroup checks always pass — signature geometry is not under test
    here, verdict plumbing is."""

    def __init__(self, truth: "Optional[dict]" = None) -> None:
        self.truth = dict(truth or {})
        self.batches: "list[int]" = []
        #: (items, groups) per rlc_partition dispatch
        self.partitions: "list[tuple]" = []

    def g2_subgroup_check_batch_async(self, points):
        n = len(points)
        return lambda: np.ones((n,), dtype=bool)

    # the ed25519 / blob_kzg seams: the scheme dispatch calls prepare()
    # first, then the async seam; the "prep" is the message bytes, so the
    # verdicts stay keyed by the same truth table as the BLS seam

    def prepare(self, items):
        return "ok", [bytes(it.message) for it in items]

    def verify_batch_async(self, prep):
        self.batches.append(len(prep))
        return lambda: all(self.truth.get(m, False) for m in prep)

    def verify_blobs_async(self, prep):
        self.batches.append(len(prep))
        return lambda: all(self.truth.get(m, False) for m in prep)

    def fast_aggregate_verify_batch_async(self, messages, signatures, keys):
        self.batches.append(len(messages))
        msgs = [bytes(m) for m in messages]
        return lambda: all(self.truth.get(m, False) for m in msgs)

    def rlc_partition_verify_async(self, messages, signatures, member_keys,
                                   groups):
        """Per-group AND over the truth table with the device backend's
        padding geometry (pow-2 bucket lo=4, pad groups are clean)."""
        n = len(messages)
        self.partitions.append((n, int(groups)))
        b = 4
        while b < n:
            b <<= 1
        g = 4
        while g < groups:
            g <<= 1
        g = min(g, b)
        span = b // g
        flags = [self.truth.get(bytes(m), False) for m in messages]
        flags += [True] * (b - n)
        out = np.array([all(flags[j * span:(j + 1) * span])
                        for j in range(g)], dtype=bool)
        return lambda: out


__all__ = ["FAULT_KINDS", "VERIFY_SEAMS", "ChaosBackend", "ChaosFault",
           "FaultPlan", "KnownAnswerBackend"]
