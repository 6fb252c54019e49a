"""Scripted fault injection on the signing plane's device seam
(counterpart of grandine_tpu/testing/chaos.py:43-235, its `batch_sign`
faults): `ChaosBackend` wraps a backend and injects the faults a
`FaultPlan` script lists, call by call.

  raise_dispatch  — the call raises (a dispatch fault)
  hang            — the call blocks until `release_hangs()` (a wedged
                    device; pairs with the settle watchdog)
  wrong_signature — the batch comes back with its first signature
                    valid-looking but wrong (signed over another message):
                    it decodes cleanly, and only the release gate catches it

Everything else delegates to the inner backend, so the gate's
`multi_verify` runs on the real kernels. The JAX wrapper's rate-driven
plans, its other fault kinds and its verify-side seams come with the
verify scheduler.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

#: injectable fault kinds on `batch_sign`
FAULT_KINDS = ("raise_dispatch", "hang", "wrong_signature")


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
    """`batch_sign` wrapper injecting `plan`-scheduled faults around an
    inner backend; every other attribute is the inner backend's."""

    def __init__(self, inner, plan: FaultPlan) -> None:
        self.inner = inner
        self.plan = plan
        self._lock = threading.Lock()
        self._hung: "list[threading.Event]" = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def release_hangs(self) -> None:
        """Unblock every injected hang (teardown: lets abandoned watchdog
        threads finish)."""
        with self._lock:
            hung, self._hung = self._hung, []
        for ev in hung:
            ev.set()

    def batch_sign(self, messages, secret_keys):
        """The signing plane's device seam (blocking), with this call's
        scripted fault."""
        kind = self.plan.next_fault()
        if kind == "raise_dispatch":
            raise ChaosFault("injected dispatch fault on batch_sign")
        if kind == "hang":
            ev = threading.Event()
            with self._lock:
                self._hung.append(ev)
            ev.wait()
            raise ChaosFault("released injected hang on batch_sign")
        sigs = self.inner.batch_sign(messages, secret_keys)
        if kind == "wrong_signature" and sigs:
            sigs = list(sigs)
            sigs[0] = secret_keys[0].sign(
                b"chaos: wrong message " + bytes(messages[0])
            )
        return sigs


__all__ = ["FAULT_KINDS", "ChaosBackend", "ChaosFault", "FaultPlan"]
