"""Fault localization of a failed verify batch on the card (counterpart of
grandine_tpu/runtime/isolation.py FANOUT, ladder, max_device_passes and
FaultLocalizer; ReputationTable and AdmissionController come with the
scheduler).

A gossip batch's verdict is one bool: one forged aggregate rejects the
whole batch. `FaultLocalizer.localize` turns the failed batch into
per-item verdicts with a bounded number of device passes — one per-item
G2 subgroup pass (`g2_subgroup_check_batch_async`), then a fixed-fanout
descent of `rlc_partition_verify_async` passes over group counts
FANOUT, FANOUT², … up to the bucket (`ladder`) — and host checks of only
the leaves the device named bad at the per-item rung, so a trickle of
forgeries costs a few device passes rather than host verification of
every item.

Unlike the reference, a device fault is not swept on the host: an
exception from a dispatch or a settle (a kernel that does not build or
launch, a CUDA error, a wrapper's ValueError) propagates to the caller.
The port has no backend health supervisor yet, so there is no breaker
and no watchdog; the only host sweep is the deadline's.
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

#: descent fanout: each device pass splits every still-suspect group into
#: FANOUT sub-groups
FANOUT = 8


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
    by kind: "g2_subgroup", "rlc_partition" and "host" (a deadline
    sweep)."""

    def __init__(self, host_check: "Optional[Callable]" = None,
                 fanout: int = FANOUT) -> None:
        assert fanout >= 2 and fanout & (fanout - 1) == 0
        self.fanout = fanout
        #: None → runtime/verify_scheduler.py host_check_item, looked up
        #: at each call
        self.host_check = host_check
        self.passes: Counter = Counter()
        self._lock = threading.Lock()

    def _leaf_check(self, item) -> bool:
        if self.host_check is not None:
            return bool(self.host_check(item))
        from grandine_tpu_torch.runtime import verify_scheduler as _vs

        return bool(_vs.host_check_item(item))

    def _count_pass(self, kind: str) -> None:
        with self._lock:
            self.passes[kind] += 1

    @staticmethod
    def _expired(deadline: "Optional[float]") -> bool:
        return deadline is not None and deadline - time.monotonic() <= 0

    def localize(self, backend, items,
                 deadline: "Optional[float]" = None) -> "list[bool]":
        """Per-item verdicts for a batch the device called invalid.

        A host pre-pass names the items that cannot reach the device (an
        undecodable or ∞ signature, no usable keys) and takes the host
        check's verdict for them; one device pass gives per-item subgroup
        verdicts (a named-bad item becomes a host leaf); then the
        partition descent narrows the suspects to the per-item rung,
        whose named-bad leaves the host confirms. An item of a group the
        device clears is True. Device passes: at most
        `max_device_passes(len(items))`.

        Differs from the reference's `localize` (and its `_host_sweep`)
        in one way: a device dispatch or settle that raises is not caught
        and swept on the host, because a fallback there would hide a
        kernel that fails to build, launch or run; the exception reaches
        the caller. The one sweep left is the deadline: once it has
        passed before a pass, the remaining suspects go to the host check,
        counted as one "host" pass."""
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
        if self._expired(deadline):
            return self._host_sweep(items, verdicts, live)

        # device pass 0: per-item subgroup verdicts
        flags = np.asarray(
            backend.g2_subgroup_check_batch_async(
                [points[i] for i in live])(), bool)
        self._count_pass("g2_subgroup")
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
        for groups in ladder(b, self.fanout):
            if not suspects:
                break
            if self._expired(deadline):
                return self._host_sweep(
                    items, verdicts, [live[p] for p in sorted(suspects)])
            group_verdicts = np.asarray(backend.rlc_partition_verify_async(
                messages, signatures, member_keys, groups)(), bool)
            self._count_pass("rlc_partition")
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
        """The deadline's sweep: the host checks every undecided item."""
        self._count_pass("host")
        for i in remaining:
            verdicts[i] = self._leaf_check(items[i])
        return [bool(v) if v is not None else False for v in verdicts]


__all__ = ["FANOUT", "FaultLocalizer", "ladder", "max_device_passes"]
