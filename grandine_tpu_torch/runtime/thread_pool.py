"""Task priorities (counterpart of grandine_tpu/runtime/thread_pool.py
`Priority`; the pool itself is not ported): the signing plane's lanes
flush HIGH before LOW."""

from __future__ import annotations

import enum


class Priority(enum.IntEnum):
    HIGH = 0  # blocks, blob sidecars, checkpoint states
    LOW = 1   # attestations, aggregates, slashings


__all__ = ["Priority"]
