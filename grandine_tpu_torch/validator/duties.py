"""The aggregate-construction seam of duty production (counterpart of
grandine_tpu/validator/duties.py:33-61): `host_aggregator` sums each
group of signatures on the host, `device_aggregator` sums every group of
a call on the card in one `g2_group_sum` launch
(gpu/bls.py g2_aggregate_groups). The duty producers themselves
(`produce_attestations` and the rest) need the state transition, which is
not ported."""

from __future__ import annotations

from typing import Callable, Sequence

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.gpu import bls as B

#: groups of signatures in → one aggregate per group out
Aggregator = Callable[
    ["Sequence[Sequence[A.Signature]]"], "list[A.Signature]"
]


def host_aggregator(groups) -> "list[A.Signature]":
    """The host twin of `device_aggregator` (a loop per group)."""
    return [A.Signature.aggregate(list(g)) for g in groups]


def device_aggregator(device=None) -> Aggregator:
    """An Aggregator backed by the card's contiguous-group G2 sum: every
    committee of the slot in one launch instead of one host point loop
    each. Runs on the card unless `device="cpu"`."""
    dev = B.resolve_device(device)

    def _aggregate(groups):
        groups = [list(g) for g in groups]
        if not groups:
            return []
        return B.g2_aggregate_groups(groups, device=dev)

    return _aggregate


__all__ = ["Aggregator", "host_aggregator", "device_aggregator"]
