"""The device dispatch of a replay window (counterpart of
grandine_tpu/runtime/replay.py BulkReplayPipeline `_device_dispatch`;
the pipeline itself is not ported yet): the signature sets that a
`CollectingVerifier` gathered over a window of blocks, as one flat RLC
batch."""

from __future__ import annotations

from typing import Sequence

from grandine_tpu_torch.consensus.verifier import SignatureInvalid
from grandine_tpu_torch.crypto import bls as A


def dispatch_window(items: "Sequence", backend):
    """One flat RLC batch for a window of `VerifyItem`s: signatures
    decompressed on the host WITHOUT the subgroup scalar-mul, each item's
    signers aggregated to one key, then `g2_subgroup_check_batch_async`
    and `multi_verify_async` launched back to back. Returns a settle
    callable giving the window's verdict, or None when the backend lacks
    the seams. An undecodable or infinity signature, or an item without
    usable keys, fails the window."""
    if not items:
        return lambda: True
    if not (hasattr(backend, "multi_verify_async")
            and hasattr(backend, "g2_subgroup_check_batch_async")):
        return None
    try:
        points = [A.g2_from_bytes(it.signature, subgroup_check=False)
                  for it in items]
    except A.BlsError:
        return lambda: False
    if any(p.is_infinity() for p in points):
        return lambda: False
    try:
        pks = [
            keys[0] if len(keys) == 1 else A.PublicKey.aggregate(keys)
            for keys in (it.resolve_keys() for it in items)
        ]
    except SignatureInvalid:
        return lambda: False
    sub_settle = backend.g2_subgroup_check_batch_async(points)
    mv_settle = backend.multi_verify_async(
        [it.message for it in items], [A.Signature(p) for p in points], pks)

    def settle() -> bool:
        if not bool(sub_settle().all()):
            return False
        return bool(mv_settle())

    return settle


__all__ = ["dispatch_window"]
