"""The BLS dispatch seam: one coalesced batch of `VerifyItem`s to the
backend's compressed-ingest seams (counterpart of
grandine_tpu/tpu/schemes.py `_dispatch_bls_compressed`, without the
scheduler's stage timers and metrics). This is the entry point of the
port's verify path: the call a verify scheduler makes once per batch."""

from __future__ import annotations

from grandine_tpu_torch.consensus.verifier import SignatureInvalid
from grandine_tpu_torch.crypto import bls as A


def sync_registry(registry, items):
    """The registry brought up to date against the batch's pubkey columns
    (identity hit when unchanged); None → indexed items take the keyed
    path with host-resolved keys."""
    if registry is None:
        return None
    cols = next((it.pubkey_columns for it in items
                 if it.member_indices is not None
                 and it.pubkey_columns is not None), None)
    if cols is None:
        return None
    try:
        if registry.ensure(cols):
            return registry
    except A.BlsError:
        pass
    return None


def dispatch_bls_compressed(items, backend, registry):
    """Forward one coalesced BLS batch's raw signature bytes to the
    backend's compressed seams; returns a settle callable giving the
    batch verdict, or None when the backend lacks the seams. Host
    screening covers only what bytes alone answer: a wrong-length blob or
    an infinity-flagged signature fails the batch. Non-canonical,
    off-curve, non-residue and non-G2 rows are rejected per row on the
    device and fail the batch."""
    if backend is None or not (
        hasattr(backend, "fast_aggregate_verify_batch_compressed_async")
        and hasattr(backend,
                    "fast_aggregate_verify_batch_indexed_compressed_async")
    ):
        return None
    sig_bytes = [bytes(it.signature) for it in items]
    if any(len(sb) != 96 for sb in sig_bytes):
        return lambda: False
    if any(sb[0] & 0x40 for sb in sig_bytes):
        return lambda: False
    registry = sync_registry(registry, items)
    indexed, keyed = [], []
    for i, it in enumerate(items):
        if registry is not None and it.member_indices is not None:
            indexed.append(i)
        else:
            keyed.append(i)
    try:
        keyed_keys = [items[i].resolve_keys() for i in keyed]
    except SignatureInvalid:
        return lambda: False
    settles = []
    if indexed:
        settles.append(
            backend.fast_aggregate_verify_batch_indexed_compressed_async(
                [items[i].message for i in indexed],
                [sig_bytes[i] for i in indexed],
                [list(items[i].member_indices) for i in indexed],
                registry,
            ))
    if keyed:
        settles.append(backend.fast_aggregate_verify_batch_compressed_async(
            [items[i].message for i in keyed],
            [sig_bytes[i] for i in keyed],
            keyed_keys,
        ))

    def settle() -> bool:
        return all(bool(s()) for s in settles)

    return settle


__all__ = ["dispatch_bls_compressed", "sync_registry"]
