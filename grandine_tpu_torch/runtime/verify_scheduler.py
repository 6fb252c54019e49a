"""`VerifyItem`, one signature check in fast-aggregate geometry as the
verify scheduler coalesces them, and `host_check_item`, its eager host
verdict (counterparts of grandine_tpu/runtime/verify_scheduler.py
VerifyItem and host_check_item; the scheduler itself is not ported
yet)."""

from __future__ import annotations

from typing import Optional, Sequence

from grandine_tpu_torch.consensus.keys import decompress_pubkey
from grandine_tpu_torch.consensus.verifier import (
    SignatureInvalid, SingleVerifier)
from grandine_tpu_torch.crypto import bls as A


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
        except (IndexError, A.BlsError) as e:
            raise SignatureInvalid(f"bad member index/pubkey: {e}") from e


def host_check_item(item: VerifyItem) -> bool:
    """The eager host path, SingleVerifier semantics (full decompression
    and subgroup checks): the fault localizer's leaf check."""
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


__all__ = ["VerifyItem", "host_check_item"]
