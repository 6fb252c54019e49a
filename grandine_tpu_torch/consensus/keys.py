"""Process-wide public-key decompression cache (counterpart of
grandine_tpu/consensus/keys.py).

Decompressing a 48-byte G1 key costs a field square root (and, unless
the key is trusted, a subgroup check); a validator registry verifies the
same keys again and again, so the cache is global and unbounded (50,000
entries are a few MB of field ints). Registry keys are decompressed
`trusted`: they passed KeyValidate at deposit time.
"""

from __future__ import annotations

from grandine_tpu_torch.crypto import bls as A

#: key bytes -> (PublicKey, subgroup_checked); a trusted entry is checked
#: again when an untrusted caller asks for it
_CACHE: "dict[bytes, tuple]" = {}


def decompress_pubkey(pubkey_bytes: bytes,
                      trusted: bool = False) -> "A.PublicKey":
    """The decompressed, non-identity public key of `pubkey_bytes`,
    subgroup-checked unless `trusted`. Raises BlsError on an invalid
    encoding or the identity (never cached)."""
    key = bytes(pubkey_bytes)
    hit = _CACHE.get(key)
    if hit is not None:
        pk, checked = hit
        if checked or trusted:
            return pk
    point = A.g1_from_bytes(key, subgroup_check=not trusted)
    if point.is_infinity():
        raise A.BlsError("identity public key is invalid")
    pk = A.PublicKey(point)
    _CACHE[key] = (pk, not trusted)
    return pk


__all__ = ["decompress_pubkey"]
