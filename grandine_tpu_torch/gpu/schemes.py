"""The BLS dispatch seams: one coalesced batch of `VerifyItem`s to the
backend's compressed-ingest seams (`dispatch_bls_compressed`, counterpart
of grandine_tpu/tpu/schemes.py `_dispatch_bls_compressed`) or, with the
signatures decompressed on the host, to its uncompressed seams
(`dispatch_bls_host_decompress`, counterpart of
`_dispatch_bls_host_decompress`), without the scheduler's stage timers
and metrics. These are the entry points of the port's gossip verify
path: the call a verify scheduler makes once per batch.

Below them, the scheme table (counterpart of the table in
grandine_tpu/tpu/schemes.py: `Scheme`, `SigningDescriptor`, `register`,
`get`) with its `bls` row (the backend factory and the sign-side
descriptor the signing plane, runtime/sign_plane.py, resolves through)
and its `blob_kzg` row (the backend factory, the host twin and the
backend's async seam). The Ed25519 row waits for its kernel, and the
verify scheduler's columns past these (`device_dispatch`, the `bls`
row's host twin and seams) for the scheduler."""

from __future__ import annotations

import threading
from typing import Callable, Optional

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


def _dispatch_split(items, sigs, registry, indexed_seam, keyed_seam):
    """Items with member indices and a synced registry go to
    `indexed_seam`, the rest (keys resolved on the host) to `keyed_seam`;
    returns the settle callable of the batch verdict."""
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
        settles.append(indexed_seam(
            [items[i].message for i in indexed], [sigs[i] for i in indexed],
            [list(items[i].member_indices) for i in indexed], registry))
    if keyed:
        settles.append(keyed_seam([items[i].message for i in keyed],
                                  [sigs[i] for i in keyed], keyed_keys))
    return lambda: all(bool(s()) for s in settles)


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
    return _dispatch_split(
        items, sig_bytes, registry,
        backend.fast_aggregate_verify_batch_indexed_compressed_async,
        backend.fast_aggregate_verify_batch_compressed_async)


def dispatch_bls_host_decompress(items, backend, registry):
    """Decompress one coalesced BLS batch's signatures on the host WITHOUT
    the per-item subgroup scalar-mul, then send the points to the
    backend's uncompressed seams, whose verify launches run the ψ check on
    the card. Returns a settle callable giving the batch verdict, or None
    when the backend lacks the seams. An undecodable or infinity
    signature, or an item without usable keys, fails the batch."""
    if backend is None or not (
        hasattr(backend, "fast_aggregate_verify_batch_async")
        and hasattr(backend, "fast_aggregate_verify_batch_indexed_async")
    ):
        return None
    try:
        points = [A.g2_from_bytes(it.signature, subgroup_check=False)
                  for it in items]
    except A.BlsError:
        return lambda: False
    if any(p.is_infinity() for p in points):
        return lambda: False
    return _dispatch_split(
        items, [A.Signature(p) for p in points], registry,
        backend.fast_aggregate_verify_batch_indexed_async,
        backend.fast_aggregate_verify_batch_async)


# --- the scheme table ------------------------------------------------------


class SigningDescriptor:
    """Sign-side row of a scheme: `batch_sign(backend, messages,
    secret_keys)` → wire signatures (the device dispatch), `host_sign(
    message, secret_key)` → bytes (the anchor and degradation target,
    byte-identical by contract) and `release_verify(backend, messages,
    sig_bytes, public_keys)` → bool (the gate every device batch passes
    before release). The JAX row's warm-up kinds come with the warm-up."""

    __slots__ = ("batch_sign", "host_sign", "release_verify")

    def __init__(self, *, batch_sign: Callable, host_sign: Callable,
                 release_verify: Callable) -> None:
        self.batch_sign = batch_sign
        self.host_sign = host_sign
        self.release_verify = release_verify


class Scheme:
    """One registered signature scheme: its curve parameters (documentation),
    `make_backend(device=)`, `host_check(item)` → bool (the scalar twin of
    the device verdict: the bisection leaf and the degradation target,
    agreeing with the device on every input), `async_seam` (the backend's
    method names that launch and return a settle callable) and its
    sign-side descriptor (None when the scheme has no device signing
    path)."""

    __slots__ = ("name", "field_bits", "curve", "make_backend", "host_check",
                 "async_seam", "signing")

    def __init__(self, name: str, *, field_bits: int, curve: str,
                 make_backend: Callable,
                 host_check: "Optional[Callable]" = None,
                 async_seam: "tuple[str, ...]" = (),
                 signing: "Optional[SigningDescriptor]" = None) -> None:
        self.name = name
        self.field_bits = int(field_bits)
        self.curve = curve
        self.make_backend = make_backend
        self.host_check = host_check
        self.async_seam = tuple(async_seam)
        self.signing = signing


_REGISTRY: "dict[str, Scheme]" = {}
_LOCK = threading.Lock()


def register(scheme: Scheme) -> Scheme:
    """Register a scheme; re-registering a name replaces the entry (an
    instrumented twin can shadow a row)."""
    with _LOCK:
        _REGISTRY[scheme.name] = scheme
    return scheme


def get(name: str) -> Scheme:
    with _LOCK:
        try:
            return _REGISTRY[name]
        except KeyError:
            raise KeyError(f"unknown signature scheme {name!r}; registered: "
                           f"{sorted(_REGISTRY)}") from None


def names() -> "list[str]":
    with _LOCK:
        return sorted(_REGISTRY)


def _make_bls_backend(*, device=None):
    from grandine_tpu_torch.gpu.bls import TorchBlsBackend

    return TorchBlsBackend(device=device)


def _bls_batch_sign(backend, messages, secret_keys):
    """N signatures in one `batch_sign` launch (gpu/bls.py
    TorchBlsBackend.batch_sign), as wire bytes in request order."""
    return [s.to_bytes()
            for s in backend.batch_sign(list(messages), list(secret_keys))]


def _bls_host_sign(message, secret_key) -> bytes:
    """The scalar anchor: `SecretKey.sign` (crypto/bls.py)."""
    return secret_key.sign(message).to_bytes()


def _bls_release_verify(backend, messages, sig_bytes, public_keys) -> bool:
    """The release gate: the device-produced signatures, decoded from the
    bytes that would be released, verified against the callers' public
    keys in one RLC `multi_verify`. Undecodable bytes fail the gate."""
    try:
        sigs = [A.Signature(A.g2_from_bytes(sb, subgroup_check=False))
                for sb in sig_bytes]
    except A.BlsError:
        return False
    return bool(backend.multi_verify(list(messages), sigs, list(public_keys)))


register(Scheme(
    "bls",
    field_bits=381,
    curve="BLS12-381",
    make_backend=_make_bls_backend,
    signing=SigningDescriptor(
        batch_sign=_bls_batch_sign,
        host_sign=_bls_host_sign,
        release_verify=_bls_release_verify,
    ),
))


# --- KZG blob proofs (EIP-4844, deneb) -------------------------------------


def _make_blob_kzg_backend(*, device=None):
    """`KzgDeviceBackend` (kzg/eip4844.py): host prep (commitment and proof
    decoding, Fiat–Shamir challenges, barycentric evaluations, the batch
    challenge's powers) in `prepare`, then ONE device pass in
    `verify_blobs_async` — one 255-bit ladder over the four groups, their
    sums and a width-4 pairing check against [G2, G2, G2, τG2]. Mixed blob
    widths or more than MAX_ITEMS items prepare as "mixed" / "oversize"
    (host degradation, per-item verdicts stay correct); undecodable bytes
    as "invalid" (the batch fails for bisection to isolate)."""
    from grandine_tpu_torch.kzg.eip4844 import KzgDeviceBackend

    return KzgDeviceBackend(device=device)


def _host_check_blob_kzg(item) -> bool:
    from grandine_tpu_torch.kzg import eip4844

    return eip4844.host_check_item(item)


register(Scheme(
    "blob_kzg",
    field_bits=381,
    curve="BLS12-381",
    make_backend=_make_blob_kzg_backend,
    host_check=_host_check_blob_kzg,
    async_seam=("verify_blobs_async",),
))


__all__ = ["dispatch_bls_compressed", "dispatch_bls_host_decompress",
           "sync_registry", "Scheme", "SigningDescriptor", "register", "get",
           "names"]
