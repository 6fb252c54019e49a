"""The scheme table of the verify plane (counterpart of grandine_tpu/tpu/
schemes.py): `Scheme`, `SigningDescriptor`, `register`, `get`, with a row
per signature scheme — its curve parameters (documentation), backend
factory, host twin (the bisection leaf and degradation target), device
dispatch, async seam, flight-record kernel label and canary flag. The
verify scheduler (runtime/verify_scheduler.py) resolves every lane
through it; the signing plane (runtime/sign_plane.py) resolves its
sign-side descriptor.

  bls      — `_dispatch_bls`: the compressed-ingest route over the
             backend's *_compressed_async seams, or, for a backend
             without them, the host-decompress route; the canary scheme.
  ed25519  — `Ed25519Backend` (gpu/ed25519.py): host prep, then one
             `ed25519_verify` launch a batch.
  blob_kzg — `KzgDeviceBackend` (kzg/eip4844.py): host prep, then one
             device pass a batch.

The BLS routes are also public without the scheduler's stage timers:
`dispatch_bls_compressed` and `dispatch_bls_host_decompress` (one
coalesced batch of `VerifyItem`s, a settle callable of its verdict) are
the call a scheduler makes once per batch, and the seams the replay
window and the tests drive directly. The reference's
GRANDINE_TPU_DEVICE_DECOMPRESS switch is not ported: no environment
variable picks a path here.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
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


def _dispatch_split(items, sigs, registry, indexed_seam, keyed_seam, stage,
                    before):
    """Items with member indices and a synced `registry` go to
    `indexed_seam`, the rest (keys resolved on the host) to `keyed_seam`;
    returns the settle callable of the batch verdict. `stage(name, **attrs)`
    times the host steps (the scheduler's stage timers); `before()`, run
    once the keys resolve and before the seams launch, returns settles
    that must pass too."""
    indexed, keyed = [], []
    for i, it in enumerate(items):
        if registry is not None and it.member_indices is not None:
            indexed.append(i)
        else:
            keyed.append(i)
    try:
        with stage("host_prep", op="resolve_keys"):
            keyed_keys = [items[i].resolve_keys() for i in keyed]
    except SignatureInvalid:
        return lambda: False
    settles = list(before())
    if indexed:
        settles.append(indexed_seam(
            [items[i].message for i in indexed], [sigs[i] for i in indexed],
            [list(items[i].member_indices) for i in indexed], registry))
    if keyed:
        settles.append(keyed_seam([items[i].message for i in keyed],
                                  [sigs[i] for i in keyed], keyed_keys))
    return lambda: all(bool(s()) for s in settles)


def _has(backend, *seams) -> bool:
    return backend is not None and all(hasattr(backend, m) for m in seams)


#: the compressed-ingest seams (keyed, indexed)
COMPRESSED_SEAMS = ("fast_aggregate_verify_batch_compressed_async",
                    "fast_aggregate_verify_batch_indexed_compressed_async")


def _screened_bytes(items):
    """The batch's raw signature bytes, or None when bytes alone fail it:
    a wrong-length blob (the twin's BlsError) or an infinity flag (the
    twin rejects an infinity signature or raises on a junk payload)."""
    sig_bytes = [bytes(it.signature) for it in items]
    if any(len(sb) != 96 or sb[0] & 0x40 for sb in sig_bytes):
        return None
    return sig_bytes


def _host_points(items):
    """The batch's signatures decompressed on the host without the
    subgroup check, or None when one is undecodable or ∞."""
    try:
        points = [A.g2_from_bytes(it.signature, subgroup_check=False)
                  for it in items]
    except A.BlsError:
        return None
    if any(p.is_infinity() for p in points):
        return None
    return points


def _dispatch_bls_compressed(sched, lane, backend, items):
    """The compressed-ingest route (`dispatch_bls_compressed`), with
    `sched`'s stage timers, registry and metrics; None when the backend
    lacks the compressed seams."""
    if not _has(backend, *COMPRESSED_SEAMS):
        return None
    with sched._stage(lane, "host_prep", op="sig_bytes", items=len(items)):
        sig_bytes = _screened_bytes(items)
    if sig_bytes is None:
        return lambda: False
    return _dispatch_split(
        items, sig_bytes, sched._sync_registry(lane, items),
        backend.fast_aggregate_verify_batch_indexed_compressed_async,
        backend.fast_aggregate_verify_batch_compressed_async,
        lambda stage, **attrs: sched._stage(lane, stage, **attrs),
        lambda: _count_sigs(sched, items))


def _dispatch_bls_host_decompress(sched, lane, backend, items):
    """The host-decompress route (`dispatch_bls_host_decompress`), with
    `sched`'s stage timers, registry and metrics; None without the
    uncompressed seams. A backend
    whose verify launches check G2 membership themselves (`fuse_subgroup`,
    as TorchBlsBackend's do) gets no separate subgroup pass; any other
    has `g2_subgroup_check_batch_async` stacked ahead of the verify, as in
    the reference. Indexed items need the indexed seam and a synced
    registry; otherwise their keys are resolved on the host."""
    if not _has(backend, "fast_aggregate_verify_batch_async",
                "g2_subgroup_check_batch_async"):
        return None
    with sched._stage(lane, "host_prep", op="g2_decompress",
                      items=len(items)):
        points = _host_points(items)
    if points is None:
        return lambda: False
    registry = (sched._sync_registry(lane, items)
                if hasattr(backend, "fast_aggregate_verify_batch_indexed_async")
                else None)

    def before():
        # the subgroup pass goes ahead of the verify launches
        settles = []
        if not getattr(backend, "fuse_subgroup", False):
            flags = backend.g2_subgroup_check_batch_async(points)
            settles.append(lambda: bool(flags().all()))
        return settles + _count_sigs(sched, items)

    return _dispatch_split(
        items, [A.Signature(p) for p in points], registry,
        getattr(backend, "fast_aggregate_verify_batch_indexed_async", None),
        backend.fast_aggregate_verify_batch_async,
        lambda stage, **attrs: sched._stage(lane, stage, **attrs), before)


def _count_sigs(sched, items) -> list:
    """The scheduler's device-batch signature count (no settle)."""
    if sched.metrics is not None:
        sched.metrics.device_batch_sigs.inc(len(items))
    return []


class _Unscheduled:
    """The scheduler surface the BLS routes use (`_stage`,
    `_sync_registry`, `metrics`) for a call without a scheduler: no stage
    timers, no metrics, the caller's registry."""

    metrics = None

    def __init__(self, registry) -> None:
        self.registry = registry

    def _stage(self, lane, stage, **attrs):
        return nullcontext()

    def _sync_registry(self, lane, items):
        return sync_registry(self.registry, items)


def dispatch_bls_compressed(items, backend, registry):
    """Forward one coalesced BLS batch's raw signature bytes to the
    backend's compressed seams; returns a settle callable giving the
    batch verdict, or None when the backend lacks the seams. Host
    screening covers only what bytes alone answer: a wrong-length blob or
    an infinity-flagged signature fails the batch. Non-canonical,
    off-curve, non-residue and non-G2 rows are rejected per row on the
    device and fail the batch."""
    return _dispatch_bls_compressed(_Unscheduled(registry), None, backend,
                                    items)


def dispatch_bls_host_decompress(items, backend, registry):
    """Decompress one coalesced BLS batch's signatures on the host WITHOUT
    the per-item subgroup scalar-mul, then send the points to the
    backend's uncompressed seams, whose verify launches run the ψ check on
    the card. Returns a settle callable giving the batch verdict, or None
    when the backend lacks the seams. An undecodable or infinity
    signature, or an item without usable keys, fails the batch."""
    return _dispatch_bls_host_decompress(_Unscheduled(registry), None,
                                         backend, items)


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
    """One registered signature scheme: its curve parameters
    (documentation); `make_backend(metrics=, tracer=, lane=, device=,
    mesh=)`;
    `host_check(item)` → bool, the scalar twin of the device verdict (the
    bisection leaf and the degradation target, agreeing with the device on
    every input); `device_dispatch(sched, lane, backend, items)` → a
    zero-arg settle callable of the batch verdict, or None when no async
    seam applies (the scheduler then degrades the batch to `host_check`);
    `async_seam`, the backend's launching method names; `kernel_label(
    backend)`, the flight record's kernel name; `canary`, whether the
    backend answers the health supervisor's BLS canary probes; and the
    sign-side descriptor (None when the scheme has no device signing
    path)."""

    __slots__ = ("name", "field_bits", "curve", "make_backend", "host_check",
                 "device_dispatch", "async_seam", "kernel_label", "canary",
                 "signing")

    def __init__(self, name: str, *, field_bits: int, curve: str,
                 make_backend: Callable, host_check: Callable,
                 device_dispatch: Callable,
                 async_seam: "tuple[str, ...]" = (),
                 kernel_label: "Optional[Callable]" = None,
                 canary: bool = False,
                 signing: "Optional[SigningDescriptor]" = None) -> None:
        self.name = name
        self.field_bits = int(field_bits)
        self.curve = curve
        self.make_backend = make_backend
        self.host_check = host_check
        self.device_dispatch = device_dispatch
        self.async_seam = tuple(async_seam)
        self.kernel_label = (kernel_label if kernel_label is not None
                             else (lambda backend: f"{name}_verify"))
        self.canary = bool(canary)
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


# --- BLS12-381 ---------------------------------------------------------------


def _make_bls_backend(*, metrics=None, tracer=None, lane="attestation",
                      device=None, mesh=None):
    from grandine_tpu_torch.gpu.bls import TorchBlsBackend

    return TorchBlsBackend(device=device, mesh=mesh)


def _host_check_bls(item) -> bool:
    # resolved through the scheduler module AT CALL TIME, so tests that
    # monkeypatch verify_scheduler.host_check_item reach every leaf
    # (bisection, degradation, localization)
    from grandine_tpu_torch.runtime import verify_scheduler as _vs

    return _vs.host_check_item(item)


def _bls_kernel_label(backend) -> str:
    return ("fast_aggregate_fused" if getattr(backend, "fuse_subgroup", False)
            else "fast_aggregate")


def _dispatch_bls(sched, lane, backend, items):
    """Route one coalesced BLS batch to the device: the compressed-ingest
    route — raw 96-byte signatures into the seams whose launches
    decompress, check G2 membership and verify in one device pass — or,
    for a backend without the compressed seams, the host-decompress
    route. Host steps run under the scheduler's stage timers and the
    registry through its `_sync_registry`."""
    settle = _dispatch_bls_compressed(sched, lane, backend, items)
    if settle is not None:
        return settle
    return _dispatch_bls_host_decompress(sched, lane, backend, items)


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
    host_check=_host_check_bls,
    device_dispatch=_dispatch_bls,
    async_seam=(
        "fast_aggregate_verify_batch_async",
        "g2_subgroup_check_batch_async",
        "fast_aggregate_verify_batch_indexed_async",
        "multi_verify_async",
        "rlc_partition_verify_async",
        "multi_verify_compressed_async",
        "fast_aggregate_verify_batch_compressed_async",
        "fast_aggregate_verify_batch_indexed_compressed_async",
    ),
    kernel_label=_bls_kernel_label,
    canary=True,
    signing=SigningDescriptor(
        batch_sign=_bls_batch_sign,
        host_sign=_bls_host_sign,
        release_verify=_bls_release_verify,
    ),
))


# --- Ed25519 (RFC 8032, cofactored batch) ------------------------------------


def _make_ed25519_backend(*, metrics=None, tracer=None, lane="ed25519",
                          device=None, mesh=None):
    from grandine_tpu_torch.gpu.ed25519 import Ed25519Backend

    return Ed25519Backend(device=device, metrics=metrics, tracer=tracer,
                          lane=lane, mesh=mesh)


def _host_check_ed25519(item) -> bool:
    from grandine_tpu_torch.crypto import ed25519

    return ed25519.check_item(item)


def _dispatch_ed25519(sched, lane, backend, items):
    """Host prep (point decode, malleability bound, RLC scalars) and one
    `ed25519_verify` launch. Malformed encodings fail the batch (bisection
    isolates against the host twin); an over-bucket batch returns None so
    the scheduler degrades it to the host path."""
    if backend is None or not hasattr(backend, "verify_batch_async"):
        return None
    with sched._stage(lane, "host_prep", op="ed25519_decode",
                      items=len(items)):
        status, prep = backend.prepare(items)
    if status == "invalid":
        return lambda: False
    if status != "ok":
        return None
    if sched.metrics is not None:
        sched.metrics.device_batch_sigs.inc(len(items))
    return backend.verify_batch_async(prep)


register(Scheme(
    "ed25519",
    field_bits=255,
    curve="curve25519",
    make_backend=_make_ed25519_backend,
    host_check=_host_check_ed25519,
    device_dispatch=_dispatch_ed25519,
    async_seam=("verify_batch_async",),
))


# --- KZG blob proofs (EIP-4844, deneb) -------------------------------------


def _make_blob_kzg_backend(*, metrics=None, tracer=None, lane="blob_kzg",
                           device=None, mesh=None):
    """`KzgDeviceBackend` (kzg/eip4844.py): host prep (commitment and proof
    decoding, Fiat–Shamir challenges, barycentric evaluations, the batch
    challenge's powers) in `prepare`, then ONE device pass in
    `verify_blobs_async` — one 255-bit ladder over the four groups, their
    sums and a width-4 pairing check against [G2, G2, G2, τG2]. Mixed blob
    widths or more than MAX_ITEMS items prepare as "mixed" / "oversize"
    (host degradation, per-item verdicts stay correct); undecodable bytes
    as "invalid" (the batch fails for bisection to isolate)."""
    from grandine_tpu_torch.kzg.eip4844 import KzgDeviceBackend

    return KzgDeviceBackend(device=device, metrics=metrics, tracer=tracer,
                            lane=lane, mesh=mesh)


def _host_check_blob_kzg(item) -> bool:
    from grandine_tpu_torch.kzg import eip4844

    return eip4844.host_check_item(item)


def _dispatch_blob_kzg(sched, lane, backend, items):
    """Host prep (commitment and proof decoding, Fiat–Shamir challenges,
    barycentric evaluations, the batch challenge's powers) and ONE device
    pass: one 255-bit ladder over the four groups, their sums and a
    width-4 pairing check. Mixed blob widths or an over-bucket batch
    return None (host degradation; per-item verdicts stay correct);
    undecodable bytes fail the batch for the bisection to isolate."""
    if backend is None or not hasattr(backend, "verify_blobs_async"):
        return None
    with sched._stage(lane, "host_prep", op="kzg_prep", items=len(items)):
        status, prep = backend.prepare(items)
    if status == "invalid":
        return lambda: False
    if status != "ok":
        return None
    if sched.metrics is not None:
        sched.metrics.device_batch_sigs.inc(len(items))
    return backend.verify_blobs_async(prep)


register(Scheme(
    "blob_kzg",
    field_bits=381,
    curve="BLS12-381",
    make_backend=_make_blob_kzg_backend,
    host_check=_host_check_blob_kzg,
    device_dispatch=_dispatch_blob_kzg,
    async_seam=("verify_blobs_async",),
))


__all__ = ["dispatch_bls_compressed", "dispatch_bls_host_decompress",
           "sync_registry", "Scheme", "SigningDescriptor", "register", "get",
           "names"]
