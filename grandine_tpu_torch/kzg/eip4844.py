"""EIP-4844 KZG operations on the card — the port of grandine_tpu/kzg/
eip4844.py (reference: kzg_utils/src/eip_4844.rs, the six public
functions over rust-kzg-blst, and the deneb polynomial-commitments.md
spec they implement).

The hot path is the G1 multi-scalar multiplication behind every
commitment and proof: one device pass (`gpu/kzg.py lincomb`: the
`g1_scalar_mul` ladder over the setup's Lagrange points, then one
`g1_group_sum`). The windowed host Pippenger `_msm_host` stays as the
host anchor the tests and chip_smoke.py hold the card against; it is
never a fallback. Single-proof verification (2 pairings) runs on the
host pairing, as in the reference.

Batch verification (`verify_blob_kzg_proof_batch` for 2 ≤ n ≤ MAX_ITEMS,
and `KzgDeviceBackend`, the `blob_kzg` row of gpu/schemes.py): host prep
decodes and subgroup-checks the G1 inputs, range-checks the blobs,
computes the Fiat–Shamir challenges, the barycentric evaluations and the
batch challenge r, and lays the WHOLE batch equation

    e(Σ rⁱ(Cᵢ − yᵢG1 + zᵢWᵢ), G2) · e(−Σ rⁱWᵢ, [τ]G2) == 1

out as ONE flat scalar-multiplication batch in four contiguous groups
(commitments·rⁱ | proofs·rⁱzᵢ | generator·(−Σrⁱyᵢ) | proofs·(−rⁱ)); the
card runs one ladder, one grouped sum, a width-4 Miller loop against [G2,
G2, G2, τG2] and one final exponentiation (`gpu/kzg.py blob_verify`).
The challenge r is deterministic, so the device verdict equals the host
batch tail (`_batch_pairing_host`) on every input, forged included.

Every call that reaches the card runs on CUDA unless the caller passes
device="cpu" (the kernels' plain versions); a kernel build, launch or
settle error raises — there is no switch to the host path and no
fallback. Shapes the reference degrades on (more than MAX_ITEMS items,
mixed widths) keep the reference's semantics.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto.curves import (
    G1, G2, Point, g1_infinity, g2_infinity)
from grandine_tpu_torch.crypto.pairing import pairing_check
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import kzg as GK
from grandine_tpu_torch.kzg import fr
from grandine_tpu_torch.kzg.setup import (
    TrustedSetup, dev_setup, official_setup)

BLS_MODULUS = fr.BLS_MODULUS
BYTES_PER_FIELD_ELEMENT = 32
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"
KZG_ENDIANNESS = "big"

G1_POINT_AT_INFINITY = bytes([0xC0]) + b"\x00" * 47


class KzgError(ValueError):
    pass


# ------------------------------------------------------------ (de)serialize


def _bytes_to_bls_field(b: bytes) -> int:
    v = int.from_bytes(b, KZG_ENDIANNESS)
    if v >= BLS_MODULUS:
        raise KzgError("field element out of range")
    return v


def _field_to_bytes(v: int) -> bytes:
    return int(v).to_bytes(BYTES_PER_FIELD_ELEMENT, KZG_ENDIANNESS)


def _blob_to_polynomial(blob: bytes, width: int) -> "list[int]":
    if len(blob) != width * BYTES_PER_FIELD_ELEMENT:
        raise KzgError(f"blob must be {width * BYTES_PER_FIELD_ELEMENT} bytes")
    return [
        _bytes_to_bls_field(blob[i * 32 : (i + 1) * 32]) for i in range(width)
    ]


def _g1_from_commitment_bytes(b: bytes) -> Point:
    try:
        return A.g1_from_bytes(bytes(b), subgroup_check=True)
    except A.BlsError as e:
        raise KzgError(f"invalid G1 encoding: {e}") from e


def _hash_to_bls_field(data: bytes) -> int:
    digest = hashlib.sha256(data).digest()
    return int.from_bytes(digest, KZG_ENDIANNESS) % BLS_MODULUS


def _compute_challenge(blob: bytes, commitment: bytes, width: int) -> int:
    degree_poly = width.to_bytes(16, KZG_ENDIANNESS)
    return _hash_to_bls_field(
        FIAT_SHAMIR_PROTOCOL_DOMAIN + degree_poly + blob + commitment
    )


# ----------------------------------------------------------------------- MSM


def _msm_host(points: "Sequence[Point]", scalars: "Sequence[int]") -> Point:
    """Windowed Pippenger MSM on the host: the anchor of `_g1_lincomb`."""
    window = 8
    acc_total = g1_infinity()
    n_windows = (255 + window - 1) // window
    for w in range(n_windows - 1, -1, -1):
        shift = w * window
        buckets: "dict[int, Point]" = {}
        for p, s in zip(points, scalars):
            digit = (s >> shift) & ((1 << window) - 1)
            if digit:
                cur = buckets.get(digit)
                buckets[digit] = p if cur is None else cur + p
        if w != n_windows - 1:
            for _ in range(window):
                acc_total = acc_total.double()
        # Σ d·B_d via descending running sums weighted by digit gaps
        running = g1_infinity()
        window_sum = g1_infinity()
        digits = sorted(buckets, reverse=True)
        for i, digit in enumerate(digits):
            running = running + buckets[digit]
            next_digit = digits[i + 1] if i + 1 < len(digits) else 0
            window_sum = window_sum + running.mul(digit - next_digit)
        acc_total = acc_total + window_sum
    return acc_total


def _g1_lincomb(setup: TrustedSetup, scalars: "Sequence[int]",
                device=None) -> Point:
    """Σ kᵢ·Lᵢ over the setup's Lagrange points (scalars below r) in one
    device pass (gpu/kzg.py lincomb) on `device` (CUDA unless "cpu");
    the sum is read back as a host point."""
    dev = B.resolve_device(device)
    px, py, inf = setup.device_g1(dev)
    k = torch.from_numpy(GK.scalar_words(scalars)).to(dev)
    total = GK.lincomb(px, py, inf, k)
    return B.g1_points_from_words(total.cpu().numpy())[0]


# ------------------------------------------------------------ the six calls


def blob_to_kzg_commitment(
    blob: bytes, setup: "Optional[TrustedSetup]" = None, device=None
) -> bytes:
    setup = setup or official_setup()
    poly = _blob_to_polynomial(bytes(blob), setup.width)
    return A.g1_to_bytes(_g1_lincomb(setup, poly, device))


def compute_kzg_proof(
    blob: bytes, z_bytes: bytes, setup: "Optional[TrustedSetup]" = None,
    device=None,
) -> "tuple[bytes, bytes]":
    """Returns (proof, y) for the evaluation p(z) = y."""
    setup = setup or official_setup()
    poly = _blob_to_polynomial(bytes(blob), setup.width)
    z = _bytes_to_bls_field(bytes(z_bytes))
    proof, y = _compute_kzg_proof_impl(poly, z, setup, device)
    return proof, _field_to_bytes(y)


def _quotient(poly, z: int, y: int, roots) -> "list[int]":
    """The quotient q_i = (f_i − y) / (w_i − z) on the host, with the
    special row when z equals a root (spec compute_kzg_proof_impl)."""
    width = len(roots)
    denoms = [(w - z) % BLS_MODULUS for w in roots]
    inv_denoms = fr.batch_inverse(denoms)
    q = [0] * width
    special = None
    for i in range(width):
        if denoms[i] == 0:
            special = i
            continue
        q[i] = (poly[i] - y) % BLS_MODULUS * inv_denoms[i] % BLS_MODULUS
    if special is not None:
        # q_m = Σ_{i≠m} (f_i − y)·w_i / (w_m·(w_m − w_i))
        m = special
        zm = roots[m]
        inv_z = fr.batch_inverse(
            [zm * ((zm - w) % BLS_MODULUS) % BLS_MODULUS for w in roots]
        )
        acc = 0
        for i in range(width):
            if i == m:
                continue
            acc += (
                (poly[i] - y)
                % BLS_MODULUS
                * roots[i]
                % BLS_MODULUS
                * inv_z[i]
                % BLS_MODULUS
            )
        q[m] = acc % BLS_MODULUS
    return q


def _compute_kzg_proof_impl(poly, z: int, setup: TrustedSetup, device=None):
    y = fr.evaluate_polynomial_in_evaluation_form(poly, z, setup.roots_brp)
    q = _quotient(poly, z, y, setup.roots_brp)
    return A.g1_to_bytes(_g1_lincomb(setup, q, device)), y


def verify_kzg_proof(
    commitment_bytes: bytes,
    z_bytes: bytes,
    y_bytes: bytes,
    proof_bytes: bytes,
    setup: "Optional[TrustedSetup]" = None,
    device=None,
) -> bool:
    """e(P - [y]G1, G2) == e(proof, [tau - z]G2) — spec verify_kzg_proof.
    Host code, as in the reference: `device` names no work here and is
    taken for the six calls' one signature."""
    setup = setup or official_setup()
    commitment = _g1_from_commitment_bytes(commitment_bytes)
    proof = _g1_from_commitment_bytes(proof_bytes)
    z = _bytes_to_bls_field(bytes(z_bytes))
    y = _bytes_to_bls_field(bytes(y_bytes))
    return _verify_kzg_proof_impl(commitment, z, y, proof, setup)


def _verify_kzg_proof_impl(commitment, z, y, proof, setup) -> bool:
    # X_minus_z = [tau]G2 - [z]G2 ; P_minus_y = commitment - [y]G1
    x_minus_z = setup.tau_g2 + (-G2.mul(z) if z else g2_infinity())
    p_minus_y = commitment + (-G1.mul(y) if y else g1_infinity())
    # e(P - y, G2) * e(-proof, X - z) == 1
    return pairing_check([(p_minus_y, G2), (-proof, x_minus_z)])


def compute_blob_kzg_proof(
    blob: bytes, commitment_bytes: bytes,
    setup: "Optional[TrustedSetup]" = None, device=None,
) -> bytes:
    setup = setup or official_setup()
    _g1_from_commitment_bytes(commitment_bytes)  # validate encoding
    poly = _blob_to_polynomial(bytes(blob), setup.width)
    z = _compute_challenge(bytes(blob), bytes(commitment_bytes), setup.width)
    proof, _y = _compute_kzg_proof_impl(poly, z, setup, device)
    return proof


def verify_blob_kzg_proof(
    blob: bytes,
    commitment_bytes: bytes,
    proof_bytes: bytes,
    setup: "Optional[TrustedSetup]" = None,
    device=None,
) -> bool:
    """Host code, as in the reference (`device` as in verify_kzg_proof)."""
    setup = setup or official_setup()
    commitment = _g1_from_commitment_bytes(commitment_bytes)
    proof = _g1_from_commitment_bytes(proof_bytes)
    poly = _blob_to_polynomial(bytes(blob), setup.width)
    z = _compute_challenge(bytes(blob), bytes(commitment_bytes), setup.width)
    y = fr.evaluate_polynomial_in_evaluation_form(poly, z, setup.roots_brp)
    return _verify_kzg_proof_impl(commitment, z, y, proof, setup)


def verify_blob_kzg_proof_batch(
    blobs: "Sequence[bytes]",
    commitments: "Sequence[bytes]",
    proofs: "Sequence[bytes]",
    setup: "Optional[TrustedSetup]" = None,
    device=None,
) -> bool:
    """Random-linear-combination batch verification (spec
    verify_blob_kzg_proof_batch): ONE pairing check for N blobs — on
    `device` (CUDA unless "cpu") for 2 ≤ N ≤ MAX_ITEMS, on the host
    pairing for N == 1 (the single-verify equation) and past MAX_ITEMS
    (the reference's degradation)."""
    setup = setup or official_setup()
    n = len(blobs)
    if not (n == len(commitments) == len(proofs)):
        raise KzgError("length mismatch")
    if n == 0:
        return True
    if n == 1:
        return verify_blob_kzg_proof(blobs[0], commitments[0], proofs[0],
                                     setup)
    inputs = _batch_inputs(blobs, commitments, proofs, setup)
    if n > KzgDeviceBackend.MAX_ITEMS:
        return _batch_pairing_host(setup, *inputs)
    return _batch_pairing_device(setup, *inputs, device=device)


# -------------------------------------------------------- batch host prep


def _decode_points(commitments, proofs):
    """The batch's commitments and proofs as subgroup-checked host points
    (KzgError on a bad encoding)."""
    return ([_g1_from_commitment_bytes(c) for c in commitments],
            [_g1_from_commitment_bytes(p) for p in proofs])


def _evaluations(blobs, commitments, setup: TrustedSetup):
    """(zs, ys): each blob's Fiat–Shamir challenge and its polynomial's
    barycentric evaluation there (KzgError on a bad blob)."""
    zs, ys = [], []
    for blob, commitment in zip(blobs, commitments):
        poly = _blob_to_polynomial(bytes(blob), setup.width)
        z = _compute_challenge(bytes(blob), bytes(commitment), setup.width)
        zs.append(z)
        ys.append(
            fr.evaluate_polynomial_in_evaluation_form(poly, z, setup.roots_brp)
        )
    return zs, ys


def _batch_inputs(blobs, commitments, proofs, setup: TrustedSetup):
    """Raw byte triples → (commitment points, proof points, zs, ys, powers
    of the batch challenge r): the host prep shared by the batch call and
    `KzgDeviceBackend.prepare_raw`. Raises KzgError on bad bytes."""
    n = len(blobs)
    commitment_points, proof_points = _decode_points(commitments, proofs)
    zs, ys = _evaluations(blobs, commitments, setup)
    # powers of r from the spec's batch-challenge domain
    data = (
        RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
        + setup.width.to_bytes(8, KZG_ENDIANNESS)
        + n.to_bytes(8, KZG_ENDIANNESS)
    )
    for commitment, z, y, proof in zip(commitments, zs, ys, proofs):
        data += (bytes(commitment) + _field_to_bytes(z) + _field_to_bytes(y)
                 + bytes(proof))
    r = _hash_to_bls_field(data)
    r_powers = [pow(r, i, BLS_MODULUS) for i in range(n)]
    return commitment_points, proof_points, zs, ys, r_powers


def _batch_pairing_host(setup, commitment_points, proof_points, zs, ys,
                        r_powers) -> bool:
    """The host tail of the batch equation (the reference's, with
    USE_DEVICE_KZG off): the anchor the device verdicts are held against,
    and the path past MAX_ITEMS."""
    #   e(Σ r^i(C_i - y_i + z_i·W_i), G2) == e(Σ r^i W_i, [tau]G2)
    proof_lincomb = g1_infinity()
    rhs_lincomb = g1_infinity()
    for ri, C_pt, W_pt, z, y in zip(
        r_powers, commitment_points, proof_points, zs, ys
    ):
        proof_lincomb = proof_lincomb + W_pt.mul(ri)
        interp = C_pt + (-G1.mul(y) if y else g1_infinity())
        interp = interp + W_pt.mul(z)
        rhs_lincomb = rhs_lincomb + interp.mul(ri)
    return pairing_check(
        [(rhs_lincomb, G2), (-proof_lincomb, setup.tau_g2)]
    )


def _batch_pairing_device(setup, commitment_points, proof_points, zs, ys,
                          r_powers, device=None) -> bool:
    """The device tail of verify_blob_kzg_proof_batch: the inputs are
    decoded and the challenge fixed, so the verdict equals the host
    tail's. Any device error raises."""
    backend = KzgDeviceBackend(device=device)
    prep = backend.pack(setup, commitment_points, proof_points, zs, ys,
                        r_powers)
    return backend.verify_blobs_async(prep)()


# ----------------------------------------------------- device batch verify


def _setup_for_width(width: int) -> TrustedSetup:
    """Blob width → trusted setup: the official 4096 setup in production,
    the INSECURE known-tau dev setup for test widths."""
    if width == 4096:
        return official_setup()
    return dev_setup(width)


class KzgDeviceBackend:
    """The blob_kzg scheme backend (gpu/schemes.py `get("blob_kzg")`, one
    per lane; also the tail of `verify_blob_kzg_proof_batch`), the port of
    the reference's KzgDeviceBackend. All verdict-relevant decoding (G1
    subgroup checks, blob range checks) and the Fiat–Shamir transcript run
    on the host in `prepare`; the card evaluates the batch equation in one
    pass (`verify_blobs_async`). Deterministic challenge → verdicts equal
    to the host batch tail bit for bit.

    Runs on `device`, CUDA unless "cpu" is passed, and raises with no
    card; on CUDA the constructor loads the kernel library (a kernel that
    does not build raises here). `metrics` is kept for the scheduler's
    factory signature and feeds no sink yet; `tracer`, when given, opens a
    "device_dispatch" span around each launch, as in the reference.
    `mesh` is accepted and unused, as in the reference
    (grandine_tpu/kzg/eip4844.py:422): a batch runs on one device."""

    ASYNC_SEAM = ("verify_blobs_async",)
    #: bucket cap: batches pad into {4, 8}; anything larger degrades to the
    #: host path
    MAX_ITEMS = 8

    def __init__(self, device=None, *, metrics=None, tracer=None,
                 lane: str = "blob_kzg", mesh=None) -> None:
        self.device = B.resolve_device(device)
        if self.device.type == "cuda":
            from grandine_tpu_torch.gpu import _build

            _build.library()
        self.metrics = metrics
        self.tracer = tracer
        self.lane = lane

    def prepare(self, items):
        """Scheduler item geometry (message=blob, public_keys=(commitment,),
        signature=proof) → (status, payload): "ok" → the packed batch,
        "invalid" → some item can never verify (the batch must FAIL so
        bisection isolates against the host twin), "mixed"/"oversize" →
        host degradation (per-item verdicts stay correct)."""
        n = len(items)
        if n == 0:
            return "ok", ()
        if n > self.MAX_ITEMS:
            return "oversize", None
        widths = set()
        for it in items:
            keys = it.public_keys
            if keys is None or len(keys) != 1:
                return "invalid", None
            blob_len = len(bytes(it.message))
            if blob_len % BYTES_PER_FIELD_ELEMENT:
                return "invalid", None
            widths.add(blob_len // BYTES_PER_FIELD_ELEMENT)
        if len(widths) != 1:
            # blob widths select the trusted setup — a mixed batch has no
            # single device shape; host degradation handles each item
            return "mixed", None
        width = widths.pop()
        if width < 2 or width & (width - 1):
            return "invalid", None
        return self.prepare_raw(
            [bytes(it.message) for it in items],
            [bytes(it.public_keys[0]) for it in items],
            [bytes(it.signature) for it in items],
            _setup_for_width(width),
        )

    def prepare_raw(self, blobs, commitments, proofs, setup: TrustedSetup):
        """Raw byte triples → (status, payload) — the shared prep of the
        scheduler path and the batch call."""
        if not blobs:
            return "ok", ()
        try:
            inputs = _batch_inputs(blobs, commitments, proofs, setup)
        except KzgError:
            return "invalid", None
        return "ok", self.pack(setup, *inputs)

    def pack(self, setup, commitment_points, proof_points, zs, ys, r_powers):
        """Decoded points + challenges → the device pass's host operands:
        (px, py (4·bn, 12) canonical words, pinf (4·bn,) bool, k (4·bn, 8)
        scalar words, setup, n), the four-group flat batch of the module
        docstring, each group padded to the bucket bn ∈ {4, 8} with ∞ rows
        of scalar 0 (neutral in the group sums), as the reference pads."""
        n = len(commitment_points)
        q = BLS_MODULUS
        bn = B._bucket(n, lo=4, hi=self.MAX_ITEMS)
        total = 4 * bn
        points = [None] * total
        scalars = [0] * total
        for i, (cp, wp, z, ri) in enumerate(
            zip(commitment_points, proof_points, zs, r_powers)
        ):
            points[i], scalars[i] = cp, ri
            points[bn + i], scalars[bn + i] = wp, ri * z % q
            # −Σ rⁱWᵢ via negated scalars
            points[3 * bn + i], scalars[3 * bn + i] = wp, (q - ri) % q
        points[2 * bn] = G1
        scalars[2 * bn] = (-sum(ri * y for ri, y in zip(r_powers, ys))) % q
        live = [i for i, pt in enumerate(points)
                if pt is not None and not pt.is_infinity()]
        px = np.zeros((total, 12), np.int32)
        py = np.zeros((total, 12), np.int32)
        pinf = np.ones((total,), bool)
        px[live], py[live] = B.g1_affine_words([points[i] for i in live])
        pinf[live] = False
        return px, py, pinf, GK.scalar_words(scalars), setup, n

    def verify_blobs_async(self, prep):
        """Launch the packed batch's device pass; returns the zero-arg
        settle giving the verdict."""
        if not prep:
            return lambda: True
        px, py, pinf, k, setup, _n = prep
        up = [torch.from_numpy(a).to(self.device) for a in (px, py, pinf, k)]
        q2 = setup.device_g2(self.device)
        if self.tracer is not None:
            with self.tracer.span("device_dispatch", {
                    "kernel": "kzg_blob_verify", "lane": self.lane}):
                verdict = GK.blob_verify(*up, q2, px.shape[0] // 4)
        else:
            verdict = GK.blob_verify(*up, q2, px.shape[0] // 4)
        return lambda: bool(verdict.item())


def host_check_item(item) -> bool:
    """VerifyItem adapter (blob_kzg lane geometry) — the scheduler's
    bisection leaf and host degradation pass. Never raises: undecodable
    bytes are a False verdict, exactly as the device path scores them."""
    keys = item.public_keys
    if keys is None or len(keys) != 1:
        return False
    blob = bytes(item.message)
    width = len(blob) // BYTES_PER_FIELD_ELEMENT
    if len(blob) % BYTES_PER_FIELD_ELEMENT or width < 2 or width & (width - 1):
        return False
    try:
        return verify_blob_kzg_proof(
            blob, bytes(keys[0]), bytes(item.signature),
            _setup_for_width(width),
        )
    except KzgError:
        return False


__all__ = [
    "KzgError",
    "KzgDeviceBackend",
    "blob_to_kzg_commitment",
    "compute_kzg_proof",
    "compute_blob_kzg_proof",
    "verify_kzg_proof",
    "verify_blob_kzg_proof",
    "verify_blob_kzg_proof_batch",
    "host_check_item",
    "G1_POINT_AT_INFINITY",
]
