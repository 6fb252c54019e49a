"""The port's entry points, the counterpart of the repository's
`__graft_entry__.py` for the JAX package.

`entry(device=None)` — `(fn, args)`: the flagship program
    `gpu.bls.multi_verify_kernel` (RLC batch BLS verification, the
    framework's "model") and a real, verifiable example batch on the card
    (`device="cpu"`: the plain versions).
`dryrun_multichip(n, device=None)` — the multi-device step: the same
    batch through the sharded flat program and, regrouped by message,
    through the sharded grouped program, over a `gpu.mesh.VerifyMesh` of
    n distinct cards where the machine has them, else of n virtual shards
    of one card (`device="cpu"`: of the CPU).

The host layouts the reference-only programs take (`flat_batch`,
`grouped_batch`, `firehose_batch`, `packed_signatures`) build their
operands from host points: canonical words, ∞ rows as zero words under a
True mask, padding rows and slots all-∞, as the JAX package pads them.
"""

from __future__ import annotations

import numpy as np
import torch

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu.mesh import VerifyMesh

#: the RLC pair of a padding row (the JAX package's rlc_bits_host pads
#: with r0 = 1, r1 = 0)
PAD_PAIR = (1, 0)


# --- host layouts ------------------------------------------------------------


def _g1_words(points):
    """Host G1 points (∞ allowed) → ((N, 12) x, (N, 12) y, (N,) inf), zero
    words on ∞ rows."""
    n = len(points)
    inf = np.array([p.is_infinity() for p in points], bool).reshape(n)
    x = np.zeros((n, 12), np.int32)
    y = np.zeros((n, 12), np.int32)
    if (~inf).any():
        x[~inf], y[~inf] = B.g1_affine_words(
            [p for p, i in zip(points, inf) if not i])
    return x, y, inf


def _g2_rows(points):
    """Host G2 points (∞ allowed) → ((N, 2, 12) x, y, (N,) inf)."""
    if not points:
        z = np.zeros((0, 2, 12), np.int32)
        return z, z.copy(), np.zeros((0,), bool)
    return B.g2_affine_words_many(points)


def _messages(points):
    """H(m) host points → ((N, 2, 2, 12) affine [x, y], (N,) inf)."""
    x, y, inf = _g2_rows(points)
    return np.stack([x, y], 1), inf


def flat_batch(keys, signatures, messages, pairs, bucket=None):
    """Operands of `gpu.bls.multi_verify_kernel` as numpy arrays: N keys
    (G1), signatures and H(mᵢ) (G2) as host points, their RLC pairs, padded
    with all-∞ rows (pair `PAD_PAIR`) to `bucket` → (pk_x, pk_y, pk_inf,
    sig_x, sig_y, sig_inf, msg, msg_inf, r01)."""
    n = len(keys)
    b = n if bucket is None else bucket
    pad = b - n
    kx, ky, kinf = _g1_words(list(keys) + [A.PublicKey.aggregate([]).point]
                             * pad)
    sx, sy, sinf = _g2_rows(list(signatures) + [A.Signature.empty().point]
                            * pad)
    msg, minf = _messages(list(messages) + [A.Signature.empty().point] * pad)
    r01 = B.rlc_pairs_words(list(pairs) + [PAD_PAIR] * pad)
    return kx, ky, kinf, sx, sy, sinf, msg, minf, r01


def grouped_batch(members, messages, pairs, bm=None, bk=None):
    """Operands of `gpu.bls.grouped_multi_verify_kernel` as numpy arrays:
    `members[j]` the (key, signature) host points signing message j,
    `messages[j]` H(mⱼ), `pairs[j]` its members' RLC pairs; padded with
    all-∞ member slots to bk ≥ the widest group and all-∞ messages to bm ≥
    M → (pk_x, pk_y, pk_inf (bm, bk, …), sig_x, sig_y, sig_inf (bm, bk,
    …), msg (bm, 2, 2, 12), msg_inf (bm,), r01 (bm, bk, 2))."""
    m = len(members)
    bm = m if bm is None else bm
    widest = max((len(g) for g in members), default=0)
    bk = max(widest, 1) if bk is None else bk
    g1_inf, g2_inf = A.PublicKey.aggregate([]).point, A.Signature.empty().point
    keys = [g1_inf] * (bm * bk)
    sigs = [g2_inf] * (bm * bk)
    flat_pairs = [PAD_PAIR] * (bm * bk)
    for j, (grp, prs) in enumerate(zip(members, pairs)):
        for i, ((pk, sig), pr) in enumerate(zip(grp, prs)):
            keys[j * bk + i], sigs[j * bk + i] = pk, sig
            flat_pairs[j * bk + i] = pr
    kx, ky, kinf = _g1_words(keys)
    sx, sy, sinf = _g2_rows(sigs)
    msg, minf = _messages(list(messages) + [g2_inf] * (bm - m))
    r01 = B.rlc_pairs_words(flat_pairs)
    return (kx.reshape(bm, bk, 12), ky.reshape(bm, bk, 12),
            kinf.reshape(bm, bk), sx.reshape(bm, bk, 2, 12),
            sy.reshape(bm, bk, 2, 12), sinf.reshape(bm, bk), msg, minf,
            r01.reshape(bm, bk, 2))


def firehose_batch(member_keys, signatures, messages, pairs, bm=None,
                   bk=None):
    """Operands of `gpu.bls.aggregate_fast_verify_kernel` as numpy arrays:
    aggregate j's member keys `member_keys[j]` (host G1 points), its
    signature and H(mⱼ) (host G2 points) and RLC pair; padded with ∞
    members to bk ≥ the widest and with padding slots (slot_pad True, all
    ∞) to bm ≥ M → (mem_x, mem_y, mem_inf (bm, bk, …), slot_pad (bm,),
    sig_x, sig_y, sig_inf, msg, msg_inf, r01 (bm, 2))."""
    m = len(member_keys)
    bm = m if bm is None else bm
    widest = max((len(g) for g in member_keys), default=0)
    bk = max(widest, 1) if bk is None else bk
    keys = [A.PublicKey.aggregate([]).point] * (bm * bk)
    for j, grp in enumerate(member_keys):
        keys[j * bk: j * bk + len(grp)] = list(grp)
    kx, ky, kinf = _g1_words(keys)
    slot_pad = np.arange(bm) >= m
    g2_inf = A.Signature.empty().point
    sx, sy, sinf = _g2_rows(list(signatures) + [g2_inf] * (bm - m))
    msg, minf = _messages(list(messages) + [g2_inf] * (bm - m))
    r01 = B.rlc_pairs_words(list(pairs) + [PAD_PAIR] * (bm - m))
    return (kx.reshape(bm, bk, 12), ky.reshape(bm, bk, 12),
            kinf.reshape(bm, bk), slot_pad, sx, sy, sinf, msg, minf, r01)


def packed_signatures(sig_x, sig_y) -> np.ndarray:
    """(…, 2, 12) affine signature words → (…, 4, 13) int32 in the packed
    transfer format (x.c0, x.c1, y.c0, y.c1; `limbs.pack_fp_words_host`
    row by row), the signature plane of
    `gpu.bls.grouped_multi_verify_msm_packed_kernel`."""
    coords = np.concatenate([np.asarray(sig_x), np.asarray(sig_y)], -2)
    return np.concatenate(
        [coords, np.zeros(coords.shape[:-1] + (1,), np.int32)], -1)


# --- the entry points of __graft_entry__.py ----------------------------------


def _example_arrays(n_real: int, bucket: int):
    """The example batch as numpy arrays: keys `SecretKey.keygen(bytes([i])
    * 32)` signing b"graft-entry-%d" % i for i < n_real, padded with ∞
    rows to `bucket`, RLC pairs (7 + 13i, 5 + 3i) on every row."""
    sks = [A.SecretKey.keygen(bytes([i]) * 32) for i in range(n_real)]
    texts = [b"graft-entry-%d" % i for i in range(n_real)]
    pairs = [(7 + 13 * i, 5 + 3 * i) for i in range(bucket)]
    out = flat_batch([sk.public_key().point for sk in sks],
                     [sk.sign(t).point for sk, t in zip(sks, texts)],
                     [hash_to_g2(t) for t in texts], pairs[:n_real], bucket)
    return out[:-1] + (B.rlc_pairs_words(pairs),)


def example_batch(n_real: int, bucket: int, device=None):
    """A real (verifiable) padded batch of `multi_verify_kernel`'s operands
    on `device` (the card unless "cpu"): the port's copy of the JAX entry's
    `_example_batch` — the same keys, messages and RLC pairs, in canonical
    words. The reference also switches on XLA's compile cache here; the
    port compiles nothing per shape, so it has no counterpart."""
    dev = B.resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in _example_arrays(n_real, bucket))


def entry(device=None):
    """(fn, example_args) — the single-device batch-verify step:
    `gpu.bls.multi_verify_kernel` and `example_batch(2, 4)` on `device`.
    `fn(*args)` is the (1,) uint8 verdict tensor, 1 for this batch."""
    return B.multi_verify_kernel, example_batch(n_real=2, bucket=4,
                                                device=device)


def _mesh(n_devices: int, device) -> VerifyMesh:
    """n distinct cards where the machine has them, else n virtual shards
    of `device`'s card; n virtual CPU shards for device="cpu"."""
    if device is not None and torch.device(device).type == "cpu":
        return VerifyMesh.build(n_devices, platform="cpu")
    dev = B.resolve_device(device)
    if torch.cuda.device_count() >= n_devices:
        return VerifyMesh.build(n_devices)
    return VerifyMesh([dev] * n_devices)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the sharded batch-verify step over an n-device mesh (`_mesh`)
    and assert that it verifies: one example batch of 2 real sets in a
    bucket of m·k (m = n messages, k = 2n members each), first through
    `gpu.bls.make_sharded_multi_verify` (the flat program), then regrouped
    by message as the reference regroups it (member k of group m is row
    k·m' + m of the flat batch, m' = n) through
    `make_sharded_multi_verify_msm` with buckets (m, k) and RLC pairs from
    numpy's default_rng(3), the reference's draw. The reference's grouped
    pass takes Pippenger plans (`sharded_msm_plans`); the port's sums with
    per-row ladders and takes none.

    The reference's last check concerns XLA's compile cache: its factory
    returns the same cached executable and a re-dispatch runs warm. The
    port compiles nothing per shape; its counterpart is that calling the
    factory again gives the same verdict with no new load of the kernel
    library (`gpu._build`)."""
    from grandine_tpu_torch.gpu import _build

    mesh = _mesh(n_devices, device)
    m, k = n_devices, 2 * n_devices
    bucket = m * k
    (pk_x, pk_y, pk_inf, sig_x, sig_y, sig_inf, msg, msg_inf,
     r01) = _example_arrays(2, bucket)
    live = np.nonzero(~pk_inf)[0]  # the sharded callables take real sets

    def flat():
        fn = B.make_sharded_multi_verify(mesh)
        return bool(fn(*(a[live] for a in (pk_x, pk_y, sig_x, sig_y,
                                           sig_inf, msg, msg_inf, r01)),
                       bucket).item())

    ok = flat()
    assert ok, "sharded multi_verify rejected a valid batch"
    print(f"dryrun_multichip({n_devices}): sharded batch verify OK "
          f"({mesh.describe()} over {sorted({str(d) for d in mesh.devices})})")

    # the grouped pass: group g's members in member order, real sets only
    g_inf = pk_inf.reshape(k, m).T
    rows = np.array([kk * m + g for g in range(m) for kk in range(k)
                     if not g_inf[g, kk]], np.int64)
    counts = [int((~g_inf[g]).sum()) for g in range(m)]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    rng = np.random.default_rng(3)
    r_lo = rng.integers(1, 1 << 32, size=bucket, dtype=np.uint64)
    r_hi = rng.integers(0, 1 << 32, size=bucket, dtype=np.uint64)
    g_r01 = B.rlc_pairs_words(list(zip(r_lo[rows].tolist(),
                                       r_hi[rows].tolist())))
    msm_fn = B.make_sharded_multi_verify_msm(mesh)
    ok = bool(msm_fn(pk_x[rows], pk_y[rows], sig_x[rows], sig_y[rows],
                     sig_inf[rows], offsets, msg[:m], msg_inf[:m], g_r01, m,
                     k).item())
    assert ok, "sharded MSM multi_verify rejected a valid batch"
    print(f"dryrun_multichip({n_devices}): sharded grouped batch verify OK")

    lib = _build._lib
    assert flat(), "the factory called again rejected the batch"
    assert _build._lib is lib, "the factory called again loaded a library"
    print(f"dryrun_multichip({n_devices}): the factory called again gives "
          f"the same verdict, no new library load")


__all__ = ["entry", "example_batch", "dryrun_multichip", "flat_batch",
           "grouped_batch", "firehose_batch", "packed_signatures",
           "PAD_PAIR"]
