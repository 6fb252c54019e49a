"""BLS batch verification and batch signing on the card: the verify
kernels that follow decompression, the signing kernel, the group sums of
aggregate construction, and the host-facing backend.

`TorchBlsBackend` is the counterpart of grandine_tpu/tpu/bls.py
TpuBlsBackend with its verify seams and their edge semantics. Four
kinds of batches run on the same kernels:

  fast-aggregate (M aggregates, each one message over many signers —
  gossip): g2_decompress_subgroup or g2_subgroup_check (gpu/curve.py),
  aggregate_rlc_scale (this module: apkᵢ = Σ members, rᵢ·apkᵢ, rᵢ·sigᵢ),
  miller_loop_pairs (gpu/pairing.py), rlc_finish (this module: ∏ fᵢ ·
  f(−g1, Σ rᵢ·sigᵢ), final exponentiation, verdict) — replacing the JAX
  programs aggregate_fast_verify_msm{,_idx}{,_comp};

  flat (N signature sets, one signer key each — a block's sets, a replay
  window): the same signature plane, multi_rlc_scale (this module: rᵢ·pkᵢ
  and rᵢ·sigᵢ), miller_loop_pairs, rlc_finish — replacing
  multi_verify_msm{,_idx,_comp};

  message-grouped (N sets over M ≤ N/2 messages — a sync-committee slot,
  unaggregated attestations): multi_rlc_scale, g1_group_sum (this module:
  Σᵢ∈ⱼ rᵢ·pkᵢ per message), M Miller loops, rlc_finish over M message
  terms and N signature terms — replacing grouped_multi_verify_msm;

  RLC partition (the fault localizer's passes): the flat kernels with
  rlc_finish giving one verdict per contiguous group of sets —
  replacing rlc_partition_verify.

rlc_finish is one group-indexed kernel for all four: offsets name each
group's terms, and groups with no term cost nothing.

Keyed seams upload their keys' affine coordinates as the gather source
and pass an index plane over them, so the registry-indexed and keyed
seams of each family share one kernel. The uncompressed seams run
`g2_subgroup_check` on the same stream and fold its mask into the
verdict, as the JAX package fuses the ψ ladder into its verify programs
by default; the compressed seams get it from the decompression kernel.

Signing (`TorchBlsBackend.batch_sign`, the signing plane's device seam):
`batch_sign` (this module: [skᵢ]·H(mᵢ) by a branchless dual 128-bit GLV
ladder) — replacing batch_sign_kernel. Aggregate construction
(`g2_aggregate_groups`, `g1_aggregate_groups`): `g2_group_sum` /
`g1_group_sum` over groups padded with ∞ — replacing g2_aggregate_kernel
and g1_aggregate_kernel.

The JAX package's reference-only programs (no runtime caller there;
`__graft_entry__.entry` runs the flagship one) have their counterparts here
on the same kernels: `multi_verify_kernel`, `grouped_multi_verify_kernel`,
`aggregate_fast_verify_kernel` and `grouped_multi_verify_msm_packed_kernel`
(with `unpack_words` for its packed signature plane), beside
`batch_pubkey` (the G1 twin of `batch_sign`) and `g1_normalize` /
`g2_normalize` (Jacobian → affine on the card).

Host prep per batch: the row pack of the wire bytes or the affine
conversion of the signature points, hash-to-G2 of each distinct message
(LRU-cached), the RLC pairs and the index plane — no field arithmetic on
the card's behalf.
"""

from __future__ import annotations

import ctypes
import secrets
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto import constants
from grandine_tpu_torch.crypto.curves import (
    B1, B2, G1, Point, decompose_glv, g1_infinity, g2_infinity)
from grandine_tpu_torch.crypto.fields import Fq, Fq2, batch_inverse
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm
from grandine_tpu_torch.gpu import pairing as TP
from grandine_tpu_torch.gpu.mesh import resolve_mesh

#: largest batch one verification covers; bigger batches are split into
#: chunks of this size, each one RLC check (all must pass)
MAX_BUCKET = 1 << 14

#: bits of each GLV half of a secret scalar: Babai rounding keeps |k0|,
#: |k1| ≤ λ ≈ 2¹²⁷·⁴, and the ladder's mixed additions never meet a
#: degenerate case only while both stay below 2¹²⁸ (grandine_tpu/tpu/
#: curve.py:604-609)
SIGN_HALF_BITS = 128

#: entries of the hash-to-G2 point cache (one per distinct signing root;
#: a slot at mainnet width has at most 64 committees)
H2C_CACHE_CAP = 4096


def resolve_device(device) -> torch.device:
    """`device` or CUDA; raises when CUDA is asked for and absent (the
    port never moves to the CPU unless the caller says so)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    return dev


# --- aggregate_rlc_scale ------------------------------------------------------


def aggregate_rlc_scale_plain(src_x, src_y, idx, cnt, sig_x, sig_y,
                              sig_mask, r01):
    """Plain version of `aggregate_rlc_scale`: gather members
    src[idx[m, :cnt[m]]], sum them, rᵢ·apkᵢ (complete-add GLV ladder) and
    rᵢ·sigᵢ (mixed-add GLV ladder) with rᵢ = r01[m, 0] + r01[m, 1]·λ."""
    m, k = idx.shape
    dev = idx.device
    rows = idx.long()
    mx = L.from_words(src_x[rows])
    my = L.from_words(src_y[rows])
    live = torch.arange(k, device=dev).unsqueeze(0) < cnt.long().unsqueeze(1)
    apk = msm.strided_tree_sum((mx, my, L.one_fp((m, k), dev)), live,
                               C.FP_OPS)
    agg_inf = L.is_zero(apk[2])
    r = r01.to(torch.int64) & 0xFFFFFFFF
    rpk = C.scalar_mul_jac_glv(apk, agg_inf, r[:, 0], r[:, 1],
                               C.g1_endo(dev), C.FP_OPS)
    rsig = C.scalar_mul_glv(L.from_words(sig_x), L.from_words(sig_y),
                            sig_mask, r[:, 0], r[:, 1], C.g2_endo(dev),
                            C.FP2_OPS)
    return C.jac_to_words(rpk, 1), agg_inf, C.jac_to_words(rsig, 2)


def aggregate_rlc_scale(src_x, src_y, idx, cnt, sig_x, sig_y, sig_mask, r01):
    """Per aggregate: gather its members' G1 keys by index, sum them,
    then rᵢ·apkᵢ and rᵢ·sigᵢ. src_x/src_y (rows, 12) affine canonical
    words (the registry, or a keyed batch's uploaded members); idx (M, K)
    int32 with cnt (M,) members each; sig_x/sig_y (M, 2, 12) affine with
    sig_mask (M,) (∞ or rejected rows); r01 (M, 2) the 32-bit RLC halves.
    Returns rpk (M, 3, 12) Jacobian, agg_inf (M,), rsig (M, 3, 2, 12).
    CUDA kernel `aggregate_rlc_scale` (csrc/aggregate.cu) on CUDA tensors, the plain version
    on CPU tensors.

    Replaces, in the JAX programs aggregate_fast_verify_msm_idx_comp /
    _comp (grandine_tpu/tpu/bls.py:839, :815), the registry gather
    (bls.py:851-854), grandine_tpu/tpu/curve.py sum_points_grouped and
    scalar_mul_jac_glv (G1), and the per-row rᵢ·sigᵢ of the signature MSM.
    One block of 128 threads per aggregate: the threads sum the members
    in a strided loop and a shared-memory tree, then warp 0 runs the G1
    ladder and warp 1 the G2 ladder at once. Bound: operations — one
    complete G1 addition a member (16 Fp products), the tree, and two
    32-step ladders (~4,800 Fp products an aggregate of 130) against 100
    bytes a member (index and gathered row); the two
    ladders run on one thread each, so the kernel is latency-bound on the
    ladders, which later work splits across a warp."""
    if idx.device.type == "cpu":
        return aggregate_rlc_scale_plain(src_x, src_y, idx, cnt, sig_x,
                                         sig_y, sig_mask, r01)
    from grandine_tpu_torch.gpu import _build

    m, k = idx.shape
    dev = idx.device
    rpk = torch.empty((m, 3, 12), dtype=torch.int32, device=dev)
    agg_inf = torch.empty((m,), dtype=torch.bool, device=dev)
    rsig = torch.empty((m, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.launch("aggregate_rlc_scale", src_x, src_y, idx, cnt,
                  ctypes.c_int(m), ctypes.c_int(k), sig_x, sig_y, sig_mask,
                  r01, rpk, agg_inf, rsig)
    aggregate_rlc_scale.launches += 1
    return rpk, agg_inf, rsig


aggregate_rlc_scale.launches = 0


# --- multi_rlc_scale --------------------------------------------------------


def multi_rlc_scale_plain(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """Plain version of `multi_rlc_scale`: rᵢ·pkᵢ with pkᵢ = src[idx[i]]
    and rᵢ·sigᵢ, both by the mixed-add GLV ladder."""
    n = idx.shape[0]
    dev = idx.device
    rows = idx.long()
    r = r01.to(torch.int64) & 0xFFFFFFFF
    rpk = C.scalar_mul_glv(L.from_words(src_x[rows]), L.from_words(src_y[rows]),
                           torch.zeros((n,), dtype=torch.bool, device=dev),
                           r[:, 0], r[:, 1], C.g1_endo(dev), C.FP_OPS)
    rsig = C.scalar_mul_glv(L.from_words(sig_x), L.from_words(sig_y),
                            sig_mask, r[:, 0], r[:, 1], C.g2_endo(dev),
                            C.FP2_OPS)
    return C.jac_to_words(rpk, 1), C.jac_to_words(rsig, 2)


def multi_rlc_scale(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """Per signature set: rᵢ·pkᵢ (G1 GLV ladder from the affine key
    src[idx[i]]) and rᵢ·sigᵢ (G2 GLV ladder), rᵢ = r01[i, 0] + r01[i, 1]·λ.
    src_x/src_y (rows, 12) affine canonical words (the registry, or a
    keyed batch's uploaded keys, none ∞); idx (N,) int32; sig_x/sig_y
    (N, 2, 12) affine with sig_mask (N,) (∞ or rejected rows); r01 (N, 2)
    the 32-bit RLC halves. Returns rpk (N, 3, 12) and rsig (N, 3, 2, 12)
    Jacobian, the layouts `miller_loop_pairs` and `rlc_finish` take. CUDA
    kernel `multi_rlc_scale` (csrc/multi.cu) on CUDA tensors, the plain
    version on CPU tensors.

    Replaces, in the JAX programs multi_verify_msm{,_idx,_comp}
    (grandine_tpu/tpu/bls.py:592, :610, :790), the registry gather
    (:629-632), the per-signature G1 scalar_mul_glv and the G2 scalar
    plane of `_flat_msm_verify_tail` (:556-589). One thread per ladder:
    the first ⌈N/32⌉ warps run the G1 ladders and the warps after them
    the G2 ladders, one warp a block, so no warp holds both branches and
    the G1 and G2 warps land on separate SMs (N = 1,048 is 66 warps on
    132 SMs, one wave). Bound: operations — 32 doublings and ~32 mixed
    additions on each group (~2,300 Fp products a set) against ~640 bytes
    a set; each ladder is one thread's dependent chain, so the kernel is
    latency-bound on the G2 ladder (3 Fp products to each of G1's)."""
    if idx.device.type == "cpu":
        return multi_rlc_scale_plain(src_x, src_y, idx, sig_x, sig_y,
                                     sig_mask, r01)
    from grandine_tpu_torch.gpu import _build

    n = idx.shape[0]
    if (idx.dtype != torch.int32 or sig_x.shape != (n, 2, 12)
            or sig_y.shape != (n, 2, 12) or sig_mask.shape != (n,)
            or r01.shape != (n, 2)):
        raise ValueError("multi_rlc_scale: idx (N,) int32, sig_x/sig_y "
                         "(N, 2, 12), sig_mask (N,), r01 (N, 2)")
    dev = idx.device
    rpk = torch.empty((n, 3, 12), dtype=torch.int32, device=dev)
    rsig = torch.empty((n, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.launch("multi_rlc_scale", src_x, src_y, idx, ctypes.c_int(n),
                  sig_x, sig_y, sig_mask, r01, rpk, rsig)
    multi_rlc_scale.launches += 1
    return rpk, rsig


multi_rlc_scale.launches = 0


# --- g1_group_sum ---------------------------------------------------------------


def _offsets(offsets, n: int, what: str) -> np.ndarray:
    """Group offsets as an int64 array: M + 1 non-decreasing ints in
    [0, n]; raises ValueError otherwise."""
    off = np.asarray(offsets, np.int64).reshape(-1)
    if (off.size < 2 or off[0] < 0 or off[-1] > n
            or (np.diff(off) < 0).any()):
        raise ValueError(f"{what}: offsets must be M + 1 non-decreasing "
                         f"ints in [0, {n}], got {off.tolist()}")
    return off


def _offsets_to(off: np.ndarray, device) -> torch.Tensor:
    """int32 offsets on the card without waiting: a copy from pageable
    host memory first waits for every kernel queued on the stream, which
    would hold the host until the batch's earlier kernels finish, so the
    table goes through pinned memory, non-blocking."""
    return torch.from_numpy(off.astype(np.int32)).pin_memory().to(
        device, non_blocking=True)


def g1_group_sum_plain(rows, offsets):
    """Plain version of `g1_group_sum`: the groups' sums in the kernel's
    order (msm.sum_points_contiguous over a BLS_TREE-thread block)."""
    off = _offsets(offsets, rows.shape[0], "g1_group_sum")
    total = msm.sum_points_contiguous(C.jac_from_words(rows, 1), off,
                                      C.FP_OPS)
    return C.jac_to_words(total, 1)


def g1_group_sum(rows, offsets):
    """Σ of the Jacobian G1 rows (N, 3, 12) of each group [offsets[m],
    offsets[m+1]) — offsets, M + 1 host ints, are the only way groups are
    given — as (M, 3, 12) Jacobian words, ∞ (1, 1, 0) for an empty group;
    a row with Z = 0 is ∞. CUDA kernel `g1_group_sum` (csrc/multi.cu, the
    G1 instance of `group_sum<F>`) on CUDA tensors, the plain version on
    CPU tensors.

    Replaces, in grandine_tpu/tpu/bls.py grouped_multi_verify_msm_kernel
    (:483), the per-message key MSM Σᵢ∈ⱼ rᵢ·pkᵢ of `_grouped_msm_verify_tail`
    (:461-466), given the rᵢ·pkᵢ that `multi_rlc_scale` computes per set
    (the bucket MSM is queued as a perf item); and g1_aggregate_kernel
    (:1010, curve.py sum_points_contiguous) behind `g1_aggregate_groups`.
    One block of 128 threads per group: a strided loop of complete
    additions, then the shared-memory tree. Bound: operations — one
    complete G1 addition (16 Fp products) a row against 144 bytes a row;
    at M = 12 groups on 132 SMs the kernel is latency-bound on the
    ⌈rows/128⌉ + 7 dependent additions of a group."""
    if rows.device.type == "cpu":
        return g1_group_sum_plain(rows, offsets)
    out = _group_sum_cuda("g1_group_sum", rows, offsets, (3, 12))
    g1_group_sum.launches += 1
    return out


g1_group_sum.launches = 0


def g2_group_sum_plain(rows, offsets):
    """Plain version of `g2_group_sum`: the G2 twin of
    `g1_group_sum_plain`."""
    off = _offsets(offsets, rows.shape[0], "g2_group_sum")
    total = msm.sum_points_contiguous(C.jac_from_words(rows, 2), off,
                                      C.FP2_OPS)
    return C.jac_to_words(total, 2)


def g2_group_sum(rows, offsets):
    """Σ of the Jacobian G2 rows (N, 3, 2, 12) of each group [offsets[m],
    offsets[m+1]) as (M, 3, 2, 12) Jacobian words, ∞ (1, 1, 0) for an
    empty group; a row with Z = 0 is ∞. CUDA kernel `g2_group_sum`
    (csrc/multi.cu, the G2 instance of `group_sum<F>`) on CUDA tensors,
    the plain version on CPU tensors.

    Replaces grandine_tpu/tpu/bls.py g2_aggregate_kernel (:980, curve.py
    sum_points_contiguous :374) behind `g2_aggregate_groups`: aggregate
    construction, every committee of a slot in one launch. One block of
    128 threads per group, as `g1_group_sum`, over 36,864 B of static
    shared memory (128 Jacobian G2 points). Bound: operations — one
    complete G2 addition (48 Fp products) a row against 288 bytes a row;
    at a slot's 12–16 groups the kernel is latency-bound on the
    ⌈rows/128⌉ + 7 dependent additions of a group."""
    if rows.device.type == "cpu":
        return g2_group_sum_plain(rows, offsets)
    out = _group_sum_cuda("g2_group_sum", rows, offsets, (3, 2, 12))
    g2_group_sum.launches += 1
    return out


g2_group_sum.launches = 0


def _group_sum_cuda(name, rows, offsets, point_shape):
    from grandine_tpu_torch.gpu import _build

    n = rows.shape[0]
    if rows.shape[1:] != point_shape or rows.dtype != torch.int32:
        raise ValueError(f"{name}: rows (N, {', '.join(map(str, point_shape))})"
                         " int32")
    off = _offsets(offsets, n, name)
    m = off.size - 1
    out = torch.empty((m, *point_shape), dtype=torch.int32,
                      device=rows.device)
    _build.launch(name, rows.contiguous(), _offsets_to(off, rows.device),
                  ctypes.c_int(m), out)
    return out


def launch_geometry(name: str, n: int):
    """(blocks, threads a block, shared memory bytes, blocks one SM holds
    at once) of the launch that "batch_sign" makes over n rows, or
    "g1_group_sum" / "g2_group_sum" over n groups, on the current CUDA
    device. A query: it launches nothing."""
    from grandine_tpu_torch.gpu import _build

    geometry = np.zeros((4,), np.int32)
    out = ctypes.c_void_p(geometry.ctypes.data)
    if name == "batch_sign":
        _build.launch("batch_sign_geometry", ctypes.c_int(n), out)
    else:
        _build.launch("group_sum_geometry",
                      ctypes.c_int(name == "g2_group_sum"), ctypes.c_int(n),
                      out)
    return tuple(int(v) for v in geometry)


# --- batch_sign -----------------------------------------------------------------


def batch_sign_plain(msg, msg_inf, k, neg):
    """Plain version of `batch_sign`: the 128-bit dual GLV ladder of
    gpu/curve.py scalar_mul_glv with the sign masks."""
    w = k.to(torch.int64) & 0xFFFFFFFF
    out = C.scalar_mul_glv(L.from_words(msg[:, 0]), L.from_words(msg[:, 1]),
                           msg_inf, w[:, 0], w[:, 1], C.g2_endo(msg.device),
                           C.FP2_OPS, nbits=SIGN_HALF_BITS,
                           neg_lo=neg[:, 0], neg_hi=neg[:, 1])
    return C.jac_to_words(out, 2)


def batch_sign(msg, msg_inf, k, neg):
    """N signatures [skᵢ]·H(mᵢ): msg (N, 2, 2, 12) the affine canonical
    words [x, y] of H(mᵢ) with msg_inf (N,) (an ∞ row gives ∞ whatever
    its scalar); k (N, 2, 4) int32 the GLV halves |k0|, |k1| of skᵢ as
    little-endian 32-bit words and neg (N, 2) bool their signs
    (`sign_scalars_host`). Returns (N, 3, 2, 12) Jacobian words. CUDA
    kernel `batch_sign` (csrc/sign.cu) on CUDA tensors, the plain version
    on CPU tensors.

    Replaces grandine_tpu/tpu/bls.py batch_sign_kernel (:896) with
    curve.py scalar_mul_glv (:591) on FP2_OPS. One thread a signature, one
    warp a block: exactly 128 steps of one doubling and both mixed
    additions, the bits and the "started" state choosing by mask selects —
    no branch and no loop bound depends on a scalar bit. Bound:
    operations — 128 doublings and ~128 mixed additions in Fp2 (~11,000
    Fp products a row) against 515 bytes a row; each row is one thread's
    dependent chain, so at a lane's 512 rows the kernel is latency-bound
    on one ladder, and a full bucket (16,384 rows, 512 one-warp blocks)
    fills the card.

    NOTE (as the JAX kernel says): secret scalars live on the card; the
    kernel is branchless on the scalar (fixed trip count, select-based)
    but NOT hardened against physical side channels — the field
    arithmetic's conditional reductions still depend on the data."""
    n = msg_inf.shape[0]
    if (msg.shape != (n, 2, 2, 12) or k.shape != (n, 2, 4)
            or k.dtype != torch.int32 or neg.shape != (n, 2)):
        raise ValueError("batch_sign: msg (N, 2, 2, 12), msg_inf (N,), "
                         "k (N, 2, 4) int32, neg (N, 2)")
    if msg.device.type == "cpu":
        return batch_sign_plain(msg, msg_inf, k, neg)
    from grandine_tpu_torch.gpu import _build

    out = torch.empty((n, 3, 2, 12), dtype=torch.int32, device=msg.device)
    _build.launch("batch_sign", msg.contiguous(), msg_inf.contiguous(),
                  k.contiguous(), neg.contiguous(), ctypes.c_int(n), out)
    batch_sign.launches += 1
    return out


batch_sign.launches = 0


# --- batch_pubkey -------------------------------------------------------------


def batch_pubkey_plain(k, neg):
    """Plain version of `batch_pubkey`: the G1 twin of `batch_sign_plain`,
    the 128-bit dual GLV ladder from the generator with the sign masks."""
    n = k.shape[0]
    dev = k.device
    w = k.to(torch.int64) & 0xFFFFFFFF
    gx, gy = G1.to_affine()
    out = C.scalar_mul_glv(L.const_fp(gx.n, (n,), dev),
                           L.const_fp(gy.n, (n,), dev),
                           torch.zeros((n,), dtype=torch.bool, device=dev),
                           w[:, 0], w[:, 1], C.g1_endo(dev), C.FP_OPS,
                           nbits=SIGN_HALF_BITS, neg_lo=neg[:, 0],
                           neg_hi=neg[:, 1])
    return C.jac_to_words(out, 1)


def batch_pubkey(k, neg):
    """N public keys [skᵢ]·g1: k (N, 2, 4) int32 the GLV halves |k0|, |k1|
    of skᵢ as little-endian 32-bit words and neg (N, 2) bool their signs
    (`sign_scalars_host`). Returns (N, 3, 12) Jacobian words. CUDA kernel
    `batch_pubkey` (csrc/sign.cu) on CUDA tensors, the plain version on
    CPU tensors.

    Replaces grandine_tpu/tpu/bls.py batch_pubkey_kernel (:961) with
    curve.py scalar_mul_glv on FP_OPS. The G1 twin of `batch_sign`: one
    thread a key, one warp a block, exactly 128 steps of one doubling and
    both mixed additions from the fixed base g1 and [λ]g1, the bits and
    the "started" state choosing by mask selects. Bound: operations — 128
    doublings (7 Fp products) and popcount(k0) + popcount(k1) ≈ 128 mixed
    additions (11) of the function, ~2,300 Fp products a key (the
    branchless ladder computes both candidates, ~3,700), against 178
    bytes a key; each key is one thread's dependent chain, so the kernel
    is latency-bound on one ladder, and a full bucket (16,384 keys, 512
    one-warp blocks) fills the card.

    NOTE (as the JAX kernel says): secret scalars live on the card; the
    kernel is branchless on the scalar (fixed trip count, select-based)
    but NOT hardened against physical side channels — the field
    arithmetic's conditional reductions still depend on the data."""
    n = k.shape[0]
    if (k.shape != (n, 2, 4) or k.dtype != torch.int32
            or neg.shape != (n, 2) or neg.dtype != torch.bool):
        raise ValueError("batch_pubkey: k (N, 2, 4) int32, neg (N, 2) bool")
    if k.device.type == "cpu":
        return batch_pubkey_plain(k, neg)
    from grandine_tpu_torch.gpu import _build

    out = torch.empty((n, 3, 12), dtype=torch.int32, device=k.device)
    _build.launch("batch_pubkey", k.contiguous(), neg.contiguous(),
                  ctypes.c_int(n), out)
    batch_pubkey.launches += 1
    return out


batch_pubkey.launches = 0


# --- g1_normalize, g2_normalize -----------------------------------------------


def _normalize_plain(points, k: int):
    """Jacobian words of G1 (k = 1) or G2 (k = 2) → (affine [x, y] words,
    ∞ mask): z⁻¹ by Fermat (zero for ∞), x·z⁻², y·z⁻³."""
    X, Y, Z = C.jac_from_words(points, k)
    if k == 1:
        zi = L.inv_mod(Z)
        zi2 = L.montsq(zi)
        zi3 = L.montmul(zi2, zi)
        ops = C.FP_OPS
    else:
        zi = F.fp2_inv(Z)
        zi2 = F.fp2_sq(zi)
        zi3 = F.fp2_mul(zi2, zi)
        ops = C.FP2_OPS
    xy = ops.mul_many([X, Y], [zi2, zi3])
    inf = (points[:, 2] == 0).reshape(points.shape[0], -1).all(-1)
    return C.jac_to_words(xy, k), inf


def g1_normalize_plain(points):
    """Plain version of `g1_normalize`."""
    return _normalize_plain(points, 1)


def g2_normalize_plain(points):
    """Plain version of `g2_normalize`."""
    return _normalize_plain(points, 2)


def _normalize_cuda(name, points):
    from grandine_tpu_torch.gpu import _build

    n = points.shape[0]
    out = torch.empty((n, 2) + points.shape[2:], dtype=torch.int32,
                      device=points.device)
    inf = torch.empty((n,), dtype=torch.bool, device=points.device)
    _build.launch(name, points.contiguous(), ctypes.c_int(n), out, inf)
    return out, inf


def _normalize_shape(name, points, k: int) -> None:
    shape = (3, 12) if k == 1 else (3, 2, 12)
    if points.dim() != 1 + len(shape) or points.shape[1:] != shape \
            or points.dtype != torch.int32:
        raise ValueError(f"{name}: points (N, {', '.join(map(str, shape))})"
                         " int32")


def g1_normalize(points):
    """Jacobian → affine for (N, 3, 12) G1 canonical words: returns (xy
    (N, 2, 12) affine [x, y] words, inf (N,) bool, Z = 0). An ∞ row comes
    out as zero words (z⁻¹ = 0), where the reference leaves garbage under
    its mask, so parity with it is on live rows and masks. CUDA kernel
    `g1_normalize` (csrc/normalize.cu, the G1 instance of `normalize<F>`)
    on CUDA tensors, the plain version on CPU tensors.

    Replaces grandine_tpu/tpu/bls.py g1_normalize_kernel (:938). One
    thread a row: one Fermat inversion (p − 2: 380 squarings and 228
    products), z⁻², z⁻³ and two products, with the conversions in and out.
    Bound: operations — ~620 Fp products a row against 241 bytes a row;
    each row is one thread's dependent chain, so the kernel is
    latency-bound on one inversion, and a full bucket (16,384 rows, 256
    blocks of 64) is one wave on 132 SMs. A batched (Montgomery-trick)
    inversion would cut the products per row threefold."""
    _normalize_shape("g1_normalize", points, 1)
    if points.device.type == "cpu":
        return g1_normalize_plain(points)
    out = _normalize_cuda("g1_normalize", points)
    g1_normalize.launches += 1
    return out


g1_normalize.launches = 0


def g2_normalize(points):
    """Jacobian → affine for (N, 3, 2, 12) G2 canonical words: returns (xy
    (N, 2, 2, 12) affine [x, y] words, inf (N,) bool), ∞ rows as zero
    words (the reference's are garbage under its mask). CUDA kernel
    `g2_normalize` (csrc/normalize.cu, the G2 instance of `normalize<F>`)
    on CUDA tensors, the plain version on CPU tensors.

    Replaces grandine_tpu/tpu/bls.py g2_normalize_kernel (:951). One
    thread a row: the Fp2 inverse through the norm (one Fermat inversion
    in Fp and four products), z⁻², z⁻³ and two Fp2 products. Bound:
    operations — ~635 Fp products a row against 481 bytes a row;
    latency-bound on one inversion, as `g1_normalize`. It reads back a
    signing bucket's affine words on the card (`batch_sign`'s Jacobian
    words), where the host today runs one batched inversion."""
    _normalize_shape("g2_normalize", points, 2)
    if points.device.type == "cpu":
        return g2_normalize_plain(points)
    out = _normalize_cuda("g2_normalize", points)
    g2_normalize.launches += 1
    return out


g2_normalize.launches = 0


# --- unpack_words -------------------------------------------------------------


def unpack_words_plain(words):
    """Plain version of `unpack_words`: bits 0–389 as hi·2³⁸⁴ + lo, lo and
    hi each into Montgomery form (hi twice: hi·2³⁸⁴), summed, back out."""
    lo = L.to_mont(L.words_to_limbs(words[..., :12]))
    hi = torch.zeros_like(lo)
    hi[..., 0] = words[..., 12].to(torch.int64) & 0x3F
    return L.to_words(L.add_mod(lo, L.to_mont(L.to_mont(hi))))


def unpack_words(words):
    """Coordinates uploaded in the packed transfer format (…, 13) int32
    (13 little-endian words read as uint32, `limbs.pack_fp_words_host`) →
    (…, 12) canonical words below p. It takes exactly the bits the
    reference's tpu/limbs.py unpack_words takes (0–389: 26 limbs of 15
    bits; 390–415 are dropped) and reduces the value mod p as its
    to_mont_dev Montgomery product does, so every value, not only one
    below p, gives the reference's field element. CUDA kernel
    `unpack_words` (csrc/decompress.cu) on CUDA tensors, the plain version
    on CPU tensors.

    Replaces grandine_tpu/tpu/limbs.py unpack_words + to_mont_dev inside
    grandine_tpu/tpu/bls.py `_g2_packed_in` (:515) of
    grouped_multi_verify_msm_packed_kernel (:527). One thread a
    coordinate: three Montgomery products in and one out. Bound:
    operations — 4 Fp products a coordinate against 100 bytes; at a
    batch's few thousand coordinates the kernel is launch-bound."""
    if words.shape[-1:] != (13,) or words.dtype != torch.int32:
        raise ValueError("unpack_words: words (..., 13) int32")
    if words.device.type == "cpu":
        return unpack_words_plain(words)
    from grandine_tpu_torch.gpu import _build

    out = torch.empty(words.shape[:-1] + (12,), dtype=torch.int32,
                      device=words.device)
    _build.launch("unpack_words", words.contiguous(),
                  ctypes.c_int(words.numel() // 13), out)
    unpack_words.launches += 1
    return out


unpack_words.launches = 0


# --- rlc_finish -----------------------------------------------------------------


#: the widest span that `rlc_finish` runs one thread a group: a slot (an
#: Fp12 term and a signature term) costs that thread ~120 Fp products in
#: its strided loop, so 8 slots are ~3 % of the ~30,000 of its Miller loop
#: and final exponentiation, about what a 32-thread block's tree (5
#: levels) would cost instead — and 32 groups share a warp where a block
#: would leave 31 lanes idle through the tail
PER_THREAD_SPAN = 8


def finish_threads(spans) -> int:
    """Threads `rlc_finish` gives each live group of one launch, from the
    groups' spans (terms of the more numerous kind): 1 when no group
    spans more than PER_THREAD_SPAN (one thread a group, its strided loop
    sequential, no tree), else ⌈widest/32⌉ warps, at most one 128-thread
    block."""
    widest = max(spans, default=0)
    if widest <= PER_THREAD_SPAN:
        return 1
    return min(msm.TREE, 32 * -(-widest // 32))


def finish_groups(f, rsig, f_off=None, s_off=None):
    """(f_off, s_off, live group ids, threads) of an `rlc_finish` call; no
    offsets means one group over every term."""
    n_f, n_s = f.shape[0], rsig.shape[0]
    fo = _offsets([0, n_f] if f_off is None else f_off, n_f, "rlc_finish")
    so = _offsets([0, n_s] if s_off is None else s_off, n_s, "rlc_finish")
    if fo.size != so.size:
        raise ValueError("rlc_finish: f_off and s_off name different "
                         "numbers of groups")
    span = np.maximum(np.diff(fo), np.diff(so))
    live = np.nonzero(span > 0)[0]
    return fo, so, live, finish_threads(span[live].tolist())


def rlc_sig_miller_plain(rsig, offsets=None, tree: int = msm.TREE):
    """f(−g1, Σ rᵢ·sigᵢ) per group [offsets[m], offsets[m+1]) of the
    signature terms (M, 3, 2, 12) (no offsets: one group), each sum in
    the kernel's order; an (M, …) Fp12 batch."""
    dev = rsig.device
    off = [0, rsig.shape[0]] if offsets is None else offsets
    sig = msm.sum_points_contiguous(C.jac_from_words(rsig, 2), off,
                                    C.FP2_OPS, tree)
    m = sig[0].shape[0]
    neg = (-G1).to_affine()
    ng = (L.const_fp(neg[0].n, (m,), dev), L.const_fp(neg[1].n, (m,), dev),
          L.one_fp((m,), dev))
    return TP.miller_loop(ng, TP.jacobian_to_homogeneous(sig),
                          F.fp2_is_zero(sig[2]))


def _segment_any(flags, lo, hi):
    """any(flags[lo[m]:hi[m]]) per segment."""
    cs = torch.cat([flags.new_zeros(1, dtype=torch.int64),
                    flags.to(torch.int64).cumsum(0)])
    lo_t = torch.from_numpy(lo).to(flags.device)
    hi_t = torch.from_numpy(hi).to(flags.device)
    return (cs[hi_t] - cs[lo_t]) > 0


def rlc_finish_plain(f, rsig, agg_inf, sig_ok, sig_sub, f_off=None,
                     s_off=None):
    """Plain version of `rlc_finish`: (G,) uint8 verdicts; each live
    group's product and sum in the kernel's order at the launch's thread
    count, the groups batched; dead groups 1."""
    fo, so, live, threads = finish_groups(f, rsig, f_off, s_off)
    out = torch.ones((fo.size - 1,), dtype=torch.uint8, device=f.device)
    if live.size == 0:
        return out
    # dead groups hold no terms, so the live ones tile the same ranges
    lf = np.append(fo[live], fo[-1])
    ls = np.append(so[live], so[-1])
    prod = TP.fp12_product_tree_grouped(L.from_words(f), lf, threads)
    one = F.fp12_is_one(TP.final_exponentiation(
        F.fp12_mul(prod, rlc_sig_miller_plain(rsig, ls, threads))))
    bad = (_segment_any(agg_inf, lf[:-1], lf[1:])
           | _segment_any(~(sig_ok & sig_sub), ls[:-1], ls[1:]))
    out[torch.from_numpy(live).to(f.device)] = (one & ~bad).to(torch.uint8)
    return out


def rlc_finish(f, rsig, agg_inf, sig_ok, sig_sub, f_off=None, s_off=None):
    """The verdicts of G RLC groups: group g owns the Fp12 terms
    f[f_off[g]:f_off[g+1]] (M, 2, 3, 2, 12) with their flags agg_inf and
    the signature terms rsig[s_off[g]:s_off[g+1]] (N, 3, 2, 12) with
    sig_ok and sig_sub; its verdict is: Σ of its signature terms, the
    Miller loop of that against −g1, the product with its f terms and the
    final exponentiation give one, none of its aggregates summed to ∞,
    each of its signature rows decoded and lies in G2. Offsets are M + 1
    host ints; none means one group over every term (the flat and
    fast-aggregate batches: G = 1, f_off = [0, M], s_off = [0, N]; the
    grouped route: G = 1 with M message terms and N signature terms; an
    RLC partition: G groups of B/G slots). Returns (G,) uint8. CUDA kernel
    `rlc_finish` (csrc/pairing.cu) on CUDA tensors, the plain version on
    CPU tensors.

    Replaces grandine_tpu/tpu/bls.py `_rlc_finish` (:162) and
    `_rlc_finish_grouped` (:177) with grandine_tpu/tpu/pairing.py
    fp12_product_tree (:334), fp12_product_tree_grouped (:354) and
    final_exp_is_one (:300), the tree sums of the signature MSM and
    curve.py sum_points_contiguous, and the verdict folds of
    bls.py:703-724 and :857-865 (fast-aggregate), `_flat_msm_verify_tail`
    (flat sets) and rlc_partition_verify_kernel's fused subgroup check.
    Only live groups launch (a group with no term is 1: an empty product
    and an ∞ sum, written here without work). Threads follow the span
    (`finish_threads`): a group of span s gets ⌈s/32⌉ warps, one block a
    group, with a strided loop and trees over threads × 576 B of dynamic
    shared memory (the partial sums share the product tree's buffer);
    groups of span ≤ PER_THREAD_SPAN run one a thread, 32 to a block, no
    shared memory.
    Bound: operations — ~66 Fp products a term plus ~30,000 a live group
    for its Miller loop and final exponentiation, which stay sequential
    on one thread, so the kernel is latency-bound on them: its time is
    one group's tail times the waves its groups take
    (`rlc_finish_geometry`)."""
    if f.device.type == "cpu":
        return rlc_finish_plain(f, rsig, agg_inf, sig_ok, sig_sub, f_off,
                                s_off)
    return _rlc_finish_cuda(f, rsig, agg_inf, sig_ok, sig_sub, f_off, s_off)


def _rlc_finish_cuda(f, rsig, agg_inf, sig_ok, sig_sub, f_off, s_off):
    from grandine_tpu_torch.gpu import _build

    m, n = f.shape[0], rsig.shape[0]
    if (f.shape[1:] != (2, 3, 2, 12) or rsig.shape[1:] != (3, 2, 12)
            or agg_inf.shape != (m,) or sig_ok.shape != (n,)
            or sig_sub.shape != (n,)):
        raise ValueError("rlc_finish: f (M, 2, 3, 2, 12), rsig (N, 3, 2, "
                         "12), agg_inf (M,), sig_ok and sig_sub (N,)")
    fo, so, live, threads = finish_groups(f, rsig, f_off, s_off)
    dev = f.device
    verdict = torch.ones((fo.size - 1,), dtype=torch.uint8, device=dev)
    if live.size:
        table = _offsets_to(np.concatenate([fo, so, live]), dev)
        g1 = fo.size
        _build.launch("rlc_finish", f.contiguous(), rsig.contiguous(),
                      agg_inf.contiguous(), sig_ok.contiguous(),
                      sig_sub.contiguous(), table[:g1], table[g1:2 * g1],
                      table[2 * g1:], ctypes.c_int(live.size),
                      ctypes.c_int(threads), verdict)
        rlc_finish.launches += 1
    return verdict


rlc_finish.launches = 0


def rlc_finish_geometry(f, rsig, f_off=None, s_off=None):
    """(blocks, threads a block, dynamic shared memory bytes, blocks one
    SM holds at once) of the launch `rlc_finish` makes for these operands
    on the current CUDA device; (0, 0, 0, 0) when no group is live. A
    query: it launches nothing."""
    from grandine_tpu_torch.gpu import _build

    _, _, live, threads = finish_groups(f, rsig, f_off, s_off)
    geometry = np.zeros((4,), np.int32)
    if live.size:
        _build.launch("rlc_finish_geometry", ctypes.c_int(live.size),
                      ctypes.c_int(threads),
                      ctypes.c_void_p(geometry.ctypes.data))
    return tuple(int(v) for v in geometry)


# --- rlc_partial -----------------------------------------------------------------


def rlc_partial_plain(f, agg_inf, sig_ok, sig_sub, f_off=None, s_off=None):
    """Plain version of `rlc_partial`: each group's product in the kernel's
    order at the launch's thread count (one for an empty group) and its
    flag byte."""
    fo, so, _, threads = finish_groups(f, sig_ok, f_off, s_off)
    terms = L.from_words(f)
    if f.shape[0] == 0:  # every group empty: give the gather a row
        terms = F.fp12_one((1,), f.device)
    prod = TP.fp12_product_tree_grouped(terms, fo, threads)
    inf = _segment_any(agg_inf, fo[:-1], fo[1:])
    bad = _segment_any(~(sig_ok & sig_sub), so[:-1], so[1:])
    return (L.to_words(prod),
            inf.to(torch.uint8) | (~bad).to(torch.uint8) * 2)


def rlc_partial(f, agg_inf, sig_ok, sig_sub, f_off=None, s_off=None):
    """The partials one shard of a sharded verify contributes, per group
    g: the product of its Fp12 terms f[f_off[g]:f_off[g+1]] (M, 2, 3, 2,
    12) canonical words (one for an empty group), and one flag byte — bit
    0 any of the terms' agg_inf, bit 1 every signature row
    [s_off[g]:s_off[g+1]] with sig_ok and sig_sub (N,) (`partial_flags`
    splits it as `rlc_finish` takes it). Offsets are G + 1 host ints; none
    means one group over every term. No Miller loop and no final
    exponentiation: `rlc_finish` runs those once, over every shard's
    partial. Returns (G, 2, 3, 2, 12) int32 and (G,) uint8. CUDA kernel
    `rlc_partial` (csrc/pairing.cu) on CUDA tensors, the plain version on
    CPU tensors.

    Replaces, in the JAX programs make_sharded_multi_verify and
    make_sharded_multi_verify_msm (grandine_tpu/tpu/bls.py:1132, :1258),
    each chip's local product `TP.fp12_product_tree(TP.miller_loop(...))`
    (:1175-1177, :1368) and its subgroup fold `_fused_subgroup_mask(...)
    .all()` (:1185-1188, :1373-1375). It is the product half of
    `rlc_finish` (one shared device function), with `rlc_finish`'s
    geometry (`finish_threads`): every group launches. Bound: operations
    — 54 Fp products and one conversion a term, against 577 bytes a term;
    a shard's 64–512 terms fold in one block's strided loop and tree, so
    the kernel is latency-bound on ⌈terms/128⌉ + 7 dependent Fp12
    products, far below `rlc_finish`'s tail."""
    if f.device.type == "cpu":
        return rlc_partial_plain(f, agg_inf, sig_ok, sig_sub, f_off, s_off)
    from grandine_tpu_torch.gpu import _build

    m, n = f.shape[0], sig_ok.shape[0]
    if (f.shape[1:] != (2, 3, 2, 12) or agg_inf.shape != (m,)
            or sig_sub.shape != (n,)):
        raise ValueError("rlc_partial: f (M, 2, 3, 2, 12), agg_inf (M,), "
                         "sig_ok and sig_sub (N,)")
    fo, so, _, threads = finish_groups(f, sig_ok, f_off, s_off)
    g = fo.size - 1
    dev = f.device
    out = torch.empty((g, 2, 3, 2, 12), dtype=torch.int32, device=dev)
    flags = torch.empty((g,), dtype=torch.uint8, device=dev)
    table = _offsets_to(np.concatenate([fo, so]), dev)
    _build.launch("rlc_partial", f.contiguous(), agg_inf.contiguous(),
                  sig_ok.contiguous(), sig_sub.contiguous(), table[:g + 1],
                  table[g + 1:], ctypes.c_int(g), ctypes.c_int(threads), out,
                  flags)
    rlc_partial.launches += 1
    return out, flags


rlc_partial.launches = 0


def partial_flags(flags):
    """`rlc_partial` flag bytes as `rlc_finish`'s (agg_inf, sig_ok)."""
    return (flags & 1) != 0, (flags & 2) != 0


def signature_plane(sig_x, sig_y, sig_inf):
    """Uploaded affine signatures as the verify kernels take them:
    (sig_x, sig_y, mask, decoded, in_subgroup), `g2_subgroup_check`
    running on the same stream (the JAX package's fused ψ ladder)."""
    return (sig_x, sig_y, sig_inf, torch.ones_like(sig_inf),
            C.g2_subgroup_check(sig_x, sig_y, sig_inf))


def signature_plane_compressed(sig_rows, sig_inf):
    """(B, 96) wire rows decompressed on the card, the ψ check fused:
    (sig_x, sig_y, mask, decoded, in_subgroup); `sig_inf` is the host's
    wire infinity-flag mask."""
    sx, sy, dinf, dok, _be, _bc, _bi, sub = C.g2_decompress_subgroup(sig_rows)
    return sx, sy, sig_inf | dinf | ~dok, dok, sub


def verify_aggregates(src_x, src_y, idx, cnt, plane, msg, msg_inf, r01):
    """One fast-aggregate RLC verification on the device of its inputs;
    returns the (1,) uint8 verdict tensor without waiting for it."""
    sx, sy, mask, ok, sub = plane
    rpk, agg_inf, rsig = aggregate_rlc_scale(src_x, src_y, idx, cnt, sx, sy,
                                             mask, r01)
    f = TP.miller_loop_pairs(rpk, msg, agg_inf | msg_inf)
    return rlc_finish(f, rsig, agg_inf, ok, sub)


def verify_sets(src_x, src_y, idx, plane, msg, pair_inf, r01, offsets=None):
    """Flat RLC verification of N (message, signature, key) sets on the
    device of its inputs (pair_inf masks a set's pairing); `offsets` (host
    ints) splits the sets into contiguous groups, each with its own
    verdict (none: one group). Returns the (G,) uint8 verdict tensor
    without waiting for it."""
    sx, sy, mask, ok, sub = plane
    rpk, rsig = multi_rlc_scale(src_x, src_y, idx, sx, sy, mask, r01)
    f = TP.miller_loop_pairs(rpk, msg, pair_inf)
    return rlc_finish(f, rsig, torch.zeros_like(pair_inf), ok, sub, offsets,
                      offsets)


def verify_grouped(src_x, src_y, idx, plane, offsets, msg, msg_inf, r01,
                   pk_inf=None):
    """One message-grouped RLC verification: N sets ordered by message,
    message j owning sets offsets[j] … offsets[j+1] − 1 (host ints), M
    messages. Σᵢ∈ⱼ rᵢ·pkᵢ per message (`g1_group_sum` over the rᵢ·pkᵢ of
    `multi_rlc_scale`; a set whose `pk_inf` is set adds ∞), M Miller
    loops, one finish over M message terms and N signature terms. Returns
    the (1,) uint8 verdict tensor without waiting for it."""
    sx, sy, mask, ok, sub = plane
    rpk, rsig = multi_rlc_scale(src_x, src_y, idx, sx, sy, mask, r01)
    if pk_inf is not None:  # Z = 0: the group sum takes the row as ∞
        rpk[:, 2].masked_fill_(pk_inf.unsqueeze(-1), 0)
    gpk = g1_group_sum(rpk, offsets)
    gpk_inf = (gpk[:, 2] == 0).all(-1)
    f = TP.miller_loop_pairs(gpk, msg, gpk_inf | msg_inf)
    return rlc_finish(f, rsig, torch.zeros_like(msg_inf), ok, sub)


# --- the reference-only programs ---------------------------------------------
#
# The JAX package's device programs with no caller of its own runtime
# (grandine_tpu/tpu/bls.py:251, :322, :636, :527): the repository's
# entry point (`__graft_entry__.entry`, here `grandine_tpu_torch.entry`),
# the profiling tools and bench.py run them. Each takes the reference's
# operands in the port's layout — canonical words, (…, 2) RLC halves
# instead of 64 bit rows, the reference's ∞-padded shapes at any N —
# launches the named kernels on the device of its inputs and returns the
# (1,) uint8 verdict tensor without waiting. Like the reference, the first
# three run NO membership check on the signatures: their verdict is the
# algebra's.


def _expect(name: str, *pairs) -> None:
    """ValueError naming `name` unless each (tensor, shape) pair matches."""
    for t, shape in pairs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")


def multi_verify_kernel(pk_x, pk_y, pk_inf, sig_x, sig_y, sig_inf, msg,
                        msg_inf, r01):
    """Flat RLC verify of N (message, signature, key) triples, the
    counterpart of grandine_tpu/tpu/bls.py multi_verify_kernel (:251):
    pk_x, pk_y (N, 12) affine key words with pk_inf (N,); sig_x, sig_y
    (N, 2, 12) with sig_inf (N,); msg (N, 2, 2, 12) the affine [x, y] of
    H(mᵢ) with msg_inf (N,); r01 (N, 2) the 32-bit RLC halves (the
    reference's r_bits rows, `rlc_bits_host`). Any N; padding rows all-∞
    are neutral, as in the reference. No membership check: it launches
    no `g2_subgroup_check` (`signature_plane` does), so a signature
    outside G2 gets the algebra's verdict, as there. Launches
    `multi_rlc_scale`, `miller_loop_pairs` and `rlc_finish` (`verify_sets`
    over the keys as their own gather source)."""
    n = pk_inf.shape[0]
    _expect("multi_verify_kernel", (pk_x, (n, 12)), (pk_y, (n, 12)),
            (sig_x, (n, 2, 12)), (sig_y, (n, 2, 12)), (sig_inf, (n,)),
            (msg, (n, 2, 2, 12)), (msg_inf, (n,)), (r01, (n, 2)))
    idx = torch.arange(n, dtype=torch.int32, device=pk_inf.device)
    return verify_sets(pk_x.contiguous(), pk_y.contiguous(), idx,
                       _signature_operands(sig_x.contiguous(),
                                           sig_y.contiguous(), sig_inf, 0),
                       msg.contiguous(), pk_inf | msg_inf, r01.contiguous())


def _grouped_program(name, pk_x, pk_y, pk_inf, sx, sy, sig_inf, msg,
                     msg_inf, r01, check_subgroup: int):
    """The grouped programs' common tail: (M, K) member slots taken
    row-major (slot (m, k) is set m·K + k with its own r01[m, k], the row
    the reference's k-major flattening `_flat_km` also gives member (m,
    k)), `verify_grouped` over groups of K with the ∞ members masked."""
    m, k = pk_inf.shape
    _expect(name, (pk_x, (m, k, 12)), (pk_y, (m, k, 12)), (sig_inf, (m, k)),
            (msg, (m, 2, 2, 12)), (msg_inf, (m,)), (r01, (m, k, 2)))
    n = m * k
    plane = _signature_operands(sx.reshape(n, 2, 12), sy.reshape(n, 2, 12),
                                sig_inf.reshape(n), check_subgroup)
    idx = torch.arange(n, dtype=torch.int32, device=pk_inf.device)
    return verify_grouped(pk_x.reshape(n, 12), pk_y.reshape(n, 12), idx,
                          plane, range(0, n + 1, k), msg.contiguous(),
                          msg_inf, r01.reshape(n, 2), pk_inf.reshape(n))


def grouped_multi_verify_kernel(pk_x, pk_y, pk_inf, sig_x, sig_y, sig_inf,
                                msg, msg_inf, r01):
    """Message-grouped RLC verify, the counterpart of grandine_tpu/tpu/
    bls.py grouped_multi_verify_kernel (:322): M messages × K member slots
    padded with ∞ — pk_x, pk_y (M, K, 12) with pk_inf (M, K), sig_x, sig_y
    (M, K, 2, 12) with sig_inf (M, K), msg (M, 2, 2, 12) with msg_inf (M,),
    r01 (M, K, 2) (member (m, k)'s halves; the reference's (M, K, 64)
    r_bits rows, which its k-major flattening pairs with the same member).
    Σ of each message's rᵢ·pkᵢ, M Miller loops, one finish over M message
    terms and M·K signature terms. No membership check, as the reference.
    Launches `multi_rlc_scale`, `g1_group_sum`, `miller_loop_pairs` and
    `rlc_finish`."""
    m, k = pk_inf.shape
    _expect("grouped_multi_verify_kernel", (sig_x, (m, k, 2, 12)),
            (sig_y, (m, k, 2, 12)))
    return _grouped_program("grouped_multi_verify_kernel", pk_x, pk_y,
                            pk_inf, sig_x, sig_y, sig_inf, msg, msg_inf, r01,
                            0)


def aggregate_fast_verify_kernel(mem_x, mem_y, mem_inf, slot_pad, sig_x,
                                 sig_y, sig_inf, msg, msg_inf, r01):
    """The firehose program, the counterpart of grandine_tpu/tpu/bls.py
    aggregate_fast_verify_kernel (:636): M aggregates of up to K uploaded
    member keys — mem_x, mem_y (M, K, 12) with mem_inf (M, K) marking
    padding members, slot_pad (M,) marking padding slots — and per
    aggregate sig_x, sig_y (M, 2, 12) with sig_inf, msg (M, 2, 2, 12)
    with msg_inf, r01 (M, 2). pkᵢ = Σₖ memᵢₖ, rᵢ·pkᵢ, rᵢ·sigᵢ, the RLC
    check. A real slot (slot_pad False) whose members sum to ∞ makes the
    batch False (the reference's `forged`: an [P, −P] committee with an
    ∞ signature); a padding slot's ∞ sum only masks its pairing, so it
    stays neutral. No membership check, as the reference. Launches
    `aggregate_rlc_scale` (its gather source the uploaded member rows,
    each aggregate's live members first), `miller_loop_pairs` and
    `rlc_finish` (whose ∞-aggregate flag is `agg_inf & ~slot_pad`)."""
    m, k = mem_inf.shape
    _expect("aggregate_fast_verify_kernel", (mem_x, (m, k, 12)),
            (mem_y, (m, k, 12)), (slot_pad, (m,)), (sig_x, (m, 2, 12)),
            (sig_y, (m, 2, 12)), (sig_inf, (m,)), (msg, (m, 2, 2, 12)),
            (msg_inf, (m,)), (r01, (m, 2)))
    dev = mem_inf.device
    # each aggregate's live members first, in order, as `cnt` counts them
    order = torch.argsort(mem_inf.to(torch.uint8), dim=1, stable=True)
    idx = (order + torch.arange(m, device=dev).unsqueeze(1) * k).to(
        torch.int32)
    cnt = (~mem_inf).sum(1, dtype=torch.int32)
    sx, sy, mask, ok, sub = _signature_operands(
        sig_x.contiguous(), sig_y.contiguous(), sig_inf, 0)
    rpk, agg_inf, rsig = aggregate_rlc_scale(
        mem_x.reshape(m * k, 12), mem_y.reshape(m * k, 12), idx, cnt, sx,
        sy, mask, r01.contiguous())
    f = TP.miller_loop_pairs(rpk, msg.contiguous(), agg_inf | msg_inf)
    return rlc_finish(f, rsig, agg_inf & ~slot_pad, ok, sub)


def grouped_multi_verify_msm_packed_kernel(pk_x, pk_y, pk_inf, sig_words,
                                           sig_inf, msg, msg_inf, r01,
                                           check_subgroup: int = 0):
    """`grouped_multi_verify_kernel` with the signature plane uploaded in
    the packed transfer format, the counterpart of grandine_tpu/tpu/bls.py
    grouped_multi_verify_msm_packed_kernel (:527): sig_words (M, K, 4, 13)
    int32 — x.c0, x.c1, y.c0, y.c1 of each member's signature as 13
    words read as uint32 (`limbs.pack_fp_words_host`), 52 bytes a
    coordinate against 48 of canonical words here (104 of the reference's
    limbs) — the rest as `grouped_multi_verify_kernel`. With
    check_subgroup set, the signatures' G2 membership folds into the
    verdict (∞ rows pass), as the reference's `_fused_subgroup_mask`. It
    takes no MSM plan: the port sums the groups and the signature terms
    with per-row ladders (`multi_rlc_scale`, `g1_group_sum`; the
    reference's Pippenger plans `plan_msm` come with its bucket MSM, a
    later slice); parity is in verdicts. Launches `unpack_words`, where
    set `g2_subgroup_check`, then `multi_rlc_scale`, `g1_group_sum`,
    `miller_loop_pairs` and `rlc_finish`."""
    m, k = pk_inf.shape
    _expect("grouped_multi_verify_msm_packed_kernel",
            (sig_words, (m, k, 4, 13)))
    coords = unpack_words(sig_words.reshape(m * k, 4, 13))
    return _grouped_program("grouped_multi_verify_msm_packed_kernel", pk_x,
                            pk_y, pk_inf, coords[:, 0:2].contiguous(),
                            coords[:, 2:4].contiguous(), sig_inf, msg,
                            msg_inf, r01, check_subgroup)


# --- the sharded verify programs -----------------------------------------------
#
# The JAX package's multi-chip verify (grandine_tpu/tpu/bls.py:1129-1452)
# is one jitted shard_map program a mesh; here each factory returns a
# callable on host arrays that places every shard's operands on its device
# (`VerifyMesh.put`), launches that shard's kernels there, gathers the
# shards' partials on the first device (`VerifyMesh.gather`, stream-ordered
# copies) and finishes once. The reference runs its finish replicated on
# every chip; one finish on the first device gives the same verdict. The
# port compiles nothing per shape, so the reference's cached dispatch
# targets `sharded_multi_verify` and `sharded_multi_verify_msm` are the
# factories themselves.


def _signature_operands(sx, sy, sinf, check_subgroup: int):
    """Uploaded affine signatures as the scale kernels take them: (sig_x,
    sig_y, mask, decoded, in_subgroup), the ψ check on their device where
    `check_subgroup` is set, every row a member of G2 where it is not."""
    if check_subgroup:
        return signature_plane(sx, sy, sinf)
    return sx, sy, sinf, torch.ones_like(sinf), torch.ones_like(sinf)


def _finish_partials(mesh, f_parts, s_parts, flag_parts):
    """The gather and the finish: D Fp12 partials, D G2 partials and D
    flag bytes onto the first device, one `rlc_finish` over them."""
    f_all, s_all, flags = (mesh.gather(p)
                           for p in (f_parts, s_parts, flag_parts))
    agg_inf, sig_ok = partial_flags(flags)
    return rlc_finish(f_all, s_all, agg_inf, sig_ok, torch.ones_like(sig_ok))


def make_sharded_multi_verify(mesh, check_subgroup: int = 0):
    """The flat RLC verify with the batch axis sharded over `mesh`
    (grandine_tpu/tpu/bls.py make_sharded_multi_verify :1132). The
    callable takes the n real sets as host arrays — pk_x, pk_y (n, 12)
    affine key words (none ∞), sig_x, sig_y (n, 2, 12) with sig_inf (n,),
    msg (n, 2, 2, 12) with msg_inf (n,), r01 (n, 2) — and the JAX
    package's bucket b ≥ n, which the mesh divides. Shard d takes rows
    `shard_range(b, d)` ∩ [0, n) on its device: `g2_subgroup_check` where
    fused, `multi_rlc_scale`, `miller_loop_pairs`, `rlc_partial` (its one
    Fp12 partial and flags) and `g2_group_sum` (its one G2 partial; ∞ for
    a shard past the real rows, whose partial is Fp12 one). Then the
    gather and one `rlc_finish` over D terms of each kind on the first
    device. Returns the (1,) uint8 verdict tensor without waiting."""
    d_count = mesh.device_count

    def sharded_multi_verify_fn(pk_x, pk_y, sig_x, sig_y, sig_inf, msg,
                                msg_inf, r01, bucket: int):
        n = pk_x.shape[0]
        if n > bucket:  # rows past the bucket would go unverified
            raise ValueError(f"{n} sets do not fit a bucket of {bucket}")
        f_parts, s_parts, flag_parts = [], [], []
        for d in range(d_count):
            lo, hi = (min(v, n) for v in mesh.shard_range(bucket, d))
            px, py, sx, sy, sinf, mg, minf, r, idx = mesh.put(
                [a[lo:hi] for a in (pk_x, pk_y, sig_x, sig_y, sig_inf, msg,
                                    msg_inf, r01)]
                + [np.arange(hi - lo, dtype=np.int32)], d)
            if hi > lo:
                sx, sy, mask, ok, sub = _signature_operands(sx, sy, sinf,
                                                     check_subgroup)
                rpk, rsig = multi_rlc_scale(px, py, idx, sx, sy, mask, r)
                f = TP.miller_loop_pairs(rpk, mg, minf)
            else:  # a shard past the real rows
                ok = sub = sinf
                f = px.new_zeros((0, 2, 3, 2, 12))
                rsig = px.new_zeros((0, 3, 2, 12))
            prod, flags = rlc_partial(f, torch.zeros_like(minf), ok, sub)
            f_parts.append(prod)
            flag_parts.append(flags)
            s_parts.append(g2_group_sum(rsig, [0, hi - lo]))
        return _finish_partials(mesh, f_parts, s_parts, flag_parts)

    return sharded_multi_verify_fn


def make_sharded_multi_verify_msm(mesh, check_subgroup: int = 0):
    """The message-grouped RLC verify sharded over `mesh`
    (grandine_tpu/tpu/bls.py make_sharded_multi_verify_msm :1258). The
    callable takes the n sets in message order as host arrays (pk_x, pk_y,
    sig_x, sig_y, sig_inf, r01 as the flat callable's), the M + 1 message
    offsets, msg (M, 2, 2, 12) with msg_inf (M,), and the JAX package's
    buckets bm ≥ M and bk ≥ the widest group, both divided by the mesh.
    Shard d owns members `member_range(bk, d)` of every group: its
    `multi_rlc_scale`, `g1_group_sum` (M partial group sums, ∞ for a
    group with no member there) and `g2_group_sum` (one G2 partial). The
    M·D G1 partials reduce on the first device with `g1_group_sum`, D rows
    a group (the reference's reduce_over_devices, :1286-1305). The Miller
    plane is sharded by message (:1353-1367): shard d pairs groups [d·bm/D,
    (d+1)·bm/D) ∩ [0, M) with their sums, then `rlc_partial` over those
    terms and its own members' signature flags. Then the gather and one
    `rlc_finish`. The group sums come from per-row ladders, not the
    reference's Pippenger scan: parity is in points and verdicts. Returns
    the (1,) uint8 verdict tensor without waiting."""
    d_count = mesh.device_count

    def sharded_multi_verify_msm_fn(pk_x, pk_y, sig_x, sig_y, sig_inf,
                                    offsets, msg, msg_inf, r01, bm: int,
                                    bk: int):
        off = _offsets(offsets, pk_x.shape[0], "sharded_multi_verify_msm")
        starts, counts = off[:-1], np.diff(off)
        m = counts.size
        if m > bm or counts.max() > bk:  # members past bk go unverified
            raise ValueError(f"{m} groups of up to {counts.max()} do not fit "
                             f"buckets ({bm}, {bk})")
        g1_parts, s_parts, member_flags = [], [], []
        for d in range(d_count):
            klo, khi = mesh.member_range(bk, d)
            take = np.clip(counts, klo, khi) - klo  # members here a group
            rows = np.concatenate([np.arange(s + klo, s + klo + t)
                                   for s, t in zip(starts, take)]).astype(
                                       np.int64)
            px, py, sx, sy, sinf, r, idx = mesh.put(
                [a[rows] for a in (pk_x, pk_y, sig_x, sig_y, sig_inf, r01)]
                + [np.arange(rows.size, dtype=np.int32)], d)
            if rows.size:
                sx, sy, mask, ok, sub = _signature_operands(sx, sy, sinf,
                                                     check_subgroup)
                rpk, rsig = multi_rlc_scale(px, py, idx, sx, sy, mask, r)
            else:  # no group reaches this shard's members
                ok = sub = sinf
                rpk = px.new_zeros((0, 3, 12))
                rsig = px.new_zeros((0, 3, 2, 12))
            g1_parts.append(g1_group_sum(rpk, np.concatenate(
                [[0], np.cumsum(take)])))
            s_parts.append(g2_group_sum(rsig, [0, rows.size]))
            member_flags.append((ok, sub))
        # D partials a group, group-major: offsets every D
        rows = mesh.gather(g1_parts).view(d_count, m, 3, 12).transpose(0, 1)
        gpk = g1_group_sum(rows.reshape(m * d_count, 3, 12),
                           range(0, m * d_count + 1, d_count))
        f_parts, flag_parts = [], []
        for d, (ok, sub) in enumerate(member_flags):
            glo, ghi = (min(v, m) for v in mesh.shard_range(bm, d))
            g_d, mg, minf = mesh.put([gpk[glo:ghi], msg[glo:ghi],
                                      msg_inf[glo:ghi]], d)
            pair_inf = (g_d[:, 2] == 0).all(-1) | minf
            f = (TP.miller_loop_pairs(g_d, mg, pair_inf) if ghi > glo
                 else g_d.new_zeros((0, 2, 3, 2, 12)))
            prod, flags = rlc_partial(f, torch.zeros_like(minf), ok, sub)
            f_parts.append(prod)
            flag_parts.append(flags)
        return _finish_partials(mesh, f_parts, s_parts, flag_parts)

    return sharded_multi_verify_msm_fn


#: the reference's cached dispatch targets (tpu/bls.py:1414, :1433)
sharded_multi_verify = make_sharded_multi_verify
sharded_multi_verify_msm = make_sharded_multi_verify_msm


# --- host helpers ------------------------------------------------------------


def _bucket(n: int, lo: int = 4, hi: int = MAX_BUCKET) -> int:
    """The power-of-two bucket (at least `lo`) a batch of n pads into in
    the JAX package (grandine_tpu/tpu/bls.py `_bucket`); ValueError past
    `hi`. The port pads nothing on the card: the bucket sets the grouped
    route's rule and a partition's group geometry."""
    b = lo
    while b < n:
        b <<= 1
    if b > hi:
        raise ValueError(f"batch of {n} exceeds max bucket {hi}")
    return b


def message_groups(messages) -> "dict[bytes, list[int]]":
    """Set indices by message, in order of first appearance."""
    groups: "dict[bytes, list[int]]" = {}
    for i, message in enumerate(messages):
        groups.setdefault(bytes(message), []).append(i)
    return groups


def grouped_route(n_groups: int, widest: int, n: int) -> bool:
    """The JAX package's rule for `multi_verify_async`'s grouped route
    (grandine_tpu/tpu/bls.py:1972-1975): at least two sets a message on
    average, and the (messages × widest group) padding of its TPU program
    within 4× the flat bucket. A padding rule of the TPU, kept so that
    both packages take the same route; on the card it is to be replaced
    by a measured cost (ROADMAP.md)."""
    return (2 * n_groups <= n
            and _bucket(n_groups) * _bucket(widest) <= 4 * _bucket(n))



class _LruCache:
    """Bounded thread-safe LRU (the hash-to-G2 point cache)."""

    def __init__(self, cap: int) -> None:
        self.cap = max(1, int(cap))
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()

    def get(self, key):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
            return hit

    def put(self, key, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)


def g2_affine_words(pt) -> "tuple[np.ndarray, bool]":
    """Host G2 point → ((2, 2, 12) int32 [x, y] canonical words, is_inf)."""
    x, y, inf = g2_affine_words_many([pt])
    return np.stack([x[0], y[0]]), bool(inf[0])


def g1_affine_ints(rows) -> "list[tuple[int, int]]":
    """Jacobian G1 coordinates [(x, y, z), …] as ints, z ≠ 0 → affine
    [(x/z², y/z³), …], with one batched inversion."""
    p = L.P
    out = []
    for (x, y, _), zi in zip(rows, batch_inverse([r[2] for r in rows], p)):
        zi2 = zi * zi % p
        out.append((x * zi2 % p, y * zi2 % p * zi % p))
    return out


def g2_affine_ints(rows) -> "list[tuple[int, int, int, int]]":
    """Jacobian G2 coordinates [(x0, x1, y0, y1, z0, z1), …] as ints (Fp2
    as c0 + c1·u), Z ≠ 0 → affine [(x0, x1, y0, y1), …], with one batched
    inversion of the norms."""
    p = L.P
    ninv = batch_inverse([(r[4] * r[4] + r[5] * r[5]) % p for r in rows], p)
    out = []
    for (x0, x1, y0, y1, z0, z1), ni in zip(rows, ninv):
        z0, z1 = z0 * ni % p, -z1 * ni % p  # 1/Z = conj(Z)/|Z|
        a0, a1 = (z0 * z0 - z1 * z1) % p, 2 * z0 * z1 % p  # 1/Z²
        b0, b1 = (a0 * z0 - a1 * z1) % p, (a0 * z1 + a1 * z0) % p  # 1/Z³
        out.append(((x0 * a0 - x1 * a1) % p, (x0 * a1 + x1 * a0) % p,
                    (y0 * b0 - y1 * b1) % p, (y0 * b1 + y1 * b0) % p))
    return out


def g1_affine_words(points) -> "tuple[np.ndarray, np.ndarray]":
    """Host G1 points (any Z, none ∞) → (N, 12) x and y canonical words,
    with one batched inversion."""
    xy = g1_affine_ints([(pt.x.n, pt.y.n, pt.z.n) for pt in points])
    w = L.ints_to_words([v for v, _ in xy] + [v for _, v in xy])
    return w[: len(points)], w[len(points):]


def g2_affine_words_many(points):
    """Host G2 points (any Z) → ((N, 2, 12) x, (N, 2, 12) y canonical
    words, zero on ∞ rows; (N,) ∞ mask), with one batched inversion."""
    p = L.P
    n = len(points)
    inf = np.array([pt.is_infinity() for pt in points], bool).reshape(n)
    vals = g2_affine_ints([
        (pt.x.c0.n, pt.x.c1.n, pt.y.c0.n, pt.y.c1.n, pt.z.c0.n, pt.z.c1.n)
        for pt, i in zip(points, inf) if not i])
    xy = np.zeros((n, 2, 2, 12), np.int32)
    xy[~inf] = L.ints_to_words([v for r in vals for v in r]).reshape(
        -1, 2, 2, 12)
    return xy[:, 0], xy[:, 1], inf


def rlc_pairs_words(pairs) -> np.ndarray:
    """[(r0, r1), …] 32-bit halves → (M, 2) int32 (read as uint32)."""
    return np.array(pairs, dtype=np.uint32).reshape(-1, 2).view(np.int32)


def rlc_bits_host(pairs) -> np.ndarray:
    """[(r0, r1), …] → (M, 64) int32 bits [r0 MSB first | r1 MSB first]:
    the JAX package's RLC bit layout, for comparisons."""
    out = np.zeros((len(pairs), 64), np.int32)
    for i, (r0, r1) in enumerate(pairs):
        for b in range(32):
            out[i, b] = (r0 >> (31 - b)) & 1
            out[i, 32 + b] = (r1 >> (31 - b)) & 1
    return out


def sign_scalars_host(scalars, pad_to: "int | None" = None):
    """Secret scalars → (k (N, 2, 4) int32, neg (N, 2) bool): the GLV
    halves |k0|, |k1| (sk ≡ ±|k0| ± |k1|·λ mod r, crypto/curves.py
    decompose_glv) as little-endian 32-bit words and their signs
    (True = negative), the meaning of the JAX package's sign_bits_host
    (grandine_tpu/tpu/bls.py:126) in words instead of bits. Rows past the
    scalars, up to pad_to, are k0 = 1, k1 = 0. Raises AssertionError when
    a half reaches 2¹²⁸, where the ladder's degeneracy argument ends."""
    decs = [decompose_glv(int(v)) for v in scalars]
    n = len(decs) if pad_to is None else pad_to
    decs += [(1, 1, 0, 1)] * (n - len(decs))
    k = np.zeros((n, 2, 4), np.uint32)
    neg = np.zeros((n, 2), bool)
    for i, (a, sa, b, sb) in enumerate(decs):
        assert a < 1 << SIGN_HALF_BITS and b < 1 << SIGN_HALF_BITS
        k[i, 0] = np.frombuffer(a.to_bytes(16, "little"), "<u4")
        k[i, 1] = np.frombuffer(b.to_bytes(16, "little"), "<u4")
        neg[i] = sa < 0, sb < 0
    return k.view(np.int32), neg


def g2_points_from_words(words) -> "list[Point]":
    """(N, 3, 2, 12) Jacobian canonical words → host G2 points in affine
    form (Z = 1; ∞ where Z = 0), with one batched inversion."""
    v = L.words_to_ints(np.asarray(words).reshape(-1, 12))
    rows = [v[6 * i : 6 * i + 6] for i in range(len(v) // 6)]
    live = iter(g2_affine_ints([r for r in rows if r[4] or r[5]]))
    out = []
    for r in rows:
        if not (r[4] or r[5]):
            out.append(g2_infinity())
            continue
        x0, x1, y0, y1 = next(live)
        out.append(Point.from_affine(Fq2.from_ints(x0, x1),
                                     Fq2.from_ints(y0, y1), B2))
    return out


def g1_points_from_words(words) -> "list[Point]":
    """(N, 3, 12) Jacobian canonical words → host G1 points in affine form
    (Z = 1; ∞ where Z = 0), with one batched inversion."""
    v = L.words_to_ints(np.asarray(words).reshape(-1, 12))
    rows = [v[3 * i : 3 * i + 3] for i in range(len(v) // 3)]
    live = iter(g1_affine_ints([r for r in rows if r[2]]))
    out = []
    for r in rows:
        if not r[2]:
            out.append(g1_infinity())
            continue
        x, y = next(live)
        out.append(Point.from_affine(Fq(x), Fq(y), B1))
    return out


def jacobian_rows(points, k: int) -> np.ndarray:
    """Host points of G1 (k = 1) or G2 (k = 2), any Z, ∞ allowed → (N, 3,
    [2,] 12) Jacobian canonical words with Z = 1, or all zero (Z = 0: ∞)
    on ∞ rows; one batched inversion."""
    n = len(points)
    shape = (n, 3, 12) if k == 1 else (n, 3, 2, 12)
    out = np.zeros(shape, np.int32)
    if k == 2:
        x, y, inf = g2_affine_words_many(points)
        out[:, 0], out[:, 1] = x, y
    else:
        inf = np.array([pt.is_infinity() for pt in points], bool).reshape(n)
        if (~inf).any():
            fx, fy = g1_affine_words([pt for pt, i in zip(points, inf)
                                      if not i])
            out[~inf, 0], out[~inf, 1] = fx, fy
    live = np.nonzero(~inf)[0]
    if k == 1:
        out[live, 2, 0] = 1  # Z = 1
    else:
        out[live, 2, 0, 0] = 1  # Z = 1 + 0·u
    return out


def g1_decompress_rows(rows, device):
    """g1_decompress on (B, 48) uint8 numpy rows placed on
    `device`; the registry's ingest seam."""
    t = torch.as_tensor(np.ascontiguousarray(rows), dtype=torch.uint8)
    return C.g1_decompress(t.to(device))


# --- aggregate construction -----------------------------------------------------


def _aggregate_groups(groups, k: int, group_sum, device):
    """The contiguous-group sums of `group_sum` over host points (G1 for
    k = 1, G2 for k = 2), with the JAX package's bucketing and chunking
    (grandine_tpu/tpu/bls.py:1031-1128): every group padded with ∞ to the
    power-of-two bucket s of the widest, group g owning rows [g·s, g·s +
    s); past MAX_BUCKET rows the groups go in chunks of MAX_BUCKET / s.
    The JAX package also pads the group count to a power of two for its
    compile cache; groups past the real ones would be all ∞ and are not
    launched. Returns one host point a group (∞ for an empty group)."""
    m = len(groups)
    s = _bucket(max(max(len(grp) for grp in groups), 1))
    per_chunk = max(1, MAX_BUCKET // s)
    if m > per_chunk:
        return [pt for i in range(0, m, per_chunk)
                for pt in _aggregate_groups(groups[i : i + per_chunk], k,
                                            group_sum, device)]
    flat = jacobian_rows([pt for grp in groups for pt in grp], k)
    rows = np.zeros((m * s,) + flat.shape[1:], np.int32)  # Z = 0: ∞
    pos = 0
    for g, grp in enumerate(groups):
        rows[g * s : g * s + len(grp)] = flat[pos : pos + len(grp)]
        pos += len(grp)
    out = group_sum(torch.from_numpy(rows).to(device), range(0, m * s + 1, s))
    words = out.cpu().numpy()
    return (g1_points_from_words if k == 1 else g2_points_from_words)(words)


def g2_aggregate_groups(groups, device=None) -> "list[A.Signature]":
    """Aggregate construction: a list of signature groups → one aggregate
    `Signature` per group, every group of the call summed on the card in
    one `g2_group_sum` launch (grandine_tpu/tpu/bls.py g2_aggregate_groups
    :1031 over g2_aggregate_kernel :980). An empty group gives ∞, as
    `Signature.aggregate([])` does; the host `Signature.aggregate` is the
    twin, byte for byte."""
    if not groups:
        return []
    pts = _aggregate_groups([[sig.point for sig in grp] for grp in groups],
                            2, g2_group_sum, resolve_device(device))
    return [A.Signature(pt) for pt in pts]


def g1_aggregate_groups(groups, device=None) -> "list[A.PublicKey]":
    """The G1 twin: public-key groups → one aggregate `PublicKey` per group
    in one `g1_group_sum` launch (grandine_tpu/tpu/bls.py
    g1_aggregate_groups :1084 over g1_aggregate_kernel :1010); the host
    `PublicKey.aggregate` is the twin."""
    if not groups:
        return []
    pts = _aggregate_groups([[pk.point for pk in grp] for grp in groups],
                            1, g1_group_sum, resolve_device(device))
    return [A.PublicKey(pt) for pt in pts]


# --- backend ------------------------------------------------------------------


class TorchBlsBackend:
    """Host façade over the verify kernels, with the edge semantics of
    grandine_tpu/tpu/bls.py TpuBlsBackend's seams: an empty batch is True;
    a length mismatch, an empty member list, an out-of-range index, an
    identity key or a wrong-length signature is False; batches over
    MAX_BUCKET run in chunks; an indexed batch past MAX_BUCKET (a wider
    committee, or more flat sets) goes to the keyed seam through the
    registry's host mirror. The RLC pairs are drawn from `rng` in the JAX
    package's order, one per set after the batch's messages are hashed.
    `multi_verify_async` routes a keyed batch with repeated messages to
    the grouped kernels where the JAX package does; `rlc_partition_verify`
    gives per-group verdicts for the fault localizer
    (runtime/isolation.py); `verify` and `fast_aggregate_verify` are
    batches of one.

    With a `VerifyMesh` (gpu/mesh.py; a 1-device mesh is no mesh) the
    backend runs on the mesh's first device and routes as the JAX package
    does (tpu/bls.py:1999-2018, :2102-2112): a keyed flat batch through
    `sharded_multi_verify` where the mesh divides its bucket b and b ≥ 2·D,
    a grouped batch through `sharded_multi_verify_msm` where D divides both
    of its buckets. The indexed seams read a row-sharded registry through
    its gather (`DevicePubkeyRegistry.rows_for`) whatever the mesh."""

    #: the uncompressed verify seams run `g2_subgroup_check` on the card
    #: and fold its mask into the verdict, so a dispatcher stacks no
    #: separate subgroup pass (the reference's fused verify programs)
    fuse_subgroup = True

    def __init__(self, device=None, mesh=None) -> None:
        self.mesh, device = resolve_mesh(mesh, device)
        self.device = resolve_device(device)
        if self.device.type == "cuda":  # a kernel that does not build
            from grandine_tpu_torch.gpu import _build  # raises here

            _build.library()
        self._h2c_cache = _LruCache(H2C_CACHE_CAP)

    # -- host prep ---------------------------------------------------------

    def _up(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, order="C")).to(self.device)

    def _hash_to_g2_words(self, message: bytes, dst: bytes):
        key = (bytes(message), dst)
        hit = self._h2c_cache.get(key)
        if hit is None:
            hit = g2_affine_words(hash_to_g2(message, dst))
            self._h2c_cache.put(key, hit)
        return hit

    @staticmethod
    def _rlc_pair(rng) -> "tuple[int, int]":
        """A nonzero (r0, r1) pair of 32-bit halves: the RLC scalar is
        r0 + r1·λ (λ = x² mod r), drawn in the JAX package's order."""
        a, b = 0, 0
        while a == 0 and b == 0:
            a, b = rng.randbits(32), rng.randbits(32)
        return a, b

    @staticmethod
    def _pack_sig_rows(signatures, b: int):
        """(b, 96) uint8 signature rows + the wire infinity-flag mask;
        padding rows carry the canonical infinity encoding. Raises
        ValueError on a wrong-length blob."""
        rows = C.compressed_rows(signatures, 96)
        n = rows.shape[0]
        sig_rows = np.zeros((b, 96), np.uint8)
        sig_rows[:, 0] = C.COMPRESSED_FLAG | C.INFINITY_FLAG
        sig_rows[:n] = rows
        sig_inf = np.ones((b,), bool)
        sig_inf[:n] = C.compressed_infinity_flags(rows)
        return sig_rows, sig_inf

    def _sig_plane(self, signatures, compressed: bool):
        """The signature operands on the card (`signature_plane*`): wire
        bytes, or `Signature`s converted to affine words on the host.
        None for a wrong-length blob."""
        if compressed:
            try:
                rows, inf = self._pack_sig_rows(signatures, len(signatures))
            except ValueError:
                return None
            return signature_plane_compressed(self._up(rows), self._up(inf))
        sx, sy, inf = g2_affine_words_many([s.point for s in signatures])
        return signature_plane(self._up(sx), self._up(sy), self._up(inf))

    def _message_words(self, messages, dst):
        """H(mᵢ) as host (M, 2, 2, 12) affine words and (M,) ∞ mask."""
        m = len(messages)
        msg = np.zeros((m, 2, 2, 12), np.int32)
        msg_inf = np.zeros((m,), bool)
        for i, message in enumerate(messages):
            msg[i], msg_inf[i] = self._hash_to_g2_words(message, dst)
        return msg, msg_inf

    def _messages(self, messages, dst):
        msg, msg_inf = self._message_words(messages, dst)
        return self._up(msg), self._up(msg_inf)

    def _keys_src(self, points):
        """Affine words of host G1 keys (none ∞) uploaded as a gather
        source."""
        fx, fy = g1_affine_words(points)
        return self._up(fx), self._up(fy)

    @staticmethod
    def _chunked(fn, m, *seqs):
        first = fn(*(s[0:MAX_BUCKET] for s in seqs))

        def settle_chunks() -> bool:
            pending = first
            for i in range(MAX_BUCKET, m, MAX_BUCKET):
                nxt = fn(*(s[i : i + MAX_BUCKET] for s in seqs))
                if not pending():
                    return False
                pending = nxt
            return pending()

        return settle_chunks

    @staticmethod
    def _settle(verdict):
        return lambda: bool(verdict.item())

    # -- the two families ----------------------------------------------------

    def _aggregate_async(self, messages, signatures, members, registry, dst,
                         rng, compressed: bool):
        """Fast-aggregate seams: `members` are PublicKey lists (registry
        None) or index lists into `registry`."""
        m = len(messages)
        if not (m == len(signatures) == len(members)):
            return lambda: False
        if m == 0:
            return lambda: True
        if any(len(ks) == 0 for ks in members):
            return lambda: False
        if m > MAX_BUCKET:
            return self._chunked(
                lambda a, b, c: self._aggregate_async(
                    a, b, c, registry, dst, rng, compressed),
                m, messages, signatures, members)
        widest = max(len(ks) for ks in members)
        if registry is not None:
            reg_x, reg_y, reg_n = registry.arrays()
            if reg_x is None or any(
                not 0 <= int(i) < reg_n for ix in members for i in ix
            ):
                return lambda: False
            if widest > MAX_BUCKET:
                return self._aggregate_async(
                    messages, signatures,
                    [registry.public_keys(ix) for ix in members], None, dst,
                    rng, compressed)
            idx = np.zeros((m, widest), np.int32)
            for i, ix in enumerate(members):
                idx[i, : len(ix)] = np.fromiter((int(v) for v in ix),
                                                np.int32, count=len(ix))
            src_x, src_y, idx = registry.rows_for(idx, self.device)
        else:
            if any(pk.point.is_infinity() for ks in members for pk in ks):
                return lambda: False
            if widest > MAX_BUCKET:
                members = [
                    ks if len(ks) <= MAX_BUCKET else [A.PublicKey.aggregate(ks)]
                    for ks in members
                ]
                widest = max(len(ks) for ks in members)
            src_x, src_y = self._keys_src(
                [pk.point for ks in members for pk in ks])
            idx = np.zeros((m, widest), np.int32)
            pos = 0
            for i, ks in enumerate(members):
                idx[i, : len(ks)] = np.arange(pos, pos + len(ks),
                                              dtype=np.int32)
                pos += len(ks)
        cnt = np.array([len(ks) for ks in members], np.int32)
        plane = self._sig_plane(signatures, compressed)
        if plane is None:
            return lambda: False
        msg, msg_inf = self._messages(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(m)]
        return self._settle(verify_aggregates(
            src_x, src_y, self._up(idx), self._up(cnt), plane, msg, msg_inf,
            self._up(rlc_pairs_words(pairs))))

    def _sets_async(self, messages, signatures, keys, registry, dst, rng,
                    compressed: bool):
        """The screening every flat seam shares, in the JAX package's
        order — length mismatch False, empty True, an out-of-range index
        False, past MAX_BUCKET an indexed batch goes keyed through the
        registry's host mirror and a keyed one runs in chunks, an ∞ key
        False — then the launch: an indexed or compressed batch flat, a
        keyed uncompressed one grouped by message where `grouped_route`
        says so. `keys` are PublicKeys (registry None) or registry
        indices, one signer per set."""
        n = len(messages)
        if not (n == len(signatures) == len(keys)):
            return lambda: False
        if n == 0:
            return lambda: True
        if registry is not None:
            reg_x, reg_y, reg_n = registry.arrays()
            if reg_x is None or any(not 0 <= int(i) < reg_n for i in keys):
                return lambda: False
            if n > MAX_BUCKET:
                return self._sets_async(messages, signatures,
                                        registry.public_keys(keys), None,
                                        dst, rng, compressed)
            src_x, src_y, idx = registry.rows_for(
                np.fromiter((int(v) for v in keys), np.int32, count=n),
                self.device)
            return self._flat_multi_verify_async(
                messages, signatures, src_x, src_y, idx, dst, rng,
                compressed)
        if n > MAX_BUCKET:
            return self._chunked(
                lambda a, b, c: self._sets_async(a, b, c, None, dst, rng,
                                                 compressed),
                n, messages, signatures, keys)
        if any(pk.point.is_infinity() for pk in keys):
            return lambda: False
        fx, fy = g1_affine_words([pk.point for pk in keys])
        if not compressed:
            groups = message_groups(messages)
            if grouped_route(len(groups), max(map(len, groups.values())), n):
                return self._grouped_multi_verify_async(
                    groups, signatures, fx, fy, dst, rng)
            b = _bucket(n)
            if (self.mesh is not None and self.mesh.divides(b)
                    and b >= 2 * self.mesh.device_count):
                return self._sharded_multi_verify_async(
                    messages, signatures, fx, fy, dst, rng)
        return self._flat_multi_verify_async(
            messages, signatures, self._up(fx), self._up(fy),
            np.arange(n, dtype=np.int32), dst, rng, compressed)

    def _flat_multi_verify_async(self, messages, signatures, src_x, src_y,
                                 idx, dst, rng, compressed: bool):
        """The flat launch: set i's key is row idx[i] of (src_x, src_y)."""
        plane = self._sig_plane(signatures, compressed)
        if plane is None:
            return lambda: False
        msg, msg_inf = self._messages(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(len(messages))]
        return self._settle(verify_sets(
            src_x, src_y, self._up(idx), plane, msg, msg_inf,
            self._up(rlc_pairs_words(pairs))))

    def _sharded_multi_verify_async(self, messages, signatures, fx, fy,
                                    dst, rng):
        """The keyed flat batch over the mesh (the JAX package's
        `sharded_multi_verify` route, tpu/bls.py:1999-2018): host words of
        keys (fx, fy), signatures and messages, the RLC pairs in the flat
        route's order, shard placement left to the sharded program."""
        sx, sy, sinf = g2_affine_words_many([s.point for s in signatures])
        msg, msg_inf = self._message_words(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(len(messages))]
        fn = sharded_multi_verify(self.mesh,
                                  check_subgroup=int(self.fuse_subgroup))
        return self._settle(fn(fx, fy, sx, sy, sinf, msg, msg_inf,
                               rlc_pairs_words(pairs),
                               _bucket(len(messages))))

    def _grouped_multi_verify_async(self, groups, signatures, fx, fy, dst,
                                    rng):
        """The message-grouped launch (the JAX package's
        `_grouped_multi_verify_async`, tpu/bls.py:2069): the sets in
        message order, one RLC pair each drawn in that order, set i's key
        row i of the host key words (fx, fy). Over the mesh where D divides
        both buckets (tpu/bls.py:2102-2112), else on one device."""
        order = np.fromiter((i for ix in groups.values() for i in ix),
                            np.int32, count=len(signatures))
        offsets = np.cumsum([0] + [len(ix) for ix in groups.values()])
        bm = _bucket(len(groups))
        bk = _bucket(int(np.diff(offsets).max()))
        mesh = self.mesh
        if (mesh is not None and bm % mesh.device_count == 0
                and bk % mesh.device_count == 0):
            sx, sy, sinf = g2_affine_words_many(
                [signatures[i].point for i in order])
            msg, msg_inf = self._message_words(list(groups), dst)
            pairs = [self._rlc_pair(rng) for _ in range(len(order))]
            fn = sharded_multi_verify_msm(
                mesh, check_subgroup=int(self.fuse_subgroup))
            return self._settle(fn(fx[order], fy[order], sx, sy, sinf,
                                   offsets, msg, msg_inf,
                                   rlc_pairs_words(pairs), bm, bk))
        plane = self._sig_plane([signatures[i] for i in order], False)
        msg, msg_inf = self._messages(list(groups), dst)
        pairs = [self._rlc_pair(rng) for _ in range(len(order))]
        return self._settle(verify_grouped(
            self._up(fx), self._up(fy), self._up(order), plane, offsets, msg,
            msg_inf, self._up(rlc_pairs_words(pairs))))

    # -- flat seams ------------------------------------------------------------

    def multi_verify(self, messages, signatures, public_keys,
                     dst: bytes = constants.DST_SIGNATURE,
                     rng=secrets) -> bool:
        return self.multi_verify_async(messages, signatures, public_keys,
                                       dst, rng)()

    def multi_verify_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        public_keys: Sequence["A.PublicKey"],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """RLC verify of N (message, signature, key) sets: launches now
        and returns a zero-arg callable giving the verdict, so the
        caller's host work overlaps the device run. Batches with repeated
        messages take the grouped route where `grouped_route` says so (M
        Miller loops over Σᵢ∈ⱼ rᵢ·pkᵢ instead of N), the rest the flat
        one; the verdict is the same."""
        return self._sets_async(messages, signatures, public_keys, None, dst,
                                rng, compressed=False)

    def multi_verify_compressed(self, messages, signatures, public_keys,
                                dst: bytes = constants.DST_SIGNATURE,
                                rng=secrets) -> bool:
        return self.multi_verify_compressed_async(
            messages, signatures, public_keys, dst, rng)()

    def multi_verify_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence["A.PublicKey"],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """multi_verify_async with signatures as 96-byte wire rows,
        decompressed and ψ-checked on the card."""
        return self._sets_async(messages, signatures, public_keys, None, dst,
                                rng, compressed=True)

    def multi_verify_indexed(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        indices: Sequence[int],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ) -> bool:
        """Flat RLC verify with each set's signer key gathered on the card
        from the registry by validator index; an index the registry does
        not cover fails."""
        return self._sets_async(messages, signatures, indices, registry, dst,
                                rng, compressed=False)()

    # -- single-item seams ---------------------------------------------------

    def verify(self, message: bytes, signature: "A.Signature",
               public_key: "A.PublicKey",
               dst: bytes = constants.DST_SIGNATURE) -> bool:
        """One (message, signature, key) set: a flat batch of one
        (grandine_tpu/tpu/bls.py TpuBlsBackend.verify :2173)."""
        return self.multi_verify([message], [signature], [public_key], dst)

    def fast_aggregate_verify(self, message: bytes, signature: "A.Signature",
                              public_keys: Sequence["A.PublicKey"],
                              dst: bytes = constants.DST_SIGNATURE) -> bool:
        """One aggregate over `public_keys`: a fast-aggregate batch of one
        (TpuBlsBackend.fast_aggregate_verify :2828); no keys is False."""
        return self.fast_aggregate_verify_batch([message], [signature],
                                                [public_keys], dst)

    def g2_subgroup_check_batch(self, points) -> np.ndarray:
        return self.g2_subgroup_check_batch_async(points)()

    def g2_subgroup_check_batch_async(self, points):
        """ψ-criterion membership of host G2 points (on the curve) in one
        launch; the callable gives an (N,) bool array, ∞ rows True."""
        if not points:
            return lambda: np.zeros((0,), bool)
        sx, sy, inf = g2_affine_words_many(points)
        out = C.g2_subgroup_check(self._up(sx), self._up(sy), self._up(inf))
        return lambda: out.cpu().numpy()

    # -- signing -------------------------------------------------------------

    def batch_sign(
        self,
        messages: Sequence[bytes],
        secret_keys: Sequence["A.SecretKey"],
        dst: bytes = constants.DST_SIGNATURE,
    ) -> "list[A.Signature]":
        """N signatures [skᵢ]·H(mᵢ) on the card (grandine_tpu/tpu/bls.py
        TpuBlsBackend.batch_sign :2986): H(mᵢ) from the hash-to-G2 cache,
        the scalars GLV-decomposed on the host (`sign_scalars_host`), one
        `batch_sign` launch, the Jacobian results read back into affine
        `Signature`s with one batched inversion. Byte for byte the host
        `SecretKey.sign`; batches past MAX_BUCKET run in chunks."""
        n = len(messages)
        assert n == len(secret_keys)
        if n == 0:
            return []
        if n > MAX_BUCKET:
            return [sig for i in range(0, n, MAX_BUCKET)
                    for sig in self.batch_sign(messages[i : i + MAX_BUCKET],
                                               secret_keys[i : i + MAX_BUCKET],
                                               dst)]
        msg, msg_inf = self._messages(messages, dst)
        k, neg = sign_scalars_host([sk.scalar for sk in secret_keys])
        words = batch_sign(msg, msg_inf, self._up(k), self._up(neg))
        return [A.Signature(pt)
                for pt in g2_points_from_words(words.cpu().numpy())]

    # -- fault localization ----------------------------------------------

    def rlc_partition_verify(self, messages, signatures, member_keys,
                             groups: int, dst: bytes = constants.DST_SIGNATURE,
                             rng=secrets) -> np.ndarray:
        return self.rlc_partition_verify_async(
            messages, signatures, member_keys, groups, dst, rng)()

    def rlc_partition_verify_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        member_keys: Sequence[Sequence["A.PublicKey"]],
        groups: int,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """Per-group verdicts of one RLC pass, the seam the fault localizer
        descends through (grandine_tpu/tpu/bls.py rlc_partition_verify_async
        and rlc_partition_verify_kernel, :2898 and :279), with its
        semantics: `groups` rounds up to a power of two of at least 4,
        clamped to the batch's bucket B; slot i is item i, group j the
        slots j·B/G … (j+1)·B/G − 1. Each item's member keys are summed
        on the host to one key. An item with no keys or an identity key
        is named bad on the host, stays out of the device pass (padding)
        and makes its group False; a group with no live item is True; each
        group's verdict is ANDed with its members' G2 subgroup flags (the
        fused ψ check, `signature_plane`). One flat pass on the card:
        `multi_rlc_scale` and `miller_loop_pairs` over the live items,
        `rlc_finish` with one group per partition group. RLC pairs are
        drawn for every item, in order, after the hashing. Returns a settle
        callable giving a (G,) bool array (an empty or mismatched batch:
        size 0)."""
        n = len(messages)
        g = _bucket(groups, lo=4)
        if not (n and n == len(signatures) == len(member_keys)):
            return lambda: np.zeros((0,), bool)
        b = _bucket(n)
        g = min(g, b)
        span = b // g
        bad_host = np.zeros((n,), bool)
        slots, agg = [], []
        for i, ks in enumerate(member_keys):
            if not ks or any(pk.point.is_infinity() for pk in ks):
                bad_host[i] = True
                continue
            slots.append(i)
            agg.append(ks[0] if len(ks) == 1 else A.PublicKey.aggregate(ks))
        pk_inf = np.array([k.point.is_infinity() for k in agg], bool)
        msg, msg_inf = self._messages([messages[i] for i in slots], dst)
        pairs = [self._rlc_pair(rng) for _ in range(n)]
        verdict = None
        if slots:
            # an ∞ aggregate's pair is masked: its row only feeds the ladder
            src_x, src_y = self._keys_src([
                G1 if inf else k.point for k, inf in zip(agg, pk_inf)])
            sx, sy, sinf = g2_affine_words_many(
                [signatures[i].point for i in slots])
            plane = signature_plane(self._up(sx), self._up(sy),
                                    self._up(sinf))
            counts = np.bincount(np.array(slots) // span, minlength=g)
            verdict = verify_sets(
                src_x, src_y, self._up(np.arange(len(slots), dtype=np.int32)),
                plane, msg, msg_inf | self._up(pk_inf),
                self._up(rlc_pairs_words([pairs[i] for i in slots])),
                np.concatenate([[0], np.cumsum(counts)]))

        def settle() -> np.ndarray:
            out = (np.ones((g,), bool) if verdict is None
                   else verdict.cpu().numpy().astype(bool))
            out[np.nonzero(bad_host)[0] // span] = False
            return out

        return settle

    # -- fast-aggregate seams --------------------------------------------------

    def fast_aggregate_verify_batch(self, messages, signatures, member_keys,
                                    dst: bytes = constants.DST_SIGNATURE,
                                    rng=secrets) -> bool:
        return self.fast_aggregate_verify_batch_async(
            messages, signatures, member_keys, dst, rng)()

    def fast_aggregate_verify_batch_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        member_keys: Sequence[Sequence["A.PublicKey"]],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as `Signature`s, their member keys as PublicKeys
        (uploaded as the gather source)."""
        return self._aggregate_async(messages, signatures, member_keys, None,
                                     dst, rng, compressed=False)

    def fast_aggregate_verify_batch_indexed(
        self, messages, signatures, member_indices, registry,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_indexed_async(
            messages, signatures, member_indices, registry, dst, rng)()

    def fast_aggregate_verify_batch_indexed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        member_indices: Sequence[Sequence[int]],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as `Signature`s whose member keys are rows of the
        device-resident registry (gpu/registry.py), gathered on the card."""
        return self._aggregate_async(messages, signatures, member_indices,
                                     registry, dst, rng, compressed=False)

    def fast_aggregate_verify_batch_compressed(
        self, messages, signatures, member_keys,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_compressed_async(
            messages, signatures, member_keys, dst, rng)()

    def fast_aggregate_verify_batch_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        member_keys: Sequence[Sequence["A.PublicKey"]],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as wire bytes with their member keys given as
        PublicKeys."""
        return self._aggregate_async(messages, signatures, member_keys, None,
                                     dst, rng, compressed=True)

    def fast_aggregate_verify_batch_indexed_compressed(
        self, messages, signatures, member_indices, registry,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_indexed_compressed_async(
            messages, signatures, member_indices, registry, dst, rng)()

    def fast_aggregate_verify_batch_indexed_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        member_indices: Sequence[Sequence[int]],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as wire bytes whose member keys are registry rows
        gathered on the card by index."""
        return self._aggregate_async(messages, signatures, member_indices,
                                     registry, dst, rng, compressed=True)


__all__ = [
    "TorchBlsBackend", "MAX_BUCKET", "resolve_device", "aggregate_rlc_scale",
    "aggregate_rlc_scale_plain", "multi_rlc_scale", "multi_rlc_scale_plain",
    "g1_group_sum", "g1_group_sum_plain", "rlc_finish", "rlc_finish_plain",
    "rlc_sig_miller_plain", "finish_threads", "finish_groups",
    "rlc_finish_geometry", "PER_THREAD_SPAN", "rlc_partial",
    "rlc_partial_plain", "partial_flags", "make_sharded_multi_verify",
    "sharded_multi_verify", "make_sharded_multi_verify_msm",
    "sharded_multi_verify_msm",
    "signature_plane", "signature_plane_compressed", "verify_aggregates",
    "verify_sets", "verify_grouped", "grouped_route", "message_groups",
    "g1_decompress_rows", "rlc_pairs_words", "rlc_bits_host",
    "g2_affine_words", "g2_affine_words_many", "g1_affine_words",
    "SIGN_HALF_BITS", "sign_scalars_host", "batch_sign", "batch_sign_plain",
    "g2_group_sum", "g2_group_sum_plain", "g2_aggregate_groups",
    "g1_aggregate_groups", "g2_points_from_words", "g1_points_from_words",
    "jacobian_rows", "launch_geometry", "batch_pubkey", "batch_pubkey_plain",
    "g1_normalize", "g1_normalize_plain", "g2_normalize",
    "g2_normalize_plain", "unpack_words", "unpack_words_plain",
    "multi_verify_kernel", "grouped_multi_verify_kernel",
    "aggregate_fast_verify_kernel", "grouped_multi_verify_msm_packed_kernel",
]
