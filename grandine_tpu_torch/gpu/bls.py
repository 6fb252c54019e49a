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
  unaggregated attestations): the Pippenger bucket MSM (gpu/msm.py, over
  plans the host builds from the RLC pairs) for Σᵢ∈ⱼ rᵢ·pkᵢ per message
  and for Σᵢ rᵢ·sigᵢ, M Miller loops, rlc_finish over M message terms and
  one signature term — replacing grouped_multi_verify_msm;

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
`batch_sign` (this module: [skᵢ]·H(mᵢ) from the secret's base-|x| digits,
one branchless 64-step ladder a lane over (−ψ)ⁱ(H), one, two or four
lanes a signature) — replacing batch_sign_kernel. Aggregate construction
(`g2_aggregate_groups`, `g1_aggregate_groups`): `g2_group_sum` /
`g1_group_sum` over groups padded with ∞ — replacing g2_aggregate_kernel
and g1_aggregate_kernel.

The JAX package's reference-only programs (no runtime caller there;
`__graft_entry__.entry` runs the flagship one) have their counterparts here
on the same kernels: `multi_verify_kernel`, `grouped_multi_verify_kernel`,
`aggregate_fast_verify_kernel`, `grouped_multi_verify_msm_kernel` and
`grouped_multi_verify_msm_packed_kernel` (both on the reference's MSM
plans; `unpack_words` for the packed signature plane), beside
`batch_pubkey` (the G1 twin of `batch_sign`) and `g1_normalize` /
`g2_normalize` (Jacobian → affine on the card).

Host prep per batch: the row pack of the wire bytes or the affine
conversion of the signature points, hash-to-G2 of each distinct message
(LRU-cached), the RLC pairs and the index plane — no field arithmetic on
the card's behalf.
"""

from __future__ import annotations

import ctypes
import json
import os
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

#: bits of each GLV half of a secret scalar (`batch_pubkey`): Babai
#: rounding keeps |k0|, |k1| ≤ λ ≈ 2¹²⁷·⁴, and the ladder's mixed additions
#: never meet a degenerate case only while both stay below 2¹²⁸
#: (grandine_tpu/tpu/curve.py:604-609)
SIGN_HALF_BITS = 128
#: lanes a key of a `batch_pubkey` launch (csrc/sign.cu PUBKEY_LANES): the
#: fastest at the full bucket of 16,384 keys, the one shape the port
#: launches at (ladder_timing.py, H100 80GB HBM3 at 700 W: 2 / 4 / 8 lanes
#: 1.045 / 1.294 / 1.908 ms)
PUBKEY_LANES = 2

#: |x|, the BLS parameter's magnitude: −ψ acts on G2 as [|x|], and a secret
#: below r < |x|⁴ has four base-|x| digits (`sign_digits_host`)
ABS_X = -constants.X
#: bits of each base-|x| digit: the ladder steps of one `batch_sign` lane
SIGN_DIGIT_BITS = 64
#: `sign_lanes`: the most threads a `batch_sign` launch takes, about one
#: warp for each of the H100's 528 warp schedulers (4 × 132 SMs). Up to it
#: more lanes only shorten each signature's chain; past it the warps share
#: a scheduler's issue slots and the lanes' duplicated doublings cost time
#: (ladder_timing.py, H100 80GB HBM3 at 700 W: 4 / 2 / 1 lanes 8.53 / 13.27
#: / 21.01 ms at 512 rows, 9.53 / 13.34 / 20.92 at 4,096, 15.67 / 14.66 /
#: 20.99 at 8,192, 29.67 / 26.71 / 23.81 at 16,384)
SIGN_LANE_THREADS = 1 << 14

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
    """Plain version of `aggregate_rlc_scale`, in the kernel's steps: gather
    members src[idx[m, :cnt[m]]], sum them (strided over the block's
    threads, then the tree), rᵢ·apkᵢ and rᵢ·sigᵢ with rᵢ = r01[m, 0] +
    r01[m, 1]·λ, each as its two halves' ladders apart joined by one
    complete addition (G1: complete additions, `C.scalar_mul_jac_glv`;
    G2: mixed additions, `C.scalar_mul_glv_split`)."""
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
    rsig = C.scalar_mul_glv_split(L.from_words(sig_x), L.from_words(sig_y),
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
    in a strided loop and a shared-memory tree (G1 on `fpc`, the Fp
    product as a call), then each ladder splits by its GLV halves r0, r1:
    warp 0's lanes 0 and 1 run the G1 halves, [r0]apk and [r1]φ(apk), and
    meet in a shuffle and one complete addition; warps 2 and 3 run the G2
    halves, [r0]sig and [r1]ψ'(sig), as warp programs (each doubling and
    mixed addition a few rounds of Fp products across the warp's lanes),
    and warp 2 joins them (csrc/aggregate.cu). Bound: operations — one
    complete G1 addition a member (16 Fp products), the tree, and the
    ladders' least work (~4,800 Fp products an aggregate of 130) against
    100 bytes a member (index and gathered row); the kernel is
    latency-bound on its G1 lanes' chains (32 doublings and ~16 complete
    additions each) and its G2 halves' chains of warp programs, which run
    at once."""
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

#: `multi_g2_lanes`: the most sets whose G2 halves run as warp programs
#: (two warps a set); past it, one thread a half (two lanes a set). Warp
#: programs take ~1.2 ms up to a wave of blocks and grow past it, one
#: thread a half takes ~3.6 ms at every width (ladder_timing.py, H100 80GB
#: HBM3 at 700 W, device ms: 1.939 / 3.580 at 512 sets, 2.520 / 3.590 at
#: 768, 3.597–3.626 / 3.591–3.632 at 1,048, 4.563–4.678 / 3.581–3.597 at
#: 1,562). The forms tie at the window's 1,048 sets (within the runs'
#: spread); the threshold sits just below the tie because past it the
#: warp form's time grows with each wave of blocks and the lane form's
#: stays flat.
MULTI_G2_WARP_SETS = 1024


def multi_g2_lanes(n: int) -> bool:
    """The G2 form of a `multi_rlc_scale` launch over n sets: False for
    warp programs (two warps a set), True for one thread a half (two
    lanes a set). Both give the same words."""
    return n > MULTI_G2_WARP_SETS


def multi_rlc_scale_plain(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """Plain version of `multi_rlc_scale`, in the kernel's steps: rᵢ·pkᵢ
    (pkᵢ = src[idx[i]], Z = 1) and rᵢ·sigᵢ, each as its two GLV halves'
    ladders apart joined by one complete addition — G1 by complete
    additions (`C.scalar_mul_jac_glv`, the G1 lanes of
    `aggregate_rlc_scale_plain`), G2 by mixed additions
    (`C.scalar_mul_glv_split`)."""
    n = idx.shape[0]
    dev = idx.device
    rows = idx.long()
    r = r01.to(torch.int64) & 0xFFFFFFFF
    pk = (L.from_words(src_x[rows]), L.from_words(src_y[rows]),
          L.one_fp((n,), dev))
    rpk = C.scalar_mul_jac_glv(pk, torch.zeros((n,), dtype=torch.bool,
                                               device=dev),
                               r[:, 0], r[:, 1], C.g1_endo(dev), C.FP_OPS)
    rsig = C.scalar_mul_glv_split(L.from_words(sig_x), L.from_words(sig_y),
                                  sig_mask, r[:, 0], r[:, 1], C.g2_endo(dev),
                                  C.FP2_OPS)
    return C.jac_to_words(rpk, 1), C.jac_to_words(rsig, 2)


def multi_rlc_scale(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """Per signature set: rᵢ·pkᵢ (G1, from the affine key src[idx[i]]) and
    rᵢ·sigᵢ (G2), rᵢ = r01[i, 0] + r01[i, 1]·λ. src_x/src_y (rows, 12)
    affine canonical words (the registry, or a keyed batch's uploaded
    keys, none ∞); idx (N,) int32; sig_x/sig_y (N, 2, 12) affine with
    sig_mask (N,) (∞ or rejected rows: ∞ out); r01 (N, 2) the 32-bit RLC
    halves. Returns rpk (N, 3, 12) and rsig (N, 3, 2, 12) Jacobian, the
    layouts `miller_loop_pairs` and `rlc_finish` take. CUDA kernel
    `multi_rlc_scale` (csrc/multi.cu) on CUDA tensors, the plain version
    on CPU tensors.

    Replaces, in the JAX programs multi_verify_msm{,_idx,_comp}
    (grandine_tpu/tpu/bls.py:592, :610, :790), the registry gather
    (:629-632), the per-signature G1 scalar_mul_glv and the G2 scalar
    plane of `_flat_msm_verify_tail` (:556-589). Each ladder splits by
    its GLV halves, as `aggregate_rlc_scale`'s do (csrc/glv_halves.cuh):
    [r0]pk and [r1]φ(pk) on two `fpc` lanes (64 sets a 128-thread block)
    joined by a shuffle and one complete addition; [r0]sig and [r1]ψ'(sig)
    as G2DBL/G2MADD warp programs on two warps (2 sets a block) joined by
    G2ADD with point_add_complete's cases — or, past MULTI_G2_WARP_SETS
    sets (`multi_g2_lanes`), where two warps a set no longer fit one wave,
    one thread a half on fp2 (64 sets a block); one kernel instance a
    form. The G2 blocks come first in the grid, the G1 blocks after, so no
    warp runs both. Bound: operations — 32 doublings and ~32 mixed
    additions on each group (~2,300 Fp products a set) against ~640 bytes
    a set; each half is a dependent chain of 32 doublings and ~16
    additions, so the kernel is latency-bound on the G2 halves' chains."""
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
                  ctypes.c_int(int(multi_g2_lanes(n))), sig_x, sig_y,
                  sig_mask, r01, rpk, rsig)
    multi_rlc_scale.launches += 1
    return rpk, rsig


multi_rlc_scale.launches = 0


# --- g1_group_sum, g2_group_sum -------------------------------------------------

#: rows a unit of a group-sum pass adds in order (csrc/multi.cu
#: GROUP_CHUNK, a compile-time constant there)
GROUP_CHUNK = 2
#: units of a lane-form tile: the lanes of a warp
GROUP_LANES = 32
#: warps a tile of g2_group_sum, G2ADD warp programs one warp a unit
#: (csrc/multi.cu G2_GROUP_WARPS, a compile-time constant there)
G2_GROUP_WARPS = 8


def group_sum_plan(offsets, tile: int):
    """The passes of a group sum over groups [offsets[m], offsets[m+1]),
    from the offsets alone: each pass an (T, 2) int32 array of tiles
    (start, count) over its input rows, a tile covering at most tile ·
    chunk of one group's rows and giving one output row; each group's
    tiles in order, so the next pass's groups are the tile counts. The
    last pass has one tile a group (an empty group: one tile of count 0,
    giving ∞). Within a tile (csrc/multi.cu gs_lanes_tile /
    gs_warps_tile), unit u adds rows u·chunk … in order and the
    ⌈count / chunk⌉ live partials fold pairwise (position t + s into t
    for s = pow2ceil(k)/2 … 1, t + s < k), chunk = GROUP_CHUNK."""
    off = np.asarray(offsets, np.int64)
    per = tile * GROUP_CHUNK
    passes = []
    while True:
        counts = np.diff(off)
        n_t = np.maximum(1, -(-counts // per))
        j = np.arange(int(n_t.sum())) - np.repeat(np.cumsum(n_t) - n_t, n_t)
        start = np.repeat(off[:-1], n_t) + j * per
        count = np.clip(np.repeat(counts, n_t) - j * per, 0, per)
        passes.append(np.stack([start, count], 1).astype(np.int32))
        if (n_t == 1).all():
            return passes
        off = np.concatenate([[0], np.cumsum(n_t)])


def group_sum_passes_plain(points, plan, ops, tile: int):
    """The passes of `group_sum_plan` on (N,) Jacobian points, step for
    step as the kernel adds: each tile's units from ∞ over their rows, then
    the fold over the live partials only (an addition skipped, not made
    with ∞, so a partial's words stay as they are), each tile's total
    with Z = 0 written as (1, 1, 0). Returns the last pass's rows, one a
    group."""
    chunk = GROUP_CHUNK
    dev = points[0].device
    pos = torch.arange(tile * chunk, device=dev).view(tile, chunk)
    for tiles in plan:
        t = torch.from_numpy(tiles.astype(np.int64)).to(dev)
        n_t = t.shape[0]
        if points[0].shape[0] == 0:  # every tile empty: give the gather a row
            one = ops.one((1,), dev)
            points = (one, one, torch.zeros_like(one))
        live = pos < t[:, 1].view(n_t, 1, 1)
        idx = torch.where(live, t[:, 0].view(n_t, 1, 1) + pos, 0)
        one = ops.one((n_t, tile), dev)
        acc = (one, one, torch.zeros_like(one))
        for c in range(chunk):
            q = tuple(p[idx[:, :, c]] for p in points)
            acc = C._sel3(live[:, :, c], C.point_add_complete(acc, q, ops),
                          acc)
        k = (t[:, 1] + chunk - 1) // chunk
        s = tile // 2
        while s:
            lo = tuple(a[:, :s] for a in acc)
            hi = tuple(a[:, s:2 * s] for a in acc)
            fold = (torch.arange(s, device=dev) + s) < k.view(n_t, 1)
            lo = C._sel3(fold, C.point_add_complete(lo, hi, ops), lo)
            acc = tuple(torch.cat([x, a[:, s:]], 1) for x, a in zip(lo, acc))
            s //= 2
        points = tuple(a[:, 0] for a in acc)
        points = C._mask_inf(points, ops.is_zero(points[2]), ops)
    return points


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


def group_tile(k: int) -> int:
    """Units a tile of the group-sum plan of G1 (k = 1) or G2 (k = 2)."""
    return G2_GROUP_WARPS if k == 2 else GROUP_LANES


def _group_sum_plain(rows, offsets, k: int, what: str):
    off = _offsets(offsets, rows.shape[0], what)
    tile = group_tile(k)
    total = group_sum_passes_plain(C.jac_from_words(rows, k),
                                   group_sum_plan(off, tile),
                                   C.FP_OPS if k == 1 else C.FP2_OPS, tile)
    return C.jac_to_words(total, k)


def g1_group_sum_plain(rows, offsets):
    """Plain version of `g1_group_sum`: the passes of the kernel's plan
    (`group_sum_plan`, 32 units a tile) in its order."""
    return _group_sum_plain(rows, offsets, 1, "g1_group_sum")


def g1_group_sum(rows, offsets):
    """Σ of the Jacobian G1 rows (N, 3, 12) of each group [offsets[m],
    offsets[m+1]) — offsets, M + 1 host ints, are the only way groups are
    given — as (M, 3, 12) Jacobian words, ∞ as (1, 1, 0) (an empty group,
    a sum at ∞); a row with Z = 0 is ∞. CUDA kernel `g1_group_sum` (csrc/multi.cu, the G1 instance
    of `group_sum<F>`, on `fpc`) on CUDA tensors, the plain version on CPU
    tensors.

    Replaces, in grandine_tpu/tpu/bls.py grouped_multi_verify_kernel
    (:322), the per-message sum of the rᵢ·pkᵢ that `multi_rlc_scale`
    computes per set (curve.py sum_points_grouped); in
    make_sharded_multi_verify_msm (:1258) the reduce of the shards' group
    sums (reduce_over_devices, :1286-1305); and g1_aggregate_kernel
    (:1010, curve.py sum_points_contiguous) behind `g1_aggregate_groups`.
    A plan from the offsets alone (`group_sum_plan`): one lane a unit of
    GROUP_CHUNK rows, a warp a tile of 32 units folded by shuffles over
    its live partials only, passes until each group is one tile — 4,096
    rows take 1 + 5 + 1 + 5 dependent additions in two passes, 8 rows 1 +
    2 in one. Bound: operations — one complete G1 addition (16 Fp
    products) a row against 144 bytes a row; the kernel is latency-bound
    on a group's chain of ~log₂(rows) additions."""
    if rows.device.type == "cpu":
        return g1_group_sum_plain(rows, offsets)
    out = _group_sum_cuda(1, rows, offsets)
    g1_group_sum.launches += 1
    return out


g1_group_sum.launches = 0


def g2_group_sum_plain(rows, offsets):
    """Plain version of `g2_group_sum`: the passes of the kernel's plan
    (`group_sum_plan` at `group_tile(2)` units a tile) in its order."""
    return _group_sum_plain(rows, offsets, 2, "g2_group_sum")


def g2_group_sum(rows, offsets):
    """Σ of the Jacobian G2 rows (N, 3, 2, 12) of each group [offsets[m],
    offsets[m+1]) as (M, 3, 2, 12) Jacobian words, ∞ as (1, 1, 0) (an
    empty group, a sum at ∞); a row with Z = 0 is ∞. CUDA kernel `g2_group_sum` (csrc/multi.cu) on
    CUDA tensors, the plain version on CPU tensors.

    Replaces grandine_tpu/tpu/bls.py g2_aggregate_kernel (:980, curve.py
    sum_points_contiguous :374) behind `g2_aggregate_groups`: aggregate
    construction, every committee of a slot in one launch; and, on the
    sharded flat route, each shard's signature sum. The plan of
    `g1_group_sum` with a warp a unit: each complete addition a G2ADD
    warp program (44 Fp products in 5 rounds across the lanes, with
    point_add_complete's cases), G2_GROUP_WARPS units a block folded
    through shared memory. Bound: operations — one complete G2 addition
    (48 Fp products) a row against 288 bytes a row; latency-bound on a
    group's chain of ~log₂(rows) warp-program additions."""
    if rows.device.type == "cpu":
        return g2_group_sum_plain(rows, offsets)
    out = _group_sum_cuda(2, rows, offsets)
    g2_group_sum.launches += 1
    return out


g2_group_sum.launches = 0


def _group_sum_cuda(k, rows, offsets):
    """The plan's passes on the card: the plan built from the offsets,
    every pass's tiles copied in one table, then one launch a pass on the
    current stream."""
    from grandine_tpu_torch.gpu import _build

    name = "g1_group_sum" if k == 1 else "g2_group_sum"
    shape = (3, 12) if k == 1 else (3, 2, 12)
    n = rows.shape[0]
    if rows.shape[1:] != shape or rows.dtype != torch.int32:
        raise ValueError(f"{name}: rows (N, {', '.join(map(str, shape))})"
                         " int32")
    off = _offsets(offsets, n, name)
    plan = group_sum_plan(off, group_tile(k))
    tiles = _offsets_to(np.concatenate(plan).reshape(-1), rows.device)
    src, at = rows.contiguous(), 0
    for t in (p.shape[0] for p in plan):
        out = torch.empty((t, *shape), dtype=torch.int32, device=rows.device)
        _build.launch(name, src, tiles[2 * at: 2 * (at + t)], ctypes.c_int(t),
                      out)
        src, at = out, at + t
    return src


def launch_geometry(name: str, n: int):
    """(blocks, threads a block, shared memory bytes, blocks one SM holds
    at once) of the launch that "batch_sign" (at `sign_lanes(n)` lanes a
    row), "g1_scalar_mul" or "multi_rlc_scale" makes over n rows, or of a
    "g1_group_sum" / "g2_group_sum" pass over n tiles, on the current CUDA
    device. A query: it launches nothing."""
    from grandine_tpu_torch.gpu import _build

    geometry = np.zeros((4,), np.int32)
    out = ctypes.c_void_p(geometry.ctypes.data)
    if name == "batch_sign":
        _build.launch("batch_sign_geometry", ctypes.c_int(n),
                      ctypes.c_int(sign_lanes(n)), out)
    elif name == "g1_scalar_mul":
        _build.launch("g1_scalar_mul_geometry", ctypes.c_int(n), out)
    elif name == "multi_rlc_scale":
        _build.launch("launch_geometry", ctypes.c_int(0), ctypes.c_int(n),
                      ctypes.c_int(int(multi_g2_lanes(n))), out)
    else:
        _build.launch("launch_geometry",
                      ctypes.c_int(1 + (name == "g2_group_sum")),
                      ctypes.c_int(n), ctypes.c_int(0), out)
    return tuple(int(v) for v in geometry)


# --- batch_sign -----------------------------------------------------------------


def sign_lanes(n: int) -> int:
    """Lanes a signature of a `batch_sign` launch over n rows: the most of
    4, 2 and 1 that keeps n · lanes within SIGN_LANE_THREADS (4 up to 4,096
    rows, 2 up to 8,192, 1 at a full bucket)."""
    return next((v for v in (4, 2) if n * v <= SIGN_LANE_THREADS), 1)


def batch_sign_plain(msg, msg_inf, d, lanes: "int | None" = None):
    """Plain version of `batch_sign`, in the kernel's steps: the bases
    Bᵢ = (−ψ)ⁱ(H), lane j's joint ladder (gpu/curve.py `ladder`) over
    Bᵢ for i = j·4/lanes … over the digits' 64 bits, then the lanes'
    sums added pairwise as the kernel's shuffle tree adds them."""
    n = msg_inf.shape[0]
    lanes = sign_lanes(n) if lanes is None else lanes
    per = 4 // lanes
    bases = [(L.from_words(msg[:, 0]), L.from_words(msg[:, 1]))]
    for _ in range(3):
        bases.append(C.neg_psi(*bases[-1]))
    w = d.to(torch.int64) & 0xFFFFFFFF
    st = C.ladder(
        [tuple(torch.stack([bases[j * per + i][c] for j in range(lanes)], 1)
               for c in range(2)) for i in range(per)],
        [C._bits_msb(w[:, i::per], SIGN_DIGIT_BITS) for i in range(per)],
        C.FP2_OPS)
    parts = [tuple(c[:, j] for c in st) for j in range(lanes)]
    while len(parts) > 1:
        parts = [C.point_add_complete(parts[i], parts[i + 1], C.FP2_OPS)
                 for i in range(0, len(parts), 2)]
    return C.jac_to_words(C._mask_inf(parts[0], msg_inf, C.FP2_OPS), 2)


def batch_sign(msg, msg_inf, d, lanes: "int | None" = None):
    """N signatures [skᵢ]·H(mᵢ): msg (N, 2, 2, 12) the affine canonical
    words [x, y] of H(mᵢ) with msg_inf (N,) (an ∞ row gives ∞ whatever
    its digits); d (N, 4, 2) int32 the base-|x| digits of skᵢ as
    little-endian 32-bit words, each below |x| (`sign_digits_host`);
    `lanes` 1, 2 or 4 lanes a signature (`sign_lanes(N)` by default).
    Returns (N, 3, 2, 12) Jacobian words. CUDA kernel `batch_sign`
    (csrc/sign.cu) on CUDA tensors, the plain version on CPU tensors.

    Replaces grandine_tpu/tpu/bls.py batch_sign_kernel (:896) with
    curve.py scalar_mul_glv (:591) on FP2_OPS, by another decomposition of
    the same product: ψ acts on G2 as [x], so with sk = Σ dᵢ|x|ⁱ (four
    digits below |x| < 2⁶⁴) [sk]H = Σ [dᵢ]Bᵢ, Bᵢ = (−ψ)ⁱ(H). One warp a
    block, `lanes` lanes a signature: each lane runs exactly 64 steps of
    one doubling and a mixed addition a base (4 / lanes bases), the digit
    bits and the "started" state choosing by mask selects; the lanes' sums
    meet in a shuffle tree of complete additions that select by masks too
    — no branch and no loop bound depends on a digit. Bound: operations —
    at the function's least work 64 doublings and Σ popcount(dᵢ) − 1 mixed
    additions in Fp2 (~5,500 Fp products a row; the branchless lanes
    compute 64 · lanes doublings and 256 additions) against 513 bytes a
    row. A lane batch of 512 rows (64 one-warp blocks at four lanes) is
    latency-bound on one lane's 64 steps (before: one thread's 128 steps
    with two additions each); a full bucket (16,384 rows, one lane: 512
    blocks, about a warp a scheduler) is bound by the schedulers' issue
    rate, so it takes the fewest duplicated doublings (`sign_lanes`).

    NOTE (as the JAX kernel says): secret scalars live on the card; the
    kernel is branchless on the secret (fixed trip count, select-based)
    but NOT hardened against physical side channels — the field
    arithmetic's conditional reductions still depend on the data."""
    n = msg_inf.shape[0]
    if (msg.shape != (n, 2, 2, 12) or d.shape != (n, 4, 2)
            or d.dtype != torch.int32):
        raise ValueError("batch_sign: msg (N, 2, 2, 12), msg_inf (N,), "
                         "d (N, 4, 2) int32")
    lanes = sign_lanes(n) if lanes is None else lanes
    if lanes not in (1, 2, 4):
        raise ValueError(f"batch_sign: 1, 2 or 4 lanes a row, not {lanes}")
    if msg.device.type == "cpu":
        return batch_sign_plain(msg, msg_inf, d, lanes)
    from grandine_tpu_torch.gpu import _build

    out = torch.empty((n, 3, 2, 12), dtype=torch.int32, device=msg.device)
    _build.launch("batch_sign", msg.contiguous(), msg_inf.contiguous(),
                  d.contiguous(), ctypes.c_int(n), ctypes.c_int(lanes), out)
    batch_sign.launches += 1
    return out


batch_sign.launches = 0


# --- batch_pubkey -------------------------------------------------------------


def batch_pubkey_plain(k, neg):
    """Plain version of `batch_pubkey`, in the kernel's steps: the comb
    table (gpu/_build.py `comb_table`), lane l of PUBKEY_LANES adding its
    windows of half l // (PUBKEY_LANES / 2) in ascending order by mixed
    additions under the "started" mask, the lanes in turn as one batch
    axis, then the lanes' sums added pairwise as the kernel's shuffle tree
    adds them."""
    from grandine_tpu_torch.gpu import _build

    n, dev = k.shape[0], k.device
    lanes = PUBKEY_LANES
    hl = lanes // 2
    per = _build.COMB_SHAPE[1] // hl
    lane = torch.arange(lanes, device=dev)
    h, j0 = lane // hl, per * (lane % hl)
    table = L.words_to_limbs(_build.comb_table(dev))  # Montgomery already
    kh = (k.to(torch.int64) & 0xFFFFFFFF)[:, h]  # (n, lanes, 4)
    sign = neg[:, h]
    one = L.one_fp((n, lanes), dev)
    st = (one, one, torch.zeros_like(one))
    started = torch.zeros((n, lanes), dtype=torch.bool, device=dev)
    for s in range(per):
        j = j0 + s
        d = (kh[:, lane, j >> 3] >> (4 * (j & 7))) & 15  # (n, lanes)
        ent = table[h, j][lane, (d - 1).clamp(min=0)]  # (n, lanes, 2, 24)
        qx, qy = ent[..., 0, :], ent[..., 1, :]
        qy = L.select(sign, L.neg_mod(qy), qy)
        bit = d != 0
        added = C.point_madd_unsafe(st, qx, qy, C.FP_OPS)
        st = C._sel3(bit, C._sel3(started, added, (qx, qy, one)), st)
        started = started | bit
    parts = [tuple(c[:, i] for c in st) for i in range(lanes)]
    while len(parts) > 1:
        parts = [C.point_add_complete(parts[i], parts[i + 1], C.FP_OPS)
                 for i in range(0, len(parts), 2)]
    return C.jac_to_words(parts[0], 1)


def batch_pubkey_glv_plain(k, neg):
    """The same points as `batch_pubkey` by another computation, kept as
    a test oracle: the 128-bit dual GLV ladder from the generator with the
    sign masks (gpu/curve.py scalar_mul_glv, the JAX kernel's steps)."""
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

    Replaces grandine_tpu/tpu/bls.py batch_pubkey_kernel (:961), the dual
    GLV ladder curve.py scalar_mul_glv on FP_OPS, by a fixed-base comb of
    the same product: each half is 32 windows of 4 bits, and the table
    (gpu/_build.py `comb_table`, built once a device) holds [d·16ʲ·λʰ]g1
    for every half h, window j and digit d, so the key is a sum of 64
    table entries with no doubling. One warp a block, PUBKEY_LANES (2)
    lanes a key: each lane adds the 32 windows of one half by mixed
    additions on `fpc`, reading all 15 entries of a window and choosing
    by masks (no branch, loop bound or address depends on a digit), then
    the lanes' sums meet in a shuffle tree of complete additions that
    select by masks too. Bound: operations — at the function's least work
    (nonzero digits − 1) mixed additions (11 Fp products) and the output
    conversion, ~690 Fp products a key, against 178 bytes a key; a full
    bucket (16,384 keys, 1,024 one-warp blocks, ~7.8 warps an SM) is
    bound by the schedulers' issue rate, so it takes two lanes, the
    fewest join levels.

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
                  ctypes.c_int(n), out, _build.comb_table(k.device))
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


def finish_threads(spans) -> int:
    """Threads a block `rlc_finish` gives each live group of one launch,
    from the groups' spans (terms of the more numerous kind): one warp up
    to a span of 32, else ⌈widest/32⌉ warps, at most one 128-thread block.
    Warp 0 of the block runs the group's tail whatever the span."""
    widest = max(spans, default=0)
    return min(msm.TREE, 32 * max(1, -(-widest // 32)))


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


def partial_groups(f, sig_ok, f_off=None, s_off=None):
    """(f_off, s_off) of an `rlc_partial` call, checked."""
    fo, so, _, _ = finish_groups(f, sig_ok, f_off, s_off)
    return fo, so


def finish_widths(fo, so, live):
    """(widest f span, widest signature span) over the live groups: with
    the thread count they size an `rlc_finish` block's shared memory."""
    if live.size == 0:
        return 0, 0
    return (int(np.diff(fo)[live].max()), int(np.diff(so)[live].max()))


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
    group's product and sum in a strided tree at the launch's thread
    count (no wider than the widest group: a group's verdict does not
    depend on the order), the groups batched; dead groups 1."""
    fo, so, live, threads = finish_groups(f, rsig, f_off, s_off)
    nf_max, ns_max = finish_widths(fo, so, live)
    out = torch.ones((fo.size - 1,), dtype=torch.uint8, device=f.device)
    if live.size == 0:
        return out
    # dead groups hold no terms, so the live ones tile the same ranges
    lf = np.append(fo[live], fo[-1])
    ls = np.append(so[live], so[-1])
    terms = L.from_words(f)
    if f.shape[0] == 0:  # signature terms only: give the gather a row
        terms = F.fp12_one((1,), f.device)
    prod = TP.fp12_product_tree_grouped(terms, lf,
                                        max(1, min(threads, nf_max)))
    one = F.fp12_is_one(TP.final_exponentiation(F.fp12_mul(
        prod, rlc_sig_miller_plain(rsig, ls, max(1, min(threads, ns_max))))))
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
    and an ∞ sum, written here without work), one block each: threads
    follow the span (`finish_threads`), a warp up to 32 terms, at most
    four. The block's threads sum their signature terms and multiply their
    f terms in strided loops (one thread a term), the sums and products
    fold in trees (a thread an operation on the wide levels, a warp an
    operation on the upper ones); then warp 0 runs the tail — the Miller
    loop of (−g1, Σ), the product, the final exponentiation — as warp
    programs (gpu/finish_programs.py, csrc/finish_tail.cuh): rounds of at
    most 32 independent Fp products, one a lane, over Fp12 values in
    shared memory, with the 36-product square and the 42-product sparse
    line product in the loop, the 18-product cyclotomic square in the
    hard part and a binary extended Euclid for the one Fp inversion.
    Bound: operations — ~66 Fp products a term plus ~16,100 a live group
    for its Miller loop (8,492) and final exponentiation (7,652) at their
    least work (chip_smoke.py `OpModel.finish`). The tail's dependent
    depth is 738 rounds of one Fp product a lane and 394 output stages
    (`finish_programs.tail_depth`) plus one Euclid inversion on one lane,
    where the one-thread tail chained ~30,500 Fp products; a group is
    latency-bound on those stages, and a launch on its groups' waves
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
    nf_max, ns_max = finish_widths(fo, so, live)
    dev = f.device
    verdict = torch.ones((fo.size - 1,), dtype=torch.uint8, device=dev)
    if live.size:
        table = _offsets_to(np.concatenate([fo, so, live]), dev)
        g1 = fo.size
        _build.launch("rlc_finish", f.contiguous(), rsig.contiguous(),
                      agg_inf.contiguous(), sig_ok.contiguous(),
                      sig_sub.contiguous(), table[:g1], table[g1:2 * g1],
                      table[2 * g1:], ctypes.c_int(live.size),
                      ctypes.c_int(threads), ctypes.c_int(nf_max),
                      ctypes.c_int(ns_max), verdict)
        rlc_finish.launches += 1
    return verdict


rlc_finish.launches = 0


def rlc_finish_geometry(f, rsig, f_off=None, s_off=None):
    """(blocks, threads a block, dynamic shared memory bytes, blocks one
    SM holds at once) of the launch `rlc_finish` makes for these operands
    on the current CUDA device; (0, 0, 0, 0) when no group is live. A
    query: it launches nothing."""
    from grandine_tpu_torch.gpu import _build

    fo, so, live, threads = finish_groups(f, rsig, f_off, s_off)
    nf_max, ns_max = finish_widths(fo, so, live)
    geometry = np.zeros((4,), np.int32)
    if live.size:
        _build.launch("rlc_finish_geometry", ctypes.c_int(live.size),
                      ctypes.c_int(threads), ctypes.c_int(nf_max),
                      ctypes.c_int(ns_max),
                      ctypes.c_void_p(geometry.ctypes.data))
    return tuple(int(v) for v in geometry)


# --- rlc_partial -----------------------------------------------------------------

#: warps a tile of `rlc_partial`'s plan, a MUL warp program a product
#: (csrc/pairing.cu PARTIAL_WARPS, a compile-time constant there)
PARTIAL_WARPS = 8


def rlc_partial_plain(f, agg_inf, sig_ok, sig_sub, f_off=None, s_off=None):
    """Plain version of `rlc_partial`: each group's product (one for an
    empty group; an Fp12 product is exact, so the kernel's plan gives the
    same words in its own order) and its flag byte."""
    fo, so = partial_groups(f, sig_ok, f_off, s_off)
    terms = L.from_words(f)
    if f.shape[0] == 0:  # every group empty: give the gather a row
        terms = F.fp12_one((1,), f.device)
    prod = TP.fp12_product_tree_grouped(terms, fo,
                                        max(1, int(np.diff(fo).max())))
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
    .all()` (:1185-1188, :1373-1375). The group sums' plan from the
    offsets (`group_sum_plan` at PARTIAL_WARPS units a tile), one launch
    a pass: a tile is a block of PARTIAL_WARPS warps, each multiplying
    GROUP_CHUNK terms with the MUL warp program of `rlc_finish`'s fold (54
    Fp products in 2 rounds across the lanes), the warps' products folded
    pairwise by the same program; the last pass, one tile a group, also
    reduces the flag byte. A shard's 512 terms take 3 passes and a chain
    of 9 MUL programs, where one 128-thread block a group chained ⌈512 /
    128⌉ + 7 one-thread Fp12 products, each as long as ~9 MUL programs;
    groups of 1–16 terms take one pass. Bound: operations — 54 Fp
    products and one conversion a term, against 577 bytes a term; the
    kernel is latency-bound on its chain of MUL programs and a launch a
    pass. `rlc_partial.launches` counts calls, as the group sums' counts
    do: a call is one launch a pass of its plan (1–3 at the paths'
    shapes), and adds one."""
    if f.device.type == "cpu":
        return rlc_partial_plain(f, agg_inf, sig_ok, sig_sub, f_off, s_off)
    from grandine_tpu_torch.gpu import _build

    m, n = f.shape[0], sig_ok.shape[0]
    if (f.shape[1:] != (2, 3, 2, 12) or agg_inf.shape != (m,)
            or sig_sub.shape != (n,)):
        raise ValueError("rlc_partial: f (M, 2, 3, 2, 12), agg_inf (M,), "
                         "sig_ok and sig_sub (N,)")
    fo, so = partial_groups(f, sig_ok, f_off, s_off)
    g = fo.size - 1
    dev = f.device
    plan = group_sum_plan(fo, PARTIAL_WARPS)
    table = _offsets_to(np.concatenate([fo, so, *(p.reshape(-1)
                                                   for p in plan)]), dev)
    flags = torch.empty((g,), dtype=torch.uint8, device=dev)
    src, at = f.contiguous(), 2 * (g + 1)
    last = (agg_inf.contiguous(), sig_ok.contiguous(), sig_sub.contiguous(),
            table[:g + 1], table[g + 1:at], flags)
    none = (ctypes.c_void_p(None),) * len(last)
    for i, t in enumerate(p.shape[0] for p in plan):
        out = torch.empty((t, 2, 3, 2, 12), dtype=torch.int32, device=dev)
        _build.launch("rlc_partial", src, table[at: at + 2 * t],
                      ctypes.c_int(t), out,
                      *(last if i == len(plan) - 1 else none))
        src, at = out, at + 2 * t
    rlc_partial.launches += 1
    return src, flags


rlc_partial.launches = 0


def rlc_partial_geometry(f_off):
    """(blocks, threads a block, shared memory bytes, blocks one SM holds
    at once) of each pass `rlc_partial` launches over the groups of
    `f_off` (G + 1 host ints), on the current CUDA device. A query: it
    launches nothing."""
    from grandine_tpu_torch.gpu import _build

    out = []
    for tiles in group_sum_plan(np.asarray(f_off, np.int64), PARTIAL_WARPS):
        geometry = np.zeros((4,), np.int32)
        _build.launch("rlc_partial_geometry", ctypes.c_int(tiles.shape[0]),
                      ctypes.c_void_p(geometry.ctypes.data))
        out.append(tuple(int(v) for v in geometry))
    return out


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


def verify_grouped(pk_x, pk_y, plane, msg, msg_inf, g1_plan, g2_plan,
                   pk_live=None):
    """One message-grouped RLC verification of N sets in any row order:
    pk_x, pk_y (N, 12) affine key words with pk_live (N,) (None: every
    key live), the signature plane of the same N rows, msg (M, 2, 2, 12)
    with msg_inf (M,); g1_plan an `msm.MsmPlan` over the N keys in M
    groups (set i in its message's group) and g2_plan a one-group plan over
    the N signatures, both from the sets' RLC pairs (host arrays, or
    tensors on the device). Σᵢ∈ⱼ rᵢ·pkᵢ per message and Σᵢ rᵢ·sigᵢ by the
    bucket MSM (a key not live and a masked signature row add ∞), M Miller
    loops with pair_inf = (Σ ∞) | msg_inf, one finish over M message terms
    and one signature term, the rows' decode and subgroup flags folded to
    one. Returns the (1,) uint8 verdict tensor without waiting for it."""
    sx, sy, mask, ok, sub = plane
    if pk_live is None:
        pk_live = torch.ones((pk_x.shape[0],), dtype=torch.bool,
                             device=pk_x.device)
    gpk = msm.msm_bucket_sum(pk_x, pk_y, pk_live, g1_plan)
    ssum = msm.msm_bucket_sum(sx, sy, ~mask, g2_plan)
    gpk_inf = (gpk[:, 2] == 0).all(-1)
    f = TP.miller_loop_pairs(gpk, msg, gpk_inf | msg_inf)
    return rlc_finish(f, ssum, torch.zeros_like(msg_inf), ok.all().reshape(1),
                      sub.all().reshape(1))


def grouped_plans(r01, pk_inf, sig_inf, group_of_set, n_groups: int,
                  g1_bits: int, g2_bits: int, lanes: "int | None" = None):
    """The two `msm.MsmPlan`s of `verify_grouped` from host arrays: r01
    (N, 2) RLC halves (int32 words read as uint32), pk_inf and sig_inf (N,)
    ∞ rows (dropped by the plans), group_of_set (N,) in [0, n_groups)."""
    r = np.asarray(r01).view(np.uint32).astype(np.uint64).reshape(-1, 2)
    return (msm.plan_msm(r[:, 0], r[:, 1], pk_inf, group_of_set, n_groups,
                         window_bits=g1_bits, lanes=lanes),
            msm.plan_msm(r[:, 0], r[:, 1], sig_inf, None, 1,
                         window_bits=g2_bits, lanes=lanes))


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
                     msg_inf, r01):
    """`grouped_multi_verify_kernel`'s tail on the ladders: (M, K) member
    slots taken row-major (slot (m, k) is set m·K + k with its own
    r01[m, k], the row the reference's k-major flattening `_flat_km` also
    gives member (m, k)), rᵢ·pkᵢ and rᵢ·sigᵢ by `multi_rlc_scale`, the ∞
    members' Z set to 0, Σ a group by `g1_group_sum`, M Miller loops, one
    finish over M message terms and M·K signature terms."""
    m, k = pk_inf.shape
    _expect(name, (pk_x, (m, k, 12)), (pk_y, (m, k, 12)), (sig_inf, (m, k)),
            (msg, (m, 2, 2, 12)), (msg_inf, (m,)), (r01, (m, k, 2)))
    n = m * k
    sx, sy, mask, ok, sub = _signature_operands(
        sx.reshape(n, 2, 12), sy.reshape(n, 2, 12), sig_inf.reshape(n), 0)
    idx = torch.arange(n, dtype=torch.int32, device=pk_inf.device)
    rpk, rsig = multi_rlc_scale(pk_x.reshape(n, 12), pk_y.reshape(n, 12), idx,
                                sx, sy, mask, r01.reshape(n, 2))
    rpk[:, 2].masked_fill_(pk_inf.reshape(n, 1), 0)  # Z = 0: the sum takes ∞
    gpk = g1_group_sum(rpk, range(0, n + 1, k))
    gpk_inf = (gpk[:, 2] == 0).all(-1)
    f = TP.miller_loop_pairs(gpk, msg.contiguous(), gpk_inf | msg_inf)
    return rlc_finish(f, rsig, torch.zeros_like(msg_inf), ok, sub)


def _k_major(t):
    """(M, K, …) member slots → (K·M, …) rows, member (m, k) at row k·M + m:
    the reference's `_flat_km`, the point order of its MSM plans."""
    return t.transpose(0, 1).reshape((-1,) + tuple(t.shape[2:])).contiguous()


def _grouped_msm_program(name, pk_x, pk_y, pk_inf, sx, sy, sig_inf, msg,
                         msg_inf, plans, g1_windows, g1_wbits, g2_windows,
                         g2_wbits, check_subgroup: int):
    """The MSM programs' common tail (the reference's
    `_grouped_msm_verify_tail`, tpu/bls.py:450-480): the (M, K) slots in
    the plans' k-major order, the signature plane with the ψ check where
    asked, `verify_grouped` over the reference's ten plan arrays (an ∞ key
    not live, an ∞ signature masked)."""
    m, k = pk_inf.shape
    _expect(name, (pk_x, (m, k, 12)), (pk_y, (m, k, 12)), (sx, (m, k, 2, 12)),
            (sy, (m, k, 2, 12)), (sig_inf, (m, k)), (msg, (m, 2, 2, 12)),
            (msg_inf, (m,)))
    if len(plans) != 10:
        raise ValueError(f"{name}: expected the ten plan arrays, got "
                         f"{len(plans)}")
    plane = _signature_operands(_k_major(sx), _k_major(sy), _k_major(sig_inf),
                                check_subgroup)
    g1 = msm.MsmPlan(*plans[:5], n_groups=m, windows=g1_windows,
                     window_bits=g1_wbits)
    g2 = msm.MsmPlan(*plans[5:], n_groups=1, windows=g2_windows,
                     window_bits=g2_wbits)
    return verify_grouped(_k_major(pk_x), _k_major(pk_y), plane,
                          msg.contiguous(), msg_inf, g1, g2,
                          ~_k_major(pk_inf))


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
                            pk_inf, sig_x, sig_y, sig_inf, msg, msg_inf, r01)


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


def grouped_multi_verify_msm_kernel(pk_x, pk_y, pk_inf, sig_x, sig_y,
                                    sig_inf, msg, msg_inf, *plans,
                                    g1_windows: int, g1_wbits: int,
                                    g2_windows: int, g2_wbits: int,
                                    check_subgroup: int = 0):
    """Message-grouped RLC verify with both scalar planes as bucket MSMs,
    the counterpart of grandine_tpu/tpu/bls.py
    grouped_multi_verify_msm_kernel (:483): the slots as
    `grouped_multi_verify_kernel`'s (no r01: the RLC scalars travel in
    the plans), then the reference's ten plan arrays — g1_pidx, g1_valid,
    g1_flush, g1_gidx, g1_gvalid of the M-group key MSM and the same five
    of the one-group signature MSM, over the k-major point order (point
    f = k·M + m is member (m, k), its group f mod M; `entry.grouped_plans`)
    — with each plan's windows and window bits. With check_subgroup set,
    the signatures' G2 membership folds into the verdict (∞ rows pass).
    Launches `msm_lane_scan`, `msm_bucket_reduce` and `msm_horner` for
    each plane, `miller_loop_pairs` and `rlc_finish` (and where set
    `g2_subgroup_check`)."""
    return _grouped_msm_program(
        "grouped_multi_verify_msm_kernel", pk_x, pk_y, pk_inf, sig_x, sig_y,
        sig_inf, msg, msg_inf, plans, g1_windows, g1_wbits, g2_windows,
        g2_wbits, check_subgroup)


def grouped_multi_verify_msm_packed_kernel(pk_x, pk_y, pk_inf, sig_words,
                                           sig_inf, msg, msg_inf, *plans,
                                           g1_windows: int, g1_wbits: int,
                                           g2_windows: int, g2_wbits: int,
                                           check_subgroup: int = 0):
    """`grouped_multi_verify_msm_kernel` with the signature plane uploaded
    in the packed transfer format, the counterpart of grandine_tpu/tpu/
    bls.py grouped_multi_verify_msm_packed_kernel (:527): sig_words (M, K,
    4, 13) int32 — x.c0, x.c1, y.c0, y.c1 of each member's signature as
    13 words read as uint32 (`limbs.pack_fp_words_host`), 52 bytes a
    coordinate against 48 of canonical words here (104 of the reference's
    limbs) — the rest, the ten plan arrays included, as
    `grouped_multi_verify_msm_kernel`. Launches `unpack_words`, then that
    program's kernels."""
    m, k = pk_inf.shape
    _expect("grouped_multi_verify_msm_packed_kernel",
            (sig_words, (m, k, 4, 13)))
    coords = unpack_words(sig_words.reshape(m * k, 4, 13)).reshape(
        m, k, 4, 12)
    return _grouped_msm_program(
        "grouped_multi_verify_msm_packed_kernel", pk_x, pk_y, pk_inf,
        coords[:, :, 0:2], coords[:, :, 2:4], sig_inf, msg, msg_inf, plans,
        g1_windows, g1_wbits, g2_windows, g2_wbits, check_subgroup)


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


def sharded_msm_plans(r_lo, r_hi, pk_inf, sig_inf, n_dev: int):
    """Per-shard MsmPlans of the sharded grouped verify, the port's copy of
    grandine_tpu/tpu/bls.py sharded_msm_plans (:1207): the (M, K) batch is
    sharded over K, so shard d's scalars are the k-major rows kk ∈
    [d·K/D, (d+1)·K/D) (r_lo, r_hi (K·M,) in that order; pk_inf, sig_inf
    (M, K)). Every shard shares one (windows, window_bits, S, T, J) shape,
    J padded to the fleet's largest. Returns (g1_arrays, g2_arrays,
    g1_plan0, g2_plan0), *_arrays the MsmPlan.arrays stacked on a leading
    shard axis."""
    m, k = pk_inf.shape
    if k % n_dev:
        raise ValueError("K must divide over the mesh")
    k_loc = k // n_dev
    r_lo = np.asarray(r_lo, np.uint64).reshape(k, m)
    r_hi = np.asarray(r_hi, np.uint64).reshape(k, m)
    pk_inf_km = np.asarray(pk_inf, bool).T  # (K, M)
    sig_inf_km = np.asarray(sig_inf, bool).T
    groups_loc = np.arange(k_loc * m) % m
    g1_w = pick_msm_window(k_loc * m, m)
    g2_w = pick_msm_window(k_loc * m, 1)
    g1_plans, g2_plans = [], []
    for d in range(n_dev):
        sl = slice(d * k_loc, (d + 1) * k_loc)
        lo = r_lo[sl].reshape(-1)
        hi = r_hi[sl].reshape(-1)
        g1_plans.append(msm.plan_msm(lo, hi, pk_inf_km[sl].reshape(-1),
                                     groups_loc, m, window_bits=g1_w))
        g2_plans.append(msm.plan_msm(lo, hi, sig_inf_km[sl].reshape(-1), None,
                                     1, window_bits=g2_w))

    def stack(plans):
        j_max = max(p.gather_idx.shape[0] for p in plans)

        def pad_j(a):
            pad = np.zeros((j_max - a.shape[0],) + a.shape[1:], a.dtype)
            return np.concatenate([a, pad], axis=0)

        cols = list(zip(*(p.arrays for p in plans)))
        return tuple(np.stack([pad_j(a) if i >= 3 else a for a in col])
                     for i, col in enumerate(cols))

    return stack(g1_plans), stack(g2_plans), g1_plans[0], g2_plans[0]


def make_sharded_multi_verify_msm(mesh, check_subgroup: int = 0):
    """The message-grouped RLC verify sharded over `mesh`
    (grandine_tpu/tpu/bls.py make_sharded_multi_verify_msm :1258). The
    callable takes the n sets in message order as host arrays (pk_x, pk_y,
    sig_x, sig_y, sig_inf, r01 as the flat callable's), the M + 1 message
    offsets, msg (M, 2, 2, 12) with msg_inf (M,), and the JAX package's
    buckets bm ≥ M and bk ≥ the widest group, both divided by the mesh.
    It lays the sets out as the reference's (bm, bk) member slots (∞
    padding) and builds the reference's plans from the pairs
    (`sharded_msm_plans`). Shard d owns members `member_range(bk, d)` of
    every group, k-major: its G1 MSM with bm groups and its one-group G2
    MSM (the bucket MSM's three kernels each; :1328-1345), and where it
    holds a real member its signature plane. The bm·D G1 partials reduce
    on the first device with `g1_group_sum`, D rows a group, for the M
    real groups (the reference's reduce_over_devices, :1286-1305). The
    Miller plane is sharded by message (:1353-1367): shard d pairs groups
    [d·bm/D, (d+1)·bm/D) ∩ [0, M) with their sums, then `rlc_partial`
    over those terms and its own members' signature flags. Then the
    gather and one `rlc_finish` over D terms of each kind. Returns the
    (1,) uint8 verdict tensor without waiting."""
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
        if not (mesh.divides(bm) and mesh.divides(bk)):
            raise ValueError(f"buckets ({bm}, {bk}) do not shard over "
                             f"{d_count} devices")
        # the reference's (bm, bk) slots: member kk of group j is set
        # starts[j] + kk where kk < counts[j], padding (∞) elsewhere
        kk = np.arange(bk)
        real = np.zeros((bm, bk), bool)
        real[:m] = kk[None, :] < counts[:, None]
        row_of = np.zeros((bm, bk), np.int64)
        row_of[:m] = starts[:, None] + kk[None, :]
        row_of[~real] = 0
        r = np.asarray(r01).view(np.uint32).astype(np.uint64).reshape(-1, 2)
        r_km = np.where(real[..., None], r[row_of], 0).transpose(1, 0, 2)
        sig_pad = ~real | np.asarray(sig_inf, bool)[row_of]
        g1_arrays, g2_arrays, g1_0, g2_0 = sharded_msm_plans(
            r_km[..., 0].reshape(-1), r_km[..., 1].reshape(-1), ~real,
            sig_pad, d_count)
        g1_parts, s_parts, member_flags = [], [], []
        for d in range(d_count):
            klo, khi = mesh.member_range(bk, d)
            rows = row_of[:, klo:khi].T.reshape(-1)  # k-major: kk·bm + j
            live = real[:, klo:khi].T.reshape(-1)
            zero = ~live[:, None]
            put = mesh.put(
                [np.where(zero, np.int32(0), a[rows]) for a in (pk_x, pk_y)]
                + [np.where(zero[..., None], np.int32(0), a[rows])
                   for a in (sig_x, sig_y)]
                + [sig_pad[:, klo:khi].T.reshape(-1), live]
                + [a[d] for a in g1_arrays + g2_arrays], d)
            px, py, sx, sy, sinf, plive = put[:6]
            sx, sy, mask, ok, sub = _signature_operands(
                sx, sy, sinf, check_subgroup if live.any() else 0)
            g1 = msm.MsmPlan(*put[6:11], n_groups=bm, windows=g1_0.windows,
                             window_bits=g1_0.window_bits)
            g2 = msm.MsmPlan(*put[11:], n_groups=1, windows=g2_0.windows,
                             window_bits=g2_0.window_bits)
            g1_parts.append(msm.msm_bucket_sum(px, py, plive, g1))
            s_parts.append(msm.msm_bucket_sum(sx, sy, ~mask, g2))
            member_flags.append((ok, sub))
        # D partials a real group, group-major: offsets every D
        rows = mesh.gather(g1_parts).view(d_count, bm, 3, 12)[:, :m]
        gpk = g1_group_sum(rows.transpose(0, 1).reshape(m * d_count, 3, 12),
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


# --- the MSM window table -----------------------------------------------------
#
# The port's counterpart of grandine_tpu/tpu/bls.py:356-447: a measured
# sweep (gpu/autotune.py, on the card) persists its winning window widths
# as {"windows": {"<n_points>:<n_groups>": w}} in the port's own table,
# gpu/msm_tune.json beside this module; pick_msm_window consults it first
# (keys quantised to the pow-2 buckets of `_bucket`) and otherwise the op
# model decides. The JAX package's tools/shapes/msm_tune.json holds TPU
# windows and is never read.

_MSM_TUNE: "dict | None" = None
_MSM_TUNE_LOCK = threading.Lock()


def msm_tune_path() -> str:
    """The port's window table: gpu/msm_tune.json beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "msm_tune.json")


def load_msm_tuning(path: "str | None" = None) -> "dict | None":
    """The {"<n>:<g>": w} table (cached for the default path), or None
    when the file is absent or unreadable — the op model then stands
    alone. Entries outside 4–8 or not integers are dropped one by one."""
    global _MSM_TUNE
    with _MSM_TUNE_LOCK:
        if _MSM_TUNE is not None and path is None:
            return _MSM_TUNE or None
        try:
            with open(path or msm_tune_path(), encoding="utf-8") as fh:
                raw = json.load(fh)
            table = {}
            for k, v in dict(raw.get("windows", {})).items():
                try:
                    w = int(v)
                except (ValueError, TypeError):
                    continue
                if 4 <= w <= 8:
                    table[str(k)] = w
        except (OSError, ValueError, TypeError, AttributeError):
            table = {}
        if path is None:
            _MSM_TUNE = table
        return table or None


def set_msm_tuning(table: "dict | None") -> None:
    """Install a window table ({"<n>:<g>": w}; {} for none), or None to
    drop the cache so that the next lookup reads the file again."""
    global _MSM_TUNE
    with _MSM_TUNE_LOCK:
        _MSM_TUNE = None if table is None else {
            str(k): int(v) for k, v in table.items()
        }


def pick_msm_window(n_points: int, n_groups: int = 1) -> int:
    """The window width of an MSM over n_points in n_groups: the table's
    entry for ("%d:%d" % (_bucket(n_points), _bucket(n_groups, lo=1)))
    where it has one, else the width in 4–8 that minimises the op model
    W·2N + 2w·G·W·2^w (scan work plus suffix and reduce work), as
    grandine_tpu/tpu/bls.py pick_msm_window."""
    table = load_msm_tuning()
    if table:
        key = "%d:%d" % (_bucket(n_points), _bucket(max(1, n_groups), lo=1))
        w = table.get(key)
        if w is not None:
            return w
    best, best_cost = 4, None
    for w in range(4, 9):
        W = (32 + w - 1) // w
        cost = W * 2 * n_points + 2 * w * n_groups * W * (1 << w)
        if best_cost is None or cost < best_cost:
            best, best_cost = w, cost
    return best


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


def sign_digits_host(scalars, pad_to: "int | None" = None) -> np.ndarray:
    """Secret scalars → (N, 4, 2) int32: the base-|x| digits d0 … d3 of
    each (sk = d0 + d1|x| + d2|x|² + d3|x|³, three divmods by |x|; every
    digit below |x| < 2⁶⁴ because sk < r < |x|⁴) as little-endian 32-bit
    words, the operands of `batch_sign`. Rows past the scalars, up to
    pad_to, are (1, 0, 0, 0)."""
    vals = [int(v) for v in scalars]
    n = len(vals) if pad_to is None else pad_to
    out = np.zeros((n, 4), "<u8")
    out[len(vals):, 0] = 1
    for i, v in enumerate(vals):
        assert 0 <= v < constants.R
        for j in range(3):
            v, out[i, j] = divmod(v, ABS_X)
        out[i, 3] = v
    return out.view("<u4").reshape(n, 4, 2).view(np.int32)


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
        both buckets (tpu/bls.py:2102-2112), else on one device: the G1
        and G2 plans built here on the host from the pairs, with the
        reference's windows pick_msm_window(n, bm) and pick_msm_window(n,
        1) (tpu/bls.py:2112-2122), then `verify_grouped`."""
        order = np.fromiter((i for ix in groups.values() for i in ix),
                            np.int32, count=len(signatures))
        offsets = np.cumsum([0] + [len(ix) for ix in groups.values()])
        bm = _bucket(len(groups))
        bk = _bucket(int(np.diff(offsets).max()))
        n = len(order)
        sx, sy, sinf = g2_affine_words_many([signatures[i].point
                                             for i in order])
        msg, msg_inf = self._message_words(list(groups), dst)
        pairs = rlc_pairs_words([self._rlc_pair(rng) for _ in range(n)])
        mesh = self.mesh
        if (mesh is not None and bm % mesh.device_count == 0
                and bk % mesh.device_count == 0):
            fn = sharded_multi_verify_msm(
                mesh, check_subgroup=int(self.fuse_subgroup))
            return self._settle(fn(fx[order], fy[order], sx, sy, sinf,
                                   offsets, msg, msg_inf, pairs, bm, bk))
        g1_plan, g2_plan = grouped_plans(
            pairs, np.zeros((n,), bool), sinf,
            np.repeat(np.arange(len(groups)), np.diff(offsets)), len(groups),
            pick_msm_window(n, bm), pick_msm_window(n, 1))
        plane = signature_plane(self._up(sx), self._up(sy), self._up(sinf))
        return self._settle(verify_grouped(
            self._up(fx[order]), self._up(fy[order]), plane, self._up(msg),
            self._up(msg_inf), g1_plan, g2_plan))

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
        the scalars' base-|x| digits on the host (`sign_digits_host`), one
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
        d = sign_digits_host([sk.scalar for sk in secret_keys])
        words = batch_sign(msg, msg_inf, self._up(d))
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
    "g1_group_sum", "g1_group_sum_plain", "group_sum_plan",
    "group_sum_passes_plain",
    "group_tile", "multi_g2_lanes", "rlc_finish", "rlc_finish_plain",
    "rlc_sig_miller_plain", "finish_threads", "finish_groups",
    "rlc_finish_geometry", "PARTIAL_WARPS", "rlc_partial_geometry",
    "partial_groups", "finish_widths", "rlc_partial",
    "rlc_partial_plain", "partial_flags", "make_sharded_multi_verify",
    "sharded_multi_verify", "make_sharded_multi_verify_msm",
    "sharded_multi_verify_msm",
    "signature_plane", "signature_plane_compressed", "verify_aggregates",
    "verify_sets", "verify_grouped", "grouped_route", "message_groups",
    "g1_decompress_rows", "rlc_pairs_words", "rlc_bits_host",
    "g2_affine_words", "g2_affine_words_many", "g1_affine_words",
    "SIGN_HALF_BITS", "SIGN_DIGIT_BITS", "sign_scalars_host",
    "sign_digits_host", "SIGN_LANE_THREADS", "sign_lanes", "batch_sign",
    "batch_sign_plain",
    "g2_group_sum", "g2_group_sum_plain", "g2_aggregate_groups",
    "g1_aggregate_groups", "g2_points_from_words", "g1_points_from_words",
    "jacobian_rows", "launch_geometry", "batch_pubkey", "batch_pubkey_plain",
    "batch_pubkey_glv_plain", "PUBKEY_LANES",
    "g1_normalize", "g1_normalize_plain", "g2_normalize",
    "g2_normalize_plain", "unpack_words", "unpack_words_plain",
    "multi_verify_kernel", "grouped_multi_verify_kernel",
    "aggregate_fast_verify_kernel", "grouped_multi_verify_msm_kernel",
    "grouped_multi_verify_msm_packed_kernel", "grouped_plans",
    "sharded_msm_plans", "msm_tune_path", "load_msm_tuning",
    "set_msm_tuning", "pick_msm_window",
]
