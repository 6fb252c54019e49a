#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every CUDA
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the kernels from csrc/ (nvcc, sm_90a) and print ptxas' report;
  2. each of the first five kernels against its plain version on the
     card, on edge rows at a reduced size (2,048 registry rows with
     infinity and bad rows, 8 aggregates with a bad and a non-G2
     signature, ∞ pairs; g2_decompress_subgroup also on the edge corpus
     of testing/decompress_rows.py — G2 points with both sign bits, y²
     with c1 = 0 on either root, a point outside G2, an x with no y, x0 ≥
     p, x1 ≥ p, the compression flag clear, ∞ and its bad forms, the
     all-zero row — with its launch geometry): exact equality; rlc_finish's edge groups (f
     terms only, signature terms only, an ∞ signature sum, spans 1, 8,
     9, 128 and 129, the 2,048-group per-item rung), each launched
     FINISH_REPEATS times with the same verdicts and held against the
     plain version with phase 14's batched checks; miller_loop_pairs at
     MILLER_EDGE pair counts (testing/pairing_rows.py: Z = 1 and Z ≠ 1,
     −g1, pair_inf rows) and aggregate_rlc_scale on its edge rows (r0 = 0,
     r1 = 0, r = 1, halves 0xFFFFFFFF, a sum to ∞, a doubling, one member,
     130 members, masked signatures), EDGE_REPEATS launches each, every
     launch equal to
     the plain version, with each shape's geometry and CUDA-event time;
     ptxas' stack need and registers of the pairing, decompression,
     aggregate, ladder, comb, Ed25519 and multi.cu kernels against
     STACK_CEILING (DETAILED_KERNELS each on a line with their spills:
     multi.cu's four entries, rlc_partial, g2_decompress_subgroup,
     g2_subgroup_check, msm_horner's G1 and G2 kernels), and the warp
     rounds
     of a group's tail and of a pair's Miller loop;
  3. the main path at real size: a 50,000-validator registry ingested on
     the card, then one slot of gossip aggregates (12 committees × 16
     aggregators = 192 aggregates of 87–130 members) through
     gpu.schemes.dispatch_bls_compressed — a valid batch must verify and
     five bad batches must not; a few aggregates are cross-checked with
     the host anchor;
  4. the block-verify path: one mainnet block's 131 signature sets (128
     attestation aggregates of 87–130 members, the proposer's signature,
     the RANDAO reveal, a 512-member sync aggregate) through
     consensus.verifier.TorchVerifier — valid → True, a forged set, a
     swapped message and an ∞ key → False, a signature outside G2 raises
     SignatureInvalid at host decompression — and the same sets through
     multi_verify_compressed (outside G2 → False) and multi_verify_indexed;
     the new kernels against their plain versions on edge rows (∞ and
     non-G2 rows, registry rows 0 and 49,999, N = 1; g2_subgroup_check
     also on testing/subgroup_rows.py's — cofactor torsion, a G2 point
     plus it, [h_eff]Q, the decompression corpus's points — with its
     geometry at the edge, block and window widths); multi_rlc_scale on
     its edge sets (r0 = 0, r1 = 0, r = 1, r = 0, halves 0xFFFFFFFF, a
     masked signature, one key in three sets), and both group sums on
     their plan edges (testing/group_rows.py: empty
     and all-∞ groups, one row, GROUP_CHUNK rows and one more, a group
     spanning two passes, P and −P, a doubling, groups of 4), each with
     its launch geometry;
  5. a replay window of 8 such blocks (1,048 sets) through
     runtime.replay.dispatch_window (g2_subgroup_check_batch_async +
     multi_verify_async): valid → True, a forged set in block 5 or a
     signature outside G2 → False; and the slot's 192 aggregates through
     gpu.schemes.dispatch_bls_host_decompress (outside G2 → False);
  6. fault localization and the grouped route: the slot's batch with 1
     forged aggregate, 3 forged in one group of 8, 3 in different groups,
     1 signature outside G2 — each fails through dispatch_bls_compressed,
     then runtime.isolation.FaultLocalizer.localize must name exactly the
     bad items within max_device_passes and with no host sweep, each pass
     timed; the same for the 1,562-signer unaggregated slot (12 roots,
     bucket 2,048, ladder 8, 64, 512, 2,048) with 2 forged; the grouped
     route of multi_verify on a 512-signer sync-committee slot and on the
     unaggregated slot (valid → True, forged or swapped → False; the
     bucket MSM's three kernels for the key and the signature plane, one
     Miller launch, one finish, no ladder and no g1_group_sum), and both
     routes timed on the same triples; the group-indexed rlc_finish and
     g1_group_sum against their plain versions on edge rows (phase 4) and
     rlc_finish on every recorded pass;
  7. the signing path on the operator's 50,000 keys: batch_sign at one,
     two and four lanes a signature (each edge call launched EDGE_REPEATS
     times with the same words) and both group_sum instances against their
     plain versions on edge rows (∞ messages, sk = 1, r − 1, r − 2, the
     digit |x| − 1, |x|, |x|³, zero digits; empty, all-∞ and
     single-member groups); the operator slot — its 1,562 duty validators
     attesting their committee's root and 512 sync-committee members
     signing the head root — through runtime.sign_plane.SigningPlane with
     DEFAULT_SIGN_LANES and the release gate on, one warm round and
     SIGN_ROUNDS timed rounds, every released signature byte for byte its
     anchor (G2 additions along the key progression), every batch on the
     device (0 degraded, faults, breaker skips, expired, gate failures), a
     sample of 16 against SecretKey.sign; aggregate construction through
     validator.duties.device_aggregator (12 committee aggregates, 4 sync
     subcommittee contributions) and gpu.bls.g1_aggregate_groups (12
     committee keys), each equal to the host aggregate; a chaos round
     (ChaosBackend, wrong_signature) releasing no bad signature, one gate
     failure, one batch degraded; one full bucket of 16,384 keys through
     TorchBlsBackend.batch_sign, every point its anchor;
  8. the EIP-4844 blob-KZG plane on the official 4,096-point setup:
     g1_scalar_mul (its edge call launched EDGE_REPEATS times) against its
     plain version and the host ladder on edge rows (k = 0, 1, r − 1, x²,
     3·x² (k0 = 0), x² − 1, halves of window digits ±16, an ∞ base, the
     generator); every batch_sign and g1_scalar_mul launch of phases 7-9,
     held against the plain versions after phase 9; a block's 6 blobs
     committed and proved on the card (kzg.eip4844, one device pass
     each), one proof at a root of unity, commitment and proof 0 equal to
     the host Pippenger, a constant blob's commitment c·G1, the zero
     blob's ∞; batch verification through verify_blob_kzg_proof_batch and
     the `blob_kzg` scheme row (prepare → verify_blobs_async) on the 6
     blobs (True), a forged proof, a tampered blob (False) and a batch
     with the zero blob (True), each verdict the host batch tail's and
     each batch launching g1_scalar_mul, g1_group_sum, miller_loop_pairs
     and rlc_finish; host_check_item names exactly the forged item; the
     commitment, proof and batch-verify p50 split host / device;
  9. the verify scheduler as the entry point (runtime.verify_scheduler.
     VerifyScheduler with DEFAULT_LANES on the card): ed25519_verify
     against its plain version on edge rows (B = 8, 32, 128; zero
     scalars, k = 1, 2^253 - 1, L - 1; the identity, the order-2 point,
     x = 0 negated, the base point, a torsion-carrying R, which must
     verify); the `ed25519` lane at full width — 1,008 signatures under
     1,008 seeded keys as jobs of 1-8, 16 batches of 63 (bucket 128),
     pipelined and then one batch at a time — and a poisoned stream (a
     forged message, S + 1, S >= L, a torsion specimen), every verdict
     the host twin's, the failed batch bisected with 0 device faults; the
     block's 131 sets through DeferredVerifier on the `block` lane, then
     one job a set with one forged (exactly that ticket False, localized
     on the card with 0 host sweeps), the 512-member sync slot on
     `sync_message`, the 6 blobs and a forged proof on `blob_kzg`, each
     verdict the direct seam's; a chaos round (ChaosBackend,
     wrong_verdict: every ticket True by bisection, one verdict fault);
     per lane 0 device faults, degraded batches, breaker skips and
     retries; every ed25519_verify launch of the phase against the plain
     version; the lane's batch p50 split host prep / device wait,
     signatures/s, the host twin's batch of 63, the block p50 through
     DeferredVerifier beside the direct TorchVerifier;
 10. the slasher at full width (grandine_tpu_torch.slasher.Slasher):
     span_update_grid against its plain version on edge rows (n = 1, 255,
     256, 257, 16,385, 50,000, 300; a row not valid, s below the grid, t
     past it, s = t - 1, UNSET and 0 inputs; grid bases 0, 2^30 - 64,
     2^31 - 64); the native CRC-32C of the database's snappy framing
     (required); six epoch windows at 50,000 validators (targets 96-101,
     32 slots x 12 committees of 130-131, every validator voting once, so
     all 50,000 rows go through the grid merge) and a poisoned seventh (a
     surround on the grid, a surrounded vote and a double vote on the
     collision path), each one on_attestations_bulk call on a device
     Slasher() and on a Slasher(device="cpu"), over sqlite databases —
     identical hits, exactly the injected offenders, one span_update_grid
     launch a window, each held against the plain version; two double
     proposals through on_block; prune dropping the same rows on both;
     the two sl: keyspaces equal byte for byte; the window p50 on the card
     and the CPU twin and the device slasher's split (checks, grid
     assembly, copy to the card, kernel by CUDA events, copy back, scatter
     and below-grid walk, record puts, flush);
 11. the multi-device verify plane (gpu.mesh.VerifyMesh over D virtual
     shards of the card, the counterpart of XLA's virtual devices), each
     case valid, forged and swapped, every verdict the single-device
     route's and the host anchor's (host_check_item on the changed sets):
     the block's 131 sets (distinct roots: the flat route, b = 256)
     through TorchVerifier over TorchBlsBackend(mesh=) at D = 2 and 4;
     the window's 1,048 sets through runtime.replay.dispatch_window at
     D = 4; the 512-signer sync slot (grouped: bm = 4, bk = 512) at D = 2
     and 4 and the 1,562-signer unaggregated slot (bm = 16, bk = 256) at
     D = 4 through multi_verify — one rlc_partial launch a shard on each
     sharded run, on the grouped runs each shard's G1 and G2 bucket MSM
     and one g1_group_sum reducing the shards' group sums; the gossip slot's 192 aggregates through
     dispatch_bls_compressed over the 50,000-key registry sharded over
     D = 4 (16,384 rows a shard, 4 g1_decompress launches, rows equal to
     the single registry's); the block through VerifyScheduler(mesh=)'s
     block lane via DeferredVerifier over that registry, devices == 4 on
     its flight records, 0 device faults, degraded batches, breaker skips
     and retries; over distinct cards (VerifyMesh.build()) when there are
     several; every rlc_partial launch against its plain version, exactly,
     each launch shape with its passes' geometry;
     the sharded and single-device routes timed on the same triples, p50
     of 3 in turns, host clock and the kernels' span by CUDA events;
 12. the reference-only programs at full width (gpu.bls counterparts of
     the JAX package's multi_verify_kernel, grouped_multi_verify_kernel,
     aggregate_fast_verify_kernel and grouped_multi_verify_msm_packed_kernel,
     and the port's entry.py): batch_pubkey, g1_normalize, g2_normalize and
     unpack_words against their plain versions on edge rows (sk = 1, r − 1,
     r − 2, both sign masks; the comb's edges: a zero half, lanes summing
     to ∞, all-15 digits, a join that doubles and one that gives ∞; ∞
     rows, Z = ±1, a non-residue Z; N = 1; 0,
     p − 1, p, 2^384 − 1, 2^390 − 1, bits above 390); the registry's first
     16,384 keys derived on the card (batch_pubkey, g1_normalize,
     compression) byte for byte the registry's; g2_normalize reading back
     the full signing bucket, equal to and timed against the host
     inversion; multi_verify_kernel on the block (bucket 256) and the
     window (2,048) — valid, forged, swapped and a signature outside G2
     (the algebra's verdict: no g2_subgroup_check launched);
     grouped_multi_verify_kernel (ladders), grouped_multi_verify_msm_kernel
     and, packed with check_subgroup, the packed program (both on the
     reference's MSM plans, entry.grouped_plans) on the unaggregated slot
     (bm = 16, bk = 256) and the sync slot; aggregate_fast_verify_kernel on the gossip slot's 192
     aggregates with uploaded members (bm = bk = 256) and the [P, −P]
     committee in a real slot (False) and a padding slot (neutral) — every
     verdict the host anchor's and the ported route's, every run's
     launches counted; entry() and dryrun_multichip(2), (4) over virtual
     shards; every launch of the four new kernels against its plain
     version, exactly;
 13. the Pippenger bucket MSM (gpu/msm.py, csrc/msm.cu): msm_lane_scan,
     msm_bucket_reduce and msm_horner against their plain versions, G1
     and G2, on edge rows (∞ rows, a row masked on the card, P and −P
     under one scalar, duplicates, zero halves, an empty group, 40 lanes,
     256 digits a section; msm_horner at G1 w = 4 and G2 w = 8 also on
     testing/horner_rows.py's groups in the same launch — no entry, ∞
     totals, equal and opposite points meeting, a sum to ∞), each sum the
     host anchor's; msm_horner's geometry at the route's shapes; the
     grouped route on the unaggregated and sync slots, valid, forged and
     swapped, every
     MSM launch held against its plain version word for word and the
     valid runs' key and signature sums equal to the host anchor's affine
     points; gpu/autotune.py's window sweep at the route's four cells, ms
     per window, its table printed beside the committed
     grandine_tpu_torch/gpu/msm_tune.json (not rewritten); the G2 bucket
     MSM beside the ladder plane
     (multi_rlc_scale + g2_group_sum) on the same signature rows at the
     gossip (192), block (131) and window (1,048) shapes, both timed, the
     same sum, neither deciding a route;
 14. each kernel again against its plain version, exactly, on the
     main-path operands (65,536 registry rows, 192 aggregates of up to 130
     members; the block's 131 sets; the window's 1,048 sets; the
     partition passes; both grouped shapes; the full bucket and a lane
     batch of batch_sign; the three aggregate calls; the KZG batch verify
     and setup MSM; ed25519_verify at B = 8, 32, 128; span_update_grid at
     a window's 50,000 rows; the registry keys of batch_pubkey and
     g1_normalize, the signing readback of g2_normalize, a packed plane of
     unpack_words; the bucket MSM's kernels at the grouped route's G1 and
     G2 shapes), and its time there (CUDA events, after
     warm-up) beside the plain version's, its bound and, where one stock
     PyTorch computation gives the same function, that one's;
     g2_decompress_subgroup's split at the gossip slot's rows (each row's
     stage clocks: decompression against the ψ check) with its geometry;
     end-to-end p50 of the gossip batch, the block and the window with
     the hash-to-G2 cache warm and cold, host prep kept apart from
     device time; then every miller_loop_pairs, aggregate_rlc_scale,
     multi_rlc_scale, g1_group_sum and g2_group_sum launch of phases 3-14,
     recorded as it ran, against batched plain calls (sets stacked; groups
     stacked with their offsets shifted) — the timing table's own launches
     are checked in the table, or there at a kernel's later shapes; the
     full bucket's batch_sign launch gives again the words of its phase-7
     launch on the same operands, held there against the plain version,
     and ed25519_verify at B = 32 and 8 the words of the scheduler phase's
     first launch at that bucket; the KZG batch verify's miller_loop_pairs
     and rlc_finish join the batched checks. The edge sets of phase 4,
     phase 2's g2_decompress_subgroup check, the split, the timing table
     and these checks each log their seconds.
Prints the card's name and power limit, one `kernels` JSON line, and as
its last line {"ok": true, "device": {...}}.
"""

import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
from functools import partial
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))

N_VALIDATORS = 50_000
SLOTS_PER_EPOCH = 32
AGGREGATORS_PER_COMMITTEE = 16
E2E_BATCHES = 10
#: one mainnet block's signature sets at the pre-Electra maximum
ATTESTATIONS_PER_BLOCK = 128
SYNC_COMMITTEE_SIZE = 512
#: a replay window, cut from the JAX package's 32 blocks (signing its
#: ~4,200 distinct messages on the host would take ~5 minutes)
WINDOW_BLOCKS = 8
BLOCK_REPS_WARM, BLOCK_REPS_COLD, WINDOW_REPS_WARM = 5, 2, 2
#: rounds of (flat, grouped, grouped, flat) when both routes are timed
ROUTE_ROUNDS = 2
#: launches of each rlc_finish edge call, which must all give the same
#: verdicts (a missing warp synchronisation shows as a verdict that moves)
FINISH_REPEATS = 20
#: launches of each batch_sign and g1_scalar_mul edge call (phases 7 and
#: 8): every launch must give the same words
EDGE_REPEATS = 5
#: timed rounds of the operator slot through the signing plane (after one
#: warm round), and the signers of its chaos round
SIGN_ROUNDS, CHAOS_SIGNERS = 3, 32
#: a Deneb block's blob sidecars (grandine_tpu/types/preset.py), and the
#: timed repetitions of the batch verify
MAX_BLOBS_PER_BLOCK, KZG_REPS = 6, 5
#: rounds of (direct TorchVerifier, DeferredVerifier) timing the block
SCHED_BLOCK_REPS = 3
#: H100 HBM3 rate (NVIDIA data sheet, SXM part)
HBM_BYTES_PER_S = 3.35e12
#: the grouped route's launches: the bucket MSM's three kernels for the
#: G1 key plane and the G2 signature plane, the fused subgroup check, M
#: Miller loops in one launch, one finish — no ladder and no group sum
GROUPED_LAUNCHES = {"msm_lane_scan": 2, "msm_bucket_reduce": 2,
                    "msm_horner": 2, "g2_subgroup_check": 1,
                    "miller_loop_pairs": 1, "rlc_finish": 1}
#: csrc/multi.cu's kernels as ptxas names them (phase 1's lines)
MULTI_KERNELS = ("multi_rlc_scale_kernelILi0E", "multi_rlc_scale_kernelILi1E",
                 "group_sum_lanes_kernel", "group_sum_warps_kernel")
#: csrc/msm.cu's msm_horner kernels (G1 a thread a group, G2 a warp)
HORNER_KERNELS = ("msm_horner_lanes_kernel", "msm_horner_warps_kernel")
#: the kernels whose registers, stack and spills phase 1 logs a line each:
#: csrc/multi.cu's, the warp forms of rlc_partial, g2_decompress_subgroup
#: and g2_subgroup_check, and msm_horner's two
DETAILED_KERNELS = MULTI_KERNELS + HORNER_KERNELS + (
    "rlc_partial_kernel", "g2_decompress_subgroup_kernel",
    "g2_subgroup_check_kernel")
#: the per-thread stack ceiling: no kernel's ptxas stack need may pass it
#: (the limit the build sets is the deepest need rounded up to 1 KiB;
#: 5,120 B since rlc_finish's warp tail, 264 MiB of device memory per KiB)
STACK_CEILING = 5120
#: pair counts of the miller_loop_pairs edge phase (phase 2): one warp, a
#: full block of four, a partial one, the gossip slot, the window, past
#: the card's 528 schedulers; each launched EDGE_REPEATS times
MILLER_EDGE = (1, 32, 33, 192, 1048, 2048)
#: rows a batched plain call of the pairing launch checks takes at most
#: (Miller pairs, aggregates), and the narrowest gather width the
#: aggregates are padded to (a plain call costs ~5 s whatever its size)
PLAIN_CHUNK_PAIRS, PLAIN_CHUNK_AGGS, PLAIN_AGG_WIDTH = 32768, 2048, 130
#: sets a batched plain call of the multi_rlc_scale launch checks takes at
#: most (16,384 sets took ~5.6 s a call; the plain version holds ~0.4 MB a
#: set at its peak), and rows a batched plain call of the group-sum checks
PLAIN_CHUNK_SETS, PLAIN_CHUNK_ROWS = 32768, 65536
#: 32-bit integer multiply / multiply-add results per clock per SM for
#: compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
#: instruction throughput table)
INT32_MUL_PER_CLK_SM = 64
#: int32 multiplies of one 12-limb CIOS Montgomery product: 144 + 144
#: 32×32→64 products (low and high halves) plus 12 for m
MULS_PER_FP_MUL = 2 * 288 + 12


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --- host prep (pure Python, the port's crypto copy) ---------------------


def make_registry_keys(rng, n, P, R, G1, batch_inverse):
    """n secret keys in arithmetic progression (a + i·d mod r) and their
    compressed pubkeys, by point addition from pk₀ with one batched
    inversion; the last key is r − sk₀ so that pk₀ + pk_last = ∞."""
    a, d = rng.randrange(1, R), rng.randrange(1, R)
    sks = [(a + i * d) % R for i in range(n - 1)] + [(R - a) % R]
    (x0, y0), (dx, dy) = (
        tuple(c.n for c in G1.mul(a).to_affine()),
        tuple(c.n for c in G1.mul(d).to_affine()))
    X, Y, Z = x0, y0, 1
    pts = [(X, Y, Z)]
    for _ in range(n - 2):  # madd-2007-bl, Jacobian + affine D
        z1z1 = Z * Z % P
        u2 = dx * z1z1 % P
        s2 = dy * Z * z1z1 % P
        h = (u2 - X) % P
        hh = h * h % P
        i4 = 4 * hh % P
        j = h * i4 % P
        r = 2 * (s2 - Y) % P
        v = X * i4 % P
        X3 = (r * r - j - 2 * v) % P
        Y3 = (r * (v - X3) - 2 * Y * j) % P
        Z = ((Z + h) * (Z + h) - z1z1 - hh) % P
        X, Y = X3, Y3
        pts.append((X, Y, Z))
    zinv = batch_inverse([p[2] for p in pts], P)
    out = []
    for (X, Y, _), zi in zip(pts, zinv):
        zi2 = zi * zi % P
        x, y = X * zi2 % P, Y * zi2 * zi % P
        out.append(_compress(x, y, P))
    out.append(_compress(x0, (P - y0) % P, P))
    return sks, tuple(out)


def _compress(x, y, P):
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= 0x80 | (0x20 if y > P - y else 0)
    return bytes(raw)


def slot_committees(rng, n):
    """One slot's committees at n validators: max(1, min(64, n // 32 //
    128)) committees over the slot's n // 32 validators."""
    count = max(1, min(64, n // SLOTS_PER_EPOCH // 128))
    slot = rng.sample(range(n - 1), n // SLOTS_PER_EPOCH)
    return [slot[i::count] for i in range(count)]


def sign_root(job):
    """[k]·H(root) as compressed signature bytes, for job (root, k)."""
    from grandine_tpu_torch.crypto import bls as A
    from grandine_tpu_torch.crypto.constants import DST_SIGNATURE
    from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2

    root, k = job
    return A.g2_to_bytes(hash_to_g2(root, DST_SIGNATURE).mul(k))


def sign_roots(jobs):
    """sign_root over jobs on the host's cores: set-up of the window's
    blocks (~70 ms of Python a signature), in spawned processes that the
    pool stops before this returns."""
    import multiprocessing

    workers = max(1, min(8, os.cpu_count() or 1))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        return pool.map(sign_root, jobs, chunksize=16)


def make_block(rng, n, sks, R, sign):
    """One block's signature sets as (signing root, signer indices,
    signature): 128 attestation aggregates of 87–130 members, each over
    its own attestation data root; the proposer's block signature and
    RANDAO reveal; a 512-member sync aggregate. Signer indices avoid the
    last key (r − sk₀). `sign` maps [(root, k), …] to the signatures'
    bytes."""
    sets = []
    for _ in range(ATTESTATIONS_PER_BLOCK):
        sets.append((rng.randbytes(32),
                     sorted(rng.sample(range(n - 1), rng.randint(87, 130)))))
    proposer = rng.randrange(n - 1)
    sets += [(rng.randbytes(32), [proposer]), (rng.randbytes(32), [proposer]),
             (rng.randbytes(32),
              sorted(rng.sample(range(n - 1), SYNC_COMMITTEE_SIZE)))]
    sigs = sign([(root, sum(sks[i] for i in mem) % R) for root, mem in sets])
    return [(root, mem, sig) for (root, mem), sig in zip(sets, sigs)]


# --- the bound of each kernel (operation counts at this run's shapes) ----


class OpModel:
    """Fp-product counts of the kernels at the function's least work."""

    def __init__(self, P, abs_x):
        from grandine_tpu_torch.gpu import finish_programs as FPG

        def pw(e):
            return e.bit_length() - 1 + bin(e).count("1") - 1
        self.sqrt = pw((P + 1) // 4) + 1
        self.inv = pw(P - 2)
        self.fp2, self.fp6, self.fp12 = 3, 18, 54
        # the Fp12 square (fp12_sq_fast), the sparse line product, the
        # cyclotomic square (Granger–Scott)
        self.sq12, self.line, self.cyc = 36, 42, 18
        self.dbl1, self.madd1, self.add1 = 7, 11, 16
        # y²'s root at the worse of its two branches: the norm and the
        # candidates' t = (c0 ± √norm)/2; where c1 ≠ 0, √norm with its
        # check and each candidate's one exponentiation u = t^((p−3)/4)
        # giving its root u·t and its 1/(2·root) = u/2 (two products) and
        # the three products of its checks; where c1 = 0, √c0 and √−c0
        # with their checks. (The kernel computes √c0 and √−c0 on every
        # row, beside √norm: work no row needs, left out of the bound.)
        self.fq2_sqrt = 2 + 2 + max(
            2 * self.sqrt, self.sqrt + 2 * (pw((P - 3) // 4) + 1 + 2 + 3))
        # ψ(P) + [|x|]P: 63 doublings (the first step's doubling is of ∞)
        # and the set bits' mixed additions in Fp2, the complete addition,
        # ψ's two Fp2 products
        psi = (63 * self.dbl1 + (bin(abs_x).count("1") - 1) * self.madd1
               + self.add1) * 3 + 2 * 3
        self.psi = psi
        self.g1_row = 6 + self.sqrt
        self.g2_row = 2 + 6 + self.fq2_sqrt + 2 + psi + 4
        n = {k: v[0] for k, v in FPG.stats().items()}
        # the Miller loop of a general (P, Q) pair from its warp programs'
        # products (finish_programs.miller_runs): P's coefficients, the
        # doubling with the 36-product square and the sparse line product,
        # the addition with Q affine; P and Q in (7), f out (12)
        self.miller = 7 + sum(n[k] * c for k, c in FPG.miller_runs()) + 12
        # rlc_finish's tail, from its warp programs' products
        # (gpu/finish_programs.py): the Miller loop of (−g1, Σ) with P's
        # constants folded, its product with the f terms; the final
        # exponentiation with the Fp12 inverse through its norms and a
        # Euclid inversion (no multiplies; 2 products back into Montgomery
        # form) and cyclotomic squares in the hard part
        # (finish_programs.tail_runs)
        runs = [n[k] * c for k, c in FPG.tail_runs()]
        self.miller_rlc = sum(runs[:4])
        self.final_exp = sum(runs[4:]) + 2

    def aggregate(self, counts, r01):
        total = 0
        for c, (r0, r1) in zip(counts, r01):
            total += 2 * c + self.add1 * max(0, c - 128)
            live = min(c, 128)
            s = 64
            while s:  # tree adds where both partials are live
                total += self.add1 * max(0, min(s, live - s))
                live = min(live, s)
                s //= 2
            adds = bin(r0).count("1") + bin(r1).count("1")
            total += 32 * self.dbl1 + self.add1 * max(0, adds - 1) + 2 + 3
            total += 3 * (32 * self.dbl1 + self.madd1 * max(0, adds - 1))
            total += 4 + 6 + 4
        return total

    def subgroup(self, live):
        """g2_subgroup_check over `live` rows that are not ∞."""
        return live * (4 + self.psi)

    def multi(self, r01, sig_live):
        """multi_rlc_scale: per set the G1 ladder from an affine key and,
        on live signature rows, the G2 ladder (3 Fp products an Fp2 one)."""
        total = 0
        for (r0, r1), live in zip(r01, sig_live):
            adds = bin(r0).count("1") + bin(r1).count("1")
            ladder = 32 * self.dbl1 + self.madd1 * max(0, adds - 1)
            total += 2 + 2 + ladder + 3
            total += 6 + (4 + 4 + 3 * ladder if live else 0)
        return total

    def finish(self, groups):
        """rlc_finish over its live groups only, (f terms, signature terms)
        each, at the least work the function needs, whatever the launch:
        each term's conversion, nf − 1 Fp12 products and ns − 1 complete
        additions, the Miller loop of (−g1, Σ) with its conversion and its
        product with the f terms (none without f terms), the final
        exponentiation. A dead group costs nothing."""
        total = 0
        for nf, ns in groups:
            if not (nf or ns):
                continue
            total += (nf * 12 + ns * 6 + max(0, nf - 1) * self.fp12
                      + self.add1 * 3 * max(0, ns - 1)
                      + ((self.miller_rlc - (0 if nf else self.fp12))
                         if ns else 0)
                      + self.final_exp)
        return total

    def partial(self, spans):
        """rlc_partial at the function's least work: each Fp12 term's
        conversion, nf − 1 Fp12 products a group and its output
        conversion."""
        return sum(nf * 12 + max(0, nf - 1) * self.fp12 + 12 for nf in spans)

    def group_sum(self, counts, k=1):
        """g1_group_sum (k = 1) or g2_group_sum (k = 2) at the function's
        least work: each member row's conversion, members − 1 complete
        additions a group (in G2 three Fp products to each Fp2 one), the
        output conversion."""
        f = 1 if k == 1 else 3
        return sum(3 * k * c + f * self.add1 * max(0, c - 1) + 3 * k
                   for c in counts)

    def sign(self, d, live):
        """batch_sign over its live rows at the function's least work with
        the base-|x| digits: per row the conversions in (4), the bases
        (−ψ)ⁱ(H) (three maps of two Fp2 products), 64 doublings and
        Σ popcount(dᵢ) − 1 mixed additions in Fp2 (three Fp products to
        each Fp2 one), the conversion out (6); the branchless lanes'
        discarded candidates and duplicated doublings are not charged.
        d: (N, 4, 2) uint32 words."""
        total = 0
        for row, lv in zip(d, live):
            if lv:
                adds = sum(bin(int(w) & 0xFFFFFFFF).count("1")
                           for w in row.reshape(-1))
                total += (4 + 3 * 2 * self.fp2 + 3 * (
                    64 * self.dbl1 + self.madd1 * max(0, adds - 1)) + 6)
        return total

    def sign_glv(self, d, live, abs_x, decompose_glv):
        """The bound of the one-thread GLV ladder: the same rows' secrets
        (Σ dᵢ|x|ⁱ) by their GLV halves — the conversions and the
        endomorphism, 128 doublings and popcount(k0) + popcount(k1) − 1
        mixed additions in Fp2."""
        total = 0
        for row, lv in zip(d, live):
            if lv:
                w = [int(v) & 0xFFFFFFFF for v in row.reshape(-1)]
                sk = sum((w[2 * i] | w[2 * i + 1] << 32) * abs_x ** i
                         for i in range(4))
                a, _, b, _ = decompose_glv(sk)
                adds = bin(a).count("1") + bin(b).count("1")
                total += (4 + 4 + 3 * (128 * self.dbl1
                                       + self.madd1 * max(0, adds - 1)) + 6)
        return total

    def kzg(self, k, inf, x2):
        """g1_scalar_mul at the function's least work with the halves
        k = k1·x² + k0: per live row the conversions in (2), φ (2), 128
        doublings and popcount(k0) + popcount(k1) − 1 mixed additions, the
        conversion out (3); k = 0 or an ∞ base only the conversion out.
        k: (N, 8) uint32 words."""
        total = 0
        for row_k, row_inf in zip(k, inf):
            v = int.from_bytes(row_k.tobytes(), "little")
            k1, k0 = divmod(v, x2)
            adds = bin(k0).count("1") + bin(k1).count("1")
            total += 3 + ((2 + 2 + 128 * self.dbl1 + self.madd1 * (adds - 1))
                          if v and not row_inf else 0)
        return total

    def kzg_one_ladder(self, k, inf):
        """The bound of the one 255-bit ladder: 255 doublings and
        popcount(k) − 1 mixed additions a live row."""
        total = 0
        for row_k, row_inf in zip(k, inf):
            v = int.from_bytes(row_k.tobytes(), "little")
            total += 3 + ((2 + 255 * self.dbl1 + self.madd1 * (
                bin(v).count("1") - 1)) if v and not row_inf else 0)
        return total

    def pubkey(self, k):
        """batch_pubkey at the function's least work, the fixed-base comb:
        per key (the nonzero 4-bit digits of both GLV halves − 1) mixed
        additions of table entries, all of which one accumulator can do
        as mixed additions (the lanes' join is one of them, done as a
        complete addition), and the output conversion; no doubling (the
        table holds every window's multiples of g1 and [λ]g1)."""
        total = 0
        for row in k:
            digits = sum(((int(w) & 0xFFFFFFFF) >> s) & 15 != 0
                         for w in row.reshape(-1) for s in range(0, 32, 4))
            total += self.madd1 * max(0, digits - 1) + 3
        return total

    def pubkey_ladder(self, k):
        """The bound of the dual GLV ladder the comb replaced: per key the
        endomorphism (2 products), 128 doublings and popcount(k0) +
        popcount(k1) − 1 mixed additions, the output conversion."""
        total = 0
        for row in k:
            adds = sum(bin(int(w) & 0xFFFFFFFF).count("1")
                       for w in row.reshape(-1))
            total += 2 + 128 * self.dbl1 + self.madd1 * max(0, adds - 1) + 3
        return total

    def normalize(self, live, k=1):
        """g1_normalize (k = 1) or g2_normalize (k = 2) over `live` rows
        that are not ∞ (an ∞ row needs no inversion): the conversions in
        and out, one inversion (in G2 through the norm: two squares and
        two products around it), z⁻², z⁻³ and the two products."""
        per = (3 + self.inv + 4 + 2) if k == 1 else (
            6 + (2 + self.inv + 2) + 4 * self.fp2 + 4)
        return live * per

    def msm_scan(self, k, entries, phis, flushes):
        """msm_lane_scan at the data's work: a mixed addition (the point
        loaded is affine) and the conversion of x, y into Montgomery form
        for each live entry, the endomorphism's products for each r1
        entry, the conversion out of each flushed sum (an Fp2 product is
        three Fp products)."""
        f = 1 if k == 1 else self.fp2
        return entries * (self.madd1 * f + 2 * k) + phis * 2 * k + \
            flushes * 3 * k

    def msm_reduce(self, k, piece_adds, pieces, n_sec, digits):
        """msm_bucket_reduce at the function's least work: each valid
        piece's conversion, the additions that fold a digit's pieces
        (pieces − 1 a digit that has any), then per section Σ_{d≥1} d·S_d
        by the running sum over the B − 1 digits (2·(B − 2) additions)
        and the total's conversion; the kernel's Hillis–Steele suffix and
        tree (B·w additions) are not charged."""
        f = 1 if k == 1 else self.fp2
        return pieces * 3 * k + piece_adds * self.add1 * f + \
            n_sec * (2 * max(0, digits - 2) * self.add1 * f + 3 * k)

    def msm_horner(self, k, groups, windows, w):
        """msm_horner at the function's least work: per group w doublings
        and one addition a window below the top (the sum starts at the
        top window's total), the conversion of each window's total, and
        the output's conversion."""
        f = 1 if k == 1 else self.fp2
        return groups * ((windows - 1) * (w * self.dbl1 + self.add1) * f
                         + windows * 3 * k + 3 * k)

    @staticmethod
    def unpack(n):
        """unpack_words over n coordinates: three Montgomery products in
        (lo·R², hi·R², ·R²) and one out."""
        return 4 * n


def bound_ms(fp_muls, nbytes, sms, clock_hz, muls_per=MULS_PER_FP_MUL):
    """The larger of the operations' time (field products × `muls_per`
    int32 multiplies at the card's rate) and the bytes' (at HBM rate)."""
    ops_s = fp_muls * muls_per / (INT32_MUL_PER_CLK_SM * sms * clock_hz)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def finish_shape(record):
    """(Fp12 terms, signature terms) of each group of a recorded rlc_finish
    call, and its bytes (each input read once, each verdict written
    once)."""
    import numpy as np

    (_f, _rsig, _ai, _ok, _sub, fo, so), _verdict = record
    groups = list(zip(np.diff(fo).tolist(), np.diff(so).tolist()))
    nf, ns = int(fo[-1] - fo[0]), int(so[-1] - so[0])
    return groups, (nf * (576 + 1) + ns * (288 + 2) + 8 * len(groups)
                    + len(groups))


def finish_plain_batched(B, torch, np, calls, padded_terms=8192):
    """The plain rlc_finish verdicts of several calls (rlc_finish's
    operands, offsets resolved or not), their groups side by side in a few
    plain calls. A group's verdict is exact field arithmetic on its own
    terms, whatever the call's thread count, so each equals its own call's
    plain verdict; the plain final exponentiation runs once a batch
    instead of once a call. The plain trees pad every group of a call to
    its widest, so calls are taken in order of width and a batch holds at
    most `padded_terms` padded terms. Returns one verdict tensor a call."""
    calls = [finish_operands(*call) for call in calls]

    def width(call):
        fo, so = call[5], call[6]
        return max(1, int(np.diff(fo).max(initial=0)),
                   int(np.diff(so).max(initial=0)))

    batches, cur, groups = [], [], 0
    for i in sorted(range(len(calls)), key=lambda i: width(calls[i])):
        g = len(calls[i][5]) - 1
        if cur and (groups + g) * width(calls[i]) > padded_terms:
            batches.append(cur)
            cur, groups = [], 0
        cur.append(i)
        groups += g
    if cur:
        batches.append(cur)
    out = [None] * len(calls)
    for batch in batches:
        parts, fo_all, so_all, sizes = [], [0], [0], []
        for i in batch:
            f, rsig, agg_inf, sig_ok, sig_sub, fo, so = calls[i]
            f0, f1, s0, s1 = int(fo[0]), int(fo[-1]), int(so[0]), int(so[-1])
            parts.append((f[f0:f1], rsig[s0:s1], agg_inf[f0:f1],
                          sig_ok[s0:s1], sig_sub[s0:s1]))
            fo_all += (np.asarray(fo[1:]) - f0 + fo_all[-1]).tolist()
            so_all += (np.asarray(so[1:]) - s0 + so_all[-1]).tolist()
            sizes.append(len(fo) - 1)
        verdicts = B.rlc_finish_plain(*(torch.cat(c) for c in zip(*parts)),
                                      np.array(fo_all), np.array(so_all))
        for i, v in zip(batch, torch.split(verdicts, sizes)):
            out[i] = v
    return out


def finish_edge_calls(torch, np, L, P, fin):
    """rlc_finish edge calls from one call's operands `fin` (f, rsig,
    agg_inf, sig_ok, sig_sub; rows tiled as needed): f terms only (the KZG
    shape), signature terms only, an ∞ signature sum (a row and its
    negation), spans 1, 8, 9, 128 and 129 (one warp a group, four warps,
    a second f term a thread) and the 2,048-group per-item rung. Returns
    [(where, operands with offsets)]."""
    f, rsig, agg_inf, ok, sub = fin
    n = f.shape[0]
    dev = f.device

    def tiled(nf, ns, groups=1):
        fi = torch.arange(nf * groups, device=dev) % n
        si = torch.arange(ns * groups, device=dev) % n
        return (f[fi], rsig[si], agg_inf[fi], ok[si], sub[si],
                np.arange(groups + 1) * nf, np.arange(groups + 1) * ns)

    neg = rsig[:2].clone()
    neg[1] = rsig[0]
    y = L.words_to_ints(rsig[0, 1].cpu().numpy())
    neg[1, 1] = torch.from_numpy(
        L.ints_to_words([(P - v) % P for v in y]).astype(np.int32)).to(dev)
    inf_sum = (f[:3], neg, agg_inf[:3], ok[:2], sub[:2], [0, 3], [0, 2])
    calls = [("f terms only (4)", tiled(4, 0)),
             ("signature terms only (5)", tiled(0, 5)),
             ("an ∞ signature sum", inf_sum)]
    calls += [(f"span {k}", tiled(k, k)) for k in (1, 8, 9, 128, 129)]
    calls.append(("the per-item rung, 2,048 groups of 1", tiled(1, 1, 2048)))
    return calls


def miller_operands(rpk, msg, inf):
    """A Recorder's `operands` for miller_loop_pairs: its inputs, cloned."""
    return rpk.clone(), msg.clone(), inf.clone()


def aggregate_operands(src_x, src_y, idx, cnt, sig_x, sig_y, sig_mask, r01):
    """A Recorder's `operands` for aggregate_rlc_scale: each aggregate's
    member rows gathered and cloned (a later write into the gather source
    cannot change what the check sees), the rest cloned."""
    rows = idx.long()
    return (src_x[rows].clone(), src_y[rows].clone(), cnt.clone(),
            sig_x.clone(), sig_y.clone(), sig_mask.clone(), r01.clone())


def check_pairing_launches(torch, B, TP, recs, same, dev):
    """Every recorded launch of miller_loop_pairs and aggregate_rlc_scale
    against the plain version: rows are independent, so the launches'
    rows are stacked (aggregates grouped by their gather width, at least
    PLAIN_AGG_WIDTH with zero rows past cnt, their member rows as the
    source) and held against a few batched plain calls of at most
    PLAIN_CHUNK_PAIRS pairs or PLAIN_CHUNK_AGGS aggregates."""
    for rec in recs:
        if not rec.calls:
            fail(f"{rec.name}: no launch recorded")
        t0 = time.perf_counter()
        if rec.name == "miller_loop_pairs":
            ins = [torch.cat([a[i].to(dev) for a, _ in rec.calls])
                   for i in range(3)]
            got = torch.cat([o.to(dev) for _, o in rec.calls])
            n, step = got.shape[0], PLAIN_CHUNK_PAIRS
            for c0 in range(0, n, step):
                same(rec.name, got[c0:c0 + step], TP.miller_loop_pairs_plain(
                    *(a[c0:c0 + step] for a in ins)),
                     f"every launch of phases 3-14: {len(rec.calls)} "
                     f"launches, pairs {c0}-{min(n, c0 + step) - 1} of {n}")
            log(f"check {rec.name}: {len(rec.calls)} launches, {n} pairs, in "
                f"{time.perf_counter() - t0:.1f} s")
            continue
        by_k = {}
        for (mx, my, *rest), out in rec.calls:
            k = max(mx.shape[1], PLAIN_AGG_WIDTH)
            pad = (0, 0, 0, k - mx.shape[1])
            by_k.setdefault(k, []).append((
                (torch.nn.functional.pad(mx, pad),
                 torch.nn.functional.pad(my, pad), *rest), out))
        total = 0
        for k, calls in sorted(by_k.items()):
            ins = [torch.cat([a[i].to(dev) for a, _ in calls])
                   for i in range(7)]
            outs = [torch.cat([o[i].to(dev) for _, o in calls])
                    for i in range(3)]
            m, step = outs[0].shape[0], PLAIN_CHUNK_AGGS
            total += m
            for c0 in range(0, m, step):
                mx, my, cnt, gx, gy, mask, r01 = (a[c0:c0 + step]
                                                 for a in ins)
                mc = mx.shape[0]
                idx = torch.arange(mc * k, dtype=torch.int32,
                                   device=dev).reshape(mc, k)
                same(rec.name, tuple(o[c0:c0 + step] for o in outs),
                     B.aggregate_rlc_scale_plain(
                         mx.reshape(-1, 12), my.reshape(-1, 12), idx, cnt,
                         gx, gy, mask, r01),
                     f"every launch of phases 3-14 at gather width {k}: "
                     f"{len(calls)} launches, aggregates {c0}-"
                     f"{min(m, c0 + step) - 1} of {m}")
        log(f"check {rec.name}: {len(rec.calls)} launches, {total} "
            f"aggregates, in {time.perf_counter() - t0:.1f} s")


def multi_operands(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """A Recorder's `operands` for multi_rlc_scale: each set's key row
    gathered and cloned, the rest cloned."""
    rows = idx.long()
    return (src_x[rows].clone(), src_y[rows].clone(), sig_x.clone(),
            sig_y.clone(), sig_mask.clone(), r01.clone())


def group_operands(rows, offsets):
    """A Recorder's `operands` for g1_group_sum / g2_group_sum."""
    return rows.clone(), [int(v) for v in offsets]


def group_geometry(B, k, offsets):
    """The launches of a g1_group_sum (k = 1) or g2_group_sum (k = 2) call
    over `offsets`: its plan's passes, each one launch."""
    plan = B.group_sum_plan(offsets, B.group_tile(k))
    geos = [B.launch_geometry(f"g{k}_group_sum", t.shape[0]) for t in plan]
    # the plan's tile is the kernel's (csrc/multi.cu G2_GROUP_WARPS)
    if k == 2 and any(g[1] != 32 * B.group_tile(2) for g in geos):
        fail(f"g2_group_sum: the kernel's tile {geos[0][1]} threads, the "
             f"plan's {B.group_tile(2)} warps")
    return "; ".join(
        f"pass {i + 1}: {t.shape[0]} tiles, geometry (blocks, threads, "
        f"shared bytes, blocks an SM) {g}"
        for i, (t, g) in enumerate(zip(plan, geos)))


def check_group_launches(torch, B, recs, same, dev):
    """Every recorded launch of multi_rlc_scale, g1_group_sum and
    g2_group_sum against the plain version: sets are independent, and a
    group's sum does not depend on the groups beside it (a group done
    before the plan's last pass passes its one row through unchanged), so
    the launches' sets are stacked (at most PLAIN_CHUNK_SETS a plain call)
    and their groups stacked with the offsets shifted (at most
    PLAIN_CHUNK_ROWS rows a plain call)."""
    started = time.perf_counter()
    for rec in recs:
        if not rec.calls:
            fail(f"{rec.name}: no launch recorded")
        t0 = time.perf_counter()
        if rec.name == "multi_rlc_scale":
            ins = [torch.cat([a[i].to(dev) for a, _ in rec.calls])
                   for i in range(6)]
            outs = [torch.cat([o[i].to(dev) for _, o in rec.calls])
                    for i in range(2)]
            n, step = outs[0].shape[0], PLAIN_CHUNK_SETS
            for c0 in range(0, n, step):
                mx, my, gx, gy, mask, r01 = (a[c0:c0 + step] for a in ins)
                idx = torch.arange(mx.shape[0], dtype=torch.int32,
                                   device=dev)
                same(rec.name, tuple(o[c0:c0 + step] for o in outs),
                     B.multi_rlc_scale_plain(mx, my, idx, gx, gy, mask, r01),
                     f"every launch of phases 3-14: {len(rec.calls)} "
                     f"launches, sets {c0}-{min(n, c0 + step) - 1} of {n}")
            log(f"check {rec.name}: {len(rec.calls)} launches, {n} sets, in "
                f"{time.perf_counter() - t0:.1f} s")
            continue
        plain = getattr(B, rec.name + "_plain")
        batches, cur = [], []
        for call in rec.calls:
            if cur and sum(c[0][0].shape[0] for c in cur) + \
                    call[0][0].shape[0] > PLAIN_CHUNK_ROWS:
                batches.append(cur)
                cur = []
            cur.append(call)
        batches.append(cur)
        groups = 0
        for calls in batches:
            rows = torch.cat([r.to(dev) for (r, _), _ in calls])
            off, base = [0], 0
            for (r, o), _ in calls:
                off += [base + v for v in o[1:]]
                base += r.shape[0]
            got = torch.cat([out.to(dev) for _, out in calls])
            groups += got.shape[0]
            same(rec.name, got, plain(rows, off),
                 f"every launch of phases 3-14: {len(calls)} launches "
                 f"stacked, {rows.shape[0]} rows in {got.shape[0]} groups")
        log(f"check {rec.name}: {len(rec.calls)} launches, {groups} groups, "
            f"in {time.perf_counter() - t0:.1f} s")
    log(f"check_group_launches: {time.perf_counter() - started:.1f} s")


def kernel_spills(log, name):
    """(spill store bytes, spill load bytes) of the entries whose names
    hold `name`, summed, from a build log; None when none matches."""
    entry, found = None, {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            found[entry] = (int(m.group(1)), int(m.group(2)))
    hits = [v for k, v in found.items() if name in k]
    return (sum(v[0] for v in hits), sum(v[1] for v in hits)) if hits \
        else None


def kernel_ptxas(log, name):
    """(registers, cumulative stack bytes) of the entry whose name holds
    `name`, from a build log; ptxas prints no stack for an entry that
    calls nothing, which needs none (0). None when no entry matches."""
    entry, found = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            st = re.search(r"(\d+) bytes cumulative stack size", line)
            found[entry] = (int(m.group(1)), int(st.group(1)) if st else 0)
    hits = [v for k, v in found.items() if name in k]
    return max(hits, key=lambda v: v[1]) if hits else None


def finish_operands(f, rsig, agg_inf, sig_ok, sig_sub, f_off=None,
                    s_off=None):
    """A recorded rlc_finish call's operands with its offsets resolved."""
    from grandine_tpu_torch.gpu.bls import finish_groups

    fo, so, _, _ = finish_groups(f, rsig, f_off, s_off)
    return f, rsig, agg_inf, sig_ok, sig_sub, fo, so


def progression_points(h, a, d, indices, R):
    """(a + i·d)·h for each validator index i (keys in arithmetic
    progression): a·h, then successive G2 additions of 2^k·(d·h) over the
    gaps between sorted indices, so that no signature costs a scalar
    multiplication. {index: Jacobian point}."""
    step = [h.mul(d % R)]
    for _ in range(max(indices).bit_length()):
        step.append(step[-1].double())
    acc, prev, out = h.mul(a % R), 0, {}
    for i in sorted(indices):
        gap = i - prev
        k = 0
        while gap:
            if gap & 1:
                acc = acc + step[k]
            gap >>= 1
            k += 1
        out[i], prev = acc, i
    return out


class HeldLaunch(SimpleNamespace):
    """A timing row's stand-in for its plain call: `words`, the result of
    a launch on the row's operands that its phase already held against
    the plain version (`where`), so the row's launch must give them
    again. Only for a later shape of a kernel (its kernels-line entry
    timed at an earlier row)."""


class Recorder:
    """Stands in for a kernel wrapper of gpu/bls.py while a `with` block
    runs (the backend looks its wrappers up as module globals at call
    time) and keeps each call as (its operands normalised by `operands`,
    its result, normalised by `result` when given: a copy, where the
    caller writes into the result). The launch count stays the wrapped
    function's."""

    def __init__(self, module, name, operands, result=None):
        self.module, self.name, self.operands = module, name, operands
        self.result = result
        self.fn = getattr(module, name)
        self.calls = []

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((self.operands(*args, **kwargs),
                           out if self.result is None else self.result(out)))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def check_ladder_launches(torch, B, GK, recs, same):
    """Every recorded launch of batch_sign and g1_scalar_mul (Recorders
    keeping (args, kwargs)) against the plain version: the launches of one
    geometry (batch_sign's lanes) stacked along the rows, one plain call
    each — rows are independent, so each launch's words must reappear."""
    plain = {"batch_sign": (lambda *a, lanes: B.batch_sign_plain(*a, lanes),
                            lambda a, k: k.get("lanes") or B.sign_lanes(
                                a[1].shape[0])),
             "g1_scalar_mul": (lambda *a, lanes: GK.g1_scalar_mul_plain(*a),
                               lambda a, k: None)}
    for rec in recs:
        fn, key = plain[rec.name]
        groups = {}
        for (args, kwargs), out in rec.calls:
            groups.setdefault(key(args, kwargs), []).append((args, out))
        for g, calls in groups.items():
            stacked = [torch.cat([a[i] for a, _ in calls])
                       for i in range(len(calls[0][0]))]
            got = torch.cat([o for _, o in calls])
            at = "" if g is None else f" at lanes {g}"
            same(rec.name, got, fn(*stacked, lanes=g),
                 f"every launch of phases 7-9{at}: {len(calls)} launches, "
                 f"{got.shape[0]} rows")
        if not rec.calls:
            fail(f"{rec.name}: no launch recorded in phases 7-9")


class PassTimer:
    """The backend's two localization seams, each pass timed on the host
    clock from its dispatch to its settled, synchronized result, with the
    geometry of the finish launch that `finish` (a Recorder) saw last."""

    def __init__(self, backend, torch, finish, geometry):
        self.backend, self.torch = backend, torch
        self.finish, self.geometry = finish, geometry
        self.rows = []

    def _timed(self, kind, size, settle, t0):
        def run():
            out = settle()
            self.torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            geometry = None
            if kind == "partition":
                ops = self.finish.calls[-1][0]
                geometry = self.geometry(ops[0], ops[1], ops[5], ops[6])
            self.rows.append((kind, size, elapsed, geometry))
            return out
        return run

    def g2_subgroup_check_batch_async(self, points):
        t0 = time.perf_counter()
        return self._timed("subgroup", len(points),
                           self.backend.g2_subgroup_check_batch_async(points),
                           t0)

    def rlc_partition_verify_async(self, messages, signatures, member_keys,
                                   groups):
        t0 = time.perf_counter()
        return self._timed("partition", groups,
                           self.backend.rlc_partition_verify_async(
                               messages, signatures, member_keys, groups), t0)


class SignSplit(Recorder):
    """Recorder of gpu/bls.py `batch_sign` that also splits each
    `backend.batch_sign` call by the thread that makes it: host clocks
    around the backend's `_messages` (hash-to-G2) and the module's
    `sign_digits_host` (base-|x| digits), CUDA events around the launch,
    and the host clock from the launch's return to `g2_points_from_words`
    (device wait and copy) and from there to the call's end (readback into
    `Signature`s). `done[thread]` holds the thread's last finished split."""

    def __init__(self, module, backend):
        super().__init__(module, "batch_sign", lambda *a: a)
        self.backend, self.live, self.done = backend, {}, {}
        self.digits = module.sign_digits_host
        self.points = module.g2_points_from_words

    def _split(self):
        return self.live.get(threading.get_ident())

    def _messages(self, *args):
        t = time.perf_counter()
        out = self.messages(*args)
        if self._split() is not None:
            self._split()["hash_s"] = time.perf_counter() - t
        return out

    def _digits(self, *args):
        t = time.perf_counter()
        out = self.digits(*args)
        if self._split() is not None:
            self._split()["digits_s"] = time.perf_counter() - t
        return out

    def _points(self, *args):
        if self._split() is not None:
            self._split()["t_points"] = time.perf_counter()
        return self.points(*args)

    def _sign(self, messages, *args):
        me = threading.get_ident()
        self.live[me] = split = {"n": len(messages),
                                 "t0": time.perf_counter()}
        out = self.sign(messages, *args)
        end = time.perf_counter()
        del self.live[me]
        events = split.pop("events")
        self.done[me] = {
            "n": split["n"], "hash_s": split["hash_s"],
            "digits_s": split["digits_s"],
            "host_prep_s": split["t_in"] - split["t0"],
            "wait_s": split["t_points"] - split["t_out"],
            "readback_s": end - split["t_points"],
            "kernel_ms": (events[0].elapsed_time(events[1])
                          if events else None)}
        return out

    def __call__(self, msg, *args):
        split = self._split()
        torch = self.module.torch
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if msg.is_cuda else [])
        split["t_in"] = time.perf_counter()
        for e in events[:1]:
            e.record()
        out = super().__call__(msg, *args)
        for e in events[1:]:
            e.record()
        split["t_out"], split["events"] = time.perf_counter(), events
        return out

    def __enter__(self):
        super().__enter__()
        self.messages, self.sign = self.backend._messages, \
            self.backend.batch_sign
        self.backend._messages, self.backend.batch_sign = self._messages, \
            self._sign
        self.module.sign_digits_host = self._digits
        self.module.g2_points_from_words = self._points
        return self

    def __exit__(self, *exc):
        del self.backend._messages, self.backend.batch_sign
        self.module.sign_digits_host = self.digits
        self.module.g2_points_from_words = self.points
        super().__exit__(*exc)


class SignTimer:
    """The backend as the signing scheme's functions see it: times its
    batch_sign and multi_verify calls."""

    def __init__(self, backend):
        self.backend, self.sign_s, self.verify_s = backend, 0.0, 0.0

    def batch_sign(self, *args):
        t = time.perf_counter()
        out = self.backend.batch_sign(*args)
        self.sign_s = time.perf_counter() - t
        return out

    def multi_verify(self, *args):
        t = time.perf_counter()
        out = self.backend.multi_verify(*args)
        self.verify_s = time.perf_counter() - t
        return out


def timed_signing_scheme(schemes, records, split):
    """A twin of the `bls` scheme row whose batch_sign and release gate are
    the row's own functions, timed: one record a batch in `records` (the
    split of the backend's call that `split`, a SignSplit, took, its
    encoding, the gate's host decode and device verify)."""

    base = schemes.get("bls")
    pending = {}

    def batch_sign(backend, messages, secret_keys):
        timer = SignTimer(backend)
        t = time.perf_counter()
        out = base.signing.batch_sign(timer, messages, secret_keys)
        total = time.perf_counter() - t
        me = threading.get_ident()  # the plane's watchdog thread
        entry = split.done.pop(me)
        # the gate gets the same list of messages from the same batch
        pending[id(messages)] = dict(entry, encode_s=total - timer.sign_s)
        return out

    def release_verify(backend, messages, sig_bytes, public_keys):
        timer = SignTimer(backend)
        t = time.perf_counter()
        ok = base.signing.release_verify(timer, messages, sig_bytes,
                                         public_keys)
        total = time.perf_counter() - t
        records.append(dict(pending.pop(id(messages)),
                            decode_s=total - timer.verify_s,
                            verify_s=timer.verify_s))
        return ok

    twin = schemes.Scheme("bls", field_bits=base.field_bits, curve=base.curve,
                          make_backend=base.make_backend,
                          host_check=base.host_check,
                          device_dispatch=base.device_dispatch,
                          async_seam=base.async_seam,
                          kernel_label=base.kernel_label, canary=base.canary,
                          signing=schemes.SigningDescriptor(
                              batch_sign=batch_sign,
                              host_sign=base.signing.host_sign,
                              release_verify=release_verify))
    return base, twin


def plane_totals(plane):
    """The plane's counters summed over its lanes."""
    out = {}
    for st in plane.stats().values():
        for k, v in st.items():
            out[k] = max(out.get(k, 0), v) if k == "max_batch_items" \
                else out.get(k, 0) + v
    return out


def signing_phase(c):
    """The signing path on the operator's keys (c: what main() built).
    Returns (timing rows, {entry: launches on its path})."""
    torch, np, A, B = c.torch, c.np, c.A, c.B
    from grandine_tpu_torch.crypto.curves import decompose_glv, g2_infinity
    from grandine_tpu_torch.gpu import schemes
    from grandine_tpu_torch.runtime.sign_plane import (
        DEFAULT_SIGN_LANES, SigningPlane)
    from grandine_tpu_torch.testing.chaos import ChaosBackend, FaultPlan
    from grandine_tpu_torch.validator.duties import device_aggregator

    dev, at, R, dst = c.dev, c.at, c.R, c.dst

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def one_launch_ms(fn, args):
        """One more launch of `fn` on `args`, timed by CUDA events."""
        if dev.type != "cuda":
            return None
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    def kernel_ms(rec):
        ms = rec["kernel_ms"]
        return "not measured (no card)" if ms is None else f"{ms:.3f} ms"

    def geometry(name, n):
        if dev.type != "cuda":
            return "geometry not measured (no card)"
        if name.endswith("group_sum"):  # n: the offsets
            return group_geometry(B, 1 + name.startswith("g2"), n)
        blocks, threads, smem, per_sm = B.launch_geometry(name, n)
        waves = -(-blocks // (per_sm * c.sms)) if per_sm else 0
        lanes = (f"{B.sign_lanes(n)} lanes a signature, "
                 if name == "batch_sign" else "")
        return (f"{lanes}{blocks} blocks of {threads} threads, {smem} B "
                f"shared memory, {per_sm} blocks an SM, {waves} wave(s) on "
                f"{c.sms} SMs")

    # the kernels against their plain versions on edge rows; batch_sign at
    # each geometry, each call launched EDGE_REPEATS times with the same
    # words (a missing warp synchronisation shows as a word that moves)
    ax = B.ABS_X
    edge_scalars = [1, R - 1, R - 2, ax - 1, ax, ax ** 3, 5 + 9 * ax ** 3,
                    7 + 3 * ax ** 2] + c.sks[:24]
    d_e = B.sign_digits_host(edge_scalars)
    dw = d_e.view(np.uint32)
    if not ((dw == 0).all(-1).any() and (dw[:, :, 0] == (ax - 1) & 0xFFFFFFFF)
            .any()):
        fail("the edge keys do not hold zero digits and the digit |x| - 1")
    probe = B.TorchBlsBackend(device=dev)
    msg_e, inf_e = probe._messages(
        [c.roots[i % len(c.roots)] for i in range(len(edge_scalars))], dst)
    inf_e = inf_e.clone()
    inf_e[[1, 17]] = True
    args = (msg_e, inf_e, torch.from_numpy(d_e).to(dev))
    for lanes in (4, 2, 1):
        got = [B.batch_sign(*args, lanes=lanes) for _ in range(EDGE_REPEATS)]
        if not all(torch.equal(got[0], g) for g in got[1:]):
            fail(f"batch_sign at {lanes} lane(s): a word moved between "
                 f"{EDGE_REPEATS} launches on the same edge rows")
        c.same("batch_sign", got[0], B.batch_sign_plain(*args, lanes),
               f"edge rows at {lanes} lane(s) a signature ({EDGE_REPEATS} "
               f"launches, the same words): {len(edge_scalars)} signatures, "
               f"∞ messages (rows 1, 17), sk = 1, r - 1, r - 2, |x| - 1, "
               f"|x|, |x|^3, zero digits")
    first12 = sorted(c.unagg_pts)[:12]
    g2_pts = [c.unagg_pts[i][1] for i in first12] + [g2_infinity()] * 2
    g1_pts = [c.keys[i].point for i in first12] + [
        A.PublicKey.aggregate([]).point] * 2
    off_e = [0, 0, 12, 14, 15, 150, 151, 300]
    for name, pts, k in (("g2_group_sum", g2_pts, 2), ("g1_group_sum", g1_pts,
                                                       1)):
        rows = torch.from_numpy(B.jacobian_rows(
            [pts[i % 14] for i in range(300)], k)).to(dev)
        c.same(name, getattr(B, name)(rows, off_e),
               getattr(B, name + "_plain")(rows, off_e),
               f"edge groups {off_e}: empty, all-∞ (12:14), single members, "
               f"past 128 rows, ∞ rows inside")

    # the operator slot through the plane: the duty validators attest
    # their committee's root, the sync committee signs the head root
    order = sorted(c.unagg_pts, key=lambda i: (c.unagg_pts[i][0], i))
    requests = ([("attestation", c.roots[c.unagg_pts[i][0]], i)
                 for i in order]
                + [("sync_message", c.sync_root, i) for i in c.sync_members])
    t0 = time.perf_counter()
    anchors = [A.g2_to_bytes(c.unagg_pts[i][1] if lane == "attestation"
                             else c.s_pts[i]) for lane, _, i in requests]
    secret = {i: A.SecretKey(c.sks[i]) for _, _, i in requests}
    log(f"host prep: {len(requests)} anchors of the operator slot by G2 "
        f"additions (above), encoded: {time.perf_counter() - t0:.1f} s "
        f"(host, not device)")
    records = []
    sign_backend = B.TorchBlsBackend(device=dev)
    lane_rec = SignSplit(B, sign_backend)
    base, twin = timed_signing_scheme(schemes, records, lane_rec)
    rounds = []

    def sign_round(plane):
        sync()
        t0 = time.perf_counter()
        tickets = [plane.submit(root, secret[i], duty_kind=lane,
                                public_key=c.keys[i])
                   for lane, root, i in requests]
        out = [t.result(300.0) for t in tickets]
        elapsed = time.perf_counter() - t0
        bad = [j for j, (o, a) in enumerate(zip(out, anchors)) if o != a]
        if bad:
            fail(f"operator slot: {len(bad)} released signatures differ from "
                 f"their anchors (first {bad[:5]})")
        return elapsed

    schemes.register(twin)
    c.count_reset()
    plane = SigningPlane(backend=sign_backend, lanes=DEFAULT_SIGN_LANES,
                         device=dev, settle_timeout_s=c.settle_timeout_s)
    try:
        with lane_rec:
            warm_s = sign_round(plane)
            del records[:]
            rounds = [sign_round(plane) for _ in range(c.sign_rounds)]
        totals = plane_totals(plane)
        health = plane.health.state
        duty = plane.flight.duty_cycle()
    finally:
        plane.stop()
        schemes.register(base)
    plane_launches = c.count_read()
    p50 = statistics.median(rounds)
    log(f"operator slot through SigningPlane (DEFAULT_SIGN_LANES, release "
        f"gate on): {len(order)} attestations over {len(c.roots)} roots + "
        f"{len(c.sync_members)} sync messages a round; warm round "
        f"{warm_s * 1e3:.1f} ms, then {c.sign_rounds} rounds p50 "
        f"{p50 * 1e3:.1f} ms ({', '.join(f'{r * 1e3:.1f}' for r in rounds)}); "
        f"{len(requests) / p50:.1f} released signatures/s; every released "
        f"signature equals its anchor byte for byte; plane duty cycle "
        f"{duty:.3f} {at}")
    log(f"plane counters: {json.dumps(totals)}; breaker {health}")
    log(f"launches on the signing path ({1 + c.sign_rounds} rounds): "
        f"{json.dumps(plane_launches)}")
    for key in ("degraded", "device_faults", "breaker_skips", "expired",
                "gate_failures", "dropped", "refused"):
        if totals[key]:
            fail(f"operator slot: {key} = {totals[key]} (0 required)")
    if totals["device_batches"] != totals["batches"] or health != "closed":
        fail(f"operator slot: not every batch ran on the device ({totals}, "
             f"breaker {health})")
    # the release gate's multi_verify of a lane batch (many signers over
    # few roots) takes the grouped route: the bucket MSM, no ladder
    for name in ("batch_sign", "msm_lane_scan", "msm_bucket_reduce",
                 "msm_horner", "miller_loop_pairs", "rlc_finish",
                 "g2_subgroup_check"):
        if plane_launches[name] < 1:
            fail(f"a kernel of the signing path was not launched: {name}")
    for r in records:
        share = r["decode_s"] + r["verify_s"]
        log(f"  sign batch of {r['n']}: host prep {r['host_prep_s'] * 1e3:.1f}"
            f" ms (hash-to-G2 {r['hash_s'] * 1e3:.1f} ms, base-|x| digits "
            f"{r['digits_s'] * 1e3:.1f} ms, upload), kernel "
            f"{kernel_ms(r)} (CUDA events), device wait "
            f"{r['wait_s'] * 1e3:.1f} ms, readback {r['readback_s'] * 1e3:.1f}"
            f" ms + encoding {r['encode_s'] * 1e3:.1f} ms; gate: host decode "
            f"{r['decode_s'] * 1e3:.1f} ms + device verify "
            f"{r['verify_s'] * 1e3:.1f} ms ({share * 1e3:.1f} ms) {at}")
    gate = sum(r["decode_s"] + r["verify_s"] for r in records)
    sign = sum(r["host_prep_s"] + r["wait_s"] + r["readback_s"]
               + r["encode_s"] for r in records)
    busy = sum((r["kernel_ms"] or 0.0) / 1e3 + r["verify_s"]
               for r in records) / c.sign_rounds
    log(f"signing batches of the {c.sign_rounds} timed rounds: sign "
        f"{sign * 1e3:.1f} ms, gate {gate * 1e3:.1f} ms in all (gate share "
        f"{gate / (gate + sign):.3f}; two workers overlap batches); device "
        f"busy at most {busy * 1e3:.1f} ms a round (batch_sign by CUDA events "
        f"+ the gate's whole multi_verify call), idle share at least "
        f"{1 - busy / p50:.3f} {at}")
    lane_ops = next(a for a, _ in lane_rec.calls
                    if a[1].shape[0] == max(x[1].shape[0]
                                            for x, _ in lane_rec.calls))
    log(f"  batch_sign launch at {lane_ops[1].shape[0]} rows: "
        f"{geometry('batch_sign', lane_ops[1].shape[0])}")

    # a sample through the card against SecretKey.sign, sk = 1, r − 1, r − 2
    sample = [1, R - 1, R - 2] + [c.sks[i] for i in order[::128][:13]]
    sample_msgs = [c.roots[j % len(c.roots)] for j in range(len(sample))]
    got = sign_backend.batch_sign(sample_msgs,
                                  [A.SecretKey(v) for v in sample])
    t0 = time.perf_counter()
    want = [A.SecretKey(v).sign(m).to_bytes()
            for v, m in zip(sample, sample_msgs)]
    host_sign_s = (time.perf_counter() - t0) / len(sample)
    if [s.to_bytes() for s in got] != want:
        fail("a sampled signature differs from SecretKey.sign")
    log(f"sample of {len(sample)} (sk = 1, r - 1, r - 2 and slot keys) "
        f"through TorchBlsBackend.batch_sign: equal to SecretKey.sign; host "
        f"sk.sign {host_sign_s * 1e3:.1f} ms a signature (host)")

    # aggregate construction: committee aggregates, sync subcommittee
    # contributions, committee aggregate keys
    com_sorted = [sorted(com) for com in c.committees]
    sub = len(c.sync_members) // 4  # 4 sync subcommittees
    groups = {
        "committee aggregates": [[A.Signature(c.unagg_pts[i][1]) for i in com]
                                 for com in com_sorted],
        "sync contributions": [[A.Signature(c.s_pts[i]) for i in
                                c.sync_members[j * sub:(j + 1) * sub]]
                               for j in range(4)],
    }
    key_groups = [[c.keys[i] for i in com] for com in com_sorted]
    aggregator = device_aggregator(device=dev)
    c.count_reset()
    agg_rows = {}
    with Recorder(B, "g2_group_sum", lambda rows, off: (rows, list(off))) \
            as rec2, Recorder(B, "g1_group_sum",
                              lambda rows, off: (rows, list(off))) as rec1:
        for where, grp in groups.items():
            sync()
            t0 = time.perf_counter()
            out = aggregator(grp)
            agg_rows[where] = (time.perf_counter() - t0, grp, out)
        sync()
        t0 = time.perf_counter()
        out_k = B.g1_aggregate_groups(key_groups, device=dev)
        agg_rows["committee aggregate keys"] = (time.perf_counter() - t0,
                                                key_groups, out_k)
    agg_launches = c.count_read()
    for (where, (secs, grp, out)), (ops_r, _) in zip(
            agg_rows.items(), rec2.calls + rec1.calls):
        host = [type(grp[0][0]).aggregate(g).to_bytes() for g in grp]
        if [a.to_bytes() for a in out] != host:
            fail(f"aggregate construction, {where}: differs from the host "
                 f"aggregate")
        name = "g2_group_sum" if where != "committee aggregate keys" \
            else "g1_group_sum"
        k_ms = one_launch_ms(getattr(B, name), ops_r)
        split = ("kernel not measured (no card)" if k_ms is None else
                 f"host conversion {secs * 1e3 - k_ms:.1f} ms + kernel "
                 f"{k_ms:.3f} ms (CUDA events, the recorded launch again)")
        log(f"aggregate construction, {where}: {len(grp)} groups of "
            f"{min(map(len, grp))}-{max(map(len, grp))} equal the host "
            f"aggregates; {secs * 1e3:.1f} ms through the seam = {split}; "
            f"{name} launch: {geometry(name, ops_r[1])} {at}")
    log(f"launches of aggregate construction: {json.dumps(agg_launches)}")
    if agg_launches["g2_group_sum"] != 2 or agg_launches["g1_group_sum"] != 1:
        fail(f"aggregate construction launches {agg_launches}")

    # a chaos round: a wrong signature from the card is never released
    signers = sorted(c.committees[0])[:c.chaos_signers]
    chaos = ChaosBackend(B.TorchBlsBackend(device=dev),
                         FaultPlan(script=["wrong_signature"]))
    plane = SigningPlane(backend=chaos, device=dev,
                         settle_timeout_s=c.settle_timeout_s)
    try:
        tickets = [plane.submit(c.roots[0], A.SecretKey(c.sks[i]),
                                duty_kind="attestation", public_key=c.keys[i])
                   for i in signers]
        out = [t.result(300.0) for t in tickets]
        totals = plane_totals(plane)
    finally:
        plane.stop()
    bad = sum(o != A.g2_to_bytes(c.unagg_pts[i][1])
              for o, i in zip(out, signers))
    log(f"chaos round (wrong_signature on the first batch_sign): "
        f"{len(signers)} signatures, {bad} differ from their anchors; "
        f"gate_failures {totals['gate_failures']}, degraded "
        f"{totals['degraded']}, device batches {totals['device_batches']} of "
        f"{totals['batches']}")
    if bad or totals["gate_failures"] != 1 or totals["degraded"] != 1 or \
            chaos.plan.injected["wrong_signature"] != 1:
        fail("the chaos round released a bad signature or miscounted")

    # one full bucket: MAX_BUCKET registry keys over the slot's roots
    n_full = c.full_bucket
    full = B.TorchBlsBackend(device=dev)
    msgs_f = [c.roots[i % len(c.roots)] for i in range(n_full)]
    full.batch_sign(c.roots, [A.SecretKey(v) for v in c.sks[:len(c.roots)]])
    sks_f = [A.SecretKey(c.sks[i]) for i in range(n_full)]
    with SignSplit(B, full) as full_rec:
        sync()
        c.count_reset()
        t0 = time.perf_counter()
        out = full.batch_sign(msgs_f, sks_f)
        full_s = time.perf_counter() - t0
        full_launches = c.count_read()["batch_sign"]
    t0 = time.perf_counter()
    want_pts = [None] * n_full
    for j, h in enumerate(c.hpts):
        idx = list(range(j, n_full, len(c.roots)))
        for i, pt in progression_points(h, c.a0, c.d0, idx, R).items():
            want_pts[i] = pt
    same_words = np.array_equal(B.jacobian_rows([s.point for s in out], 2),
                                B.jacobian_rows(want_pts, 2))
    anchor_s = time.perf_counter() - t0
    r = full_rec.done[threading.get_ident()]
    log(f"full bucket: TorchBlsBackend.batch_sign of {n_full} registry keys "
        f"over {len(c.roots)} roots ({full_launches} launch): "
        f"{full_s * 1e3:.1f} ms = host prep {r['host_prep_s'] * 1e3:.1f} ms "
        f"(hash-to-G2 {r['hash_s'] * 1e3:.1f} ms, base-|x| digits "
        f"{r['digits_s'] * 1e3:.1f} ms, upload) + device wait "
        f"{r['wait_s'] * 1e3:.1f} ms (kernel {kernel_ms(r)}, CUDA "
        f"events) + readback {r['readback_s'] * 1e3:.1f} ms; "
        f"{n_full / full_s:.1f} signatures/s; every point equals its anchor "
        f"({same_words}; anchors by G2 additions {anchor_s:.1f} s, host) {at}")
    log(f"  batch_sign launch at {n_full} rows: {geometry('batch_sign', n_full)}")
    if not same_words:
        fail("full bucket: a signature differs from its anchor")
    if full_launches != 1:
        fail(f"full bucket: {full_launches} batch_sign launches (1 expected)")
    c.full_sign = full_rec.calls[0]  # (operands, Jacobian words): phase 12

    # timing rows: (name, where, kernel, plain, reps, Fp products, bytes,
    # replaces, launches on its path, kernels-line entry). The lane batch,
    # the plane's shape, comes first: it is the kernels-line entry, with the
    # plane's launches; the full bucket's row has its own run's launch.
    rows = []
    for where, ops_s, n_l in (
            (f"lane batch, N = {lane_ops[1].shape[0]}", lane_ops,
             plane_launches["batch_sign"]),
            (f"full bucket, N = {n_full}", full_rec.calls[0][0],
             full_launches)):
        n = ops_s[1].shape[0]
        d_s, live_s = ops_s[2].cpu().numpy(), (~ops_s[1]).cpu().tolist()
        old_ms = bound_ms(c.ops.sign_glv(d_s, live_s, B.ABS_X,
                                         decompose_glv), n * 515, c.sms,
                          c.clock_hz)[0]
        log(f"  batch_sign bound, {where}: the one-thread GLV ladder's "
            f"least work {old_ms:.4f} ms; the digits' below (time line) "
            f"{at}")
        rows.append((
            "batch_sign", where, lambda a=ops_s: B.batch_sign(*a),
            HeldLaunch(words=full_rec.calls[0][1],
                       where="the phases 7-9 check of every batch_sign "
                       "launch") if ops_s is not lane_ops
            else (lambda a=ops_s: B.batch_sign_plain(*a)), 3,
            c.ops.sign(d_s, live_s),
            n * 513, "grandine_tpu/tpu/bls.py:896", n_l, "batch_sign"))
    for (where, (_, grp, _)), (ops_r, _) in zip(agg_rows.items(),
                                                rec2.calls + rec1.calls):
        k = 2 if where != "committee aggregate keys" else 1
        name = "g2_group_sum" if k == 2 else "g1_group_sum"
        counts = [len(g) for g in grp]
        rows.append((
            name, f"aggregate construction, {where}",
            lambda a=ops_r, f=getattr(B, name): f(*a),
            lambda a=ops_r, f=getattr(B, name + "_plain"): f(*a), 5,
            c.ops.group_sum(counts, k), sum(counts) * 144 * k
            + len(counts) * (144 * k + 4) + 4,
            "grandine_tpu/tpu/bls.py:" + ("980" if k == 2 else "1010"),
            agg_launches[name],
            name if k == 2 else "g1_group_sum/aggregate"))
    return rows


class KzgSplit:
    """Stands in, while a `with` block runs, for the two device passes of
    gpu/kzg.py (`lincomb`, `blob_verify`: host clock at entry, CUDA events
    around their launches) and for the host steps of the batch call
    (kzg/eip4844.py `_decode_points`, `_batch_inputs` and
    `KzgDeviceBackend.pack`: host seconds each). `start()` opens a call's
    split and `finish()` closes it; all are looked up at call time."""

    def __init__(self, GK, K, torch):
        self.torch, self.split = torch, {}
        self.slots = [(GK, "lincomb", self._device), (GK, "blob_verify",
                                                      self._device),
                      (K, "_decode_points", self._host),
                      (K, "_batch_inputs", self._host),
                      (K.KzgDeviceBackend, "pack", self._host)]

    def start(self):
        self.split = {"t0": time.perf_counter()}

    def finish(self):
        s = self.split
        s["total_s"] = time.perf_counter() - s["t0"]
        events = s.pop("events", None)
        s["kernel_ms"] = events[0].elapsed_time(events[1]) if events else None
        return s

    def _host(self, name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self.split[name] = time.perf_counter() - t
            return out
        return run

    def _device(self, name, fn):
        def run(*args, **kwargs):
            self.split["t_pass"] = time.perf_counter()
            cuda = args[0].is_cuda
            events = ([self.torch.cuda.Event(enable_timing=True)
                       for _ in range(2)] if cuda else [])
            for e in events[:1]:
                e.record()
            out = fn(*args, **kwargs)
            for e in events[1:]:
                e.record()
            self.split["events"] = events or None
            return out
        return run

    def __enter__(self):
        self.saved = [(owner, name, getattr(owner, name))
                      for owner, name, _ in self.slots]
        for (owner, name, wrap), (_, _, fn) in zip(self.slots, self.saved):
            setattr(owner, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def kzg_phase(c):
    """The EIP-4844 blob-KZG plane at c.setup's width (c: what main()
    built): a block's blobs committed and proved on the card, held against
    the host anchors; batch verification through the batch call and the
    `blob_kzg` scheme row, every verdict the host tail's; the split of
    each call. Returns timing rows."""
    torch, np, A, B, R = c.torch, c.np, c.A, c.B, c.R
    from grandine_tpu_torch.crypto.curves import G1, g1_infinity
    from grandine_tpu_torch.gpu import kzg as GK
    from grandine_tpu_torch.gpu import pairing as TP
    from grandine_tpu_torch.gpu import schemes
    from grandine_tpu_torch.kzg import eip4844 as K
    from grandine_tpu_torch.kzg import fr
    from grandine_tpu_torch.runtime.verify_scheduler import VerifyItem

    dev, at, setup = c.dev, c.at, c.setup
    width = setup.width
    rng = random.Random(20261020)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def ms(v):
        return "not measured (no card)" if v is None else f"{v:.3f} ms"

    # the ladder against its plain version on edge rows, the call launched
    # EDGE_REPEATS times with the same words; the last two rows' halves
    # take window digits +16 and -16 in turn (the table's last entry)
    lag = setup.g1_lagrange_brp
    edge_pts = [lag[0], lag[1], lag[2], g1_infinity(), G1, G1, lag[3],
                lag[4], lag[5], lag[6], lag[1], lag[2]]
    alt = [sum((15 << 5 * i) if i % 2 == par else (1 << (5 * i + 4))
               for i in range(25)) for par in (0, 1)]
    edge_k = [0, 1, R - 1, rng.randrange(R), rng.randrange(R), 1, R - 1,
              GK.X2, 3 * GK.X2, GK.X2 - 1, alt[1] * GK.X2 + alt[0],
              alt[0] * GK.X2 + alt[1]]
    inf = np.array([p.is_infinity() for p in edge_pts], bool)
    px = np.zeros((len(edge_pts), 12), np.int32)
    py = np.zeros_like(px)
    px[~inf], py[~inf] = B.g1_affine_words([p for p in edge_pts
                                            if not p.is_infinity()])
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (px, py, inf, GK.scalar_words(edge_k)))
    got = [GK.g1_scalar_mul(*args) for _ in range(EDGE_REPEATS)]
    if not all(torch.equal(got[0], g) for g in got[1:]):
        fail(f"g1_scalar_mul: a word moved between {EDGE_REPEATS} launches "
             f"on the same edge rows")
    c.same("g1_scalar_mul", got[0], GK.g1_scalar_mul_plain(*args),
           f"edge rows ({EDGE_REPEATS} launches, the same words): k = 0, 1, "
           f"r - 1 on setup points, an ∞ base, the generator with a random "
           f"k, 1 and r - 1, k = x^2, 3·x^2 (k0 = 0), x^2 - 1, window digits "
           f"+-16")
    back = B.g1_points_from_words(got[0].cpu().numpy())
    if [a == p.mul(k) for a, p, k in zip(back, edge_pts, edge_k)] != \
            [True] * len(edge_pts):
        fail("g1_scalar_mul: an edge row differs from the host ladder")

    # the producer: a block's blobs committed and proved on the card
    blobs = [b"".join(rng.randrange(R).to_bytes(32, "big")
                      for _ in range(width)) for _ in range(c.n_blobs)]
    split = KzgSplit(GK, K, torch)
    rec = {name: Recorder(mod, name, lambda *a: a) for mod, name in (
        (GK, "g1_scalar_mul"), (TP, "miller_loop_pairs"))}
    rec["g1_group_sum"] = Recorder(B, "g1_group_sum",
                                   lambda rows, off: (rows, list(off)))
    rec["rlc_finish"] = Recorder(B, "rlc_finish", finish_operands)

    def timed(fn, *a):
        split.start()
        out = fn(*a)
        sync()
        return out, split.finish()

    c.count_reset()
    with split, rec["g1_scalar_mul"], rec["g1_group_sum"]:
        made = [timed(K.blob_to_kzg_commitment, b, setup, dev)
                for b in blobs]
        comms = [m[0] for m in made]
        proved = [timed(K.compute_blob_kzg_proof, b, cm, setup, dev)
                  for b, cm in zip(blobs, comms)]
        proofs = [p[0] for p in proved]
        j_root = 77 % width  # the special row of the quotient
        z_root = setup.roots_brp[j_root].to_bytes(32, "big")
        (proof_r, y_r), _ = timed(K.compute_kzg_proof, blobs[0], z_root,
                                  setup, dev)
    producer = c.count_read()
    msm_ops = {name: r.calls[0][0] for name, r in rec.items() if r.calls}
    n_pass = 2 * c.n_blobs + 1
    log(f"kzg producer: {c.n_blobs} blobs of {width} field elements "
        f"committed and proved, 1 proof at a root of unity, on the card; "
        f"launches {json.dumps(producer)}")
    if producer["g1_scalar_mul"] != n_pass or \
            producer["g1_group_sum"] != n_pass:
        fail(f"kzg producer: {n_pass} device passes expected, launches "
             f"{producer}")
    for what, rows in (("commitment", made), ("blob proof", proved)):
        for i, (_, s) in enumerate(rows):
            log(f"  kzg {what} {i}: {s['total_s'] * 1e3:.1f} ms = host prep "
                f"{(s['t_pass'] - s['t0']) * 1e3:.1f} ms + device pass, "
                f"readback and encoding "
                f"{(s['t0'] + s['total_s'] - s['t_pass']) * 1e3:.1f} ms "
                f"(kernels {ms(s['kernel_ms'])}, CUDA events) {at}")
    # the host anchors: one commitment and one proof by the host Pippenger
    poly0 = K._blob_to_polynomial(blobs[0], width)
    t0 = time.perf_counter()
    anchor_c = A.g1_to_bytes(K._msm_host(lag, poly0))
    anchor_c_s = time.perf_counter() - t0
    z0 = K._compute_challenge(blobs[0], comms[0], width)
    y0 = fr.evaluate_polynomial_in_evaluation_form(poly0, z0, setup.roots_brp)
    t0 = time.perf_counter()
    anchor_p = A.g1_to_bytes(K._msm_host(
        lag, K._quotient(poly0, z0, y0, setup.roots_brp)))
    anchor_p_s = time.perf_counter() - t0
    log(f"kzg host anchors (host Pippenger): commitment 0 {anchor_c_s:.1f} s,"
        f" proof 0 {anchor_p_s:.1f} s (host); equal to the card's: "
        f"{anchor_c == comms[0]}, {anchor_p == proofs[0]}")
    if anchor_c != comms[0] or anchor_p != proofs[0]:
        fail("kzg: a commitment or proof differs from the host anchor")
    if y_r != blobs[0][j_root * 32:(j_root + 1) * 32] or \
            not K.verify_kzg_proof(comms[0], z_root, y_r, proof_r, setup):
        fail("kzg: the proof at a root of unity does not verify")
    const = 0x1234_5678
    got = K.blob_to_kzg_commitment(const.to_bytes(32, "big") * width, setup,
                                   dev)
    zero = bytes(32 * width)
    zc = K.blob_to_kzg_commitment(zero, setup, dev)
    zp = K.compute_blob_kzg_proof(zero, zc, setup, dev)
    log(f"kzg: a constant blob commits to c·G1: "
        f"{got == A.g1_to_bytes(G1.mul(const))}; the zero blob's commitment "
        f"and proof are ∞: {zc == zp == K.G1_POINT_AT_INFINITY}; the proof "
        f"at a root of unity verifies on the host")
    if got != A.g1_to_bytes(G1.mul(const)) or \
            not zc == zp == K.G1_POINT_AT_INFINITY:
        fail("kzg: the constant or the zero blob")

    # the verifier: the batch call and the scheme row's backend
    flip = bytearray(blobs[4])
    flip[5 * 32 + 31] ^= 1  # a low bit of element 5: still below r
    cases = {
        f"{c.n_blobs} blobs": (blobs, comms, proofs, True),
        "forged proof at item 2": (blobs, comms, proofs[:2] + [proofs[3]]
                                   + proofs[3:], False),
        "tampered blob at item 4": (blobs[:4] + [bytes(flip)] + blobs[5:],
                                    comms, proofs, False),
        "the zero blob (∞ commitment and proof)": (
            blobs[:-1] + [zero], comms[:-1] + [zc], proofs[:-1] + [zp], True),
    }
    row = schemes.get("blob_kzg")
    backend = row.make_backend(device=dev)
    c.count_reset()
    with rec["g1_scalar_mul"], rec["g1_group_sum"], \
            rec["miller_loop_pairs"], rec["rlc_finish"]:
        for r in rec.values():
            r.calls.clear()
        verdicts = {}
        for where, (bl, cm, pr, want) in cases.items():
            v_call = K.verify_blob_kzg_proof_batch(bl, cm, pr, setup, dev)
            items = [VerifyItem(b, p, public_keys=[m])
                     for b, m, p in zip(bl, cm, pr)]
            status, prep = backend.prepare(items)
            v_row = getattr(backend, row.async_seam[0])(prep)()
            verdicts[where] = (v_call, status, v_row, want)
    verifier = c.count_read()
    for where, (bl, cm, pr, want) in cases.items():
        v_call, status, v_row, _ = verdicts[where]
        host = K._batch_pairing_host(setup, *K._batch_inputs(bl, cm, pr,
                                                              setup))
        log(f"kzg batch {where}: verify_blob_kzg_proof_batch -> {v_call}, "
            f"blob_kzg prepare {status} -> verify_blobs_async {v_row}; host "
            f"batch tail {host}")
        if not v_call == v_row == host == want or status != "ok":
            fail(f"kzg batch {where}: verdicts differ")
    log(f"launches on the kzg verify path ({2 * len(cases)} batches): "
        f"{json.dumps(verifier)}")
    for name in ("g1_scalar_mul", "g1_group_sum", "miller_loop_pairs",
                 "rlc_finish"):
        if verifier[name] != 2 * len(cases):
            fail(f"kzg verify: {name} launched {verifier[name]} times for "
                 f"{2 * len(cases)} batches")
    bl, cm, pr, _ = cases["forged proof at item 2"]
    named = [i for i, it in enumerate(zip(bl, cm, pr))
             if not row.host_check(VerifyItem(it[0], it[2],
                                              public_keys=[it[1]]))]
    log(f"kzg forged batch: host_check_item names {named} (forged [2])")
    if named != [2]:
        fail("kzg: host_check_item did not name exactly the forged item")

    # p50 of each call, host prep apart from the device
    rows_c = [s for _, s in made]
    rows_p = [s for _, s in proved]
    for what, rows in (("commitment", rows_c), ("blob proof", rows_p)):
        total = statistics.median(s["total_s"] for s in rows)
        host = statistics.median(s["t_pass"] - s["t0"] for s in rows)
        kern = ([s["kernel_ms"] for s in rows] if dev.type == "cuda"
                else None)
        log(f"kzg {what} p50 {total * 1e3:.1f} ms over {len(rows)} (host "
            f"prep {host * 1e3:.1f} ms, device pass + readback "
            f"{(total - host) * 1e3:.1f} ms, kernels "
            f"{ms(statistics.median(kern) if kern else None)}) {at}")
    batch = []
    with split:
        for _ in range(c.kzg_reps):
            batch.append(timed(K.verify_blob_kzg_proof_batch, blobs, comms,
                               proofs, setup, dev)[1])
    med = {k: statistics.median(s[k] for s in batch)
           for k in ("total_s", "_decode_points", "_batch_inputs", "pack")}
    kern = statistics.median(s["kernel_ms"] for s in batch) \
        if dev.type == "cuda" else None
    log(f"kzg batch verify of {c.n_blobs} blobs p50 {med['total_s'] * 1e3:.1f}"
        f" ms over {c.kzg_reps} (medians: decode with subgroup checks "
        f"{med['_decode_points'] * 1e3:.1f} ms, challenges + barycentric "
        f"evaluations "
        f"{(med['_batch_inputs'] - med['_decode_points']) * 1e3:.1f}"
        f" ms, pack {med['pack'] * 1e3:.1f} ms, upload + device pass + wait "
        f"{(med['total_s'] - med['_batch_inputs'] - med['pack']) * 1e3:.1f}"
        f" ms;"
        f" kernels {ms(kern)}, CUDA events) {at}")

    # timing rows: (name, where, kernel, plain, reps, Fp products, bytes,
    # replaces, launches on its path, kernels-line entry)
    ver = {name: r.calls[0][0] for name, r in rec.items()}
    out = []
    for where, ops_k, n_l, entry in (
            (f"batch verify, bucket 8, {ver['g1_scalar_mul'][2].shape[0]} "
             f"rows", ver["g1_scalar_mul"], verifier["g1_scalar_mul"],
             "g1_scalar_mul"),
            (f"setup MSM, {width} rows", msm_ops["g1_scalar_mul"],
             producer["g1_scalar_mul"], "g1_scalar_mul/msm")):
        n = ops_k[2].shape[0]
        k_s, inf_s = ops_k[3].cpu().numpy(), ops_k[2].cpu().tolist()
        old_ms = bound_ms(c.ops.kzg_one_ladder(k_s, inf_s), n * (129 + 144),
                          c.sms, c.clock_hz)[0]
        if dev.type == "cuda":
            blocks, threads, smem, per_sm = B.launch_geometry(
                "g1_scalar_mul", n)
            geo = (f"window {GK.KZG_WINDOW}, {blocks} blocks of {threads} "
                   f"threads, {smem} B shared memory, {per_sm} blocks an SM")
        else:
            geo = "geometry not measured (no card)"
        log(f"  g1_scalar_mul launch, {where}: {geo}; bound at the one "
            f"255-bit ladder's least work {old_ms:.4f} ms, the "
            f"halves' below (time line) {at}")
        out.append(("g1_scalar_mul", where,
                    lambda a=ops_k: GK.g1_scalar_mul(*a),
                    lambda a=ops_k: GK.g1_scalar_mul_plain(*a), 5,
                    c.ops.kzg(k_s, inf_s, GK.X2), n * (129 + 144),
                    "grandine_tpu/kzg/eip4844.py:370", n_l, entry))
    for where, ops_s, n_l, entry in (
            ("batch verify, 4 groups of 8", ver["g1_group_sum"],
             verifier["g1_group_sum"], "g1_group_sum/kzg"),
            (f"setup MSM, 1 group of {width}", msm_ops["g1_group_sum"],
             producer["g1_group_sum"], "g1_group_sum/kzg_msm")):
        counts = np.diff(ops_s[1]).tolist()
        out.append(("g1_group_sum", where,
                    lambda a=ops_s: B.g1_group_sum(*a),
                    lambda a=ops_s: B.g1_group_sum_plain(*a), 5,
                    c.ops.group_sum(counts),
                    ops_s[0].shape[0] * 144 + len(counts) * (144 + 4) + 4,
                    "grandine_tpu/kzg/eip4844.py:" + (
                        "370" if entry.endswith("kzg") else "150"),
                    n_l, entry))
    c.blobs, c.comms, c.proofs = blobs, comms, proofs  # for the lanes
    # the pairing kernels at the batch verify's shape: later shapes of the
    # gossip rows' entries, their plain calls joining the batched checks
    # at the end of the table (check_pairing_launches, finish_plain_batched)
    ml = ver["miller_loop_pairs"]
    out.append(("miller_loop_pairs", "batch verify, 4 pairs",
                lambda a=ml: TP.miller_loop_pairs(*a),
                partial(TP.miller_loop_pairs_plain, *ml), 5,
                c.ops.miller * int((~ml[2]).sum()),
                4 * (144 + 96 + 1 + 576), "grandine_tpu/kzg/eip4844.py:370",
                verifier["miller_loop_pairs"], "miller_loop_pairs"))
    groups, nbytes = finish_shape(rec["rlc_finish"].calls[0])
    out.append(("rlc_finish", "batch verify, 1 group of 4 terms",
                lambda a=ver["rlc_finish"]: B.rlc_finish(*a),
                partial(B.rlc_finish_plain, *ver["rlc_finish"]), 3,
                c.ops.finish(groups), nbytes,
                "grandine_tpu/kzg/eip4844.py:370", verifier["rlc_finish"],
                "rlc_finish"))
    return out


class MetricsRecorder:
    """A metrics sink that records what the verify plane feeds it:
    every series the scheduler, the flight recorder, the supervisor and
    the localizer touch, by name and labels (`count(name, *labels)`)."""

    class _Series:
        def __init__(self, store, name, labels=()):
            self.store, self.name, self.lbl = store, name, labels

        def labels(self, *labels):
            return MetricsRecorder._Series(self.store, self.name, labels)

        def inc(self, *labels, amount=1, **_):
            key = (self.name, self.lbl + tuple(labels))
            self.store[key] = self.store.get(key, 0) + amount

        def observe(self, *labels, value=None, **_):
            self.inc(*(labels if value is not None else ()))

        def set(self, *labels, value=None, **_):
            pass

    def __init__(self):
        self.store = {}

    def __getattr__(self, name):
        return MetricsRecorder._Series(self.store, name)

    def count(self, name, *labels):
        return self.store.get((name, labels), 0)


class LaneSplit:
    """Stands in for an Ed25519 backend's `prepare` and
    `verify_batch_async` while a `with` block runs: the host seconds of
    each prepare (decode and RLC), and each settle's device wait, on the
    settle thread."""

    def __init__(self, backend):
        self.backend, self.prep, self.wait = backend, [], []

    def __enter__(self):
        be, prep, wait = self.backend, self.backend.prepare, \
            self.backend.verify_batch_async

        def timed_prepare(items):
            t = time.perf_counter()
            out = prep(items)
            self.prep.append(time.perf_counter() - t)
            return out

        def timed_launch(payload):
            settle = wait(payload)

            def timed_settle():
                t = time.perf_counter()
                out = settle()
                self.wait.append(time.perf_counter() - t)
                return out
            return timed_settle

        be.prepare, be.verify_batch_async = timed_prepare, timed_launch
        return self

    def __exit__(self, *exc):
        del self.backend.prepare, self.backend.verify_batch_async


#: int32 multiplies of one 2²⁵⁵ − 19 product as csrc/ed25519.cu runs it:
#: 64 32×32→64 partial products (low and high halves), the high half's
#: 8 words times 38 (low and high halves), the fold of the bits from 2²⁵⁵
#: by 19
MULS_PER_ED_MUL = 2 * 64 + 2 * 8 + 1
#: products of one unified addition (a doubling is one too)
ED_ADD_MULS = 9


def ed_verify_ops(k_words):
    """Field products of ed25519_verify at the function's least work on
    these scalars: per row with k ≠ 0, bit_length(k) − 1 doublings and
    popcount(k) − 1 additions; live rows − 1 tree additions; 3 doublings."""
    from grandine_tpu_torch.gpu.ed25519 import words_to_ints

    ks = [k for k in words_to_ints(k_words) if k]
    steps = sum(k.bit_length() - 1 + bin(k).count("1") - 1 for k in ks)
    return ED_ADD_MULS * (steps + max(0, len(ks) - 1) + 3)


def scheduler_phase(c):
    """The verify scheduler as the entry point (c: what main() built):
    ed25519_verify against its plain version on edge rows; the `ed25519`
    lane at full width (1,008 signatures, 16 batches of 63) and a poisoned
    stream; the `block`, `sync_message` and `blob_kzg` lanes on the
    operands of the earlier phases, each verdict the direct seam's; a
    chaos round; every recorded ed25519_verify launch against the plain
    version; timings. Returns the kernels-line rows of ed25519_verify."""
    torch, np, A, dev, at = c.torch, c.np, c.A, c.dev, c.at
    from grandine_tpu_torch.crypto import ed25519 as HE
    from grandine_tpu_torch.gpu import ed25519 as E
    from grandine_tpu_torch.runtime.verify_scheduler import (
        DEFAULT_LANES, VerifyItem, VerifyScheduler)
    from grandine_tpu_torch.testing.chaos import ChaosBackend, FaultPlan

    rng = random.Random(20261021)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def affine(p):
        zinv = pow(p[2], HE.P - 2, HE.P)
        return p[0] * zinv % HE.P, p[1] * zinv % HE.P

    def torsion_item(sk, msg):
        a, prefix = HE.secret_expand(sk)
        pk = HE.secret_to_public(sk)
        r = int.from_bytes(HE.sha512(prefix + msg), "little") % HE.L
        r_enc = HE.point_compress(HE.point_add(HE.point_mul(r, HE.BASE),
                                               HE.ORDER2))
        k = int.from_bytes(HE.sha512(r_enc + pk + msg), "little") % HE.L
        return VerifyItem(msg, r_enc + ((r + k * a) % HE.L).to_bytes(
            32, "little"), public_keys=(pk,))

    # 1. ed25519_verify against its plain version on edge rows ----------------
    t_item = torsion_item(b"\x11" * 32, b"torsion specimen")
    r_t = HE.point_decompress(t_item.signature[:32])
    edge_pts = [(0, 1), affine(HE.ORDER2), affine(HE.BASE),
                ((HE.P - 0) % HE.P, HE.P - 1), affine(r_t), affine(HE.BASE),
                affine(HE.point_neg(r_t)), (0, 1)]
    edge_k = [0, 1, (1 << 253) - 1, HE.L - 1, rng.randrange(1 << 128),
              HE.L - 1, 8, 0]
    edge = {}
    for b in E.BUCKETS:
        pts = edge_pts + [affine(HE.point_mul(rng.randrange(1, HE.L),
                                              HE.BASE))
                          for _ in range(b - len(edge_pts))]
        ks = edge_k + [rng.randrange(1 << 253) for _ in range(b - len(edge_k))]
        edge[b] = tuple(torch.from_numpy(w).to(dev) for w in (
            E.ints_to_words([x for x, _ in pts]),
            E.ints_to_words([y for _, y in pts]),
            E.ints_to_words([x * y % HE.P for x, y in pts]),
            E.ints_to_words(ks)))
        c.same("ed25519_verify", E.ed25519_verify(*edge[b]),
               E.ed25519_verify_plain(*edge[b]),
               f"edge rows, B = {b}: zero scalars, k = 1, 2^253 - 1, L - 1, "
               f"8; the identity, the order-2 point, x = 0 negated, the base "
               f"point, a torsion-carrying R")
    be_direct = E.Ed25519Backend(device=dev)
    status, prep = be_direct.prepare([t_item])
    v_t = be_direct.verify_batch_async(prep)()
    log(f"ed25519 torsion specimen: twin {HE.check_item(t_item)}, card "
        f"{v_t} (prepare {status})")
    if not (v_t is True and HE.check_item(t_item) is True):
        fail("the torsion specimen must verify on the card and the twin")

    # 2. the ed25519 lane at full width ---------------------------------------
    t0 = time.perf_counter()
    n_sigs = c.ed_batches * 63
    items = []
    for i in range(n_sigs):
        sk = rng.randbytes(32)
        msg = rng.randbytes(rng.randint(0, 96))
        items.append(VerifyItem(msg, HE.sign(sk, msg),
                                public_keys=(HE.secret_to_public(sk),)))
    log(f"ed25519 host prep: {n_sigs} messages signed under {n_sigs} seeded "
        f"keys in {time.perf_counter() - t0:.1f} s (host, not device)")
    jobs, at_i = [], 0  # jobs of 1–8 items, each batch's jobs sum to 63
    for _ in range(c.ed_batches):
        left = 63
        while left:
            size = min(left, rng.randint(1, 8))
            jobs.append(items[at_i:at_i + size])
            at_i += size
            left -= size
    metrics = MetricsRecorder()
    sched = VerifyScheduler(device=dev, metrics=metrics,
                            settle_timeout_s=c.settle_timeout_s)
    ed_calls = []
    lane_backend = sched._backend_for(sched.lanes["ed25519"])
    block_lane = sched.lanes["block"]
    rec = Recorder(E, "ed25519_verify", lambda *a: a)

    def submit_all(job_list, lane="ed25519"):
        with sched._cond:  # park the dispatcher: whole batches form
            tickets = [sched.submit(lane, j) for j in job_list]
        return tickets

    rec.__enter__()  # every launch of the phase is held against the plain
    c.count_reset()
    with LaneSplit(lane_backend) as split:
        sync()
        t0 = time.perf_counter()
        tickets = submit_all(jobs)
        verdicts = [t.result(120.0) for t in tickets]
        wall = time.perf_counter() - t0
        # the same signatures again, one batch at a time: submit → tickets
        lat = []
        i = 0
        for _ in range(c.ed_batches):
            batch_jobs, n = [], 0
            while n < 63:
                batch_jobs.append(jobs[i])
                n += len(jobs[i])
                i += 1
            t1 = time.perf_counter()
            bt = [sched.submit("ed25519", j) for j in batch_jobs]
            ok = [t.result(120.0) for t in bt]
            lat.append(time.perf_counter() - t1)
            verdicts += ok
        # the poisoned stream: a forged message, S + 1, S ≥ L, a torsion
        # specimen, among valid items
        s_of = int.from_bytes(items[3].signature[32:], "little")
        poison = [
            [items[0], items[1]],
            [VerifyItem(items[2].message + b"!", items[2].signature,
                        public_keys=items[2].public_keys)],
            [VerifyItem(items[3].message, items[3].signature[:32] + (
                (s_of + 1) % HE.L).to_bytes(32, "little"),
                public_keys=items[3].public_keys)],
            [items[4], items[5], items[6]],
            [VerifyItem(items[7].message, items[7].signature[:32] + (
                int.from_bytes(items[7].signature[32:], "little")
                + HE.L).to_bytes(32, "little"),
                public_keys=items[7].public_keys)],
            [torsion_item(b"\x12" * 32, b"torsion 2"), items[8]],
        ]
        want_p = [all(HE.check_item(it) for it in j) for j in poison]
        got_p = [t.result(120.0) for t in submit_all(poison)]
    ed_launches = c.count_read()["ed25519_verify"]
    ed_calls = list(rec.calls)
    st = dict(sched.stats["ed25519"])
    log(f"ed25519 lane: {n_sigs} signatures as {len(jobs)} jobs of 1-8, "
        f"twice (pipelined, then one batch at a time) -> "
        f"{sum(verdicts)} True of {len(verdicts)}; poisoned stream "
        f"{got_p} (twin {want_p}); stats {json.dumps(st)}; launches "
        f"{ed_launches}, buckets {[a[0].shape[0] for a, _ in ed_calls]}")
    if not all(verdicts) or len(verdicts) != 2 * len(jobs):
        fail("a valid ed25519 batch did not verify")
    if got_p != want_p or want_p != [True, False, False, True, False, True]:
        fail(f"ed25519 poisoned stream {got_p}, twin {want_p}")
    full = [a for a, _ in ed_calls if a[0].shape[0] == 128]
    if len(full) != 2 * c.ed_batches or st["max_batch_items"] != 63:
        fail(f"ed25519: {len(full)} launches at bucket 128 for "
             f"{2 * c.ed_batches} full batches, max batch "
             f"{st['max_batch_items']}")
    for key in ("device_faults", "breaker_skips", "retries"):
        if st[key]:
            fail(f"ed25519 lane: {key} = {st[key]}")
    degraded = metrics.count("verify_lane_batches", "ed25519", "degraded")
    if degraded or ed_launches != len(ed_calls):
        fail(f"ed25519 lane: {degraded} degraded batches, launches "
             f"{ed_launches} for {len(ed_calls)} recorded calls")
    flights = [r for r in sched.flight.snapshot("ed25519") if r.note != "shed"]
    if any(r.fault for r in flights) or any(r.kernel != "ed25519_verify"
                                            for r in flights):
        fail("ed25519 lane: a flight record with a fault or no kernel")
    if metrics.count("verify_watchdog_fired", "ed25519"):
        fail("ed25519 lane: the settle watchdog fired")
    log(f"ed25519 bisection: the poisoned batch named exactly the bad jobs "
        f"{[i for i, w in enumerate(got_p) if not w]} with 0 device faults")

    # 3. the BLS and KZG lanes through the same scheduler -------------------
    keys = c.keys
    block = c.block

    def keys_of(mem):
        return [keys[i] for i in mem]

    from grandine_tpu_torch.consensus.verifier import (SignatureInvalid,
                                                       TorchVerifier)

    def deferred_block(sets):
        v = sched.deferred("block", timeout=120.0)
        for root, mem, sig in sets:
            if len(mem) == 1:
                v.verify_singular(root, sig, keys[mem[0]])
            else:
                v.verify_aggregate(root, sig, keys_of(mem))
        try:
            v.finish()
        except SignatureInvalid:
            return False
        return True

    def direct_block(sets):
        v = TorchVerifier(c.block_backend)
        for root, mem, sig in sets:
            if len(mem) == 1:
                v.verify_singular(root, sig, keys[mem[0]])
            else:
                v.verify_aggregate(root, sig, keys_of(mem))
        try:
            v.finish()
        except SignatureInvalid:
            return False
        return True

    c.count_reset()
    v_sched = deferred_block(block)
    v_direct = direct_block(block)
    forged_i = min(41, len(block) - 2)
    forged_sets = list(block)
    r0, m0, _ = forged_sets[forged_i]
    forged_sets[forged_i] = (r0, m0, block[forged_i + 1][2])
    loc = sched._localizer
    passes0 = dict(loc.passes)
    set_tickets = submit_all([[VerifyItem(r, s, public_keys=keys_of(m))]
                              for r, m, s in forged_sets], "block")
    set_v = [t.result(120.0) for t in set_tickets]
    passes = {k: loc.passes[k] - passes0.get(k, 0) for k in loc.passes}
    # the 512-member sync committee slot, one job a signature
    s_items = [VerifyItem(m, A.g2_to_bytes(s.point), public_keys=[k])
               for m, s, k in zip(c.s_msgs, c.s_sigs, c.s_keys)]
    s_v = [t.result(120.0) for t in submit_all([[it] for it in s_items],
                                                "sync_message")]
    s_direct = c.block_backend.multi_verify(c.s_msgs, c.s_sigs, c.s_keys)
    # the blob lane: the block's blobs in one job, a forged proof in another
    from grandine_tpu_torch.kzg import eip4844 as K

    blob_items = [VerifyItem(b, p, public_keys=[m])
                  for b, m, p in zip(c.blobs, c.comms, c.proofs)]
    forged_blob = VerifyItem(c.blobs[2], c.proofs[3],
                             public_keys=[c.comms[2]])
    blob_v = [t.result(300.0) for t in submit_all([blob_items,
                                                   [forged_blob]],
                                                  "blob_kzg")]
    blob_direct = [K.verify_blob_kzg_proof_batch(c.blobs, c.comms, c.proofs,
                                                 c.setup, dev),
                   K.verify_blob_kzg_proof_batch([c.blobs[2]], [c.comms[2]],
                                                 [c.proofs[3]], c.setup,
                                                 dev)]
    bls_launches = c.count_read()
    log(f"block lane: the block's {len(block)} sets through DeferredVerifier "
        f"-> {v_sched} (direct TorchVerifier {v_direct}); one job a set with "
        f"set {forged_i} forged -> False at "
        f"{[i for i, v in enumerate(set_v) if not v]}; localization passes "
        f"{json.dumps(passes)}")
    log(f"sync_message lane: {len(s_items)} signatures -> "
        f"{sum(s_v)} True (direct multi_verify {s_direct}); blob_kzg lane: "
        f"{len(blob_items)} blobs -> {blob_v[0]}, forged proof -> "
        f"{blob_v[1]} (direct {blob_direct}); launches "
        f"{json.dumps(bls_launches)}")
    if not (v_sched is v_direct is True):
        fail("the block through DeferredVerifier")
    if [i for i, v in enumerate(set_v) if not v] != [forged_i]:
        fail(f"block lane: rejected {[i for i, v in enumerate(set_v) if not v]}")
    if passes.get("host", 0) or not passes.get("rlc_partition"):
        fail(f"block lane localization: {passes}")
    if not all(s_v) or s_direct is not True:
        fail("sync_message lane")
    if blob_v != blob_direct or blob_v != [True, False]:
        fail(f"blob_kzg lane {blob_v}, direct {blob_direct}")
    for lane in ("block", "sync_message", "blob_kzg"):
        st_l = sched.stats[lane]
        bad = {k: st_l[k] for k in ("device_faults", "breaker_skips",
                                    "retries") if st_l[k]}
        deg = metrics.count("verify_lane_batches", lane, "degraded")
        if bad or deg:
            fail(f"{lane} lane: {bad}, {deg} degraded")
    for name in ("multi_rlc_scale", "aggregate_rlc_scale",
                 "miller_loop_pairs", "rlc_finish", "g1_scalar_mul"):
        if bls_launches.get(name, 0) < 1:
            fail(f"the BLS and KZG lanes did not launch {name}")
    # every block and sync_message batch took the compressed route: one
    # decompression launch a batch (the direct seams decompress on the
    # host, the localizer checks the subgroup without decompressing)
    lane_batches = sum(sched.stats[n]["batches"]
                       for n in ("block", "sync_message"))
    if bls_launches.get("g2_decompress_subgroup", 0) != lane_batches:
        fail(f"{lane_batches} block and sync_message batches, "
             f"{bls_launches.get('g2_decompress_subgroup')} decompression "
             f"launches")

    # 4. a chaos round: the device says False on a valid batch ----------------
    chaos = ChaosBackend(E.Ed25519Backend(device=dev),
                         FaultPlan(["wrong_verdict"]))
    ed_lane = next(l for l in DEFAULT_LANES if l.name == "ed25519")
    csched = VerifyScheduler(backend=chaos, lanes=[ed_lane],
                             settle_timeout_s=c.settle_timeout_s)
    try:
        with csched._cond:
            ctk = [csched.submit("ed25519", j) for j in jobs[:6]]
        cv = [t.result(120.0) for t in ctk]
        cfaults = dict(csched.health.breaker.stats["faults"])
    finally:
        csched.stop()
    log(f"ed25519 chaos round (wrong_verdict): {len(cv)} tickets -> "
        f"{cv}; breaker faults {cfaults}")
    if not all(cv) or cfaults["verdict"] != 1 or \
            chaos.plan.injected["wrong_verdict"] != 1:
        fail("the chaos round")
    rec.__exit__()

    # every launch of the phase against the plain version, one plain pass
    # per bucket with the launches stacked
    t0 = time.perf_counter()
    for b in E.BUCKETS:
        calls = [(a, o) for a, o in rec.calls if a[0].shape[0] == b]
        if not calls:
            continue
        stacked = [torch.stack([a[i] for a, _ in calls], 1)
                   for i in range(4)]
        got = (torch.cat([o[0] for _, o in calls]),
               torch.stack([o[1] for _, o in calls], 1),
               torch.stack([o[2] for _, o in calls]))
        c.same("ed25519_verify", got, E.ed25519_verify_plain(*stacked),
               f"every launch of the phase at B = {b} ({len(calls)} "
               f"launches: lane, bisection, chaos)")
    log(f"ed25519 plain check of {len(rec.calls)} launches: "
        f"{time.perf_counter() - t0:.1f} s")

    # 5. timings --------------------------------------------------------------
    # block p50 through DeferredVerifier beside the direct TorchVerifier, in
    # turns, hash-to-G2 caches warm
    rows_b = {"scheduler": [], "direct": []}
    for name in ["direct", "scheduler"] * c.block_reps:
        sync()
        t0 = time.perf_counter()
        ok = (deferred_block if name == "scheduler" else direct_block)(block)
        rows_b[name].append(time.perf_counter() - t0)
        if ok is not True:
            fail(f"block ({name}) did not verify")
    p_s = statistics.median(rows_b["scheduler"])
    p_d = statistics.median(rows_b["direct"])
    log(f"block p50 through DeferredVerifier (block lane) {p_s * 1e3:.1f} ms "
        f"beside the direct TorchVerifier {p_d * 1e3:.1f} ms over "
        f"{c.block_reps} each, in turns: the scheduler adds "
        f"{(p_s - p_d) * 1e3:.1f} ms {at}")
    nb = c.ed_batches
    log(f"ed25519 lane: batch p50 submit to ticket "
        f"{statistics.median(lat) * 1e3:.1f} ms over {nb} batches of 63, one "
        f"at a time (host prep: decode and RLC p50 "
        f"{statistics.median(split.prep[nb:2 * nb]) * 1e3:.1f} ms, device "
        f"wait p50 {statistics.median(split.wait[nb:2 * nb]) * 1e3:.1f} ms); "
        f"pipelined {n_sigs / wall:.1f} signatures/s ({wall:.2f} s for "
        f"{n_sigs}, host prep {sum(split.prep[:nb]):.2f} s) {at}")
    batch63 = items[:63]
    t0 = time.perf_counter()
    if not all(HE.check_item(it) for it in batch63):
        fail("the host twin rejects a valid batch")
    log(f"ed25519 host twin: one batch of 63 in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host)")
    sched.stop()

    # kernels-line rows: (name, where, kernel, plain, reps, field products,
    # bytes, replaces, launches on its path, entry, int32 multiplies a
    # product)
    # the lane's B = 128 first, with its plain call; the bisection's
    # buckets are later shapes of that entry, held against the words of
    # their first recorded launch (checked above with every launch)
    out = []
    for b in sorted(E.BUCKETS, reverse=True):
        recorded = [(a, o) for a, o in ed_calls if a[0].shape[0] == b]
        ops_in = recorded[0][0] if recorded else edge[b]
        where = (f"ed25519 lane, B = {b}" if recorded
                 else f"edge rows, B = {b}")
        plain = (HeldLaunch(words=recorded[0][1], where="the phase's check "
                            f"of every launch at B = {b}")
                 if recorded and out else
                 partial(E.ed25519_verify_plain, *ops_in))
        out.append(("ed25519_verify", where,
                    lambda a=ops_in: E.ed25519_verify(*a), plain, 5,
                    ed_verify_ops(ops_in[3]), b * (4 * 32 + 128) + 128 + 1,
                    "grandine_tpu/tpu/ed25519.py:298", len(recorded),
                    "ed25519_verify", MULS_PER_ED_MUL))
    return out


# --- the slasher: surround, double-vote and double-block detection ---------

#: the cell's registry and its honest epoch windows (targets; source one
#: below), near genesis so that a fresh slasher's min tail stays short
SLASHER_VALIDATORS = 50_000
SLASHER_TARGETS = tuple(range(96, 102))
#: span_update_grid's edge cases: (rows, grid base)
SPAN_EDGE = ((1, 0), (255, (1 << 30) - 64), (256, 48), (257, 0),
             (16_385, (1 << 30) - 64), (50_000, 48), (300, (1 << 31) - 64))


class SlasherSplit:
    """Splits the device slasher's `on_attestations_bulk` calls: host clocks
    around its steps (its instance methods wrapped while the phase runs;
    the slasher has no trace knob) and, around each span_update_grid
    launch, a synchronize and CUDA events. `rec` is a Recorder that stands
    in for gpu/spans.py `span_update_grid` inside a `with` block (SpanPlane
    looks it up as a module global) and keeps each launch's operands and
    result; `t` holds the seconds of each step of the current call."""

    STEPS = ("checks", "grid assembly", "copy to card", "kernel",
             "copy back", "scatter + below-grid walk", "record puts",
             "flush")

    def __init__(self, sl, spans, torch):
        self.torch = torch
        self.cuda = sl.span_plane.device.type == "cuda"
        self.t, self.marks, self.in_flush = {}, {}, False
        split = self

        class Timed(Recorder):
            def __call__(self, *args):
                split.sync()
                split.mark("kernel in")
                if split.cuda:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                out = self.fn(*args)
                if split.cuda:
                    e1.record()
                split.sync()
                split.mark("kernel out")
                split.t["kernel"] += (
                    e0.elapsed_time(e1) / 1e3 if split.cuda else
                    split.marks["kernel out"] - split.marks["kernel in"])
                self.calls.append((args, out))
                return out

        self.rec = Timed(spans, "span_update_grid", lambda *a: a)
        for name in ("_check_rows", "_check_one"):
            self._wrap(sl, name, "checks")
        self._wrap(sl, "flush", "flush", flush=True)
        self._wrap(sl.db, "put_batch", "record puts", outside_flush=True)
        self._wrap(sl, "_merge_grid", None, marks="grid")
        self._wrap(sl.span_plane, "update", None, marks="update")
        self.start()

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def mark(self, name):
        self.marks[name] = time.perf_counter()

    def start(self):
        self.t = dict.fromkeys(self.STEPS, 0.0)

    def _wrap(self, obj, name, key, flush=False, outside_flush=False,
              marks=None):
        fn = getattr(obj, name)
        split = self

        def run(*args, **kwargs):
            if marks:
                split.mark(marks + " in")
            t0 = time.perf_counter()
            split.in_flush |= flush
            try:
                return fn(*args, **kwargs)
            finally:
                if flush:
                    split.in_flush = False
                if key and not (outside_flush and split.in_flush):
                    split.t[key] += time.perf_counter() - t0
                if marks:
                    split.mark(marks + " out")
                    split.close(marks)

        setattr(obj, name, run)

    def close(self, which):
        m, t = self.marks, self.t
        if m.get("update in", 0) < m[which + " in"] and which == "grid":
            return  # no grid row: the merge made no launch
        if which == "update":
            t["copy to card"] += m["kernel in"] - m["update in"]
            t["copy back"] += m["update out"] - m["kernel out"]
        else:
            t["grid assembly"] += m["update in"] - m["grid in"]
            t["scatter + below-grid walk"] += m["grid out"] - m["update out"]


def poisoned_window(window, target, seed):
    """The honest window at `target` with known offenders injected; returns
    it and {(kind, validator)} the slasher must report. Surround: 4
    validators leave their committee's aggregate and vote (90, target)
    alone (grid rows). Surrounded: 3 validators first vote (target − 2,
    target + 2), which surrounds nothing; their honest (target − 1, target)
    after it is surrounded (the collision path). Double vote: 5 validators
    vote their honest (source, target) again over another root (the
    collision path)."""
    rng = random.Random(seed)
    window = list(window)
    a, b, d = rng.sample(range(len(window)), 3)
    ids, s, t, root = window[a]
    surround = ids[:4]
    window[a] = (ids[4:], s, t, root)
    window.append((surround, 90, target, root))
    surrounded = window[b][0][:3]
    window.insert(0, (surrounded, target - 2, target + 2, window[b][3]))
    double = window[d + 1][0][-5:]
    window.append((double, target - 1, target, rng.randbytes(32)))
    want = ({("surround_vote", v) for v in surround}
            | {("surrounded_vote", v) for v in surrounded}
            | {("double_vote", v) for v in double})
    return window, want


def slasher_phase(c):
    """The slasher at full width (c: what main() built): span_update_grid
    against its plain version on edge rows; the CRC-32C in use (native
    required); six epoch windows at `c.n_validators` validators (every one
    votes once: all rows go through the grid merge) and a poisoned
    seventh through a device `Slasher()` and a `Slasher(device="cpu")`
    over sqlite databases, one on_attestations_bulk call a window — equal
    hits, exactly the injected offenders, one launch a window each held
    against the plain version; double proposals through on_block; prune;
    equal `sl:` keyspaces. Prints the window p50 on the card and the CPU
    twin and the device slasher's split. Returns the kernels-line row."""
    import itertools
    import shutil
    import tempfile

    torch, np, dev, at = c.torch, c.np, c.dev, c.at
    from grandine_tpu_torch import slasher as SL
    from grandine_tpu_torch.gpu import spans as GS
    from grandine_tpu_torch.spec_tests.snappy import crc_engine
    from grandine_tpu_torch.storage.database import Database
    from grandine_tpu_torch.testing.slasher import (
        epoch_window, span_edge_rows)

    t_phase = time.perf_counter()
    # 1. span_update_grid against its plain version on edge rows -------------
    for n, base in c.span_edge:
        ops = [torch.from_numpy(a).to(dev)
               for a in span_edge_rows(n, base, seed=n)]
        c.same("span_update_grid", GS.span_update_grid(*ops, base),
               GS.span_update_grid_plain(*ops, base),
               f"edge rows, n = {n}, base = {base}: a row not valid, s below "
               f"the grid, t past it, s = t - 1, s = t, UNSET and 0 inputs")

    # 2. the CRC-32C of every database put -----------------------------------
    engine = crc_engine()
    log(f"slasher CRC-32C: {engine} (grandine_tpu_torch/native, g++ at "
        f"first use)")
    if not engine.startswith("native"):
        fail("the snappy framing runs the Python CRC loop, not the native "
             "one")

    # 3. the cell: six epoch windows and a poisoned seventh ----------------
    n_val = c.n_validators
    windows = [epoch_window(n_val, t, seed=20261023 + t)
               for t in c.targets]
    last = c.targets[-1] + 1
    bad, want = poisoned_window(epoch_window(n_val, last, seed=20261023 +
                                             last), last, 20261024)
    windows.append(bad)
    scratch = os.path.join(HERE, ".scratch")
    os.makedirs(scratch, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="slasher-", dir=scratch)
    try:
        card = SL.Slasher(Database.persistent(
            os.path.join(workdir, "card.sqlite")), device=dev)
        host = SL.Slasher(Database.persistent(
            os.path.join(workdir, "cpu.sqlite")), device="cpu")
        split = SlasherSplit(card, GS, torch)
        rows, hits_all = [], []
        c.count_reset()
        for w in windows:
            split.start()
            split.sync()
            t0 = time.perf_counter()
            with split.rec:
                got = card.on_attestations_bulk(w)
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = host.on_attestations_bulk(w)
            t_host = time.perf_counter() - t0
            key = [[(h.kind, h.validator_index, h.evidence) for h in x]
                   for x in got]
            if key != [[(h.kind, h.validator_index, h.evidence) for h in x]
                       for x in ref]:
                fail(f"slasher window at target {w[-1][2]}: the card's hits "
                     f"differ from the CPU slasher's")
            hits_all.append(key)
            rows.append((t_card, t_host, dict(split.t),
                         sum(len(a[0]) for a in w)))
        launches = c.count_read()["span_update_grid"]
        for k, (t_card, t_host, t, n_idx) in enumerate(rows):
            other = t_card - sum(t.values())
            log(f"slasher window {k + 1} (target "
                f"{windows[k][-1][2]}, {len(windows[k])} aggregates, {n_idx} "
                f"attesting indices): card {t_card * 1e3:.1f} ms = "
                + ", ".join(f"{name} {v * 1e3:.2f}" for name, v in t.items())
                + f", other {other * 1e3:.1f}; the CPU slasher "
                f"{t_host * 1e3:.1f} ms {at}")
        honest = rows[:len(c.targets)]
        p_card = statistics.median(r[0] for r in honest)
        p_host = statistics.median(r[1] for r in honest)
        p_step = {k: statistics.median(r[2][k] for r in honest) * 1e3
                  for k in ("kernel", "copy to card", "copy back")}
        log(f"slasher window p50 over {len(honest)} honest windows of "
            f"{n_val} validators: card {p_card * 1e3:.1f} ms "
            f"({n_val / p_card:.0f} attesting indices/s), the CPU slasher "
            f"{p_host * 1e3:.1f} ms ({n_val / p_host:.0f} attesting "
            f"indices/s); kernel p50 {p_step['kernel']:.4f} ms, copies p50 "
            f"to card {p_step['copy to card']:.2f} ms, back "
            f"{p_step['copy back']:.2f} ms {at}")
        if launches != len(windows) or len(split.rec.calls) != len(windows):
            fail(f"span_update_grid launched {launches} times "
                 f"({len(split.rec.calls)} recorded) over {len(windows)} "
                 f"windows: one a window required")
        for k, (args, out) in enumerate(split.rec.calls):
            c.same("span_update_grid", out, GS.span_update_grid_plain(*args),
                   f"slasher window {k + 1}, {args[0].shape[0]} rows, base "
                   f"{args[5]}")
        if any(h for key in hits_all[:-1] for h in key):
            fail("an honest slasher window reported an offense")
        found = {(k, v) for hits in hits_all[-1] for k, v, _ in hits}
        n_found = sum(len(x) for x in hits_all[-1])
        log(f"slasher offenses in the poisoned window: {n_found} -> "
            f"{sorted(found, key=lambda h: (h[0], h[1]))}")
        if found != want or n_found != len(want):
            fail(f"the slasher found {sorted(found)}, injected {sorted(want)}")

        # double proposals, then prune
        rng = random.Random(20261025)
        first_slot = last * 32
        blocks = [(rng.randrange(n_val), first_slot + i, rng.randbytes(32))
                  for i in range(32)]
        blocks += [(p, slot, rng.randbytes(32)) for p, slot, _ in
                   (blocks[3], blocks[17])]
        proposals = []
        for b in blocks:
            hb, hh = card.on_block(*b), host.on_block(*b)
            if (hb and (hb.kind, hb.validator_index, hb.evidence)) != (
                    hh and (hh.kind, hh.validator_index, hh.evidence)):
                fail("on_block: the two slashers disagree")
            if hb:
                proposals.append((hb.kind, hb.validator_index))
        log(f"slasher double proposals: {proposals}")
        if proposals != [("double_block", blocks[3][0]),
                         ("double_block", blocks[17][0])]:
            fail("the double proposals were not both found")
        kinds = {k for k, _ in found} | {k for k, _ in proposals}
        if kinds != {"surround_vote", "surrounded_vote", "double_vote",
                     "double_block"}:
            fail(f"not every kind of offense appeared: {sorted(kinds)}")
        drained = card.drain()
        if len(drained) != len(host.drain()) or len(drained) != (
                n_found + len(proposals)):
            fail("drain: the two slashers disagree")
        finalized = card.history_epochs + c.targets[0]
        dropped = (card.prune(finalized), host.prune(finalized))
        log(f"slasher prune at finalized epoch {finalized}: {dropped[0]} and "
            f"{dropped[1]} rows dropped (card, CPU)")
        if dropped[0] != dropped[1] or not dropped[0]:
            fail("prune: the two slashers dropped different rows")
        t0 = time.perf_counter()
        n_keys = n_bytes = 0
        for a, b in itertools.zip_longest(card.db.iterate_prefix(b"sl:"),
                                          host.db.iterate_prefix(b"sl:")):
            if a != b:
                fail(f"the sl: keyspaces differ at {a and a[0]!r}, "
                     f"{b and b[0]!r}")
            n_keys += 1
            n_bytes += len(a[1])
        log(f"slasher state: the sl: keyspaces of the card's and the CPU "
            f"slasher equal byte for byte, {n_keys} keys, {n_bytes} value "
            f"bytes ({time.perf_counter() - t0:.1f} s to read both)")
        for sl in (card, host):
            sl.db.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"slasher phase: {time.perf_counter() - t_phase:.1f} s")

    ops = split.rec.calls[len(c.targets) - 1][0]
    n = ops[0].shape[0]
    return [("span_update_grid", f"slasher window, {n} rows",
             lambda a=ops: GS.span_update_grid(*a),
             lambda a=ops: GS.span_update_grid_plain(*a), 20, 0,
             2 * n * 64 * 4 + 9 * n + 2 * n * 64 * 4,
             "grandine_tpu/tpu/spans.py:45", launches, "span_update_grid",
             MULS_PER_FP_MUL, lambda a=ops: GS.span_update_grid_plain(*a))]


# --- main ------------------------------------------------------------------


def mesh_phase(c):
    """The multi-device verify plane over D virtual shards of the card
    (`VerifyMesh([card] * D)`, the counterpart of XLA's virtual devices):
    every route against the single-device route's verdict and the host
    anchor's (`host_check_item` on the changed sets), valid, forged and
    swapped; one `rlc_partial` launch a shard on the sharded routes, every
    one held against its plain version; the sharded and single-device
    routes timed on the same triples. Returns the timed rows of
    `rlc_partial`."""
    torch, np, A, B = c.torch, c.np, c.A, c.B
    from grandine_tpu_torch.consensus.verifier import SignatureInvalid
    from grandine_tpu_torch.gpu.mesh import VerifyMesh
    from grandine_tpu_torch.gpu.registry import DevicePubkeyRegistry
    from grandine_tpu_torch.gpu.schemes import dispatch_bls_compressed
    from grandine_tpu_torch.runtime.replay import dispatch_window
    from grandine_tpu_torch.runtime.verify_scheduler import (
        DeferredVerifier, VerifyItem, VerifyScheduler, host_check_item)

    t_phase = time.perf_counter()
    meshes = {d: VerifyMesh([c.dev] * d) for d in (2, 4)}

    def mesh_backend(d, warm):
        be = B.TorchBlsBackend(mesh=meshes[d])
        # the roots' hash-to-G2 points cached, as for the single-device
        # backend it shares them with: both routes run warm
        be._h2c_cache = warm._h2c_cache
        return be

    anchors = {}

    def anchor(key, items):
        """The host anchor's verdict on the sets a variant changed (every
        other set is the valid batch's)."""
        if key not in anchors:
            anchors[key] = all(host_check_item(it) for it in items)
        return anchors[key]

    def held(where, d, variant, got, single, host, launches, partials,
             sums=None, msm_planes=0):
        log(f"mesh {where}, D = {d}, {variant}: sharded -> {got}, "
            f"single-device -> {single}, host anchor -> {host}; launches "
            f"rlc_partial {launches['rlc_partial']}, g1_group_sum "
            f"{launches['g1_group_sum']}, msm_lane_scan / bucket_reduce / "
            f"horner {launches['msm_lane_scan']} / "
            f"{launches['msm_bucket_reduce']} / {launches['msm_horner']}, "
            f"rlc_finish {launches['rlc_finish']} {c.at}")
        if not (got is single is host is (variant == "valid")):
            fail(f"mesh {where}, D = {d}, {variant}: verdicts disagree")
        if launches["rlc_partial"] != partials or launches["rlc_finish"] < 1 \
                or (sums is not None and launches["g1_group_sum"] != sums) \
                or any(launches[k] != msm_planes for k in (
                    "msm_lane_scan", "msm_bucket_reduce", "msm_horner")):
            fail(f"mesh {where}, D = {d}, {variant}: launches {launches}")

    def set_item(sets, i):
        root, mem, sig = sets[i]
        return VerifyItem(root, sig, public_keys=[c.keys[j] for j in mem])

    def two_swapped(sets, i, j):
        return c.with_set(c.with_set(sets, i, root=sets[j][0]), j,
                          root=sets[i][0])

    n = len(c.block)
    blk = {"valid": (c.block, [0, n - 1]),
           "forged": (c.with_set(c.block, 5, sig=c.block[6][2]), [5]),
           "swapped": (two_swapped(c.block, 7, 8), [7, 8])}
    k5, k2 = 5 * n + 3, 2 * n + 7
    win = {"valid": (c.window, [0, len(c.window) - 1]),
           "forged": (c.with_set(c.window, k5, sig=c.window[k5 + 1][2]),
                      [k5]),
           "swapped": (two_swapped(c.window, k2, k2 + 1), [k2, k2 + 1])}
    recorded = {}  # (where, d) -> the first rlc_partial call of its run
    with Recorder(B, "rlc_partial", lambda *a: a) as rec:

        def run(where, d, fn):
            c.count_reset()
            first = len(rec.calls)
            got = fn()
            torch.cuda.synchronize()
            recorded.setdefault((where, d), (rec.calls[first:],
                                             c.count_read()))
            return got, c.count_read()

        # the block through TorchVerifier (flat: b = 256)
        for d in (2, 4):
            be = mesh_backend(d, c.block_backend)
            for variant, (sets, changed) in blk.items():
                got, launches = run("block", d,
                                    lambda: c.block_verdict(sets, be))
                held("block through TorchVerifier", d, variant, got,
                     c.block_single[variant],
                     anchor(("block", variant),
                            [set_item(sets, i) for i in changed]),
                     launches, d, 0)
        # the replay window through dispatch_window (flat: b = 2,048)
        wbe = mesh_backend(4, c.window_backend)
        for variant, (sets, changed) in win.items():
            items = c.window_items(sets)
            got, launches = run("window", 4,
                                lambda: dispatch_window(items, wbe)())
            single = c.window_single.get(variant)
            if single is None:
                single = dispatch_window(items, c.window_backend)()
            held("window through dispatch_window", 4, variant, got, single,
                 anchor(("window", variant),
                        [set_item(sets, i) for i in changed]),
                 launches, 4, 0)
        # the grouped shapes: sync slot (bm = 4, bk = 512), unaggregated
        # slot (bm = 16, bk = 256)
        for where, (ml, sl, kl), ds in (
                ("sync slot", c.sync, (2, 4)),
                ("unaggregated slot", c.unagg, (4,))):
            groups = B.message_groups(ml)
            bm = B._bucket(len(groups))
            bk = B._bucket(max(map(len, groups.values())))
            forged = list(sl)
            forged[7] = sl[8]
            other = next((i for i, m in enumerate(ml) if m != ml[3]), 4)
            swapped = list(sl)
            swapped[3], swapped[other] = sl[other], sl[3]
            variants = {"valid": (sl, [0, len(sl) - 1]),
                        "forged": (forged, [7]),
                        "swapped": (swapped, [3, other])}
            singles = {v: c.backend.multi_verify(ml, s_l, kl)
                       for v, (s_l, _) in variants.items()}
            for d in ds:
                be = mesh_backend(d, c.backend)
                for variant, (s_l, changed) in variants.items():
                    got, launches = run(where, d,
                                        lambda: be.multi_verify(ml, s_l, kl))
                    # each shard's G1 and G2 bucket MSM, one reduce of
                    # the shards' group sums
                    held(f"{where} (grouped, bm = {bm}, bk = {bk})", d,
                         variant, got, singles[variant],
                         anchor((where, variant), [VerifyItem(
                             ml[i], s_l[i].to_bytes(), public_keys=[kl[i]])
                             for i in changed]), launches, d, 1, 2 * d)
        # the gossip slot over the registry sharded 4 ways
        reg4 = DevicePubkeyRegistry(mesh=meshes[4])
        c.count_reset()
        t0 = time.perf_counter()
        reg4.ensure(c.pubkeys)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        rx, ry, _ = c.registry.arrays()
        sx, sy, _ = reg4.arrays()
        log(f"mesh registry: {reg4.count} keys at capacity {reg4.capacity}, "
            f"{len(sx)} blocks of {sx[0].shape[0]} rows, ingested by "
            f"{c.count_read()['g1_decompress']} g1_decompress launches in "
            f"{ingest_s * 1e3:.1f} ms (host prep included) {c.at}")
        if c.count_read()["g1_decompress"] != 4 or not (
                torch.equal(torch.cat(sx), rx)
                and torch.equal(torch.cat(sy), ry)):
            fail("the sharded registry's rows are not the single registry's")
        gbe = mesh_backend(4, c.backend)
        m_aggs = len(c.msgs)
        half = m_aggs // 2  # another committee's aggregate
        gsw = list(c.sigs)
        gsw[0], gsw[half] = c.sigs[half], c.sigs[0]
        gossip = {"valid": (c.sigs, [0, m_aggs - 1]),
                  "forged": ([c.sigs[1]] + c.sigs[1:], [0]),
                  "swapped": (gsw, [0, half])}

        def gossip_items(sl):
            return [VerifyItem(m, s, member_indices=mm,
                               pubkey_columns=c.pubkeys)
                    for m, s, mm in zip(c.msgs, sl, c.members)]

        for variant, (sl, changed) in gossip.items():
            items = gossip_items(sl)
            got, launches = run("gossip", 4, lambda: dispatch_bls_compressed(
                items, gbe, reg4)())
            single = dispatch_bls_compressed(items, c.backend, c.registry)()
            held("gossip slot through dispatch_bls_compressed, registry "
                 "sharded", 4, variant, got, single,
                 anchor(("gossip", variant), [items[i] for i in changed]),
                 launches, 0, 0)
            if launches["aggregate_rlc_scale"] != 1:
                fail(f"mesh gossip: launches {launches}")
        # the block through the scheduler's block lane over the sharded
        # registry (the lanes reach the fast-aggregate seams)
        metrics = MetricsRecorder()
        sched = VerifyScheduler(mesh=meshes[4], registry=reg4,
                                metrics=metrics,
                                settle_timeout_s=c.settle_timeout_s)
        try:
            for variant, (sets, changed) in blk.items():
                v = DeferredVerifier(sched, "block", timeout=120.0)
                for root, mem, sig in sets:
                    v.verify_aggregate_indexed(root, sig, mem, c.pubkeys)
                c.count_reset()
                try:
                    v.finish()
                    got = True
                except SignatureInvalid:
                    got = False
                held("block through VerifyScheduler(mesh=) and "
                     "DeferredVerifier, registry sharded", 4, variant, got,
                     c.block_single[variant], anchors[("block", variant)],
                     c.count_read(), 0)
            recs = sched.flight.snapshot(lane="block", kind="batch")
            st = sched.stats["block"]
            degraded = metrics.count("verify_lane_batches", "block",
                                     "degraded")
            log(f"mesh scheduler: {len(recs)} block-lane flight records, "
                f"devices {sorted({r.devices for r in recs})}; device "
                f"faults {st['device_faults']}, degraded {degraded}, "
                f"breaker skips {st['breaker_skips']}, retries "
                f"{st['retries']}")
            if not recs or any(r.devices != 4 for r in recs) or degraded or \
                    st["device_faults"] or st["retries"] or \
                    st["breaker_skips"]:
                fail("mesh scheduler: flight records or faults")
        finally:
            sched.stop()
        if torch.cuda.device_count() > 1:  # distinct cards, where present
            cards = B.TorchBlsBackend(mesh=VerifyMesh.build())
            forged = list(c.block_sig_objs)
            forged[5] = forged[6]
            for variant, s_l in (("valid", c.block_sig_objs),
                                 ("forged", forged)):
                got, launches = run("cards", cards.mesh.device_count,
                                    lambda: cards.multi_verify(
                                        c.block_msgs, s_l, c.agg_keys))
                held(f"block over {cards.mesh.device_count} distinct cards",
                     cards.mesh.device_count, variant, got,
                     c.block_single[variant], anchors[("block", variant)],
                     launches, cards.mesh.device_count, 0)

        # the routes timed on the same triples: p50 of 3 each, in turns,
        # host clock to the settled verdict, CUDA events around the
        # enqueue for the kernels' span on the card
        win_msgs = [root for root, _, _ in c.window]
        win_sigs = [A.Signature(A.g2_from_bytes(sig, subgroup_check=False))
                    for _, _, sig in c.window]
        win_keys = [c.keys[mem[0]] if len(mem) == 1 else
                    A.PublicKey.aggregate([c.keys[i] for i in mem])
                    for _, mem, _ in c.window]
        cases = [(f"block, {n} sets", d,
                  lambda be: be.multi_verify_async(
                      c.block_msgs, c.block_sig_objs, c.agg_keys),
                  c.block_backend) for d in (2, 4)]
        cases.append((f"window, {len(c.window)} sets", 4,
                      lambda be: be.multi_verify_async(win_msgs, win_sigs,
                                                       win_keys),
                      c.window_backend))
        cases += [(f"sync slot, {len(c.sync[0])} signers", d,
                   lambda be: be.multi_verify_async(*c.sync), c.backend)
                  for d in (2, 4)]
        cases.append((f"unaggregated slot, {len(c.unagg[0])} signers", 4,
                      lambda be: be.multi_verify_async(*c.unagg), c.backend))
        items = gossip_items(c.sigs)
        for where, d, fn, single_be in cases + [(
                f"gossip slot, {m_aggs} aggregates, registry sharded", 4,
                None, c.backend)]:
            be = mesh_backend(d, single_be)
            runs = {"single": [], "sharded": []}
            for route in ("single", "sharded", "sharded", "single",
                          "single", "sharded"):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                if fn is None:
                    settle = dispatch_bls_compressed(
                        items, single_be if route == "single" else be,
                        c.registry if route == "single" else reg4)
                else:
                    settle = fn(single_be if route == "single" else be)
                e1.record()
                if settle() is not True:
                    fail(f"mesh timing {where}: a valid batch failed")
                total = time.perf_counter() - t0
                torch.cuda.synchronize()
                runs[route].append((total, e0.elapsed_time(e1)))
            p50 = {r: (statistics.median(t for t, _ in v) * 1e3,
                       statistics.median(k for _, k in v))
                   for r, v in runs.items()}
            log(f"mesh time {where}, D = {d}: sharded p50 "
                f"{p50['sharded'][0]:.1f} ms (kernels' span "
                f"{p50['sharded'][1]:.1f} ms), single-device p50 "
                f"{p50['single'][0]:.1f} ms (span {p50['single'][1]:.1f} "
                f"ms); sharded / single {p50['sharded'][0] / p50['single'][0]:.3f}"
                f" — virtual shards on one card: launch and gather "
                f"overhead, not scaling {c.at}")
    worst, shapes = 0, {}
    for ops_r, out in rec.calls:
        for g, r in zip(out, B.rlc_partial_plain(*ops_r)):
            diff = (g.cpu().to(torch.int64) - r.cpu().to(torch.int64)).abs()
            worst = max(worst, int(diff.max()) if diff.numel() else 0)
        f_off = ops_r[4] if len(ops_r) > 4 and ops_r[4] is not None else [
            0, ops_r[0].shape[0]]
        spans = tuple(np.diff(np.asarray(f_off)).tolist())
        shapes[spans] = shapes.get(spans, 0) + 1
    for spans, count in shapes.items():
        log(f"rlc_partial launch, {len(spans)} groups of {min(spans)}-"
            f"{max(spans)} terms ({count} launches): geometry of each pass "
            f"(blocks, threads, shared bytes, blocks an SM) "
            f"{B.rlc_partial_geometry(np.concatenate([[0], np.cumsum(spans)]))}")
    log(f"check rlc_partial (every launch of the mesh phase, "
        f"{len(rec.calls)} launches): max |kernel - plain| = {worst} (exact "
        f"required) {c.at}")
    if worst:
        fail("rlc_partial disagrees with its plain version")
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")

    rows = []
    for where in ("window", "block"):
        calls, launches = recorded[(where, 4)]
        ops_r = calls[0][0]
        nf, ns = ops_r[0].shape[0], ops_r[2].shape[0]
        rows.append(("rlc_partial", f"{where}, D = 4, shard 0: {nf} sets",
                     lambda a=ops_r: B.rlc_partial(*a),
                     lambda a=ops_r: B.rlc_partial_plain(*a), 5,
                     c.ops.partial([nf]),
                     nf * (576 + 1) + 2 * ns + 16 + 576 + 1,
                     "grandine_tpu/tpu/bls.py:1175", launches["rlc_partial"],
                     "rlc_partial"))
    return rows


def reference_phase(c):
    """The reference-only programs at the main path's full width. The four
    new kernels against their plain versions on edge rows; `batch_pubkey`
    and `g1_normalize` deriving the registry's first 16,384 keys (the last
    one r − sk₀), compressed byte for byte as the registry's; `g2_normalize`
    reading back the full signing bucket beside today's host inversion;
    `multi_verify_kernel` (the block, the window, a signature outside G2),
    `grouped_multi_verify_kernel` (the unaggregated and sync slots),
    `aggregate_fast_verify_kernel` (the gossip slot, the [P, −P] committee
    in a real and a padding slot) and `grouped_multi_verify_msm_packed_kernel`
    (both grouped shapes, check_subgroup on) — valid, forged and swapped,
    each verdict the host anchor's and the ported route's, each run's
    launches counted; the port's `entry()` and `dryrun_multichip(2)` / `(4)`.
    Every launch of the four new kernels is held against its plain version.
    Returns the timed rows of the new kernels."""
    from contextlib import ExitStack

    torch, np, A, B, P, R = c.torch, c.np, c.A, c.B, c.P, c.R
    from grandine_tpu_torch import entry as E
    from grandine_tpu_torch.crypto.curves import G1, g2_infinity
    from grandine_tpu_torch.crypto.fields import Fq2
    from grandine_tpu_torch.gpu import limbs as L
    from grandine_tpu_torch.testing import pubkey_rows as PKR
    from grandine_tpu_torch.gpu.schemes import dispatch_bls_compressed
    from grandine_tpu_torch.runtime.verify_scheduler import (
        VerifyItem, host_check_item)

    t_phase = time.perf_counter()
    dev, at = c.dev, c.at
    news = ("batch_pubkey", "g1_normalize", "g2_normalize", "unpack_words")
    notes = {name: [] for name in news}  # where each launch came from

    def up(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def words(ints, shape):
        return torch.from_numpy(L.ints_to_words(ints).reshape(shape).copy()
                                ).to(dev)

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def pairs_for(n):
        return [B.TorchBlsBackend._rlc_pair(c.bits) for _ in range(n)]

    with ExitStack() as stack:
        recs = {name: stack.enter_context(Recorder(B, name, lambda *a: a))
                for name in news}

        # -- edge rows -------------------------------------------------------
        scalars = [1, R - 1, R - 2] + c.sks[:29]
        k_e, neg_e = B.sign_scalars_host(scalars)
        if not (neg_e.any(0).all() and (~neg_e).any(0).all()):
            fail("edge scalars: a sign mask of a half never set or cleared")
        pk_e = B.batch_pubkey(*up((k_e, neg_e)))
        pk_1 = B.batch_pubkey(*up((k_e[:1], neg_e[:1])))
        pk_c = B.batch_pubkey(*up(PKR.halves_operands(PKR.COMB_EDGES)))
        notes["batch_pubkey"] += ["edge rows (sk = 1, r − 1, r − 2, both "
                                  "sign masks), N = 32", "N = 1",
                                  "comb edges (a zero half, lanes summing "
                                  "to ∞, all-15 digits, a join that doubles "
                                  "and one that gives ∞), N = 6"]
        live = [i for i in range(len(PKR.COMB_EDGES))
                if i != PKR.COMB_INF_ROW]
        if (pk_c[PKR.COMB_INF_ROW, 2].abs().sum().item()
                or not pk_c[live, 2].abs().sum(-1).all().item()):
            fail("batch_pubkey comb edges: the ∞ join or a live row's Z")
        gx, gy = G1.to_affine()
        lam = 2
        while pow(lam, (P - 1) // 2, P) != P - 1:
            lam += 1
        e1 = words([gx.n, gy.n, 1, gx.n, (P - gy.n) % P, P - 1,
                    lam * lam * gx.n % P, pow(lam, 3, P) * gy.n % P, lam,
                    0, 0, 0], (4, 3, 12))
        xy1, inf1 = B.g1_normalize(torch.cat([pk_e, e1]))
        one1 = B.g1_normalize(e1[2:3])[0]
        notes["g1_normalize"] += ["edge rows (32 ladder outputs, Z = 1, "
                                  "Z = −1, Z a non-residue, ∞), N = 36",
                                  "N = 1 (Z a non-residue)"]
        host = [G1.mul(s).to_affine() for s in scalars[:3]]
        g_words = L.ints_to_words([gx.n, gy.n]).reshape(2, 12)
        if (inf1.tolist() != [False] * 35 + [True]
                or xy1[35].abs().sum().item()
                or any(L.words_to_ints(xy1[i]) != [h[0].n, h[1].n]
                       for i, h in enumerate(host))
                or not all(np.array_equal(x.cpu().numpy(), g_words)
                           for x in (xy1[32], xy1[33], xy1[34], one1[0]))):
            fail("g1_normalize edge rows: masks, ∞ words or affine points")
        hx, hy = c.h_of[c.msgs[0]].to_affine()
        lam2 = Fq2.from_ints(1, 0)
        while True:  # λ ∈ Fp2 a non-residue: its norm one in Fp
            lam2 = lam2 + Fq2.from_ints(0, 1)
            norm = (lam2.c0.n ** 2 + lam2.c1.n ** 2) % P
            if pow(norm, (P - 1) // 2, P) == P - 1:
                break
        nx, ny = lam2 * lam2 * hx, lam2 * lam2 * lam2 * hy
        e2 = words([hx.c0.n, hx.c1.n, hy.c0.n, hy.c1.n, 1, 0,
                    hx.c0.n, hx.c1.n, (P - hy.c0.n) % P, (P - hy.c1.n) % P,
                    P - 1, 0, nx.c0.n, nx.c1.n, ny.c0.n, ny.c1.n,
                    lam2.c0.n, lam2.c1.n] + [0] * 6, (4, 3, 2, 12))
        sign_ops, sign_words = c.full_sign
        xy2, inf2 = B.g2_normalize(torch.cat([sign_words[:28], e2]))
        one2 = B.g2_normalize(e2[2:3])[0]
        notes["g2_normalize"] += ["edge rows (28 signatures, Z = 1, Z = −1, "
                                  "Z a non-residue of Fp2, ∞), N = 32",
                                  "N = 1 (Z a non-residue)"]
        h_words = L.ints_to_words([hx.c0.n, hx.c1.n, hy.c0.n, hy.c1.n]
                                  ).reshape(2, 2, 12)
        if (inf2.tolist() != [False] * 31 + [True]
                or xy2[31].abs().sum().item()
                or not all(np.array_equal(x.cpu().numpy(), h_words)
                           for x in (xy2[28], xy2[29], xy2[30], one2[0]))):
            fail("g2_normalize edge rows: masks, ∞ words or affine points")
        values = [0, P - 1, P, (1 << 384) - 1, (1 << 390) - 1, (1 << 416) - 1,
                  ((1 << 26) - 1) << 390, (123 << 395) | 5]
        w_edge = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(13)]
                           for v in values], np.uint32).view(np.int32)
        got = B.unpack_words(*up((w_edge,)))
        notes["unpack_words"].append("edge values (0, p − 1, p, 2^384 − 1, "
                                     "2^390 − 1, bits above 390)")
        if L.words_to_ints(got) != [(v % (1 << 390)) % P for v in values]:
            fail("unpack_words edge values")
        log(f"reference edge rows: batch_pubkey (N = 32, 1), g1_normalize "
            f"(N = 36, 1), g2_normalize (N = 32, 1), unpack_words (8 values): "
            f"masks, ∞ rows, Z = ±1 and non-residue Z, reductions as "
            f"expected {at}")

        # -- keys: the registry's first bucket derived on the card ----------
        n_keys = B.MAX_BUCKET
        rows_k = list(range(n_keys - 1)) + [len(c.sks) - 1]  # r − sk₀ last
        t0 = time.perf_counter()
        k_k, neg_k = B.sign_scalars_host([c.sks[i] for i in rows_k])
        glv_s = time.perf_counter() - t0
        kt, nt = up((k_k, neg_k))
        torch.cuda.synchronize()
        ev_p, ev_n = events(), events()
        t0 = time.perf_counter()
        ev_p[0].record()
        pk_words = B.batch_pubkey(kt, nt)
        ev_p[1].record()
        ev_n[0].record()
        pk_xy, pk_inf = B.g1_normalize(pk_words)
        ev_n[1].record()
        xy_h, inf_h = pk_xy.cpu(), pk_inf.cpu()
        card_s = time.perf_counter() - t0
        notes["batch_pubkey"].append(f"registry keys, N = {n_keys}")
        notes["g1_normalize"].append(f"registry keys, N = {n_keys}")
        ints = L.words_to_ints(xy_h)
        derived = [_compress(ints[2 * i], ints[2 * i + 1], P)
                   for i in range(n_keys)]
        same_keys = (not inf_h.any()) and derived == [c.pubkeys[i]
                                                      for i in rows_k]
        log(f"keys: batch_pubkey + g1_normalize of the registry's first "
            f"{n_keys} secret keys (the last r − sk₀): {card_s * 1e3:.1f} ms "
            f"host clock (upload, kernels, copy of affine words; GLV "
            f"decomposition {glv_s * 1e3:.1f} ms before it); kernels "
            f"batch_pubkey {ev_p[0].elapsed_time(ev_p[1]):.3f} ms, "
            f"g1_normalize {ev_n[0].elapsed_time(ev_n[1]):.3f} ms (CUDA "
            f"events); compressed, byte for byte the registry's: "
            f"{same_keys} {at}")
        if not same_keys:
            fail("keys derived on the card differ from the registry's")
        comb_ms, ladder_ms = (bound_ms(ops, n_keys * 178, c.sms,
                                       c.clock_hz)[0]
                              for ops in (c.ops.pubkey(k_k),
                                          c.ops.pubkey_ladder(k_k)))
        log(f"  batch_pubkey bound, registry keys: the comb's least work "
            f"{comb_ms:.4f} ms (the dual GLV ladder's {ladder_ms:.4f} ms) "
            f"{at}")

        # -- readback: the full signing bucket's affine words ----------------
        n_sig = sign_words.shape[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts = B.g2_points_from_words(sign_words.cpu().numpy())
        host_s = time.perf_counter() - t0
        ev = events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        rb_xy, rb_inf = B.g2_normalize(sign_words)
        ev[1].record()
        rb_h, rb_inf_h = rb_xy.cpu().numpy(), rb_inf.cpu().numpy()
        card_rb = time.perf_counter() - t0
        notes["g2_normalize"].append(f"the full signing bucket, N = {n_sig}")
        inf_host = np.array([pt.is_infinity() for pt in pts])
        want = np.zeros((n_sig, 2, 2, 12), np.int32)
        live = [pt for pt in pts if not pt.is_infinity()]
        want[~inf_host] = L.ints_to_words([
            v for pt in live for v in (pt.x.c0.n, pt.x.c1.n, pt.y.c0.n,
                                       pt.y.c1.n)]).reshape(-1, 2, 2, 12)
        same_rb = (np.array_equal(rb_h, want)
                   and np.array_equal(rb_inf_h, inf_host))
        log(f"readback of the full signing bucket ({n_sig} signatures): host "
            f"(copy of Jacobian words + one batched inversion into points, "
            f"g2_points_from_words) {host_s * 1e3:.1f} ms; card g2_normalize "
            f"{ev[0].elapsed_time(ev[1]):.3f} ms (CUDA events) + copy of "
            f"affine words = {card_rb * 1e3:.1f} ms host clock; affine words "
            f"equal: {same_rb} {at}")
        if not same_rb:
            fail("g2_normalize readback differs from the host readback")

        # -- the four verify programs ----------------------------------------
        nonsub_pt = A.g2_from_bytes(c.nonsub, subgroup_check=False)
        nonsub_x, nonsub_y, _ = B.g2_affine_words_many([nonsub_pt])

        def run(name, fn, arrays, **kw):
            """(verdict, launches) of one program run on the card."""
            c.count_reset()
            v = fn(*up(arrays), **kw)
            torch.cuda.synchronize()
            return bool(v.item()), c.count_read()

        def check(where, variant, got, launches, route, anchor, want,
                  expect):
            log(f"program {where}, {variant}: -> {got} (ported route "
                f"{route}, host anchor {anchor}); launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})} "
                f"{at}")
            if not (got is route is anchor is want):
                fail(f"program {where}, {variant}: verdicts disagree")
            if {k: v for k, v in launches.items() if v} != expect:
                fail(f"program {where}, {variant}: launches {launches}")

        def item_of(sets, i):
            root, mem, sig = sets[i]
            return VerifyItem(root, sig, public_keys=[c.keys[j] for j in mem])

        flat_kernels = {"multi_rlc_scale": 1, "miller_loop_pairs": 1,
                        "rlc_finish": 1}
        win_keys = [c.keys[mem[0]] if len(mem) == 1 else
                    A.PublicKey.aggregate([c.keys[i] for i in mem])
                    for _, mem, _ in c.window]
        for where, sets, keys_l, be in (
                (f"multi_verify_kernel, block of {len(c.block)} sets",
                 c.block, c.agg_keys, c.block_backend),
                (f"multi_verify_kernel, window of {len(c.window)} sets",
                 c.window, win_keys, c.window_backend)):
            n = len(sets)
            b = B._bucket(n)
            sig_objs = [A.Signature(A.g2_from_bytes(s, subgroup_check=False))
                        for _, _, s in sets]
            base = list(E.flat_batch([k.point for k in keys_l],
                                     [s.point for s in sig_objs],
                                     [g2_infinity()] * n, pairs_for(n), b))
            base[6][:n] = np.stack([be._hash_to_g2_words(root, c.dst)[0]
                                    for root, _, _ in sets])
            base[7][:n] = False
            j = 2 * n // 3  # a set of a later block in the window
            variants = {"valid": ([], [0, n - 1]), "forged": ([(5, 6)], [5]),
                        "swapped": ([], [j, j + 1])}
            for variant, (copies, changed) in variants.items():
                arr = [a.copy() for a in base]
                sl, ml = list(sig_objs), [root for root, _, _ in sets]
                v_sets = list(sets)
                for dst_i, src_i in copies:
                    arr[3][dst_i], arr[4][dst_i] = arr[3][src_i], arr[4][src_i]
                    sl[dst_i] = sig_objs[src_i]
                    v_sets[dst_i] = (sets[dst_i][0], sets[dst_i][1],
                                     sets[src_i][2])
                if variant == "swapped":
                    arr[6][[j, j + 1]] = arr[6][[j + 1, j]]
                    ml[j], ml[j + 1] = ml[j + 1], ml[j]
                    v_sets[j] = (sets[j + 1][0],) + sets[j][1:]
                    v_sets[j + 1] = (sets[j][0],) + sets[j + 1][1:]
                got, launches = run(where, B.multi_verify_kernel, arr)
                route = be.multi_verify(ml, sl, keys_l, rng=c.bits)
                anchor = all(host_check_item(item_of(v_sets, i))
                             for i in changed)
                check(where, variant, got, launches, route, anchor,
                      variant == "valid", flat_kernels)
            arr = [a.copy() for a in base]
            arr[3][10], arr[4][10] = nonsub_x[0], nonsub_y[0]
            got, launches = run(where, B.multi_verify_kernel, arr)
            sl = list(sig_objs)
            sl[10] = A.Signature(nonsub_pt)
            route = be.multi_verify([r for r, _, _ in sets], sl, keys_l,
                                    rng=c.bits)
            anchor = host_check_item(VerifyItem(
                sets[10][0], c.nonsub,
                public_keys=[c.keys[i] for i in sets[10][1]]))
            check(where, "signature 10 outside G2 (no membership check: the "
                  "algebra's verdict)", got, launches, route, anchor, False,
                  flat_kernels)

        grouped_kernels = flat_kernels | {"g1_group_sum": 1}
        msm_kernels = {"msm_lane_scan": 2, "msm_bucket_reduce": 2,
                       "msm_horner": 2, "miller_loop_pairs": 1,
                       "rlc_finish": 1}
        packed_kernels = msm_kernels | {"unpack_words": 1,
                                        "g2_subgroup_check": 1}
        for where, (ml, sl, kl) in (
                (f"unaggregated slot, {len(c.unagg[0])} signers", c.unagg),
                (f"sync slot, {len(c.sync[0])} signers", c.sync)):
            groups = B.message_groups(ml)
            bm = B._bucket(len(groups))
            bk = B._bucket(max(map(len, groups.values())))
            pairs = pairs_for(len(ml))
            base = E.grouped_batch(
                [[(kl[i].point, sl[i].point) for i in ix]
                 for ix in groups.values()],
                [c.h_of[root] for root in groups],
                [[pairs[i] for i in ix] for ix in groups.values()], bm, bk)
            slot = {i: (g, p) for g, ix in enumerate(groups.values())
                    for p, i in enumerate(ix)}
            # the reference's MSM plans of the batch's pairs (k-major)
            plans, plan_kw = E.grouped_plans(base)
            plans = list(plans)
            other = next((i for i, m in enumerate(ml) if m != ml[3]), 4)
            variants = {"valid": ({}, [0, len(ml) - 1]),
                        "forged": ({7: 8}, [7]),
                        "swapped": ({3: other, other: 3}, [3, other])}
            for variant, (take, changed) in variants.items():
                arr = [a.copy() for a in base]
                v_sl = list(sl)
                for dst_i, src_i in take.items():
                    arr[3][slot[dst_i]] = base[3][slot[src_i]]
                    arr[4][slot[dst_i]] = base[4][slot[src_i]]
                    v_sl[dst_i] = sl[src_i]
                got, launches = run(where, B.grouped_multi_verify_kernel, arr)
                route = c.backend.multi_verify(ml, v_sl, kl, rng=c.bits)
                anchor = all(host_check_item(VerifyItem(
                    ml[i], v_sl[i].to_bytes(), public_keys=[kl[i]]))
                    for i in changed)
                tag = f"grouped_multi_verify_kernel, {where} (bm = {bm}, bk = {bk})"
                check(tag, variant, got, launches, route, anchor,
                      variant == "valid", grouped_kernels)
                got_m, launches = run(where, B.grouped_multi_verify_msm_kernel,
                                      list(arr[:8]) + plans, **plan_kw)
                check(f"grouped_multi_verify_msm_kernel, {where}", variant,
                      got_m, launches, route, anchor, variant == "valid",
                      msm_kernels)
                packed = arr[:3] + [E.packed_signatures(arr[3], arr[4])] + \
                    arr[5:8] + plans
                got_p, launches = run(where,
                                      B.grouped_multi_verify_msm_packed_kernel,
                                      packed, check_subgroup=1, **plan_kw)
                notes["unpack_words"].append(
                    f"packed program, {where}, {variant}, "
                    f"{bm * bk * 4} coordinates")
                check(f"grouped_multi_verify_msm_packed_kernel, {where}, "
                      f"check_subgroup", variant, got_p, launches, route,
                      anchor, variant == "valid", packed_kernels)
            arr = [a.copy() for a in base]
            arr[3][slot[5]], arr[4][slot[5]] = nonsub_x[0], nonsub_y[0]
            packed = arr[:3] + [E.packed_signatures(arr[3], arr[4])] + \
                arr[5:8] + plans
            got_p, launches = run(where, B.grouped_multi_verify_msm_packed_kernel,
                                  packed, check_subgroup=1, **plan_kw)
            notes["unpack_words"].append(f"packed program, {where}, outside G2")
            v_sl = list(sl)
            v_sl[5] = A.Signature(nonsub_pt)
            route = c.backend.multi_verify(ml, v_sl, kl, rng=c.bits)
            anchor = host_check_item(VerifyItem(ml[5], c.nonsub,
                                                public_keys=[kl[5]]))
            check(f"grouped_multi_verify_msm_packed_kernel, {where}, "
                  f"check_subgroup", "signature 5 outside G2", got_p,
                  launches, route, anchor, False, packed_kernels)

        # the firehose program: the gossip slot, members uploaded
        m_aggs = len(c.msgs)
        # the reference's power-of-two buckets, room for one padding slot
        bm = B._bucket(m_aggs + 1)
        bk = B._bucket(max(map(len, c.members)))
        sig_pts = [A.g2_from_bytes(s, subgroup_check=False) for s in c.sigs]
        base = list(E.firehose_batch(
            [[c.keys[i].point for i in mem] for mem in c.members], sig_pts,
            [c.h_of[m] for m in c.msgs], pairs_for(m_aggs), bm, bk))
        half = m_aggs // 2

        def gossip_items(sl):
            return [VerifyItem(m, s, member_indices=mm,
                               pubkey_columns=c.pubkeys)
                    for m, s, mm in zip(c.msgs, sl, c.members)]

        where = f"aggregate_fast_verify_kernel, gossip slot, {m_aggs} " \
                f"aggregates (bm = {bm}, bk = {bk})"
        fh_kernels = {"aggregate_rlc_scale": 1, "miller_loop_pairs": 1,
                      "rlc_finish": 1}
        for variant, take, changed in (("valid", {}, [0, m_aggs - 1]),
                                       ("forged", {0: 1}, [0]),
                                       ("swapped", {0: half, half: 0},
                                        [0, half])):
            arr = [a.copy() for a in base]
            v_sl = list(c.sigs)
            for dst_i, src_i in take.items():
                arr[4][dst_i], arr[5][dst_i] = base[4][src_i], base[5][src_i]
                v_sl[dst_i] = c.sigs[src_i]
            got, launches = run(where, B.aggregate_fast_verify_kernel, arr)
            items = gossip_items(v_sl)
            route = dispatch_bls_compressed(items, c.backend, c.registry)()
            anchor = all(host_check_item(items[i]) for i in changed)
            check(where, variant, got, launches, route, anchor,
                  variant == "valid", fh_kernels)
        # the [P, −P] committee (rows 0 and 49,999) with an ∞ signature in
        # slot m_aggs: a real slot fails the batch, a padding slot does not
        pair_x, pair_y = B.g1_affine_words([c.keys[0].point,
                                            c.keys[len(c.keys) - 1].point])
        arr = [a.copy() for a in base]
        arr[0][m_aggs, :2], arr[1][m_aggs, :2] = pair_x, pair_y
        arr[2][m_aggs, :2] = False
        arr[7][m_aggs] = c.block_backend._hash_to_g2_words(c.msgs[0],
                                                            c.dst)[0]
        arr[8][m_aggs] = False
        for pad in (False, True):
            arr[3][m_aggs] = pad
            got, launches = run(where, B.aggregate_fast_verify_kernel, arr)
            log(f"program {where}, [P, -P] with an ∞ signature in a "
                f"{'padding' if pad else 'real'} slot: -> {got} {at}")
            if got is not pad or {k: v for k, v in launches.items() if v} \
                    != fh_kernels:
                fail(f"the [P, -P] slot (padding {pad}): {got}, {launches}")
        if c.block_backend.fast_aggregate_verify(
                c.msgs[0], A.Signature.empty(),
                [c.keys[0], c.keys[len(c.keys) - 1]]):
            fail("the ported route verifies the [P, -P] committee")

        # -- the port's entry points -------------------------------------
        fn, args = E.entry()
        if fn(*args).tolist() != [1]:
            fail("entry(): the flagship program rejects its example batch")
        log(f"entry(): multi_verify_kernel on example_batch(2, 4) -> True "
            f"{at}")
        for d in (2, 4):
            t0 = time.perf_counter()
            E.dryrun_multichip(d)
            log(f"dryrun_multichip({d}): {time.perf_counter() - t0:.2f} s, "
                f"both passes True {at}")

    for name in news:
        worst = 0
        plain = getattr(B, name + "_plain")
        for args, out in recs[name].calls:
            ref = plain(*args)
            for g, r in zip(out if isinstance(out, tuple) else (out,),
                            ref if isinstance(ref, tuple) else (ref,),
                            strict=True):
                g64 = g.cpu().to(torch.int64) & 0xFFFFFFFF
                r64 = r.cpu().to(torch.int64) & 0xFFFFFFFF
                if g64.shape != r64.shape:
                    fail(f"{name}: shape {tuple(g64.shape)} vs "
                         f"{tuple(r64.shape)}")
                worst = max(worst, int((g64 - r64).abs().max())
                            if g64.numel() else 0)
        log(f"check {name} (every launch of phase 12, "
            f"{len(recs[name].calls)} launches: {'; '.join(notes[name])}): "
            f"max |kernel - plain| = {worst} (exact required) {at}")
        if worst or len(recs[name].calls) != len(notes[name]):
            fail(f"{name}: disagrees with its plain version or launched "
                 f"{len(recs[name].calls)} times for {len(notes[name])}")
    log(f"reference phase: {time.perf_counter() - t_phase:.1f} s")

    n_unpack = recs["unpack_words"].calls[1][0]  # the unaggregated slot's
    return [
        ("batch_pubkey", f"registry keys, N = {n_keys}",
         lambda: B.batch_pubkey(kt, nt), lambda: B.batch_pubkey_plain(kt, nt),
         3, c.ops.pubkey(k_k), n_keys * (32 + 2 + 144),
         "grandine_tpu/tpu/bls.py:961", len(recs["batch_pubkey"].calls),
         "batch_pubkey"),
        ("g1_normalize", f"registry keys, N = {n_keys}",
         lambda: B.g1_normalize(pk_words),
         lambda: B.g1_normalize_plain(pk_words), 3,
         c.ops.normalize(n_keys, 1), n_keys * (144 + 96 + 1),
         "grandine_tpu/tpu/bls.py:938", len(recs["g1_normalize"].calls),
         "g1_normalize"),
        ("g2_normalize", f"signing bucket readback, N = {n_sig}",
         lambda: B.g2_normalize(sign_words),
         lambda: B.g2_normalize_plain(sign_words), 3,
         c.ops.normalize(int((~rb_inf).sum()), 2), n_sig * (288 + 192 + 1),
         "grandine_tpu/tpu/bls.py:951", len(recs["g2_normalize"].calls),
         "g2_normalize"),
        ("unpack_words", f"packed program, unaggregated slot, "
         f"{n_unpack[0].numel() // 13} coordinates",
         lambda a=n_unpack: B.unpack_words(*a),
         lambda a=n_unpack: B.unpack_words_plain(*a), 5,
         c.ops.unpack(n_unpack[0].numel() // 13),
         n_unpack[0].numel() // 13 * (52 + 48),
         "grandine_tpu/tpu/limbs.py:295", len(recs["unpack_words"].calls),
         "unpack_words"),
    ]


#: the bucket MSM's edge rows: (field, points, groups, window bits, lanes)
#: — a lane count not a multiple of 32, 256 digits a section (72 KiB of
#: shared memory a G2 block), an empty last group
MSM_EDGE = ((1, 37, 5, 4, 64), (1, 30, 3, 8, 40), (2, 17, 1, 5, 64),
            (2, 40, 2, 8, 64))
#: (field, window bits) of the MSM edge cases whose msm_horner launch also
#: takes testing/horner_rows.py's groups: the grouped route's windows
HORNER_EDGE = ((1, 4), (2, 8))


def msm_edge_case(c, k, n, n_groups, w, lanes, seed):
    """Host points (four bases, so duplicates share buckets; an ∞ row; a
    point and its negation under one scalar and group; a zero scalar and
    a zero low half; the last group empty; one live row masked on the
    device), its plan, the operands on the card and the host anchor's
    affine sums Σ (r0 + r1·λ)·P per group."""
    np, torch = c.np, c.torch
    rng = random.Random(seed)
    gen = c.G1 if k == 1 else c.G2
    base = [gen.mul(rng.randrange(1, 1 << 64)) for _ in range(4)]
    pts = [base[rng.randrange(4)] for _ in range(n)]
    pts[1] = gen.mul(0)
    pts[2] = -pts[4]
    lo = [rng.randrange(0, 1 << 32) for _ in range(n)]
    hi = [rng.randrange(0, 1 << 32) for _ in range(n)]
    lo[2], hi[2] = lo[4], hi[4]
    lo[5] = hi[5] = 0
    lo[6] = 0
    groups = [rng.randrange(0, max(1, n_groups - 1)) for _ in range(n)]
    groups[2] = groups[4]
    inf = np.array([p.is_infinity() for p in pts])
    plan = c.M.plan_msm(lo, hi, inf, groups, n_groups, window_bits=w,
                        lanes=lanes)
    if k == 1:
        x = np.zeros((n, 12), np.int32)
        y = np.zeros((n, 12), np.int32)
        x[~inf], y[~inf] = c.B.g1_affine_words([p for p in pts
                                               if not p.is_infinity()])
    else:
        x, y, _ = c.B.g2_affine_words_many(pts)
    live = ~inf
    live[8] = False
    sums = [gen.mul(0) for _ in range(n_groups)]
    for p, a, b, g, lv in zip(pts, lo, hi, groups, live):
        if lv:
            sums[g] = sums[g] + p.mul((a + b * c.LAMBDA) % c.R)
    ops = tuple(torch.from_numpy(a.copy()).to(c.dev) for a in (x, y, live))
    return plan, ops, [host_affine(p, k) for p in sums]


def host_affine(p, k):
    """A host point's affine canonical ints (None: ∞)."""
    a = p.to_affine()
    if a is None:
        return None
    if k == 1:
        return (a[0].n, a[1].n)
    return ((a[0].c0.n, a[0].c1.n), (a[1].c0.n, a[1].c1.n))


def words_affine(c, words, k):
    """(G, 3, [2,] 12) Jacobian words on the card → affine canonical ints
    per row (None: ∞), converted on the host."""
    from grandine_tpu_torch.crypto.fields import Fq2

    out = []
    for row in words.cpu():
        x, y, z = (c.L.words_to_ints(row[i].reshape(-1, 12)) for i in range(3))
        if not any(z):
            out.append(None)
        elif k == 1:
            zi = pow(z[0], -1, c.P)
            out.append((x[0] * zi * zi % c.P, y[0] * zi ** 3 % c.P))
        else:
            X, Y, Z = (Fq2.from_ints(*v) for v in (x, y, z))
            zi = Z.inv()
            ax, ay = X * zi * zi, Y * zi * zi * zi
            out.append(((ax.c0.n, ax.c1.n), (ay.c0.n, ay.c1.n)))
    return out


def host_msm(terms, infinity, phi):
    """Σ (r0 + r1·λ)·P over host (point, (r0, r1)) terms: the 2N points P,
    φ(P) with their 32-bit halves, 4-bit windows from the top, each window's
    buckets summed by the running-sum trick — plain host arithmetic, no
    device code and none of the port's plans."""
    pts = [(q, s) for p, (r0, r1) in terms for q, s in ((p, r0), (phi(p), r1))]
    acc = infinity
    for win in range(7, -1, -1):
        for _ in range(4):
            acc = acc.double()
        buckets = [infinity] * 16
        for q, s in pts:
            d = (s >> (4 * win)) & 15
            if d:
                buckets[d] = buckets[d] + q
        run = total = infinity
        for d in range(15, 0, -1):
            run = run + buckets[d]
            total = total + run
        acc = acc + total
    return acc


def msm_phase(c):
    """The Pippenger bucket MSM (gpu/msm.py, csrc/msm.cu) on the card. Its
    three kernels against their plain versions, G1 and G2, on edge rows,
    the composed sums equal to the host anchor's; the grouped route of
    `TorchBlsBackend.multi_verify` on the unaggregated and sync slots,
    valid, forged and swapped, every MSM launch held against its plain
    version word for word and the valid runs' sums equal to the host
    anchor's; the window sweep of gpu/autotune.py at the route's cells,
    its table compared with the port's committed msm_tune.json; the G2
    bucket MSM beside the ladder plane (multi_rlc_scale + g2_group_sum)
    on the same signature rows at the gossip, block and window shapes,
    timed and compared, deciding no route. Returns the timed rows of the three
    kernels at the route's shapes."""
    torch, np, A, B, M = c.torch, c.np, c.A, c.B, c.M
    from grandine_tpu_torch.crypto.curves import endo_constants
    from grandine_tpu_torch.crypto.fields import Fq, Fq2
    from grandine_tpu_torch.gpu import autotune
    from grandine_tpu_torch.testing import horner_rows as HR

    t_phase = time.perf_counter()
    at, dev = c.at, c.dev
    names = ("msm_lane_scan", "msm_bucket_reduce", "msm_horner")

    # -- edge rows ------------------------------------------------------------
    for k, n, g, w, lanes in MSM_EDGE:
        plan, (x, y, live), want = msm_edge_case(c, k, n, g, w, lanes,
                                                 0x3C00 + n)
        arr = M.upload_plan(plan, dev).arrays
        where = (f"edge rows, G{k}, {n} points in {g} groups, w = {w}, "
                 f"{plan.point_idx.shape[1]} lanes")
        emit = M.msm_lane_scan(x, y, live, *arr[:3])
        c.same("msm_lane_scan", emit,
               M.msm_lane_scan_plain(x, y, live, *arr[:3]), where)
        totals = M.msm_bucket_reduce(emit, *arr[3:])
        c.same("msm_bucket_reduce", totals,
               M.msm_bucket_reduce_plain(emit, *arr[3:]), where)
        # at the grouped route's windows the Horner edge groups
        # (testing/horner_rows.py) follow the case's own: one launch and one
        # plain call for both
        h_tot, h_names, h_sums = (HR.horner_totals(k, w, 0x4E00 + k)
                                  if (k, w) in HORNER_EDGE else (None, [], []))
        if h_names:
            totals = torch.cat([totals, torch.from_numpy(h_tot).to(dev)])
            where += f"; Horner edge groups: {', '.join(h_names)}"
        g_all = g + len(h_names)
        out = M.msm_horner(totals, g_all, w)
        c.same("msm_horner", out, M.msm_horner_plain(totals, g_all, w), where)
        if words_affine(c, out, k) != want + [host_affine(p, k)
                                              for p in h_sums]:
            fail(f"msm edge rows ({where}): sums differ from the host anchor")
    log(f"msm edge rows: {len(MSM_EDGE)} cases (∞ rows, a masked row, P and "
        f"−P, duplicates, zero halves, an empty group; the Horner edge "
        f"groups at G1 w = 4 and G2 w = 8), every sum the host anchor's "
        f"{at}")

    # -- the grouped route, every launch recorded -------------------------------
    (bx, by), (wx, wy) = (endo_constants()[g] for g in ("g1", "g2"))

    def phi(p, k):
        a = p.to_affine()
        if a is None:
            return p
        if k == 1:
            return c.Point.from_affine(a[0] * Fq(bx), a[1] * Fq(by), c.B1)
        return c.Point.from_affine(a[0] * Fq2.from_ints(wx, 0),
                                   a[1] * Fq2.from_ints(wy, 0), c.B2)

    recs = {name: Recorder(M, name, lambda *a: a) for name in names}
    route_ops = {}  # (shape, field) -> the valid run's operands a kernel
    route_launches = {}  # (shape, field) -> the valid run's launches a kernel
    anchor_s = 0.0
    for rec in recs.values():
        rec.__enter__()
    try:
        for where, (ml, sl, kl) in c.shapes.items():
            groups = B.message_groups(ml)
            forged = list(sl)
            forged[7] = sl[8]
            other = next((i for i, m in enumerate(ml) if m != ml[3]), 4)
            swapped = list(sl)
            swapped[3], swapped[other] = sl[other], sl[3]
            for variant, s_l in (("valid", sl), ("forged", forged),
                                 ("swapped", swapped)):
                seed = 0x5EED + len(ml) + len(route_ops)
                first = {n_: len(r.calls) for n_, r in recs.items()}
                c.count_reset()
                v = c.backend.multi_verify(ml, s_l, kl, rng=SimpleNamespace(
                    randbits=random.Random(seed).getrandbits))
                torch.cuda.synchronize()
                launches = {k_: n_ for k_, n_ in c.count_read().items() if n_}
                log(f"msm grouped route, {where}, {variant}: -> {v}; "
                    f"launches {json.dumps(launches)}")
                if v is not (variant == "valid") or \
                        launches != GROUPED_LAUNCHES:
                    fail(f"msm grouped route, {where}, {variant}: verdict or "
                         f"launches")
                if variant != "valid":
                    continue
                for k in (1, 2):  # G1 then G2: each kernel's k-th call
                    route_ops[(where, k)] = {
                        n_: recs[n_].calls[first[n_] + k - 1] for n_ in names}
                    # this run's launches of each instance (the wrappers
                    # count G1 and G2 together): Jacobian words out are
                    # (…, 3, 12) in G1, (…, 3, 2, 12) in G2
                    route_launches[(where, k)] = {
                        n_: sum(out.dim() - 2 == k
                                for _, out in recs[n_].calls[first[n_]:])
                        for n_ in names}
                    if set(route_launches[(where, k)].values()) != {1}:
                        fail(f"msm grouped route, {where}: G{k} launches "
                             f"{route_launches[(where, k)]}, one a kernel "
                             f"expected")
                # the host anchor: the route's pairs (its draw replayed),
                # in message order
                t0 = time.perf_counter()
                draw = SimpleNamespace(
                    randbits=random.Random(seed).getrandbits)
                pairs = {i: B.TorchBlsBackend._rlc_pair(draw)
                         for ix in groups.values() for i in ix}
                g1 = [host_msm([(kl[i].point, pairs[i]) for i in ix],
                               c.G1.mul(0), lambda p: phi(p, 1))
                      for ix in groups.values()]
                g2 = host_msm([(sl[i].point, pairs[i]) for i in pairs],
                              c.G2.mul(0), lambda p: phi(p, 2))
                anchor_s += time.perf_counter() - t0
                got1 = words_affine(c, route_ops[(where, 1)]["msm_horner"][1],
                                    1)
                got2 = words_affine(c, route_ops[(where, 2)]["msm_horner"][1],
                                    2)
                if got1 != [host_affine(p, 1) for p in g1] or \
                        got2 != [host_affine(g2, 2)]:
                    fail(f"msm grouped route, {where}: the sums differ from "
                         f"the host anchor's")
                log(f"msm grouped route, {where}: {len(groups)} key sums and "
                    f"the signature sum equal the host anchor's affine points "
                    f"{at}")
    finally:
        for rec in recs.values():
            rec.__exit__()
    worst = {}
    for name, rec in recs.items():
        plain = getattr(M, name + "_plain")
        err = 0
        for args, out in rec.calls:
            err = max(err, c.same(name, out, plain(*args),
                                  "every launch of the grouped route"))
        worst[name] = (err, len(rec.calls))
    log(f"msm: every grouped-route launch held against its plain version "
        f"({json.dumps(worst)} (max |kernel - plain|, launches)); host "
        f"anchor sums {anchor_s:.1f} s (host) {at}")

    # -- the window sweep ----------------------------------------------------------
    t0 = time.perf_counter()
    times = {}
    table = autotune.sweep(repeats=3, verbose=None, times=times, device=dev)
    for (key, field, w), ms in sorted(times.items()):
        log(f"msm sweep {key} G{field} w={w}: {ms:.3f} ms (plan upload and "
            f"the three kernels, CUDA events, best of 3) {at}")
    # the committed table is left as it is: a sweep that disagrees is
    # reported, and `python -m grandine_tpu_torch.gpu.autotune` run by
    # hand is what rewrites it
    path = B.msm_tune_path()
    committed = B.load_msm_tuning(path) or {}
    log(f"msm window sweep ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(dict(sorted(table.items())))}; the committed table "
        f"{os.path.relpath(path, HERE)}: "
        f"{json.dumps(dict(sorted(committed.items())))} — "
        f"{'the same' if committed == table else 'they differ'} {at}")

    # -- the G2 bucket MSM beside the ladders ---------------------------------
    def cuda_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    for where, scale in c.ladder_shapes.items():
        src_x, src_y, idx, sx, sy, mask, r01 = scale
        n = idx.shape[0]
        r = r01.cpu().numpy().view(np.uint32).astype(np.uint64)
        t0 = time.perf_counter()
        plan = M.plan_msm(r[:, 0], r[:, 1], mask.cpu().numpy(), None, 1,
                          window_bits=B.pick_msm_window(n, 1))
        plan_ms = (time.perf_counter() - t0) * 1e3
        on_card = M.upload_plan(plan, dev)
        live = ~mask

        def ladder():
            return B.g2_group_sum(
                B.multi_rlc_scale(src_x, src_y, idx, sx, sy, mask, r01)[1],
                [0, n])

        ladder_ms = cuda_ms(ladder)
        msm_ms = cuda_ms(lambda: M.msm_bucket_sum(sx, sy, live, plan))
        kern_ms = cuda_ms(lambda: M.msm_bucket_sum(sx, sy, live, on_card))
        a_l = words_affine(c, ladder(), 2)
        a_m = words_affine(c, M.msm_bucket_sum(sx, sy, live, on_card), 2)
        if a_l != a_m:
            fail(f"msm beside the ladders, {where}: the G2 sums differ")
        log(f"msm beside ladders, {where}, {n} signature rows: G2 bucket MSM "
            f"(w = {plan.window_bits}, S×T = {plan.point_idx.shape[0]}×"
            f"{plan.point_idx.shape[1]}, J = {plan.gather_idx.shape[0]}) "
            f"{kern_ms:.3f} ms for its three kernels, {msm_ms:.3f} ms with "
            f"the plan's upload (host plan {plan_ms:.1f} ms before it); "
            f"multi_rlc_scale (G1 and G2 ladders) + g2_group_sum "
            f"{ladder_ms:.3f} ms; same sum; MSM / ladders "
            f"{kern_ms / ladder_ms:.3f} — measured, deciding no route {at}")

    # -- the timed rows: each kernel at the route's shapes -----------------------
    rows = []
    for (where, k), ops_k in route_ops.items():
        tag = f"grouped route, {where}, G{k}"
        px, py, live, pidx, valid, flush = ops_k["msm_lane_scan"][0]
        emit, gidx, gvalid = ops_k["msm_bucket_reduce"][0]
        totals, n_groups, wbits = ops_k["msm_horner"][0]
        n = px.shape[0]
        pidx_h, valid_h, flush_h = (t.cpu().numpy() for t in (pidx, valid,
                                                              flush))
        live_h = live.cpu().numpy()
        e = pidx_h[valid_h]
        entries = int((live_h[np.where(e < n, e, e - n)]).sum())
        phis = int((live_h[np.where(e < n, e, e - n)] & (e >= n)).sum())
        flushes = int(flush_h.sum())
        J, n_sec, n_dig = gidx.shape
        gvalid_h = gvalid.cpu().numpy()
        pieces = int(gvalid_h.sum())
        piece_adds = pieces - int(gvalid_h.any(axis=0).sum())
        n_l = route_launches[(where, k)]
        log(f"msm_horner, {tag}, {n_groups} groups: geometry (blocks, "
            f"threads, shared bytes, blocks an SM) "
            f"{M.msm_horner_geometry(k, n_groups)} {at}")
        pt = 144 * k
        suffix = "" if k == 1 else "/g2"
        rows += [
            ("msm_lane_scan", tag,
             lambda a=ops_k["msm_lane_scan"][0]: M.msm_lane_scan(*a),
             lambda a=ops_k["msm_lane_scan"][0]: M.msm_lane_scan_plain(*a), 5,
             c.ops.msm_scan(k, entries, phis, flushes),
             n * (2 * 48 * k + 1) + pidx_h.size * 6 + flushes * pt,
             "grandine_tpu/tpu/msm.py:244", n_l["msm_lane_scan"],
             "msm_lane_scan" + suffix),
            ("msm_bucket_reduce", tag,
             lambda a=ops_k["msm_bucket_reduce"][0]: M.msm_bucket_reduce(*a),
             lambda a=ops_k["msm_bucket_reduce"][0]:
             M.msm_bucket_reduce_plain(*a), 5,
             c.ops.msm_reduce(k, piece_adds, pieces, n_sec, n_dig),
             J * n_sec * n_dig * 5 + pieces * pt + n_sec * pt,
             "grandine_tpu/tpu/msm.py:244", n_l["msm_bucket_reduce"],
             "msm_bucket_reduce" + suffix),
            ("msm_horner", tag,
             lambda a=ops_k["msm_horner"][0]: M.msm_horner(*a),
             lambda a=ops_k["msm_horner"][0]: M.msm_horner_plain(*a), 5,
             c.ops.msm_horner(k, n_groups, n_sec // n_groups, wbits),
             n_sec * pt + n_groups * pt,
             "grandine_tpu/tpu/msm.py:244", n_l["msm_horner"],
             "msm_horner" + suffix),
        ]
    log(f"msm phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


def main() -> None:
    started = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "grandine_tpu_torch", "csrc")):
        fail("run from a checkout of the repository (grandine_tpu_torch/ "
             "not found beside this script)")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, HERE)
    import numpy as np

    from grandine_tpu_torch.crypto import bls as A
    from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, P, R, X
    from grandine_tpu_torch.crypto.curves import G1
    from grandine_tpu_torch.crypto.fields import batch_inverse
    from grandine_tpu_torch.crypto.hash_to_curve import (
        hash_to_field_fq2, hash_to_g2, map_to_curve_g2)
    from grandine_tpu_torch.gpu import _build
    from grandine_tpu_torch.gpu import bls as B
    from grandine_tpu_torch.gpu import curve as C
    from grandine_tpu_torch.gpu import ed25519 as GE
    from grandine_tpu_torch.gpu import finish_programs as FPG
    from grandine_tpu_torch.gpu import kzg as GK
    from grandine_tpu_torch.gpu import limbs as L
    from grandine_tpu_torch.gpu import msm as M
    from grandine_tpu_torch.gpu import pairing as TP
    from grandine_tpu_torch.gpu import spans as GS
    from grandine_tpu_torch.gpu.registry import DevicePubkeyRegistry
    from grandine_tpu_torch.testing import decompress_rows as DR
    from grandine_tpu_torch.testing import group_rows as GR
    from grandine_tpu_torch.testing import pairing_rows as PR
    from grandine_tpu_torch.testing import subgroup_rows as SR
    from grandine_tpu_torch.consensus.verifier import (
        SignatureInvalid, TorchVerifier)
    from grandine_tpu_torch.crypto.curves import (
        B1, B2, G2, LAMBDA, Point, g2_infinity)
    from grandine_tpu_torch.crypto.fields import Fq
    from grandine_tpu_torch.gpu.schemes import (
        dispatch_bls_compressed, dispatch_bls_host_decompress)
    from grandine_tpu_torch.runtime.isolation import (
        FaultLocalizer, max_device_passes)
    from grandine_tpu_torch.runtime.replay import dispatch_window
    from grandine_tpu_torch.runtime.verify_scheduler import (
        VerifyItem, host_check_item)

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    name, power, clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].rsplit(", ", 2)
    card = f"{name}, {power}"  # as --query-gpu=name,power.limit prints it
    clock_hz = float(clock.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    at = f"[{card}]"
    log(f"card: {card}; {sms} SMs, max SM clock {clock}")
    kernels = {
        "g1_decompress": C.g1_decompress,
        "g2_decompress_subgroup": C.g2_decompress_subgroup,
        "g2_subgroup_check": C.g2_subgroup_check,
        "aggregate_rlc_scale": B.aggregate_rlc_scale,
        "multi_rlc_scale": B.multi_rlc_scale,
        "g1_group_sum": B.g1_group_sum,
        "g2_group_sum": B.g2_group_sum,
        "miller_loop_pairs": TP.miller_loop_pairs,
        "rlc_finish": B.rlc_finish,
        "batch_sign": B.batch_sign,
        "g1_scalar_mul": GK.g1_scalar_mul,
        "ed25519_verify": GE.ed25519_verify,
        "span_update_grid": GS.span_update_grid,
        "rlc_partial": B.rlc_partial,
        "batch_pubkey": B.batch_pubkey,
        "g1_normalize": B.g1_normalize,
        "g2_normalize": B.g2_normalize,
        "unpack_words": B.unpack_words,
        "msm_lane_scan": M.msm_lane_scan,
        "msm_bucket_reduce": M.msm_bucket_reduce,
        "msm_horner": M.msm_horner,
    }

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    log(f"build: nvcc, one process per source, {time.perf_counter() - t0:.1f}"
        f" s{'' if _build.build_log else ' (sources unchanged: cached)'}")
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "==")) or (
                "spill" in line and " 0 bytes spill stores" not in line):
            log("  ptxas " + line.strip())
    free0 = torch.cuda.mem_get_info()[0]
    _build.library()
    limit = _build.stack_limit
    taken = free0 - torch.cuda.mem_get_info()[0]
    _build.set_stack_limit(24576)  # for comparison: a fixed 24 KiB
    taken_24k = free0 - torch.cuda.mem_get_info()[0]
    _build.set_stack_limit(limit)
    log(f"stack limit: {limit} B a thread (the deepest kernel's ptxas need, "
        f"rounded up to {_build.STACK_GRANULE} B); loading the kernels and "
        f"setting it took {taken / 2**20:.1f} MiB of device memory, "
        f"{taken_24k / 2**20:.1f} MiB with a 24576 B limit {at}")
    needs = {}
    for lib, names in (("pairing", ("rlc_finish_kernel", "rlc_partial_kernel",
                                    "miller_loop_pairs_kernel")),
                       ("decompress", ("g2_decompress_subgroup_kernel",
                                       "g2_subgroup_check_kernel")),
                       ("msm", HORNER_KERNELS),
                       ("aggregate", ("aggregate_rlc_scale_kernel",)),
                       ("sign", ("batch_sign_kernelILi4",
                                 "batch_sign_kernelILi2",
                                 "batch_sign_kernelILi1",
                                 "batch_pubkey_kernel")),
                       ("kzg", ("g1_scalar_mul_kernel",)),
                       ("ed25519", ("ed25519_ladder_kernel",
                                    "ed25519_tree_kernel")),
                       ("multi", MULTI_KERNELS)):
        with open(os.path.join(_build.BUILD_DIR, f"lib{lib}.so.log")) as fh:
            blog = fh.read()
        needs.update({k: kernel_ptxas(blog, k) for k in names})
        for k in names:
            if k in DETAILED_KERNELS:
                regs, stack = needs[k] or (None, None)
                spills = kernel_spills(blog, k)
                log(f"ptxas {k}: {regs} registers, {stack} B cumulative "
                    f"stack (ceiling {STACK_CEILING} B), spill stores / "
                    f"loads {spills} B")
    if None in needs.values():
        fail("a kernel's entry is missing from its ptxas log")
    log("ptxas stack: " + ", ".join(f"{k} {v[1]} B ({v[0]} registers)"
                                    for k, v in needs.items())
        + f"; the card-wide limit {limit} B")
    if max(v[1] for v in needs.values()) > STACK_CEILING:
        fail(f"a kernel's stack need rose above the {STACK_CEILING} B "
             f"ceiling")
    rounds, stages = FPG.tail_depth()
    log(f"rlc_finish tail: {rounds} rounds of one Fp product a lane and "
        f"{stages} output stages a live group, one Euclid inversion")
    rounds, stages = FPG.tail_depth(FPG.miller_runs())
    log(f"miller_loop_pairs: {rounds} rounds of one Fp product a lane and "
        f"{stages} output stages a pair, one warp a pair")

    # host prep: registry keys, committees, aggregates ------------------------
    rng = random.Random(20261017)
    # the backend's RLC draw (rng=) takes the `randbits` of `secrets`
    bits = SimpleNamespace(randbits=random.Random(20261018).getrandbits)
    t0 = time.perf_counter()
    sks, pubkeys = make_registry_keys(rng, N_VALIDATORS, P, R, G1,
                                      batch_inverse)
    committees = slot_committees(rng, N_VALIDATORS)
    roots = [rng.randbytes(32) for _ in committees]
    hpts = [hash_to_g2(m, DST_SIGNATURE) for m in roots]
    msgs, sigs, members = [], [], []
    for c, com in enumerate(committees):
        for _ in range(AGGREGATORS_PER_COMMITTEE):
            k = rng.randint(87, min(130, len(com)))
            mem = sorted(rng.sample(com, k))
            members.append(mem)
            msgs.append(roots[c])
            sigs.append(A.g2_to_bytes(hpts[c].mul(sum(sks[i] for i in mem)
                                                  % R)))
    prep_s = time.perf_counter() - t0
    m_aggs = len(msgs)
    n_members = sum(len(x) for x in members)
    log(f"host prep: {N_VALIDATORS} keys, {len(committees)} committees of "
        f"{min(map(len, committees))}-{max(map(len, committees))}, "
        f"{m_aggs} aggregates, {n_members} member signatures: "
        f"{prep_s:.1f} s (host, not device)")

    # 2. each kernel against its plain version on edge rows ----------------
    errs = {}

    def same(name, got, ref, where):
        got = got if isinstance(got, (tuple, list)) else (got,)
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        err = 0
        for g, r in zip(got, ref, strict=True):
            g64 = g.cpu().to(torch.int64)
            r64 = r.cpu().to(torch.int64)
            if g.dtype == torch.int32:
                g64, r64 = g64 & 0xFFFFFFFF, r64 & 0xFFFFFFFF
            if g64.shape != r64.shape:
                fail(f"{name}: shape {tuple(g64.shape)} vs {tuple(r64.shape)}")
            err = max(err, int((g64 - r64).abs().max()) if g64.numel() else 0)
        log(f"check {name} ({where}): max |kernel - plain| = {err} "
            f"(exact required) {at}")
        if err:
            fail(f"{name} disagrees with its plain version ({where})")
        return err

    small = 2048
    rows = np.frombuffer(b"".join(pubkeys[:small - 2]), np.uint8).reshape(
        -1, 48)
    rows = np.concatenate([rows, np.frombuffer(
        bytes([0xC0]) + bytes(47) + bytes([0x80]) + b"\xff" * 47,
        np.uint8).reshape(2, 48)])
    rows_t = torch.from_numpy(rows.copy()).to(dev)
    edge = "edge rows: infinity, bad rows, ∞ pairs, a 3-member aggregate"
    same("g1_decompress", C.g1_decompress(rows_t),
         C.g1_decompress_plain(rows_t), edge)
    sm = 8
    nonsub = A.g2_to_bytes(map_to_curve_g2(
        hash_to_field_fq2(b"ng-0", b"SGT", 1)[0]))
    t_dec = time.perf_counter()
    d_edges, d_names = DR.edge_rows()
    srows = np.concatenate([np.frombuffer(
        b"".join(sigs[:sm - 2] + [nonsub, bytes([0x80]) + b"\x11" * 95]),
        np.uint8).reshape(-1, 96), d_edges])
    srows_t = torch.from_numpy(srows.copy()).to(dev)
    dec = C.g2_decompress_subgroup(srows_t)
    same("g2_decompress_subgroup", dec, C.g2_decompress_subgroup_plain(srows_t),
         f"{edge}; the edge corpus of testing/decompress_rows.py: "
         f"{', '.join(dict.fromkeys(d_names))}")
    if list(zip(dec[3][sm:].tolist(), dec[7][sm:].tolist())) != [
            DR.EXPECTED[n] for n in d_names]:
        fail("g2_decompress_subgroup: the edge corpus's (ok, in_subgroup) "
             "flags are not the corpus's")
    log(f"g2_decompress_subgroup edge launch, {srows.shape[0]} rows: "
        f"geometry (blocks, threads, shared bytes, blocks an SM) "
        f"{C.g2_decompress_subgroup_geometry(srows.shape[0])}; its check "
        f"({sm} edge rows and the corpus's {d_edges.shape[0]}, one launch "
        f"and one plain call) in {time.perf_counter() - t_dec:.2f} s")
    dec = tuple(t[:sm] for t in dec)
    reg_small = DevicePubkeyRegistry(device=dev)
    sub_members = [[i % (small - 2) for i in mm[:40]] for mm in members[:sm]]
    idx = np.zeros((sm, 40), np.int32)
    cnt = np.zeros((sm,), np.int32)
    for i, mm in enumerate(sub_members):
        idx[i, : len(mm)] = mm
        cnt[i] = len(mm)
    cnt[1] = 3
    reg_small.ensure(pubkeys[: small - 2])
    rx, ry, _ = reg_small.arrays()
    pairs = [B.TorchBlsBackend._rlc_pair(bits) for _ in range(sm)]
    r01 = torch.from_numpy(B.rlc_pairs_words(pairs)).to(dev)
    sig_mask = dec[2] | ~dec[3]
    args = (rx, ry, torch.from_numpy(idx).to(dev),
            torch.from_numpy(cnt).to(dev), dec[0], dec[1], sig_mask, r01)
    agg = B.aggregate_rlc_scale(*args)
    same("aggregate_rlc_scale", agg, B.aggregate_rlc_scale_plain(*args), edge)
    msg_w = torch.from_numpy(np.stack(
        [B.g2_affine_words(hpts[i % len(hpts)])[0] for i in range(sm)])).to(dev)
    pair_inf = agg[1].clone()
    pair_inf[2] = True
    f = TP.miller_loop_pairs(agg[0], msg_w, pair_inf)
    same("miller_loop_pairs", f, TP.miller_loop_pairs_plain(agg[0], msg_w,
                                                           pair_inf), edge)
    fin = (f, agg[2], agg[1], dec[3], dec[7])
    same("rlc_finish", B.rlc_finish(*fin), B.rlc_finish_plain(*fin), edge)
    # miller_loop_pairs at MILLER_EDGE pair counts (prefixes of one set of
    # rows: Z = 1 and Z ≠ 1, −g1, pair_inf rows) and aggregate_rlc_scale
    # on its edge rows, each launched EDGE_REPEATS times, every launch
    # equal to the plain version; the geometry and CUDA-event time a shape
    m_rows, m_msg, m_inf, m_tile = PR.miller_rows(max(MILLER_EDGE), 20261020)
    e_plain = TP.miller_loop_pairs_plain(*(torch.from_numpy(a).to(dev) for a
                                           in (m_rows, m_msg, m_inf)))
    e_rows = [torch.from_numpy(np.ascontiguousarray(a[m_tile])).to(dev)
              for a in (m_rows, m_msg, m_inf)]
    e_plain = e_plain[torch.from_numpy(m_tile).to(dev)]

    def repeats(fn):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        outs = [fn() for _ in range(EDGE_REPEATS)]
        e1.record()
        torch.cuda.synchronize()
        return outs, e0.elapsed_time(e1) / EDGE_REPEATS

    for n in MILLER_EDGE:
        outs, ms = repeats(lambda: TP.miller_loop_pairs(
            *(a[:n] for a in e_rows)))
        for o in outs:
            same("miller_loop_pairs", o, e_plain[:n],
                 f"edge rows, {n} pairs (Z = 1 and Z ≠ 1, −g1, the "
                 f"generator and hashed messages, "
                 f"{int(e_rows[2][:n].sum())} pair_inf)")
        log(f"miller_loop_pairs edge, {n} pairs: geometry (blocks, "
            f"threads, shared bytes, blocks an SM) "
            f"{TP.miller_loop_pairs_geometry(n)}; {ms:.3f} ms a launch "
            f"(CUDA events, {EDGE_REPEATS} launches) {at}")
    a_args = [torch.from_numpy(a).to(dev)
              for a in PR.aggregate_rows(PR.AGGREGATE_EDGES, 20261021)]
    a_plain = B.aggregate_rlc_scale_plain(*a_args)
    outs, ms = repeats(lambda: B.aggregate_rlc_scale(*a_args))
    for o in outs:
        same("aggregate_rlc_scale", o, a_plain, "edge rows: r0 = 0; r1 = 0; "
             "r = 1; halves 0xFFFFFFFF; 130 members; a sum to ∞; the same "
             "key twice; one member; masked signatures")
    if a_plain[1].tolist() != [i in (4, 8) for i in range(len(a_args[3]))]:
        fail(f"aggregate_rlc_scale edges: agg_inf {a_plain[1].tolist()}")
    log(f"aggregate_rlc_scale edge rows ({len(a_args[3])} aggregates): "
        f"{ms:.3f} ms a launch (CUDA events, {EDGE_REPEATS} launches, each "
        f"equal to the plain version) {at}")
    # rlc_finish's edge groups, each launched FINISH_REPEATS times with
    # identical verdicts; held against the plain version with the other
    # recorded finish calls, in the batched plain calls after the timings
    finish_edge = []
    for where, ops in finish_edge_calls(torch, np, L, P, fin):
        first = B.rlc_finish(*ops)
        for _ in range(FINISH_REPEATS - 1):
            if not torch.equal(B.rlc_finish(*ops), first):
                fail(f"rlc_finish: verdicts moved between repeats ({where})")
        finish_edge.append((f"edge group: {where}, {FINISH_REPEATS} "
                            f"launches alike", ops, first))
    log(f"rlc_finish edge groups: {len(finish_edge)} calls, each launched "
        f"{FINISH_REPEATS} times with the same verdicts")

    # 3. the main path at real size -------------------------------------------
    # every launch of miller_loop_pairs and aggregate_rlc_scale from here on
    # (the timing table's own launches aside, checked in the table) is
    # recorded and held against the plain version at the end
    pair_recs = [Recorder(TP, "miller_loop_pairs", miller_operands),
                 Recorder(B, "aggregate_rlc_scale", aggregate_operands)]
    # copies of the results: the grouped program zeroes rpk's Z of its ∞
    # members after the launch
    group_recs = [Recorder(B, "multi_rlc_scale", multi_operands,
                           lambda out: tuple(t.clone() for t in out)),
                  Recorder(B, "g1_group_sum", group_operands, torch.clone),
                  Recorder(B, "g2_group_sum", group_operands, torch.clone)]
    for r in pair_recs + group_recs:
        r.__enter__()
    backend = B.TorchBlsBackend()
    registry = DevicePubkeyRegistry()

    def items_of(msg_l, sig_l, mem_l):
        return [VerifyItem(m, s, member_indices=mm, pubkey_columns=pubkeys)
                for m, s, mm in zip(msg_l, sig_l, mem_l)]

    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = dispatch_bls_compressed(items_of(msgs, sigs, members), backend,
                                 registry)()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"main path: registry {registry.count} keys at capacity "
        f"{registry.capacity} ingested on the card, valid batch of {m_aggs} "
        f"aggregates -> {ok} ({first_s:.2f} s incl. ingest) {at}")
    log(f"launches on the gossip path: {json.dumps(launches)}")
    if ok is not True:
        fail("the valid batch did not verify")
    gossip_kernels = ("g1_decompress", "g2_decompress_subgroup",
                      "aggregate_rlc_scale", "miller_loop_pairs", "rlc_finish")
    if any(launches[k] < 1 for k in gossip_kernels):
        fail(f"a kernel of the gossip path was not launched: {launches}")
    rx, ry, _ = registry.arrays()
    for i in (0, 1, N_VALIDATORS - 1):
        aff = A.g1_from_bytes(pubkeys[i], subgroup_check=False).to_affine()
        if L.words_to_ints(rx[i]) != [aff[0].n] or \
                L.words_to_ints(ry[i]) != [aff[1].n]:
            fail(f"registry row {i} disagrees with the host decompression")

    def row(x1):
        r = bytearray(x1.to_bytes(48, "big") + bytes(48))
        r[0] |= 0x80
        return bytes(r)

    c1 = 1
    while True:  # x = c1·u with no point over it
        from grandine_tpu_torch.crypto.fields import Fq2
        xx = Fq2.from_ints(0, c1)
        if (xx * xx * xx + Fq2.from_ints(4, 4)).sqrt() is None:
            break
        c1 += 1
    bad = {
        "forged_signature": (msgs, [sigs[1]] + sigs[1:], members),
        "non_canonical_row": (msgs, sigs[:5] + [row(P + 2)] + sigs[6:],
                              members),
        "off_curve_row": (msgs, sigs[:7] + [row(c1)] + sigs[8:], members),
        "outside_g2": (msgs, sigs[:9] + [nonsub] + sigs[10:], members),
        "identity_committee": (msgs, sigs[:11] + [bytes([0xC0]) + bytes(95)]
                               + sigs[12:], members[:11] +
                               [[0, N_VALIDATORS - 1]] + members[12:]),
    }
    for name, (ml, sl, mm) in bad.items():
        v = dispatch_bls_compressed(items_of(ml, sl, mm), backend, registry)()
        log(f"bad batch {name}: -> {v}")
        if v is not False:
            fail(f"bad batch {name} verified")
    v = backend.fast_aggregate_verify_batch_indexed_compressed(
        [msgs[0]], [bytes([0xC0]) + bytes(95)], [[0, N_VALIDATORS - 1]],
        registry)
    log(f"bad seam call identity_committee (infinity signature, device "
        f"rule): -> {v}")
    if v is not False:
        fail("the [P, -P] committee with an infinity signature verified")
    # the keyed seam: the last committee's items carry materialized keys
    keyed = items_of(msgs, sigs, members)
    for i in range(m_aggs - AGGREGATORS_PER_COMMITTEE, m_aggs):
        keyed[i] = VerifyItem(msgs[i], sigs[i], public_keys=[
            A.PublicKey(A.g1_from_bytes(pubkeys[j], subgroup_check=False))
            for j in members[i]])
    v = dispatch_bls_compressed(keyed, backend, registry)()
    log(f"mixed batch ({m_aggs - AGGREGATORS_PER_COMMITTEE} indexed + "
        f"{AGGREGATORS_PER_COMMITTEE} keyed items, both seams): -> {v}")
    if v is not True:
        fail("the mixed indexed + keyed batch did not verify")
    for i in (0, m_aggs // 2, m_aggs - 1):
        keys = [A.PublicKey(A.g1_from_bytes(pubkeys[j], subgroup_check=False))
                for j in members[i]]
        if not A.Signature.from_bytes(sigs[i]).fast_aggregate_verify(
                msgs[i], keys):
            fail(f"host anchor rejects aggregate {i}")
    log("host anchor: 3 aggregates verify on the host")

    # 4. the block-verify path ------------------------------------------------
    brng = random.Random(20261019)
    t0 = time.perf_counter()
    blocks = [make_block(brng, N_VALIDATORS, sks, R, sign_roots)
              for _ in range(WINDOW_BLOCKS)]
    block = blocks[0]
    # the validators' keys as the state holds them (affine, decompressed
    # once): from the registry rows the card decompressed
    xs, ys = L.words_to_ints(rx[:N_VALIDATORS]), L.words_to_ints(
        ry[:N_VALIDATORS])
    keys = [A.PublicKey(Point.from_affine(Fq(x), Fq(y), B1))
            for x, y in zip(xs, ys)]
    n_sets = len(block)
    log(f"host prep: {WINDOW_BLOCKS} blocks of {n_sets} signature sets "
        f"({ATTESTATIONS_PER_BLOCK} attestation aggregates of 87-130, "
        f"proposer, RANDAO, a {SYNC_COMMITTEE_SIZE}-member sync aggregate) "
        f"signed: {time.perf_counter() - t0:.1f} s (host, not device)")

    def feed(verifier, sets):
        """The transition's calls: one key a singular set, the members'
        keys (aggregated by the verifier) an aggregate."""
        for root, mem, sig in sets:
            if len(mem) == 1:
                verifier.verify_singular(root, sig, keys[mem[0]])
            else:
                verifier.verify_aggregate(root, sig, [keys[i] for i in mem])

    def block_verdict(sets, be):
        v = TorchVerifier(be)
        feed(v, sets)
        try:
            v.finish()
        except SignatureInvalid:
            return False
        return True

    def with_set(sets, i, root=None, mem=None, sig=None):
        out = list(sets)
        r0, m0, s0 = out[i]
        out[i] = (root or r0, mem or m0, sig or s0)
        return out

    block_backend = B.TorchBlsBackend()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = block_verdict(block, block_backend)
    torch.cuda.synchronize()
    block_launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"block path: TorchVerifier over one block of {n_sets} sets -> {ok} "
        f"({time.perf_counter() - t0:.2f} s, hash-to-G2 cache cold) {at}")
    log(f"launches on the block path: {json.dumps(block_launches)}")
    if ok is not True:
        fail("the valid block did not verify")
    block_kernels = ("g2_subgroup_check", "multi_rlc_scale",
                     "miller_loop_pairs", "rlc_finish")
    if any(block_launches[k] < 1 for k in block_kernels):
        fail(f"a kernel of the block path was not launched: {block_launches}")
    bad_block = {
        "forged_set": with_set(block, 5, sig=block[6][2]),
        "swapped_message": with_set(with_set(block, 7, root=block[8][0]), 8,
                                    root=block[7][0]),
        "infinity_key": with_set(block, 9, mem=[0, N_VALIDATORS - 1]),
    }
    block_single = {"valid": ok}  # the mesh phase's single-device verdicts
    for name, sets in bad_block.items():
        v = block_verdict(sets, block_backend)
        log(f"bad block {name} (TorchVerifier): -> {v}")
        if v is not False:
            fail(f"bad block {name} verified")
        block_single[{"forged_set": "forged",
                      "swapped_message": "swapped"}.get(name, name)] = v
    outside = with_set(block, 10, sig=nonsub)
    v = TorchVerifier(block_backend)
    feed(v, outside)
    try:
        v.finish_async()
        fail("a signature outside G2 passed host decompression")
    except SignatureInvalid as e:
        log(f"bad block outside_g2 (TorchVerifier): SignatureInvalid at host "
            f"decompression ({e})")
    agg_keys = [keys[mem[0]] if len(mem) == 1
                else A.PublicKey.aggregate([keys[i] for i in mem])
                for _, mem, _ in block]
    block_msgs = [root for root, _, _ in block]
    block_sigs = [sig for _, _, sig in block]
    block_sig_objs = [A.Signature.from_bytes(s) for s in block_sigs]
    v = block_backend.multi_verify_compressed(block_msgs, block_sigs, agg_keys)
    log(f"block through multi_verify_compressed: -> {v}")
    if v is not True:
        fail("the block did not verify through multi_verify_compressed")
    v = block_backend.multi_verify_compressed(
        block_msgs, [s for _, _, s in outside], agg_keys)
    log(f"bad block outside_g2 (multi_verify_compressed): -> {v}")
    if v is not False:
        fail("a signature outside G2 verified through multi_verify_compressed")
    # multi_verify_indexed: the registry with the block's aggregate keys
    # appended as rows; the proposer and RANDAO sets sign with one
    # validator's row
    agg_rows = [i for i, (_, mem, _) in enumerate(block) if len(mem) > 1]
    block_registry = DevicePubkeyRegistry()
    block_registry.ensure(pubkeys + tuple(
        A.g1_to_bytes(agg_keys[i].point) for i in agg_rows))
    rows_of = {i: N_VALIDATORS + j for j, i in enumerate(agg_rows)}
    indices = [rows_of.get(i, mem[0]) for i, (_, mem, _) in enumerate(block)]
    v = block_backend.multi_verify_indexed(
        block_msgs, block_sig_objs, indices, block_registry)
    log(f"block through multi_verify_indexed ({block_registry.count} rows, "
        f"{len(agg_rows)} of them the block's aggregate keys): -> {v}")
    if v is not True:
        fail("the block did not verify through multi_verify_indexed")

    # the new kernels against their plain versions on edge rows -------------
    # (g2_subgroup_check also on testing/subgroup_rows.py's, after the 8
    # rows the multi_rlc_scale edge calls below pick from)
    edge_pts = [A.g2_from_bytes(s, subgroup_check=False)
                for s in sigs[:6] + [nonsub]] + [g2_infinity()]
    *sub_words, sub_names, sub_want = SR.edge_rows()
    ex, ey, einf = (torch.from_numpy(np.concatenate([a, b])).to(dev)
                    for a, b in zip(B.g2_affine_words_many(edge_pts),
                                    sub_words))
    edge2 = (f"edge rows: 6 signatures, a point of E2 outside G2, ∞; "
             f"{', '.join(dict.fromkeys(sub_names))}")
    got = C.g2_subgroup_check(ex, ey, einf)
    same("g2_subgroup_check", got, C.g2_subgroup_check_plain(ex, ey, einf),
         edge2)
    if got.tolist() != [True] * 6 + [False, True] + sub_want:
        fail(f"g2_subgroup_check verdicts {got.tolist()}")
    for n_g in (ex.shape[0], n_sets, len(blocks) * n_sets):
        log(f"g2_subgroup_check, {n_g} rows: geometry (blocks, threads, "
            f"shared bytes, blocks an SM) "
            f"{C.g2_subgroup_check_geometry(n_g)} {at}")
    # N = 1: the last registry row with the point outside G2; N = 8:
    # rows 0 and 49,999 first, the 6 signatures, the point outside G2, ∞
    for rows_e, pick in (([N_VALIDATORS - 1], [6]),
                         ([0, N_VALIDATORS - 1] + list(range(1, 7)),
                          list(range(8)))):
        n_e = len(rows_e)
        pairs = [B.TorchBlsBackend._rlc_pair(bits) for _ in range(n_e)]
        args = (rx, ry, torch.tensor(rows_e, dtype=torch.int32, device=dev),
                ex[pick].contiguous(), ey[pick].contiguous(),
                einf[pick].contiguous(),
                torch.from_numpy(B.rlc_pairs_words(pairs)).to(dev))
        same("multi_rlc_scale", B.multi_rlc_scale(*args),
             B.multi_rlc_scale_plain(*args),
             f"N = {n_e}: registry rows {rows_e[:2]}, signature rows {pick} "
             f"of the edge rows")

    # the group-indexed finish and g1_group_sum on edge rows: partition
    # passes over 6 gossip aggregates (bucket 8) with item 1 forged and
    # item 3 keyless — at G = 8 span 1 with G = B, the keyless item's group
    # and the two padding groups dead; at G = 4 span 2 (one thread a group
    # still, its loop taking the slots in turn), the last group all
    # padding, group 1's only other slot the keyless one — and the offsets
    # of a group sum with empty groups
    rpk8 = B.multi_rlc_scale(*args)[0]
    off_e = [0, 0, 3, 3, 8]
    same("g1_group_sum", B.g1_group_sum(rpk8, off_e),
         B.g1_group_sum_plain(rpk8, off_e),
         f"offsets {off_e}: empty groups, 8 rows of multi_rlc_scale")
    # multi_rlc_scale's edge sets and the group sums' plan edges
    # (testing/group_rows.py), each with its launch geometry
    t_edges = time.perf_counter()
    m_args = tuple(torch.from_numpy(a).to(dev)
                   for a in GR.multi_rows(GR.MULTI_EDGES, 20261022))
    same("multi_rlc_scale", B.multi_rlc_scale(*m_args),
         B.multi_rlc_scale_plain(*m_args), "edge sets: r0 = 0, r1 = 0, "
         "r = 1, r = 0, halves 0xFFFFFFFF, a masked signature, one key in "
         "three sets")
    for n_m in (len(GR.MULTI_EDGES), n_sets, len(blocks) * n_sets):
        log(f"multi_rlc_scale, {n_m} sets: geometry (blocks, threads, "
            f"shared bytes, blocks an SM) "
            f"{B.launch_geometry('multi_rlc_scale', n_m)} {at}")
    for k in (1, 2):
        name = f"g{k}_group_sum"
        rows_g, off_g, names_g = GR.group_rows(k, 20261023 + k,
                                               B.group_tile(k))
        rows_g = torch.from_numpy(rows_g).to(dev)
        same(name, getattr(B, name)(rows_g, off_g),
             getattr(B, name + "_plain")(rows_g, off_g),
             f"plan edges: {', '.join(dict.fromkeys(names_g))}")
        log(f"{name}, plan edges: {group_geometry(B, k, off_g)} {at}")
    log(f"multi_rlc_scale and group-sum edges: "
        f"{time.perf_counter() - t_edges:.1f} s")
    e_keys = [[keys[j] for j in members[i]] for i in range(6)]
    e_keys[3] = []
    e_sigs = [A.Signature.from_bytes(sigs[i]) for i in range(6)]
    e_sigs[1] = e_sigs[2]
    def recording_finish():
        return Recorder(B, "rlc_finish", finish_operands)

    for groups, want in ((8, [1, 0, 1, 0, 1, 1, 1, 1]), (4, [0, 0, 1, 1])):
        with recording_finish() as rec:
            got = block_backend.rlc_partition_verify(msgs[:6], e_sigs,
                                                     e_keys, groups, rng=bits)
        (ops_e, verdict_e), = rec.calls
        geo = B.rlc_finish_geometry(ops_e[0], ops_e[1], ops_e[5], ops_e[6])
        same("rlc_finish", verdict_e, B.rlc_finish_plain(*ops_e),
             f"partition of 6 items at G = {groups}: "
             f"{geo[0]} blocks of {geo[1]} threads, dead groups "
             f"{[j for j, (a, b) in enumerate(zip(ops_e[5], ops_e[5][1:])) if a == b]}")
        log(f"rlc_partition_verify, 6 items, G = {groups}: {got.tolist()}")
        if got.astype(int).tolist() != want:
            fail(f"partition verdicts {got.tolist()} at G = {groups}, "
                 f"expected {want}")

    # 5. the replay window and the uncompressed gossip seams ------------------
    window = [s for b in blocks for s in b]

    def window_items(sets):
        return [VerifyItem(root, sig, public_keys=[keys[i] for i in mem])
                for root, mem, sig in sets]

    def timed_window(items, be):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        settle = dispatch_window(items, be)
        t1 = time.perf_counter()
        v = settle()
        return v, t1 - t0, time.perf_counter() - t1

    window_backend = B.TorchBlsBackend()
    v, host_s, wait_s = timed_window(window_items(window), window_backend)
    log(f"window: {WINDOW_BLOCKS} blocks, {len(window)} sets through "
        f"dispatch_window, hash-to-G2 cache cold: -> {v} (host prep + enqueue "
        f"{host_s * 1e3:.1f} ms, device wait {wait_s * 1e3:.1f} ms; "
        f"{len(window) / (host_s + wait_s):.1f} sets/s) {at}")
    if v is not True:
        fail("the valid window did not verify")
    window_cold = (host_s, wait_s)
    window_single = {"valid": v}  # the mesh phase's single-device verdicts
    k5 = 5 * n_sets + 3
    bad_window = {
        "forged_set_in_block_5": with_set(window, k5, sig=window[k5 + 1][2]),
        "outside_g2_in_block_3": with_set(window, 3 * n_sets + 2, sig=nonsub),
    }
    for name, sets in bad_window.items():
        v = timed_window(window_items(sets), window_backend)[0]
        if name == "forged_set_in_block_5":
            window_single["forged"] = v
        log(f"bad window {name}: -> {v}")
        if v is not False:
            fail(f"bad window {name} verified")
    v = dispatch_bls_host_decompress(items_of(msgs, sigs, members), backend,
                                     registry)()
    log(f"gossip batch of {m_aggs} aggregates through "
        f"dispatch_bls_host_decompress (uncompressed seams): -> {v}")
    if v is not True:
        fail("the gossip batch did not verify through the uncompressed seams")
    ml, sl, mm = bad["outside_g2"]
    v = dispatch_bls_host_decompress(items_of(ml, sl, mm), backend,
                                     registry)()
    log(f"bad batch outside_g2 (dispatch_bls_host_decompress): -> {v}")
    if v is not False:
        fail("a signature outside G2 verified through the uncompressed seams")


    # 6. fault localization of failed batches, and the grouped route ----------
    def count_reset():
        for fn in kernels.values():
            fn.launches = 0

    def count_read():
        return {k: fn.launches for k, fn in kernels.items()}

    finish_records = []  # (where, recorded rlc_finish call)

    def localize_failed(where, items, bad):
        """The batch fails through dispatch_bls_compressed; then localize
        names exactly the bad items, every pass timed, no host sweep,
        within the pass bound. Returns the run's launches and passes."""
        v = dispatch_bls_compressed(items, backend, registry)()
        if v is not False:
            fail(f"{where}: the failed batch verified")
        leaf_s = []

        def leaf(item):
            t = time.perf_counter()
            out = host_check_item(item)
            leaf_s.append(time.perf_counter() - t)
            return out

        loc = FaultLocalizer(host_check=leaf)
        count_reset()
        with recording_finish() as rec:
            timer = PassTimer(backend, torch, rec, B.rlc_finish_geometry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            verdicts = loc.localize(timer, items)
            total = time.perf_counter() - t0
        run_launches = count_read()
        finish_records.extend((where, r) for r in rec.calls)
        want = [i not in bad for i in range(len(items))]
        device_passes = loc.passes["g2_subgroup"] + loc.passes["rlc_partition"]
        bound = max_device_passes(len(items))
        passes_s = sum(r[2] for r in timer.rows)
        log(f"localize {where}: {len(items)} items, named bad "
            f"{[i for i, x in enumerate(verdicts) if not x]} (forged "
            f"{sorted(bad)}); {device_passes} device passes (bound {bound}), "
            f"{loc.passes['host']} host-sweep passes; {total * 1e3:.1f} ms = "
            f"host pre-pass {(total - passes_s - sum(leaf_s)) * 1e3:.1f} ms + "
            f"passes {passes_s * 1e3:.1f} ms + {len(leaf_s)} host leaf checks "
            f"{sum(leaf_s) * 1e3:.1f} ms {at}")
        for kind, size, secs, geo in timer.rows:
            if kind == "subgroup":
                log(f"  pass g2_subgroup over {size} items: "
                    f"{secs * 1e3:.1f} ms {at}")
                continue
            waves = -(-geo[0] // (geo[3] * sms)) if geo[3] else 0
            log(f"  pass rlc_partition G = {size}: {secs * 1e3:.1f} ms; "
                f"rlc_finish {geo[0]} blocks of {geo[1]} threads, "
                f"{geo[2]} B dynamic shared memory, {geo[3]} blocks an SM, "
                f"{waves} wave(s) on {sms} SMs {at}")
        if verdicts != want:
            fail(f"{where}: localize named {verdicts}, expected {want}")
        if loc.passes["host"] or device_passes > bound:
            fail(f"{where}: {dict(loc.passes)} (bound {bound})")
        if run_launches["rlc_finish"] != loc.passes["rlc_partition"] or \
                run_launches["g2_subgroup_check"] < loc.passes["g2_subgroup"]:
            fail(f"{where}: launches {run_launches} for passes "
                 f"{dict(loc.passes)}")
        return run_launches, dict(loc.passes), timer.rows

    gossip_bad = {
        "1 forged": {0},
        "3 forged in one group of 8": {40, 45, 50},
        "3 forged in different groups": {5, 100, 180},
        "1 outside G2": {9},
    }
    loc_launches = {}
    for where, bad_items in gossip_bad.items():
        sl = list(sigs)
        for i in bad_items:
            sl[i] = nonsub if where == "1 outside G2" else sigs[i + 1]
        loc_launches[where] = localize_failed(
            f"gossip slot, {where}", items_of(msgs, sl, members), bad_items)[0]

    # the unaggregated attestation slot: each of the slot's validators
    # signs its committee's root; keys in arithmetic progression, so each
    # committee's signatures come by successive G2 additions
    t0 = time.perf_counter()
    a0, d0 = sks[0], (sks[1] - sks[0]) % R
    unagg_pts = {}
    for c, com in enumerate(committees):
        for i, pt in progression_points(hpts[c], a0, d0, com, R).items():
            unagg_pts[i] = (c, pt)
    order = sorted(unagg_pts, key=lambda i: (unagg_pts[i][0], i))
    u_msgs = [roots[unagg_pts[i][0]] for i in order]
    u_sigs = [A.Signature(unagg_pts[i][1]) for i in order]
    u_keys = [keys[i] for i in order]
    sync_root = rng.randbytes(32)
    sync_members = sorted(rng.sample(range(N_VALIDATORS - 1),
                                     SYNC_COMMITTEE_SIZE))
    h_sync = hash_to_g2(sync_root, DST_SIGNATURE)
    s_pts = progression_points(h_sync, a0, d0, sync_members, R)
    s_msgs = [sync_root] * SYNC_COMMITTEE_SIZE
    s_sigs = [A.Signature(s_pts[i]) for i in sync_members]
    s_keys = [keys[i] for i in sync_members]
    u_bytes = [A.g2_to_bytes(s.point) for s in u_sigs]
    if not A.Signature.from_bytes(u_bytes[0]).verify(u_msgs[0], u_keys[0]):
        fail("the host anchor rejects an unaggregated signature")
    log(f"host prep: {len(order)} unaggregated signatures over "
        f"{len(roots)} roots and a {SYNC_COMMITTEE_SIZE}-signer sync "
        f"committee slot by G2 additions: {time.perf_counter() - t0:.1f} s "
        f"(host, not device)")
    u_bad = {100, 1000}
    u_sl = list(u_bytes)
    for i in u_bad:
        u_sl[i] = u_bytes[i + 1]
    wide_where = f"unaggregated slot, 2 forged (bucket {B._bucket(len(order))})"
    loc_launches["wide"], _, _ = localize_failed(
        wide_where, [VerifyItem(m, sb, member_indices=[i],
                                pubkey_columns=pubkeys)
                     for m, sb, i in zip(u_msgs, u_sl, order)], u_bad)

    # the grouped route: both shapes valid, forged, swapped
    grouped_records = {}
    shapes = {
        f"sync committee, {SYNC_COMMITTEE_SIZE} signers over 1 root":
            (s_msgs, s_sigs, s_keys),
        f"unaggregated slot, {len(order)} signers over {len(roots)} roots":
            (u_msgs, u_sigs, u_keys),
    }
    for where, (ml, sl, kl) in shapes.items():
        groups = B.message_groups(ml)
        if not B.grouped_route(len(groups), max(map(len, groups.values())),
                               len(ml)):
            fail(f"{where}: the JAX package's rule does not group it")
        count_reset()
        with recording_finish() as fin_rec:
            v = backend.multi_verify(ml, sl, kl)
            torch.cuda.synchronize()
        grouped_records[where] = (fin_rec.calls[0], count_read())
        log(f"grouped route, {where}: valid -> {v}; launches "
            f"{json.dumps(grouped_records[where][1])}")
        if v is not True or {k: n for k, n in grouped_records[where][1].items()
                             if n} != GROUPED_LAUNCHES:
            fail(f"{where}: the valid batch or its launches")
        forged = list(sl)
        forged[7] = sl[8]
        # set 3 and the first set of another root (of set 4 on one root)
        other = next((i for i, m in enumerate(ml) if m != ml[3]), 4)
        swapped = list(sl)
        swapped[3], swapped[other] = sl[other], sl[3]
        for name, bad_l in (("1 forged", forged),
                            ("2 swapped " + ("across roots" if other != 4
                                             else "between signers"),
                             swapped)):
            v = backend.multi_verify(ml, bad_l, kl)
            log(f"grouped route, {where}, {name}: -> {v}")
            if v is not False:
                fail(f"{where}: {name} verified")

    # both routes on the same triples, in turns (flat, grouped, grouped,
    # flat), host prep apart from the device wait
    route_rows = {}
    for where, (ml, sl, kl) in shapes.items():
        groups = B.message_groups(ml)
        fx_k, fy_k = B.g1_affine_words([pk.point for pk in kl])
        sx_k, sy_k = backend._up(fx_k), backend._up(fy_k)
        idx_k = np.arange(len(ml), dtype=np.int32)
        runs = {
            "flat": lambda: backend._flat_multi_verify_async(
                ml, sl, sx_k, sy_k, idx_k, DST_SIGNATURE, bits, False),
            "grouped": lambda: backend._grouped_multi_verify_async(
                groups, sl, fx_k, fy_k, DST_SIGNATURE, bits),
        }
        rows_r = {"flat": [], "grouped": []}
        for name in ["flat", "grouped"] + ["flat", "grouped", "grouped",
                                           "flat"] * ROUTE_ROUNDS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            settle = runs[name]()
            t1 = time.perf_counter()
            if settle() is not True:
                fail(f"{where}: the {name} route rejected a valid batch")
            rows_r[name].append((time.perf_counter() - t0, t1 - t0))
        for name, rr in rows_r.items():
            rr = rr[1:]  # the first of each route warms it up
            total = statistics.median(r[0] for r in rr)
            host = statistics.median(r[1] for r in rr)
            route_rows[(where, name)] = total
            log(f"route {name}, {where}: p50 {total * 1e3:.1f} ms over "
                f"{len(rr)} (host prep + enqueue {host * 1e3:.1f} ms, device "
                f"wait {(total - host) * 1e3:.1f} ms) {at}")
        g, f_ = route_rows[(where, "grouped")], route_rows[(where, "flat")]
        log(f"route comparison, {where}: grouped / flat = {g / f_:.3f} "
            f"({'grouped' if g < f_ else 'flat'} faster by "
            f"{abs(f_ - g) * 1e3:.1f} ms) {at}")

    # every batch_sign and g1_scalar_mul launch of phases 7-9 is recorded
    # and held against the plain versions after phase 9
    ladder_recs = [Recorder(B, "batch_sign", lambda *a, **k: (a, k)),
                   Recorder(GK, "g1_scalar_mul", lambda *a, **k: (a, k))]
    for r in ladder_recs:
        r.__enter__()

    # 7. the signing path: the operator slot through the signing plane,
    # aggregate construction, a chaos round, one full bucket ------------------
    ops = OpModel(P, -X)
    sign_ctx = SimpleNamespace(
        torch=torch, np=np, A=A, B=B, dev=dev, at=at, sms=sms, R=R,
        dst=DST_SIGNATURE, same=same, ops=ops, sks=sks, keys=keys,
        committees=committees, roots=roots, hpts=hpts, unagg_pts=unagg_pts,
        sync_root=sync_root, sync_members=sync_members, s_pts=s_pts, a0=a0,
        d0=d0, count_reset=count_reset, count_read=count_read,
        sign_rounds=SIGN_ROUNDS, chaos_signers=CHAOS_SIGNERS,
        full_bucket=B.MAX_BUCKET, settle_timeout_s=5.0, clock_hz=clock_hz)
    sign_rows = signing_phase(sign_ctx)

    # 8. the blob-KZG plane at full width: the official setup, a block's
    # blobs -------------------------------------------------------------------
    from grandine_tpu_torch.kzg.setup import official_setup

    t0 = time.perf_counter()
    kzg_setup = official_setup()
    log(f"kzg setup: the official trusted setup ({kzg_setup.width} Lagrange "
        f"points) parsed, or loaded from its cache, in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    kzg_ctx = SimpleNamespace(
        torch=torch, np=np, A=A, B=B, R=R, dev=dev, at=at, same=same, ops=ops,
        setup=kzg_setup, n_blobs=MAX_BLOBS_PER_BLOCK, kzg_reps=KZG_REPS,
        count_reset=count_reset, count_read=count_read, sms=sms,
        clock_hz=clock_hz)
    kzg_rows = kzg_phase(kzg_ctx)

    # 9. the verify scheduler: every lane through VerifyScheduler ------------
    t0 = time.perf_counter()
    sched_rows = scheduler_phase(SimpleNamespace(
        torch=torch, np=np, A=A, dev=dev, at=at, same=same, keys=keys,
        block=block, block_backend=block_backend, s_msgs=s_msgs,
        s_sigs=s_sigs, s_keys=s_keys, blobs=kzg_ctx.blobs,
        comms=kzg_ctx.comms, proofs=kzg_ctx.proofs, setup=kzg_setup,
        block_reps=SCHED_BLOCK_REPS, ed_batches=16, settle_timeout_s=5.0,
        count_reset=count_reset,
        count_read=count_read))
    log(f"scheduler phase: {time.perf_counter() - t0:.1f} s")
    for r in ladder_recs:
        r.__exit__()
    t0 = time.perf_counter()
    check_ladder_launches(torch, B, GK, ladder_recs, same)
    log(f"ladder plain checks: {time.perf_counter() - t0:.1f} s")

    # 10. the slasher at full width: six epoch windows and a poisoned one ------
    slasher_rows = slasher_phase(SimpleNamespace(
        torch=torch, np=np, dev=dev, at=at, same=same,
        n_validators=SLASHER_VALIDATORS, targets=SLASHER_TARGETS,
        span_edge=SPAN_EDGE, count_reset=count_reset, count_read=count_read))

    # 11. the multi-device verify plane over virtual shards of the card -----
    mesh_rows = mesh_phase(SimpleNamespace(
        torch=torch, np=np, A=A, B=B, dev=dev, at=at, ops=ops, keys=keys,
        pubkeys=pubkeys, block=block, with_set=with_set,
        block_verdict=block_verdict, block_single=block_single,
        window=window, window_items=window_items,
        window_single=window_single, block_backend=block_backend,
        window_backend=window_backend, backend=backend, registry=registry,
        msgs=msgs, sigs=sigs, members=members,
        sync=(s_msgs, s_sigs, s_keys), unagg=(u_msgs, u_sigs, u_keys),
        block_msgs=block_msgs, block_sig_objs=block_sig_objs,
        agg_keys=agg_keys, count_reset=count_reset, count_read=count_read,
        settle_timeout_s=30.0))

    # 12. the reference-only programs at full width, the port's entry -------
    h_of = dict(zip(roots, hpts))
    h_of[sync_root] = h_sync
    reference_rows = reference_phase(SimpleNamespace(
        torch=torch, np=np, A=A, B=B, P=P, R=R, dev=dev, at=at, ops=ops,
        dst=DST_SIGNATURE, bits=bits, sks=sks, pubkeys=pubkeys, keys=keys,
        block=block, window=window, agg_keys=agg_keys,
        block_backend=block_backend, window_backend=window_backend,
        backend=backend, registry=registry, msgs=msgs, sigs=sigs,
        members=members, h_of=h_of, unagg=(u_msgs, u_sigs, u_keys),
        sync=(s_msgs, s_sigs, s_keys), nonsub=nonsub,
        full_sign=sign_ctx.full_sign, sms=sms, clock_hz=clock_hz,
        count_reset=count_reset, count_read=count_read))

    # 14. timings: the main-path operands of every kernel (phase 13 takes
    # the gossip, block and window signature planes from here too) --------
    def cuda_ms(fn, reps):
        out = fn()  # warm-up; its result is held against the plain version
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps, out

    def plain_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    # the main-path operands of every kernel
    raw = np.zeros((registry.capacity, 48), np.uint8)
    raw[:N_VALIDATORS] = np.frombuffer(b"".join(pubkeys), np.uint8).reshape(
        -1, 48)
    raw_t = torch.from_numpy(raw).to(dev)
    sig_rows = torch.from_numpy(np.frombuffer(b"".join(sigs), np.uint8)
                                .reshape(-1, 96).copy()).to(dev)
    k = max(len(x) for x in members)
    idx = np.zeros((m_aggs, k), np.int32)
    cnt = np.array([len(x) for x in members], np.int32)
    for i, mm in enumerate(members):
        idx[i, : len(mm)] = mm
    pairs = [B.TorchBlsBackend._rlc_pair(bits) for _ in range(m_aggs)]
    r01 = torch.from_numpy(B.rlc_pairs_words(pairs)).to(dev)
    dec = C.g2_decompress_subgroup(sig_rows)
    # the kernel's split at the gossip slot's rows: each row's stage
    # clocks (one more launch, held against the one above)
    t_split = time.perf_counter()
    split_out, clocks = C.g2_decompress_subgroup_split(sig_rows)
    if not all(torch.equal(a, b) for a, b in zip(split_out, dec)):
        fail("g2_decompress_subgroup: the split launch's outputs differ")
    clk = clocks.cpu().numpy().astype(np.float64)
    dec_c, psi_c = clk[:, 1] - clk[:, 0], clk[:, 2] - clk[:, 1]
    log(f"g2_decompress_subgroup split, {m_aggs} rows, one warp a row "
        f"(stage clocks, mean / max a row): decompression "
        f"{dec_c.mean():.0f} / {dec_c.max():.0f} cycles "
        f"({dec_c.mean() / clock_hz * 1e3:.3f} ms at the max SM clock), "
        f"psi check {psi_c.mean():.0f} / {psi_c.max():.0f} cycles "
        f"({psi_c.mean() / clock_hz * 1e3:.3f} ms); decompression's share "
        f"{dec_c.mean() / (dec_c + psi_c).mean():.3f}; geometry (blocks, "
        f"threads, shared bytes, blocks an SM) "
        f"{C.g2_decompress_subgroup_geometry(m_aggs)}; the split launch and "
        f"its check in {time.perf_counter() - t_split:.2f} s {at}")
    agg_args = (rx, ry, torch.from_numpy(idx).to(dev),
                torch.from_numpy(cnt).to(dev), dec[0], dec[1],
                dec[2] | ~dec[3], r01)
    agg = B.aggregate_rlc_scale(*agg_args)
    msg_w = torch.from_numpy(np.stack([B.g2_affine_words(hpts[i // 16])[0]
                                       for i in range(m_aggs)])).to(dev)
    ml_args = (agg[0], msg_w, agg[1])
    f = TP.miller_loop_pairs(*ml_args)
    fin = (f, agg[2], agg[1], dec[3], dec[7])
    if B.rlc_finish(*fin).item() != 1:
        fail("the timed operands do not verify")

    def flat_operands(sets, be):
        """The operands TorchBlsBackend.multi_verify_async gives the flat
        kernels for `sets` (keys aggregated on the host, hash-to-G2 points
        from `be`'s warm cache)."""
        pts = [A.g2_from_bytes(sig, subgroup_check=False)
               for _, _, sig in sets]
        sx, sy, sinf = (torch.from_numpy(a.copy()).to(dev)
                        for a in B.g2_affine_words_many(pts))
        fx, fy = B.g1_affine_words([
            keys[mem[0]].point if len(mem) == 1
            else A.PublicKey.aggregate([keys[i] for i in mem]).point
            for _, mem, _ in sets])
        n = len(sets)
        fl_pairs = [B.TorchBlsBackend._rlc_pair(bits) for _ in range(n)]
        scale = (torch.from_numpy(fx.copy()).to(dev),
                 torch.from_numpy(fy.copy()).to(dev),
                 torch.arange(n, dtype=torch.int32, device=dev), sx, sy, sinf,
                 torch.from_numpy(B.rlc_pairs_words(fl_pairs)).to(dev))
        sub = C.g2_subgroup_check(sx, sy, sinf)
        rpk, rsig = B.multi_rlc_scale(*scale)
        msg = torch.from_numpy(np.stack([
            be._hash_to_g2_words(root, DST_SIGNATURE)[0]
            for root, _, _ in sets])).to(dev)
        none = torch.zeros((n,), dtype=torch.bool, device=dev)
        ml = (rpk, msg, none)
        fin = (TP.miller_loop_pairs(*ml), rsig, none, ~none, sub)
        if B.rlc_finish(*fin).item() != 1:
            fail(f"the timed flat operands (N = {n}) do not verify")
        return (sx, sy, sinf), scale, fl_pairs, ml, fin

    blk = flat_operands(block, block_backend)
    win = flat_operands(window, window_backend)

    # 13. the Pippenger bucket MSM: edge rows, the grouped route's launches,
    # the window sweep, the G2 plane beside the ladders ------------------------
    first_member = torch.tensor([mm[0] for mm in members], dtype=torch.int32,
                                device=dev)
    msm_rows = msm_phase(SimpleNamespace(
        torch=torch, np=np, A=A, B=B, M=M, L=L, P=P, R=R, G1=G1, G2=G2,
        Point=Point, B1=B1, B2=B2, LAMBDA=LAMBDA, dev=dev, at=at, same=same,
        ops=ops, backend=backend, shapes=shapes, count_reset=count_reset,
        count_read=count_read, ladder_shapes={
            f"gossip batch, M = {m_aggs}": (
                rx, ry, first_member, dec[0], dec[1], dec[2] | ~dec[3], r01),
            f"block, N = {n_sets}": blk[1],
            f"window, N = {len(window)}": win[1]}))
    gossip = f"gossip batch, M = {m_aggs}"
    timed = [
        ("g1_decompress", lambda: C.g1_decompress(raw_t),
         lambda: C.g1_decompress_plain(raw_t), 3,
         ops.g1_row * raw.shape[0], raw.shape[0] * (48 + 96 + 5),
         "grandine_tpu/tpu/bls.py:868"),
        ("g2_decompress_subgroup", lambda: C.g2_decompress_subgroup(sig_rows),
         lambda: C.g2_decompress_subgroup_plain(sig_rows), 5,
         ops.g2_row * m_aggs, m_aggs * (96 + 96 + 6),
         "grandine_tpu/tpu/curve.py:786"),
        ("aggregate_rlc_scale", lambda: B.aggregate_rlc_scale(*agg_args),
         lambda: B.aggregate_rlc_scale_plain(*agg_args), 5,
         ops.aggregate(cnt.tolist(), pairs),
         n_members * (4 + 96) + m_aggs * (4 + 96 + 1 + 8 + 144 + 1 + 288),
         "grandine_tpu/tpu/bls.py:839"),
        ("miller_loop_pairs", lambda: TP.miller_loop_pairs(*ml_args),
         lambda: TP.miller_loop_pairs_plain(*ml_args), 5,
         ops.miller * m_aggs, m_aggs * (144 + 96 + 1 + 576),
         "grandine_tpu/tpu/pairing.py:208"),
        ("rlc_finish", lambda: B.rlc_finish(*fin),
         lambda: B.rlc_finish_plain(*fin), 5,
         ops.finish([(m_aggs, m_aggs)]), m_aggs * (576 + 288 + 3) + 1,
         "grandine_tpu/tpu/bls.py:162"),
    ]
    timed = [(name, gossip, *rest) for name, *rest in timed]
    for where, (sub_in, scale, fl_pairs, ml, fin_f) in (
            (f"block, N = {n_sets}", blk),
            (f"window, N = {len(window)}", win)):
        n = sub_in[2].shape[0]
        live = (~sub_in[2]).tolist()
        timed += [
            ("g2_subgroup_check", where,
             lambda a=sub_in: C.g2_subgroup_check(*a),
             lambda a=sub_in: C.g2_subgroup_check_plain(*a), 5,
             ops.subgroup(sum(live)), n * (96 + 96 + 1 + 1),
             "grandine_tpu/tpu/bls.py:919"),
            ("multi_rlc_scale", where, lambda a=scale: B.multi_rlc_scale(*a),
             partial(B.multi_rlc_scale_plain, *scale), 5,
             ops.multi(fl_pairs, live), n * (4 + 96 + 96 + 1 + 8 + 144 + 288),
             "grandine_tpu/tpu/bls.py:592"),
        ]
        if n > n_sets:  # the shared pairing kernels at the window's width
            timed += [
                ("miller_loop_pairs", where,
                 lambda a=ml: TP.miller_loop_pairs(*a),
                 partial(TP.miller_loop_pairs_plain, *ml), 5,
                 ops.miller * n, n * (144 + 96 + 1 + 576),
                 "grandine_tpu/tpu/pairing.py:208"),
                ("rlc_finish", where, lambda a=fin_f: B.rlc_finish(*a),
                 partial(B.rlc_finish_plain, *fin_f), 5,
                 ops.finish([(n, n)]), n * (576 + 288 + 3) + 1,
                 "grandine_tpu/tpu/bls.py:162"),
            ]
    # the reworked and new kernels on the operands their paths gave them:
    # rlc_finish at each partition width of two localizations and on the
    # grouped route, g1_group_sum on both grouped shapes; every other
    # recorded partition pass is held against the plain version below
    timed_finish = ("gossip slot, 3 forged in different groups", wide_where)
    for where, record in finish_records:
        if where not in timed_finish:
            continue
        groups, nbytes = finish_shape(record)
        g_n = len(groups)
        wide = where == wide_where and g_n == B._bucket(len(order))
        timed.append((
            "rlc_finish", f"{where}, partition G = {g_n}",
            lambda a=record[0]: B.rlc_finish(*a),
            partial(B.rlc_finish_plain, *record[0]), 3,
            ops.finish(groups), nbytes,
            "grandine_tpu/tpu/bls.py:177",
            loc_launches["wide" if where == wide_where else
                         where.split(", ", 1)[1]]["rlc_finish"],
            "rlc_finish/partition" if wide else "rlc_finish"))
    for where in reversed(list(shapes)):
        fin_rec, path_launches = grouped_records[where]
        groups, nbytes = finish_shape(fin_rec)
        timed.append((
            "rlc_finish", f"grouped route, {where}",
            lambda a=fin_rec[0]: B.rlc_finish(*a),
            partial(B.rlc_finish_plain, *fin_rec[0]), 3,
            ops.finish(groups), nbytes,
            "grandine_tpu/tpu/bls.py:483", path_launches["rlc_finish"],
            "rlc_finish"))
    timed += (sign_rows + kzg_rows + sched_rows + slasher_rows + mesh_rows
              + reference_rows + msm_rows)
    # rlc_finish calls checked in batched plain calls after the table
    # (finish_plain_batched): every other recorded partition pass, and
    # the timed rows of a kernels-line entry already timed at its first
    # shape, whose plain time is not taken again
    finish_checks = finish_edge + [
        (f"main-path operands, {where}, partition G = {len(ops_r[5]) - 1}",
         ops_r, verdict_r)
        for where, (ops_r, verdict_r) in finish_records
        if where not in timed_finish]

    for r in pair_recs + group_recs:  # the table times the wrappers
        r.__exit__(None, None, None)
    later = {r.name: r for r in pair_recs + group_recs}
    report = []
    sources = {name: src for src, names in _build.LIBRARIES.items()
               for name in names}
    sources.update({name: "msm.cu" for name in ("msm_lane_scan",
                                                "msm_bucket_reduce",
                                                "msm_horner")})
    t_table = time.perf_counter()
    for row in timed:
        name, where, kern, plain, reps, fp_muls, nbytes, replaces = row[:8]
        source = sources[name]
        ms, got = cuda_ms(kern, reps)
        b_ms, b_by = bound_ms(fp_muls, nbytes, sms, clock_hz,
                              *row[10:11])
        # launches: on the gossip path for its kernels, on the block path
        # for the kernels it brought, on its own path for the rest
        n_l = row[8] if len(row) > 8 else (
            launches if where == gossip else block_launches)[name]
        entry = row[9] if len(row) > 9 else name
        if isinstance(plain, HeldLaunch) and entry in errs:
            same(name, got, plain.words, f"main-path operands, {where}: "
                 f"the words of the launch held in {plain.where}")
            log(f"time {name} ({where}): kernel {ms:.3f} ms, plain in "
                f"{plain.where}, bound {b_ms:.4f} ms ({b_by}; {fp_muls} "
                f"field products, {nbytes} B), library none, launches on "
                f"its path {n_l} {at}")
            continue
        rec = later.get(name)
        if rec is not None and entry in errs and isinstance(plain, partial):
            # a later shape of a recorded kernel: its plain call joins the
            # batched checks of the recorded launches at the end
            rec.calls.append((rec.operands(*plain.args), got))
            log(f"time {name} ({where}): kernel {ms:.3f} ms, plain in the "
                f"batched check at the end, bound {b_ms:.4f} ms ({b_by}; "
                f"{fp_muls} field products, {nbytes} B), library none, "
                f"launches on its path {n_l} {at}")
            continue
        if name == "rlc_finish" and entry in errs:
            finish_checks.append((f"main-path operands, {where}",
                                  plain.args, got))
            log(f"time {name} ({where}): kernel {ms:.3f} ms, plain in the "
                f"batched check below, bound {b_ms:.4f} ms ({b_by}; "
                f"{fp_muls} field products, {nbytes} B), library none, "
                f"launches on its path {n_l} {at}")
            continue
        p_ms, ref = plain_ms(plain)
        err = same(name, got, ref, f"main-path operands, {where}")
        # the library column: stock PyTorch computing the same function,
        # where it can (the span grid's plain torch.where / minimum /
        # maximum expression), by CUDA events after warm-up
        lib_ms = None
        if len(row) > 11:
            lib_ms = cuda_ms(row[11], reps)[0]
        log(f"time {name} ({where}): kernel {ms:.3f} ms, plain {p_ms:.1f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}; {fp_muls} field products, "
            f"{nbytes} B), library "
            f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, launches "
            f"on its path {n_l} {at}")
        if entry in errs:  # the kernels line: each entry at its first shape
            continue
        errs[entry] = err
        report.append({
            "name": entry, "route": "cuda",
            "source": "grandine_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": n_l,
            "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
    t0 = time.perf_counter()
    refs = finish_plain_batched(B, torch, np, [ops for _, ops, _ in
                                               finish_checks])
    for (where, _, got), ref in zip(finish_checks, refs, strict=True):
        same("rlc_finish", got, ref, where)
    log(f"rlc_finish: {len(finish_checks)} calls held against batched "
        f"plain calls over their {sum(r.shape[0] for r in refs)} groups in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"timing table: {len(timed)} rows with their checks in "
        f"{time.perf_counter() - t_table:.1f} s")
    for r in pair_recs + group_recs:
        r.__enter__()

    # end to end: host prep apart from device time --------------------------
    # "warm": the same batch again, its 12 signing roots' hash-to-G2 points
    # cached. "cold": a backend with an empty cache each batch, as at one
    # batch per slot, where every slot brings new roots; the hash-to-G2 of
    # the 12 roots is also timed alone, outside the batch.
    items = items_of(msgs, sigs, members)
    for cache in ("warm", "cold"):
        totals, hosts, h2c = [], [], []
        for _ in range(E2E_BATCHES):
            if cache == "cold":
                t0 = time.perf_counter()
                for root in roots:
                    B.g2_affine_words(hash_to_g2(root, DST_SIGNATURE))
                h2c.append(time.perf_counter() - t0)
                backend = B.TorchBlsBackend()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            settle = dispatch_bls_compressed(items, backend, registry)
            t1 = time.perf_counter()
            v = settle()
            t2 = time.perf_counter()
            if v is not True:
                fail("a valid end-to-end batch did not verify")
            totals.append(t2 - t0)
            hosts.append(t1 - t0)
        p50 = statistics.median(totals)
        host50 = statistics.median(hosts)
        h2c_note = (f"; hash-to-G2 of the {len(roots)} roots, timed alone, "
                    f"{statistics.median(h2c) * 1e3:.1f} ms" if h2c else "")
        log(f"end to end, hash-to-G2 cache {cache}: batch p50 "
            f"{p50 * 1e3:.1f} ms over {E2E_BATCHES} valid batches (host prep "
            f"+ enqueue {host50 * 1e3:.1f} ms, device wait "
            f"{(p50 - host50) * 1e3:.1f} ms{h2c_note}); {m_aggs / p50:.1f} "
            f"aggregates/s, {n_members / p50:.0f} member signatures "
            f"covered/s {at}")
    # the block: "warm" is the same block again (its 131 roots' hash-to-G2
    # points cached); "cold" a backend with an empty cache each time, as
    # at one block per slot. Key aggregation (the verifier's calls), host
    # decompression + hash-to-G2 + enqueue (finish_async) and the device
    # wait are timed apart; decompression and hash-to-G2 also alone.
    t0 = time.perf_counter()
    for sig in block_sigs:
        A.Signature.from_bytes(sig)
    dec_alone = time.perf_counter() - t0
    t0 = time.perf_counter()
    for root in block_msgs:
        B.g2_affine_words(hash_to_g2(root, DST_SIGNATURE))
    h2c_alone = time.perf_counter() - t0
    log(f"block host prep timed alone: decompression of the {n_sets} "
        f"signatures with the subgroup check {dec_alone * 1e3:.1f} ms, "
        f"hash-to-G2 of the {n_sets} roots {h2c_alone * 1e3:.1f} ms (host)")
    for cache, reps in (("warm", BLOCK_REPS_WARM), ("cold", BLOCK_REPS_COLD)):
        rows = []
        for _ in range(reps):
            be = block_backend if cache == "warm" else B.TorchBlsBackend()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = TorchVerifier(be)
            feed(v, block)
            t1 = time.perf_counter()
            settle = v.finish_async()
            t2 = time.perf_counter()
            settle()
            rows.append((time.perf_counter() - t0, t1 - t0, t2 - t1))
        total, agg_s, prep_s = (statistics.median(c) for c in zip(*rows))
        log(f"block verify, hash-to-G2 cache {cache}: p50 {total * 1e3:.1f} "
            f"ms over {reps} blocks of {n_sets} sets (medians: key "
            f"aggregation {agg_s * 1e3:.1f} ms, decompression + hash-to-G2 + "
            f"enqueue {prep_s * 1e3:.1f} ms, device wait "
            f"{(total - agg_s - prep_s) * 1e3:.1f} ms); "
            f"{n_sets / total:.1f} sets/s {at}")
    rows = [timed_window(window_items(window), window_backend)
            for _ in range(WINDOW_REPS_WARM)]
    total = statistics.median(h + w for _, h, w in rows)
    host = statistics.median(h for _, h, _ in rows)
    log(f"window of {len(window)} sets, hash-to-G2 cache warm: p50 "
        f"{total * 1e3:.1f} ms over {WINDOW_REPS_WARM} (host prep + enqueue "
        f"{host * 1e3:.1f} ms, device wait {(total - host) * 1e3:.1f} ms); "
        f"{len(window) / total:.1f} sets/s; cold (above): "
        f"{sum(window_cold) * 1e3:.1f} ms {at}")
    if not all(v is True for v, _, _ in rows):
        fail("a valid window did not verify")
    for r in pair_recs + group_recs:
        r.__exit__(None, None, None)
    check_pairing_launches(torch, B, TP, pair_recs, same, dev)
    check_group_launches(torch, B, group_recs, same, dev)
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, the "
        f"build included")
    log(json.dumps({"kernels": report}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
