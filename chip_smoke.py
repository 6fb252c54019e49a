#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every CUDA
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the kernels from csrc/ (nvcc, sm_90a) and print ptxas' report;
  2. each of the five kernels against its plain version on the card, on
     edge rows at a reduced size (2,048 registry rows with infinity and
     bad rows, 8 aggregates with a bad and a non-G2 signature, ∞ pairs):
     exact equality;
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
     non-G2 rows, registry rows 0 and 49,999, N = 1);
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
     unaggregated slot (valid → True, forged or swapped → False, one
     launch of g1_group_sum each), and both routes timed on the same
     triples; the group-indexed rlc_finish and g1_group_sum against their
     plain versions on edge rows (phase 4) and on every recorded pass;
  7. each kernel again against its plain version, exactly, on the
     main-path operands (65,536 registry rows, 192 aggregates of up to 130
     members; the block's 131 sets; the window's 1,048 sets; the
     partition passes; both grouped shapes), and its time there (CUDA
     events, after warm-up) beside the plain version's and its bound;
     end-to-end p50 of the gossip batch, the block and the window with
     the hash-to-G2 cache warm and cold, host prep kept apart from
     device time.
Prints the card's name and power limit, one `kernels` JSON line, and as
its last line {"ok": true, "device": {...}}.
"""

import json
import os
import random
import statistics
import subprocess
import sys
import time
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
BLOCK_REPS_WARM, BLOCK_REPS_COLD, WINDOW_REPS_WARM = 5, 3, 3
#: rounds of (flat, grouped, grouped, flat) when both routes are timed
ROUTE_ROUNDS = 2
#: H100 HBM3 rate (NVIDIA data sheet, SXM part)
HBM_BYTES_PER_S = 3.35e12
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


def make_block(rng, n, sks, R, sign):
    """One block's signature sets as (signing root, signer indices,
    signature): 128 attestation aggregates of 87–130 members, each over
    its own attestation data root; the proposer's block signature and
    RANDAO reveal; a 512-member sync aggregate. Signer indices avoid the
    last key (r − sk₀)."""
    sets = []
    for _ in range(ATTESTATIONS_PER_BLOCK):
        sets.append((rng.randbytes(32),
                     sorted(rng.sample(range(n - 1), rng.randint(87, 130)))))
    proposer = rng.randrange(n - 1)
    sets += [(rng.randbytes(32), [proposer]), (rng.randbytes(32), [proposer]),
             (rng.randbytes(32),
              sorted(rng.sample(range(n - 1), SYNC_COMMITTEE_SIZE)))]
    return [(root, mem, sign(root, sum(sks[i] for i in mem) % R))
            for root, mem in sets]


# --- the bound of each kernel (operation counts at this run's shapes) ----


class OpModel:
    """Fp-product counts of the kernels as csrc/ runs them."""

    def __init__(self, P, abs_x):
        def pw(e):
            return e.bit_length() - 1 + bin(e).count("1") - 1
        self.sqrt = pw((P + 1) // 4) + 1
        self.inv = pw(P - 2)
        self.fp2, self.fp6, self.fp12 = 3, 18, 54
        self.dbl1, self.madd1, self.add1 = 7, 11, 16
        self.fq2_sqrt = 2 + 3 * self.sqrt + 2 + 2 * (self.sqrt + self.inv + 4)
        psi = (64 * self.dbl1 + (bin(abs_x).count("1") - 1) * self.madd1
               + self.add1) * 3 + 2 * 3
        self.psi = psi
        self.g1_row = 6 + self.sqrt
        self.g2_row = 2 + 6 + self.fq2_sqrt + 2 + psi + 4
        fp2_inv = 4 + self.inv
        fp6_inv = 12 * 3 + fp2_inv
        fp12_inv = 4 * self.fp6 + fp6_inv
        expx = 63 * self.fp12 + (bin(abs_x).count("1") - 1) * self.fp12
        self.final_exp = (fp12_inv + 5 * expx + 10 * self.fp12 + 5 * 21)
        dbl_step, add_step = 16 * 3 + 4, 23 * 3 + 4
        self.miller = (7 + 3 + 63 * (2 * self.fp12 + dbl_step)
                       + (bin(abs_x).count("1") - 1) * (add_step + self.fp12)
                       + 12)

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
        product with the f terms, the final exponentiation. A dead group
        costs nothing."""
        total = 0
        for nf, ns in groups:
            if not (nf or ns):
                continue
            total += (nf * 12 + ns * 6 + max(0, nf - 1) * self.fp12
                      + self.add1 * 3 * max(0, ns - 1)
                      + ((9 + self.miller + (self.fp12 if nf else 0))
                         if ns else 0)
                      + self.final_exp)
        return total

    def group_sum(self, counts):
        """g1_group_sum: each row's conversion, the complete additions past
        the first of each thread, the tree adds where both partials are
        live, the output conversion."""
        total = 0
        for c in counts:
            total += 3 * c + self.add1 * max(0, c - 128)
            live = min(c, 128)
            s = 64
            while s:
                total += self.add1 * max(0, min(s, live - s))
                live = min(live, s)
                s //= 2
            total += 3
        return total


def bound_ms(fp_muls, nbytes, sms, clock_hz):
    ops_s = fp_muls * MULS_PER_FP_MUL / (INT32_MUL_PER_CLK_SM * sms * clock_hz)
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


class Recorder:
    """Stands in for a kernel wrapper of gpu/bls.py while a `with` block
    runs (the backend looks its wrappers up as module globals at call
    time) and keeps each call as (its operands normalised by `operands`,
    its result). The launch count stays the wrapped function's."""

    def __init__(self, module, name, operands):
        self.module, self.name, self.operands = module, name, operands
        self.fn = getattr(module, name)
        self.calls = []

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((self.operands(*args, **kwargs), out))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


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


# --- main ------------------------------------------------------------------


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
    from grandine_tpu_torch.gpu import limbs as L
    from grandine_tpu_torch.gpu import pairing as TP
    from grandine_tpu_torch.gpu.registry import DevicePubkeyRegistry
    from grandine_tpu_torch.consensus.verifier import (
        SignatureInvalid, TorchVerifier)
    from grandine_tpu_torch.crypto.curves import B1, Point, g2_infinity
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
        "miller_loop_pairs": TP.miller_loop_pairs,
        "rlc_finish": B.rlc_finish,
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

    # host prep: registry keys, committees, aggregates -------------------------
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
    srows = np.frombuffer(b"".join(sigs[:sm - 2] + [nonsub, bytes([0x80]) +
                                                    b"\x11" * 95]),
                          np.uint8).reshape(-1, 96)
    srows_t = torch.from_numpy(srows.copy()).to(dev)
    dec = C.g2_decompress_subgroup(srows_t)
    same("g2_decompress_subgroup", dec, C.g2_decompress_subgroup_plain(srows_t),
         edge)
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

    # 3. the main path at real size ---------------------------------------------
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

    # 4. the block-verify path -------------------------------------------------
    brng = random.Random(20261019)
    t0 = time.perf_counter()
    blocks = [make_block(brng, N_VALIDATORS, sks, R,
                         lambda m, k: A.g2_to_bytes(
                             hash_to_g2(m, DST_SIGNATURE).mul(k)))
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
    for name, sets in bad_block.items():
        v = block_verdict(sets, block_backend)
        log(f"bad block {name} (TorchVerifier): -> {v}")
        if v is not False:
            fail(f"bad block {name} verified")
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
        block_msgs, [A.Signature.from_bytes(s) for s in block_sigs], indices,
        block_registry)
    log(f"block through multi_verify_indexed ({block_registry.count} rows, "
        f"{len(agg_rows)} of them the block's aggregate keys): -> {v}")
    if v is not True:
        fail("the block did not verify through multi_verify_indexed")

    # the new kernels against their plain versions on edge rows -------------
    edge_pts = [A.g2_from_bytes(s, subgroup_check=False)
                for s in sigs[:6] + [nonsub]] + [g2_infinity()]
    ex, ey, einf = (torch.from_numpy(a.copy()).to(dev)
                    for a in B.g2_affine_words_many(edge_pts))
    edge2 = "edge rows: 6 signatures, a point of E2 outside G2, ∞"
    got = C.g2_subgroup_check(ex, ey, einf)
    same("g2_subgroup_check", got, C.g2_subgroup_check_plain(ex, ey, einf),
         edge2)
    if got.tolist() != [True] * 6 + [False, True]:
        fail(f"g2_subgroup_check verdicts {got.tolist()}")
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
    e_keys = [[keys[j] for j in members[i]] for i in range(6)]
    e_keys[3] = []
    e_sigs = [A.Signature.from_bytes(sigs[i]) for i in range(6)]
    e_sigs[1] = e_sigs[2]
    def finish_operands(f, rsig, agg_inf, sig_ok, sig_sub, f_off=None,
                        s_off=None):
        fo, so, _, _ = B.finish_groups(f, rsig, f_off, s_off)
        return f, rsig, agg_inf, sig_ok, sig_sub, fo, so

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

    # 5. the replay window and the uncompressed gossip seams ---------------------
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
    k5 = 5 * n_sets + 3
    bad_window = {
        "forged_set_in_block_5": with_set(window, k5, sig=window[k5 + 1][2]),
        "outside_g2_in_block_3": with_set(window, 3 * n_sets + 2, sig=nonsub),
    }
    for name, sets in bad_window.items():
        v = timed_window(window_items(sets), window_backend)[0]
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


    # 6. fault localization of failed batches, and the grouped route -------------
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
        with recording_finish() as fin_rec, Recorder(
                B, "g1_group_sum",
                lambda rows, offsets: (rows, np.asarray(offsets))) as sum_rec:
            v = backend.multi_verify(ml, sl, kl)
            torch.cuda.synchronize()
        grouped_records[where] = (fin_rec.calls[0], sum_rec.calls[0],
                                  count_read())
        log(f"grouped route, {where}: valid -> {v}; launches "
            f"{json.dumps(grouped_records[where][2])}")
        if v is not True or any(grouped_records[where][2][k] != 1 for k in (
                "g1_group_sum", "multi_rlc_scale", "miller_loop_pairs",
                "rlc_finish", "g2_subgroup_check")):
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
        sx_k, sy_k = backend._keys_src([pk.point for pk in kl])
        idx_k = np.arange(len(ml), dtype=np.int32)
        runs = {
            "flat": lambda: backend._flat_multi_verify_async(
                ml, sl, sx_k, sy_k, idx_k, DST_SIGNATURE, bits, False),
            "grouped": lambda: backend._grouped_multi_verify_async(
                groups, sl, sx_k, sy_k, DST_SIGNATURE, bits),
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

    # 7. timings -----------------------------------------------------------------
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
    ops = OpModel(P, -X)
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
             lambda a=scale: B.multi_rlc_scale_plain(*a), 5,
             ops.multi(fl_pairs, live), n * (4 + 96 + 96 + 1 + 8 + 144 + 288),
             "grandine_tpu/tpu/bls.py:592"),
        ]
        if n > n_sets:  # the shared pairing kernels at the window's width
            timed += [
                ("miller_loop_pairs", where,
                 lambda a=ml: TP.miller_loop_pairs(*a),
                 lambda a=ml: TP.miller_loop_pairs_plain(*a), 5,
                 ops.miller * n, n * (144 + 96 + 1 + 576),
                 "grandine_tpu/tpu/pairing.py:208"),
                ("rlc_finish", where, lambda a=fin_f: B.rlc_finish(*a),
                 lambda a=fin_f: B.rlc_finish_plain(*a), 5,
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
            lambda a=record[0]: B.rlc_finish_plain(*a), 3,
            ops.finish(groups), nbytes,
            "grandine_tpu/tpu/bls.py:177",
            loc_launches["wide" if where == wide_where else
                         where.split(", ", 1)[1]]["rlc_finish"],
            "rlc_finish/partition" if wide else "rlc_finish"))
    for where in reversed(list(shapes)):
        fin_rec, sum_rec, path_launches = grouped_records[where]
        (rows_g, off_g), _ = sum_rec
        counts = np.diff(off_g).tolist()
        timed.append((
            "g1_group_sum", f"grouped route, {where}",
            lambda a=(rows_g, off_g): B.g1_group_sum(*a),
            lambda a=(rows_g, off_g): B.g1_group_sum_plain(*a), 5,
            ops.group_sum(counts), rows_g.shape[0] * 144
            + len(counts) * (144 + 4) + 4, "grandine_tpu/tpu/bls.py:483",
            path_launches["g1_group_sum"], "g1_group_sum"))
        groups, nbytes = finish_shape(fin_rec)
        timed.append((
            "rlc_finish", f"grouped route, {where}",
            lambda a=fin_rec[0]: B.rlc_finish(*a),
            lambda a=fin_rec[0]: B.rlc_finish_plain(*a), 3,
            ops.finish(groups), nbytes,
            "grandine_tpu/tpu/bls.py:483", path_launches["rlc_finish"],
            "rlc_finish"))
    for where, (ops_r, verdict_r) in finish_records:
        if where in timed_finish:
            continue
        same("rlc_finish", verdict_r, B.rlc_finish_plain(*ops_r),
             f"main-path operands, {where}, partition G = "
             f"{len(ops_r[5]) - 1}")

    report = []
    sources = {name: src for src, names in _build.LIBRARIES.items()
               for name in names}
    for row in timed:
        name, where, kern, plain, reps, fp_muls, nbytes, replaces = row[:8]
        source = sources[name]
        ms, got = cuda_ms(kern, reps)
        p_ms, ref = plain_ms(plain)
        err = same(name, got, ref, f"main-path operands, {where}")
        b_ms, b_by = bound_ms(fp_muls, nbytes, sms, clock_hz)
        # launches: on the gossip path for its kernels, on the block path
        # for the kernels it brought, on its own path for the rest
        n_l = row[8] if len(row) > 8 else (
            launches if where == gossip else block_launches)[name]
        entry = row[9] if len(row) > 9 else name
        log(f"time {name} ({where}): kernel {ms:.3f} ms, plain {p_ms:.1f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}; {fp_muls} Fp products, "
            f"{nbytes} B), launches on its path {n_l} {at}")
        if entry in errs:  # the kernels line: each entry at its first shape
            continue
        errs[entry] = err
        report.append({
            "name": entry, "route": "cuda",
            "source": "grandine_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": n_l,
            "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })

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
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, the "
        f"build included")
    log(json.dumps({"kernels": report}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
