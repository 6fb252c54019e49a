"""Cycles of the pieces of `rlc_finish`'s tail, and of the ladder steps of
`batch_sign` and `g1_scalar_mul`, on the card.

    python -m grandine_tpu_torch.gpu.tail_bench

Builds csrc/tail_bench.cu with nvcc (sm_90a) into csrc/build/ and times,
on one warp of one block with clock64: the Fp product, one of the
cyclotomic square's output forms, every warp program of
csrc/finish_programs.cuh (on seeded values: the G2 addition takes its
generic case), the Euclid inversion, the one-thread Fp12 product and G2
addition of the block's folds and a whole final exponentiation; the Fp
addition and subtraction, the G1 doubling and mixed addition (their Fp
products inlined, and on `fpc`, as calls), the G2 doubling and mixed
addition and the Fp2 product, each on every lane of the warp; an
`aggregate_rlc_scale` G1 lane and G2 half (csrc/aggregate.cu). Prints
the card's name and power limit, one line an operation (cycles, and µs at
the card's maximum SM clock) and one JSON object. Needs a card: it raises
without one.

    python -m grandine_tpu_torch.gpu.tail_bench --aggregate

times `aggregate_rlc_scale` (csrc/aggregate.cu, included in
csrc/tail_bench.cu: the same kernel and launch) at the gossip slot's
shape — AGG_M aggregates of 87–130 members gathered from AGG_KEYS keys —
by CUDA events, and splits each block's time by the kernel's stage
clocks (clock64): the gather and strided sum (thread 0), the tree, the G1
ladder, the G2 ladder; the launch's outputs are held against the plain
version, exactly.

    python -m grandine_tpu_torch.gpu.tail_bench --decompress

times `g2_decompress_subgroup` (csrc/decompress.cu, included: the same
kernel and launch, one warp a row) at DEC_ROWS rows of seeded G2
signatures with the edge rows of testing/decompress_rows.py among them,
by CUDA events, and splits each row's time by the stage clocks: the
decompression (square roots) against the ψ check; the last rows' outputs
are held against the plain version, exactly.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from grandine_tpu_torch.crypto.constants import P
from grandine_tpu_torch.gpu import _build
from grandine_tpu_torch.gpu import finish_programs as FP
from grandine_tpu_torch.gpu import limbs as L

SOURCE = os.path.join(_build.CSRC, "tail_bench.cu")
LIBRARY = os.path.join(_build.BUILD_DIR, "libtail_bench.so")
#: (name, operation id of tail_bench.cu, repetitions)
PIECES = [("fp_mul (a lane)", -1, 1000), ("form (CYC_SQ output)", -2, 1000),
          ("Euclid inversion (one lane)", -3, 20),
          ("fp12_mul_to (one thread)", -4, 20),
          ("point_add_complete (one thread)", -5, 20),
          ("final exponentiation", -6, 1),
          ("fp_add (a lane)", -7, 1000), ("fp_sub (a lane)", -8, 1000),
          ("G1 point_double (a lane)", -9, 100),
          ("G1 point_madd_unsafe (a lane)", -11, 100),
          ("G2 point_double (a lane)", -12, 50),
          ("G2 point_madd_unsafe (a lane)", -13, 50),
          ("fp2_mul (a lane)", -14, 200),
          ("G1 point_double, products as calls (a lane)", -15, 100),
          ("G1 point_madd_unsafe, products as calls (a lane)", -16, 100),
          ("aggregate G1 lane, 32 steps on fpc (one lane)", -17, 3),
          ("aggregate G2 half, 32 steps as warp programs", -18, 3)]


#: the gossip slot's aggregates (12 committees × 16 aggregators), the
#: keys they are gathered from, the rows' seed
AGG_M, AGG_KEYS, AGG_SEED = 192, 4096, 20261018
#: g2_decompress_subgroup's launched widths: a small gossip batch, the
#: block through multi_verify_compressed, the gossip slot, the grouped
#: compressed routes and the localization passes
DEC_ROWS = (8, 131, 192, 512, 1562)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def aggregate_stages(lib, K, hz, clock, reps=5):
    """aggregate_rlc_scale's time (CUDA events) and each stage's cycles
    (mean and max over the blocks) at the gossip slot's shape, its outputs
    against the plain version."""
    from grandine_tpu_torch.gpu import bls as B
    from grandine_tpu_torch.testing import pairing_rows as PR

    host = [torch.from_numpy(a) for a in PR.aggregate_rows(
        PR.gossip_cases(AGG_SEED, AGG_M, AGG_KEYS), AGG_SEED, AGG_KEYS)]
    cnt = host[3].numpy()
    k = host[2].shape[1]
    dev = [a.cuda() for a in host]
    rpk = torch.empty((AGG_M, 3, 12), dtype=torch.int32, device="cuda")
    agg_inf = torch.empty((AGG_M,), dtype=torch.bool, device="cuda")
    rsig = torch.empty((AGG_M, 3, 2, 12), dtype=torch.int32, device="cuda")
    clocks = torch.zeros((AGG_M, 5), dtype=torch.int64, device="cuda")

    def launch(clk):
        src_x, src_y, d_idx, d_cnt, d_gx, d_gy, d_inf, d_r = dev
        err = lib.tail_bench_aggregate(
            _ptr(src_x), _ptr(src_y), _ptr(d_idx), _ptr(d_cnt), AGG_M, k,
            _ptr(d_gx), _ptr(d_gy), _ptr(d_inf), _ptr(d_r), _ptr(rpk),
            _ptr(agg_inf), _ptr(rsig), _ptr(K), clk)
        if err:
            raise RuntimeError(f"aggregate_rlc_scale: CUDA error {err}")

    launch(None)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        launch(None)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    launch(_ptr(clocks))
    torch.cuda.synchronize()
    c = clocks.cpu().numpy()
    want = B.aggregate_rlc_scale_plain(*host)
    exact = all(torch.equal(g.cpu(), w) for g, w in
                zip((rpk, agg_inf, rsig), want))
    stages = {"gather and strided sum (thread 0)": c[:, 1] - c[:, 0],
              "tree": c[:, 2] - c[:, 1], "G1 ladder": c[:, 3] - c[:, 2],
              "G2 ladder": c[:, 4] - c[:, 2],
              "block": np.maximum(c[:, 3], c[:, 4]) - c[:, 0]}
    print(f"aggregate_rlc_scale, {AGG_M} aggregates of {cnt.min()}-"
          f"{cnt.max()} members from {AGG_KEYS} keys: {ms:.3f} ms (CUDA "
          f"events, {reps} launches); outputs equal to the plain version: "
          f"{exact}")
    out = {"ms": ms, "exact": exact}
    for name, v in stages.items():
        out[name] = {"mean": float(v.mean()), "max": int(v.max())}
        print(f"  {name}: mean {v.mean():.0f} cycles, max {v.max()} "
              f"({v.mean() / hz * 1e3:.3f} / {v.max() / hz * 1e3:.3f} ms at "
              f"{clock})")
    if not exact:
        raise RuntimeError("aggregate_rlc_scale differs from its plain "
                           "version")
    return out


def decompress_rows(n, seed):
    """n wire rows: 32 seeded G2 signatures tiled, the edge corpus of
    testing/decompress_rows.py in the last rows (as many as fit)."""
    import random

    from grandine_tpu_torch.crypto import bls as A
    from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, R
    from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
    from grandine_tpu_torch.testing import decompress_rows as DR

    rng = random.Random(seed)
    sigs = np.frombuffer(b"".join(
        A.g2_to_bytes(hash_to_g2(b"split-%d" % i, DST_SIGNATURE).mul(
            rng.randrange(1, R))) for i in range(32)), np.uint8).reshape(-1, 96)
    rows = sigs[np.arange(n) % 32].copy()
    edges = DR.edge_rows()[0]
    k = min(n // 2, edges.shape[0])
    rows[n - k:] = edges[:k]
    return rows


def decompress_stages(lib, K, hz, clock, reps=5, seed=AGG_SEED):
    """g2_decompress_subgroup at each of DEC_ROWS: its time (CUDA events),
    its rows' stage cycles (mean and max), and its last rows' outputs
    against the plain version's."""
    from grandine_tpu_torch.gpu import curve as C

    out = {}
    for n in DEC_ROWS:
        rows = torch.from_numpy(decompress_rows(n, seed)).cuda()
        x = torch.empty((n, 2, 12), dtype=torch.int32, device="cuda")
        y = torch.empty_like(x)
        flags = torch.empty((6, n), dtype=torch.bool, device="cuda")
        clocks = torch.zeros((n, 3), dtype=torch.int64, device="cuda")

        def launch(clk):
            err = lib.tail_bench_g2_decompress(
                _ptr(rows), _ptr(x), _ptr(y), _ptr(flags), n, _ptr(K), clk)
            if err:
                raise RuntimeError(f"g2_decompress_subgroup: CUDA error {err}")

        launch(None)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            launch(None)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / reps
        launch(_ptr(clocks))
        torch.cuda.synchronize()
        c = clocks.cpu().numpy()
        stages = {"decompression": c[:, 1] - c[:, 0],
                  "psi check": c[:, 2] - c[:, 1],
                  "row": c[:, 2] - c[:, 0]}
        res = {"ms": ms}
        print(f"g2_decompress_subgroup, {n} rows: {ms:.3f} ms "
              f"(CUDA events, {reps} launches)")
        for name, v in stages.items():
            res[name] = {"mean": float(v.mean()), "max": int(v.max())}
            print(f"  {name}: mean {v.mean():.0f} cycles, max {v.max()} "
                  f"({v.mean() / hz * 1e3:.3f} / {v.max() / hz * 1e3:.3f}"
                  f" ms at {clock}); share of the row "
                  f"{v.mean() / stages['row'].mean():.3f}")
        check = min(n, 40)
        want = C.g2_decompress_subgroup_plain(rows[n - check:])
        exact = all(torch.equal(g[n - check:], w)
                    for g, w in zip((x, y, *flags.unbind(0)), want))
        print(f"  outputs: the last {check} rows equal the plain version's: "
              f"{exact}")
        if not exact:
            raise RuntimeError("g2_decompress_subgroup: the plain version "
                               "differs")
        out[n] = res
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--aggregate", action="store_true",
                    help="only aggregate_rlc_scale's stage split")
    ap.add_argument("--decompress", action="store_true",
                    help="only g2_decompress_subgroup's stage split")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("tail_bench measures the card: no CUDA device")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", LIBRARY,
                    SOURCE], check=True, capture_output=True)
    lib = ctypes.CDLL(LIBRARY)
    card, clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].rsplit(", ", 1)
    hz = float(clock.split()[0]) * 1e6
    K = _build.constant_table(torch.device("cuda"))
    if a.aggregate:
        print(card)
        print(json.dumps({"card": card, "max_sm_clock": clock,
                          "aggregate_rlc_scale": aggregate_stages(
                              lib, K, hz, clock)}))
        return
    if a.decompress:
        print(card)
        print(json.dumps({"card": card, "max_sm_clock": clock,
                          "g2_decompress_subgroup": decompress_stages(
                              lib, K, hz, clock)}))
        return
    rng = np.random.default_rng(13)
    seed = torch.from_numpy(L.ints_to_words(
        [int.from_bytes(rng.bytes(48), "little") % P for _ in range(200)]
    ).copy()).cuda()
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    names = [p.name for p in FP.programs()]
    pieces = PIECES + [(f"program {n}", i, 20) for i, n in enumerate(names)]
    print(card)
    result = {}
    for name, what, reps in pieces:
        err = lib.tail_bench(what, reps, ctypes.c_void_p(out.data_ptr()),
                             ctypes.c_void_p(seed.data_ptr()),
                             ctypes.c_void_p(K.data_ptr()))
        if err:
            raise RuntimeError(f"tail_bench {name}: CUDA error {err}")
        cycles = int(out[0])
        result[name] = cycles
        print(f"{name}: {cycles} cycles, {cycles / hz * 1e6:.2f} µs at "
              f"{clock}")
    print(json.dumps({"card": card, "max_sm_clock": clock,
                      "cycles": result}))


if __name__ == "__main__":
    main()
