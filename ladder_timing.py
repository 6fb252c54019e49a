#!/usr/bin/env python3
"""Time `batch_sign`, `g1_scalar_mul`, `miller_loop_pairs`,
`aggregate_rlc_scale`, `ed25519_verify` and `batch_pubkey` of one or more
checkouts of the port on one card, in turns, at the shapes of their paths.

    python3 ladder_timing.py TREE [TREE ...]   # parent change change parent

Each TREE (a directory holding `grandine_tpu_torch/`) runs in a process of
its own, in the order given. The process builds only csrc/sign.cu,
csrc/kzg.cu, csrc/pairing.cu, csrc/aggregate.cu and csrc/ed25519.cu
(nvcc, the tree's own flags), prints ptxas' lines for their kernels
(registers, stack frame, spills, cumulative stack), and times by CUDA
events, after one warm-up launch, --reps launches of

  batch_sign at 512 rows (the signing plane's lane batch), 2,048, 4,096,
  8,192 and 16,384 (a full bucket): H(m) of 8 seeded messages tiled,
  seeded keys below r;
  g1_scalar_mul at 1 row (one ladder alone), 32 (a batch verify at bucket
  8) and 4,096 (a setup MSM): 8 seeded multiples of G1 tiled, seeded
  scalars below r;
  miller_loop_pairs at 4 pairs (a KZG batch verify), 192 (the gossip
  slot), 1,048 (the window) and 2,048: 64 seeded Jacobian multiples of
  G1 (Z ≠ 1) and H(m) of the 8 messages, tiled;
  aggregate_rlc_scale at the gossip slot's 192 aggregates of 87–130
  members gathered from 4,096 seeded keys (testing/pairing_rows.py);
  ed25519_verify at B = 8, 32 and 128 on rows shaped as the ed25519
  lane's (Ed25519Backend.prepare): the base point under a 253-bit
  scalar, (B − 1) // 2 seeded points under 128-bit z and as many under
  253-bit z·k, identity pads with scalar 0;
  batch_pubkey at 512, 4,096 and 16,384 (a full bucket) seeded keys.

batch_sign is timed at each lane count `sign_lanes` chooses between (4,
2 and 1 lanes a signature); each geometry, and g1_scalar_mul, is held
against its plain version on 40 rows, miller_loop_pairs on 40 pairs,
aggregate_rlc_scale on its 192 aggregates, ed25519_verify on the B = 128
rows and batch_pubkey on 40 keys, exactly. Prints the card's name and
power limit, one line a timing and one JSON line a tree. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import re
import subprocess
import sys

#: the timed shapes
SIGN_ROWS = (512, 2048, 4096, 8192, 16384)
KZG_ROWS = (1, 32, 4096)
MILLER_PAIRS = (4, 192, 1048, 2048)
ED_ROWS = (8, 32, 128)
PUBKEY_KEYS = (512, 4096, 16384)
SOURCES = ("sign.cu", "kzg.cu", "pairing.cu", "aggregate.cu", "ed25519.cu")
CHECK_ROWS = 40


def _ptxas(log: str) -> "list[str]":
    keep = ("Compiling entry", "registers", "stack frame", "spill")
    return [line.strip() for line in log.splitlines()
            if any(k in line for k in keep)]


def worker(tree: str, reps: int, seed: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, R
    from grandine_tpu_torch.crypto.curves import G1
    from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
    from grandine_tpu_torch.gpu import _build
    from grandine_tpu_torch.gpu import bls as B
    from grandine_tpu_torch.gpu import kzg as GK

    _build.LIBRARIES = {src: _build.LIBRARIES[src] for src in SOURCES}
    _build.library()
    ptxas = {src: _ptxas(open(os.path.join(
        _build.BUILD_DIR, f"lib{src[:-3]}.so.log")).read())
        for src in SOURCES}
    nvcc_s = re.findall(r"== (\S+) \((\d+\.\d) s\)", _build.build_log)
    dev = torch.device("cuda")
    rng = random.Random(seed)

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    h = np.stack([B.g2_affine_words(hash_to_g2(b"ladder-%d" % i,
                                               DST_SIGNATURE))[0]
                  for i in range(8)])
    g1 = [G1.mul(rng.randrange(1, R)) for _ in range(8)]
    gx, gy = B.g1_affine_words(g1)

    def sign_args(n):
        keys = [rng.randrange(1, R) for _ in range(n)]
        msg = torch.from_numpy(h[np.arange(n) % 8]).to(dev)
        inf = torch.zeros((n,), dtype=torch.bool, device=dev)
        return msg, inf, torch.from_numpy(B.sign_digits_host(keys)).to(dev)

    def kzg_args(n):
        idx = np.arange(n) % 8
        k = GK.scalar_words([rng.randrange(R) for _ in range(n)])
        return tuple(torch.from_numpy(a).to(dev) for a in (
            gx[idx], gy[idx], np.zeros(n, bool), k))

    from grandine_tpu_torch.gpu import limbs as L
    from grandine_tpu_torch.gpu import pairing as TP

    # the aggregate rows of this script's own tree (a parent may lack them)
    spec = importlib.util.spec_from_file_location("pairing_rows", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "grandine_tpu_torch",
        "testing", "pairing_rows.py"))
    PR = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(PR)

    gj = []  # 64 Jacobian multiples of G1, Z ≠ 1
    for p in [G1.mul(rng.randrange(1, R)) for _ in range(64)]:
        x, y = p.to_affine()
        z = rng.randrange(2, L.P)
        gj += [x.n * z * z % L.P, y.n * z ** 3 % L.P, z]
    gj = L.ints_to_words(gj).reshape(64, 3, 12)

    def miller_args(n):
        idx = np.arange(n)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (gj[idx % 64], h[idx % 8], idx % 7 == 6))

    rows, checks = [], []
    for n in SIGN_ROWS:
        args = sign_args(n)
        for lanes in (4, 2, 1):
            ms = cuda_ms(lambda: B.batch_sign(*args, lanes=lanes))
            rows.append({"kernel": "batch_sign", "rows": n, "lanes": lanes,
                         "ms": ms})
    for n in KZG_ROWS:
        args = kzg_args(n)
        rows.append({"kernel": "g1_scalar_mul", "rows": n,
                     "ms": cuda_ms(lambda: GK.g1_scalar_mul(*args))})
    for n in MILLER_PAIRS:
        args = miller_args(n)
        rows.append({"kernel": "miller_loop_pairs", "rows": n,
                     "ms": cuda_ms(lambda: TP.miller_loop_pairs(*args))})
    agg = tuple(torch.from_numpy(a).to(dev) for a in PR.aggregate_rows(
        PR.gossip_cases(seed), seed, 4096))
    rows.append({"kernel": "aggregate_rlc_scale", "rows": agg[2].shape[0],
                 "ms": cuda_ms(lambda: B.aggregate_rlc_scale(*agg))})
    from grandine_tpu_torch.crypto import ed25519 as HE
    from grandine_tpu_torch.gpu import ed25519 as E

    def ed_args(b):
        """Rows shaped as Ed25519Backend.prepare's: [c_B]B, [z](−R),
        [z·k](−A), identity pads."""
        n = (b - 1) // 2
        pts = [HE.BASE] + [HE.point_mul(rng.randrange(1, HE.L), HE.BASE)
                           for _ in range(2 * n)]
        aff = []
        for p in pts:
            zi = pow(p[2], HE.P - 2, HE.P)
            aff.append((p[0] * zi % HE.P, p[1] * zi % HE.P))
        aff += [(0, 1)] * (b - len(aff))
        ks = ([rng.randrange(HE.L)] + [rng.getrandbits(128) | 1
                                       for _ in range(n)]
              + [rng.randrange(HE.L) for _ in range(n)])
        ks += [0] * (b - len(ks))
        return tuple(torch.from_numpy(E.ints_to_words(v)).to(dev) for v in (
            [x for x, _ in aff], [y for _, y in aff],
            [x * y % HE.P for x, y in aff], ks))

    for b in ED_ROWS:
        args = ed_args(b)
        rows.append({"kernel": "ed25519_verify", "rows": b,
                     "ms": cuda_ms(lambda: E.ed25519_verify(*args))})
    for n in PUBKEY_KEYS:
        args = tuple(torch.from_numpy(a).to(dev) for a in B.sign_scalars_host(
            [rng.randrange(1, R) for _ in range(n)]))
        rows.append({"kernel": "batch_pubkey", "rows": n,
                     "ms": cuda_ms(lambda: B.batch_pubkey(*args))})
    # every geometry against its plain version, exactly
    args = ed_args(128)
    checks.append(("ed25519_verify", {}, all(
        torch.equal(g, x) for g, x in zip(E.ed25519_verify(*args),
                                          E.ed25519_verify_plain(*args)))))
    args = tuple(torch.from_numpy(a).to(dev) for a in B.sign_scalars_host(
        [1, R - 1, R - 2] + [rng.randrange(1, R)
                             for _ in range(CHECK_ROWS - 3)]))
    checks.append(("batch_pubkey", {}, torch.equal(
        B.batch_pubkey(*args), B.batch_pubkey_plain(*args))))
    args = sign_args(CHECK_ROWS)
    args[1][[3, 17]] = True
    for lanes in (4, 2, 1):
        checks.append(("batch_sign", {"lanes": lanes}, torch.equal(
            B.batch_sign(*args, lanes=lanes),
            B.batch_sign_plain(*args, lanes))))
    args = kzg_args(CHECK_ROWS)
    args[2][[5]] = True
    args[3][[0, 1]] = torch.from_numpy(GK.scalar_words([0, GK.X2])).to(dev)
    checks.append(("g1_scalar_mul", {}, torch.equal(
        GK.g1_scalar_mul(*args), GK.g1_scalar_mul_plain(*args))))
    args = miller_args(CHECK_ROWS)
    checks.append(("miller_loop_pairs", {}, torch.equal(
        TP.miller_loop_pairs(*args), TP.miller_loop_pairs_plain(*args))))
    checks.append(("aggregate_rlc_scale", {}, all(
        torch.equal(g, w) for g, w in zip(B.aggregate_rlc_scale(*agg),
                                          B.aggregate_rlc_scale_plain(*agg)))))
    return {"tree": tree, "ptxas": ptxas, "stack_limit": _build.stack_limit,
            "nvcc_s": dict(nvcc_s),
            "timings": rows,
            "checks": [{"kernel": k, **v, "equal": ok}
                       for k, v, ok in checks]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.trees[0], a.reps, a.seed)))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ladder_timing measures the card: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    failed = False
    for tree in a.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(tree), "--reps", str(a.reps), "--seed",
             str(a.seed)], capture_output=True, text=True,
            cwd=os.path.abspath(tree))
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for src, lines in res["ptxas"].items():
            for line in lines:
                print(f"{tree}: ptxas {src}: {line}")
        print(f"{tree}: stack limit {res['stack_limit']} B "
              f"({', '.join(SOURCES)}); nvcc seconds {res['nvcc_s']}")
        for r in res["timings"]:
            shape = ", ".join(f"{k} {v}" for k, v in r.items()
                              if k not in ("kernel", "ms"))
            print(f"{tree}: {r['kernel']} ({shape}): {r['ms']:.3f} ms "
                  f"[{card}]", flush=True)
        for c in res["checks"]:
            print(f"{tree}: check {c}")
            failed |= not c["equal"]
        print(json.dumps(res), flush=True)
    if failed:
        raise SystemExit("a kernel differs from its plain version")


if __name__ == "__main__":
    main()
