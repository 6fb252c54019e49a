#!/usr/bin/env python3
"""Time `batch_sign`, `g1_scalar_mul`, `miller_loop_pairs`,
`aggregate_rlc_scale`, `ed25519_verify`, `batch_pubkey`,
`multi_rlc_scale`, the group sums, `rlc_partial`,
`g2_decompress_subgroup`, `g2_subgroup_check` and `msm_horner` of one or
more checkouts of the port on one card, in turns, at the shapes of their
paths.

    python3 ladder_timing.py TREE [TREE ...]   # parent change change parent

Each TREE (a directory holding `grandine_tpu_torch/`) runs in a process of
its own, in the order given. TREE:NAME=V[,NAME=V] runs the tree with the
compile-time constant NAME of its sources set to V (nvcc -DNAME=V, into a
build directory of its own) and its Python mirror gpu/bls.py NAME, where
there is one, set to V alike — e.g. `.
.:G2_GROUP_WARPS=4 .:G2_GROUP_WARPS=4 .` times g2_group_sum's tile in
turns. The process builds only csrc/sign.cu, csrc/kzg.cu,
csrc/pairing.cu, csrc/aggregate.cu, csrc/ed25519.cu, csrc/multi.cu,
csrc/decompress.cu and csrc/msm.cu, or of them only those `--only` needs
and pairing.cu
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
  batch_pubkey at 512, 4,096 and 16,384 (a full bucket) seeded keys;
  multi_rlc_scale at 64 sets (a block's shard at D = 4), 131 (a block),
  192 (a localization pass of the gossip slot), 262, 512 (a window's
  shard at D = 4), 768, 1,048 (the window) and 1,562 (a localization
  pass of the unaggregated slot): 8 seeded keys and 64 seeded signatures
  tiled, seeded halves, one in five signatures masked;
  g1_group_sum at 1 group of 4,096 rows (a setup MSM), 4 of 8 (a KZG
  batch verify), 12 of 256 with 131 live rows each (committee keys,
  padded with ∞ as g1_aggregate_groups pads) and 12 of 4 (the mesh's
  reduction at D = 4); g2_group_sum at 12 of 256 with 131 live (committee
  aggregates), 4 of 128 (sync contributions), 1 of 64 and 1 of 512 (a
  block and a window shard's signature sum at D = 4): 64 seeded Jacobian
  points tiled;
  rlc_partial at one group of 64, 512 and 1,048 terms (a block's and a
  window's shard at D = 4, a whole window) and 16 groups of 1–8 terms
  (the grouped sharded runs): 64 seeded Fp12 values tiled;
  g2_decompress_subgroup at 8 rows, 131 (the block through
  multi_verify_compressed), 192 (the gossip slot), 512 and 1,562 (the
  grouped compressed routes, the localization passes): the 64 seeded
  signatures compressed, tiled;
  g2_subgroup_check at 8 rows, 131 (a block), 192, 512, 1,048 (a window)
  and 1,562: the 64 seeded signatures' affine words, tiled;
  msm_horner at the grouped route's shapes — G1 at w = 4 with 12 groups
  (the unaggregated slot's messages) and 1 (the sync slot), G2 at w = 8
  with 1 group and 12: 64 seeded Jacobian points as window totals, tiled.

On a tree with both G2 forms of multi_rlc_scale (gpu/bls.py
multi_g2_lanes) each shape is timed in both (`form` in the line; the
form the rule does not choose through the C entry,
testing/group_rows.py multi_launch), and both are checked. Each line gives the
CUDA-event ms a call over back-to-back calls and the kernels' own ms a
call from torch.profiler, with the kernels it recorded a call.

batch_sign is timed at each lane count `sign_lanes` chooses between (4,
2 and 1 lanes a signature); each geometry, and g1_scalar_mul, is held
against its plain version on 40 rows, miller_loop_pairs on 40 pairs,
aggregate_rlc_scale on its 192 aggregates, ed25519_verify on the B = 128
rows and batch_pubkey on 40 keys, multi_rlc_scale on its edge sets and
70 seeded ones, the group sums on their edge groups
(testing/group_rows.py) and at the 12 × 256 shape, rlc_partial on 64
mixed groups of 0–17 terms with ∞ and refused flags and at 1 × 512,
g2_decompress_subgroup on the edge corpus of testing/decompress_rows.py
beside 40 signatures, g2_subgroup_check on testing/subgroup_rows.py's
rows beside 40 signatures, msm_horner on testing/horner_rows.py's groups
at G1 w = 4 and G2 w = 8, exactly; where the tree reports it, each line
of the last four kernels carries its launch geometry; their lines
carry chip_smoke.py's bound (OpModel at the least work, this tree's). `--only
NAME[,NAME]` keeps the kernels whose names hold one of the NAMEs (e.g.
`--only multi,group` for multi_rlc_scale and both group sums), for the
timings and the checks. Prints the card's name and power limit, one line
a timing and one JSON line a tree. Needs a card.
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
MULTI_SETS = (64, 131, 192, 262, 512, 768, 1048, 1562)
#: (groups, rows a group, live rows a group)
G1_GROUPS = ((1, 4096, 4096), (4, 8, 8), (12, 256, 131), (12, 4, 4))
G2_GROUPS = ((12, 256, 131), (4, 128, 128), (1, 64, 64), (1, 512, 512))
#: rlc_partial's groups a call (each a list of spans)
PARTIAL_SPANS = ([64], [512], [1048], [1 + i % 8 for i in range(16)])
DEC_ROWS = (8, 131, 192, 512, 1562)
SUB_ROWS = (8, 131, 192, 512, 1048, 1562)
#: msm_horner's (field, window bits, groups)
HORNER_SHAPES = ((1, 4, 12), (1, 4, 1), (2, 8, 1), (2, 8, 12))
#: the source of each timed kernel
SOURCE_OF = {"batch_sign": "sign.cu", "batch_pubkey": "sign.cu",
             "g1_scalar_mul": "kzg.cu", "miller_loop_pairs": "pairing.cu",
             "aggregate_rlc_scale": "aggregate.cu",
             "ed25519_verify": "ed25519.cu", "multi_rlc_scale": "multi.cu",
             "g1_group_sum": "multi.cu", "g2_group_sum": "multi.cu",
             "rlc_partial": "pairing.cu",
             "g2_decompress_subgroup": "decompress.cu",
             "g2_subgroup_check": "decompress.cu", "msm_horner": "msm.cu"}
CHECK_ROWS = 40


def _ptxas(log: str) -> "list[str]":
    keep = ("Compiling entry", "registers", "stack frame", "spill")
    return [line.strip() for line in log.splitlines()
            if any(k in line for k in keep)]


def _rows_module(name: str):
    """A module of testing/ from this script's own tree (a parent may lack
    it), importing the tree under test's gpu.bls."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "grandine_tpu_torch",
        "testing", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_tree(arg: str):
    """TREE[:NAME=V[,NAME=V]] → (TREE, {NAME: V})."""
    tree, _, spec = arg.partition(":")
    defines = {}
    for item in filter(None, spec.split(",")):
        name, _, value = item.partition("=")
        defines[name] = int(value)
    return tree, defines


def worker(arg: str, reps: int, seed: int, only: str) -> dict:
    tree, defines = split_tree(arg)
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, R
    from grandine_tpu_torch.crypto.curves import G1
    from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
    from grandine_tpu_torch.gpu import _build
    from grandine_tpu_torch.gpu import bls as B
    from grandine_tpu_torch.gpu import curve as C
    from grandine_tpu_torch.gpu import kzg as GK

    names = [k for k in only.split(",") if k]

    def wanted(kernel):
        return not names or any(k in kernel for k in names)

    # pairing.cu exports bls_set_stack_limit, which every build needs
    sources = sorted({"pairing.cu"} | {SOURCE_OF[k] for k in SOURCE_OF
                                       if wanted(k)})
    _build.LIBRARIES = {src: _build.LIBRARIES[src] for src in sources}
    for name, value in defines.items():
        if hasattr(B, name):
            setattr(B, name, value)
        _build.NVCC_FLAGS = [*_build.NVCC_FLAGS, f"-D{name}={value}"]
    if defines:
        _build.BUILD_DIR = os.path.join(_build.BUILD_DIR, ",".join(
            f"{k}={v}" for k, v in sorted(defines.items())))
    _build.library()
    ptxas = {src: _ptxas(open(os.path.join(
        _build.BUILD_DIR, f"lib{src[:-3]}.so.log")).read())
        for src in sources}
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

    def device_ms(fn):
        """The kernels' own time a call (torch.profiler's CUDA activity,
        copies left out): what CUDA events between back-to-back calls see
        too, unless the host's calls leave the card waiting. None when
        the profiler records no kernel. Beside it the kernels the
        profiler recorded a call, to be held against the launches a call
        makes (one for each of the last four kernels): a short count
        means records were dropped."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if not e.key.startswith(("Memcpy", "Memset"))
                   and str(getattr(e, "device_type", "")).endswith("CUDA")]
        us = sum(getattr(e, "self_device_time_total", 0) for e in kernels)
        return {"device_ms": us / reps / 1e3 if us else None,
                "device_kernels": sum(e.count for e in kernels) / reps}

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

    PR = _rows_module("pairing_rows")

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
    for n in (SIGN_ROWS if wanted("batch_sign") else ()):
        args = sign_args(n)
        for lanes in (4, 2, 1):
            ms = cuda_ms(lambda: B.batch_sign(*args, lanes=lanes))
            rows.append({"kernel": "batch_sign", "rows": n, "lanes": lanes,
                         "ms": ms})
    for n in (KZG_ROWS if wanted("g1_scalar_mul") else ()):
        args = kzg_args(n)
        rows.append({"kernel": "g1_scalar_mul", "rows": n,
                     "ms": cuda_ms(lambda: GK.g1_scalar_mul(*args))})
    for n in (MILLER_PAIRS if wanted("miller_loop_pairs") else ()):
        args = miller_args(n)
        rows.append({"kernel": "miller_loop_pairs", "rows": n,
                     "ms": cuda_ms(lambda: TP.miller_loop_pairs(*args))})
    if wanted("aggregate_rlc_scale"):
        agg = tuple(torch.from_numpy(a).to(dev) for a in PR.aggregate_rows(
            PR.gossip_cases(seed), seed, 4096))
        rows.append({"kernel": "aggregate_rlc_scale",
                     "rows": agg[2].shape[0],
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

    for b in (ED_ROWS if wanted("ed25519_verify") else ()):
        args = ed_args(b)
        rows.append({"kernel": "ed25519_verify", "rows": b,
                     "ms": cuda_ms(lambda: E.ed25519_verify(*args))})
    for n in (PUBKEY_KEYS if wanted("batch_pubkey") else ()):
        args = tuple(torch.from_numpy(a).to(dev) for a in B.sign_scalars_host(
            [rng.randrange(1, R) for _ in range(n)]))
        rows.append({"kernel": "batch_pubkey", "rows": n,
                     "ms": cuda_ms(lambda: B.batch_pubkey(*args))})
    GR = _rows_module("group_rows")
    planned = hasattr(B, "group_sum_plan")
    # the bounds of chip_smoke.py (OpModel at the function's least work,
    # the card's int32 multiply rate or HBM rate), from this script's tree
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    from grandine_tpu_torch.crypto.constants import P, X
    ops = CS.OpModel(P, -X)
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bound(fp_muls, nbytes):
        return CS.bound_ms(fp_muls, nbytes, sms, clock_hz)[0]
    multi_keys = GR.progression(G1.mul(rng.randrange(1, R)),
                                G1.mul(rng.randrange(1, R)), 8)
    kx, ky = B.g1_affine_words(multi_keys)
    from grandine_tpu_torch.crypto.curves import G2
    multi_sigs = GR.progression(G2.mul(rng.randrange(1, R)),
                                G2.mul(rng.randrange(1, R)), 64)
    mx, my, _ = B.g2_affine_words_many(multi_sigs)

    def multi_args(n):
        idx = np.arange(n)
        pairs = [(rng.getrandbits(32), rng.getrandbits(32))
                 for _ in range(n)]
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (kx, ky, (idx * 5 % 8).astype(np.int32),
                               mx[idx % 64], my[idx % 64], idx % 5 == 4,
                               B.rlc_pairs_words(pairs)))
        return args, bound(ops.multi(pairs, (idx % 5 != 4).tolist()),
                           n * (4 + 96 + 96 + 1 + 8 + 144 + 288))

    def multi_forms(n):
        """(form, call) of each G2 form: the rule's through the wrapper,
        the other through the C entry (a parent tree: its one form)."""
        if not planned:
            return [("parent", B.multi_rlc_scale)]
        rule = B.multi_g2_lanes(n)
        return [(f"g2 {'lanes' if lanes else 'warps'}"
                 f"{' (the rule)' if lanes == rule else ''}",
                 B.multi_rlc_scale if lanes == rule
                 else lambda *a, lanes=lanes: GR.multi_launch(a, lanes))
                for lanes in (False, True)]

    for n in (MULTI_SETS if wanted("multi_rlc_scale") else ()):
        args, b_ms = multi_args(n)
        for form, call in multi_forms(n):
            rows.append({"kernel": "multi_rlc_scale", "rows": n,
                         "form": form, "bound_ms": b_ms,
                         "ms": cuda_ms(lambda: call(*args)),
                         **device_ms(lambda: call(*args))})
    g_pts = {1: GR.jacobian_words(GR.progression(
        G1.mul(rng.randrange(1, R)), G1.mul(rng.randrange(1, R)), 64), 1),
             2: GR.jacobian_words(multi_sigs, 2)}

    def group_args(k, m, width, live):
        rows = np.zeros((m * width,) + g_pts[k].shape[1:], np.int32)
        for g in range(m):
            rows[g * width: g * width + live] = g_pts[k][
                (np.arange(live) + 7 * g) % 64]
        return (torch.from_numpy(rows).to(dev),
                list(range(0, m * width + 1, width)))

    for k, shapes in ((1, G1_GROUPS), (2, G2_GROUPS)):
        name = f"g{k}_group_sum"
        if not wanted(name):
            continue
        fn = getattr(B, name)
        for m, width, live in shapes:
            rows_t, off = group_args(k, m, width, live)

            def run():
                return fn(rows_t, off)
            rows.append({"kernel": name, "groups": m, "rows": width,
                         "live": live, "bound_ms": bound(
                             ops.group_sum([live] * m, k),
                             m * width * 144 * k + m * (144 * k + 4) + 4),
                         "ms": cuda_ms(run), **device_ms(run)})
    fp12 = L.ints_to_words([rng.randrange(L.P) for _ in range(64 * 12)]
                           ).reshape(64, 2, 3, 2, 12)

    def partial_args(spans, seed_flags=False):
        n = sum(spans)
        off = np.concatenate([[0], np.cumsum(spans)])
        flags = np.random.default_rng(n)
        bad = (lambda p: flags.random(n) < p) if seed_flags else (
            lambda p: np.zeros(n, bool))
        return (*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            fp12[np.arange(n) % 64], bad(0.05), ~bad(0.05), ~bad(0.05))),
            off, off)

    import time

    def host_ms(fn):
        """The host's time a call to enqueue it (no synchronisation),
        after a warm-up, over --reps calls."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return ms

    for spans in (PARTIAL_SPANS if wanted("rlc_partial") else ()):
        args = partial_args(spans)

        def run():
            return B.rlc_partial(*args)
        n = sum(spans)
        row = {"kernel": "rlc_partial", "groups": len(spans), "terms": n,
               "bound_ms": bound(ops.partial(spans),
                                 n * (576 + 1) + 2 * n + 8 * len(spans) + 8
                                 + 577 * len(spans)),
               "ms": cuda_ms(run), **device_ms(run),
               "host_ms": host_ms(run)}
        if hasattr(B, "rlc_partial_geometry"):
            row["geometry"] = B.rlc_partial_geometry(args[4])
        rows.append(row)
    from grandine_tpu_torch.crypto import bls as A

    sig_rows = np.frombuffer(b"".join(A.g2_to_bytes(p) for p in multi_sigs),
                             np.uint8).reshape(64, 96)
    for n in (DEC_ROWS if wanted("g2_decompress_subgroup") else ()):
        dec_rows = torch.from_numpy(sig_rows[np.arange(n) % 64].copy()).to(
            dev)

        def run():
            return C.g2_decompress_subgroup(dec_rows)
        row = {"kernel": "g2_decompress_subgroup", "rows": n,
               "bound_ms": bound(ops.g2_row * n, n * (96 + 96 + 6)),
               "ms": cuda_ms(run), **device_ms(run)}
        if hasattr(C, "g2_decompress_subgroup_geometry"):
            row["geometry"] = C.g2_decompress_subgroup_geometry(n)
        rows.append(row)
    sub_pts = B.g2_affine_words_many(multi_sigs)
    for n in (SUB_ROWS if wanted("g2_subgroup_check") else ()):
        idx = np.arange(n) % 64
        sub = tuple(torch.from_numpy(np.ascontiguousarray(a[idx])).to(dev)
                    for a in sub_pts)

        def run():
            return C.g2_subgroup_check(*sub)
        row = {"kernel": "g2_subgroup_check", "rows": n,
               "bound_ms": bound(ops.subgroup(n), n * (96 + 96 + 1 + 1)),
               "ms": cuda_ms(run), **device_ms(run)}
        if hasattr(C, "g2_subgroup_check_geometry"):
            row["geometry"] = C.g2_subgroup_check_geometry(n)
        rows.append(row)
    from grandine_tpu_torch.gpu import msm as M

    for k, w, g in (HORNER_SHAPES if wanted("msm_horner") else ()):
        W = (32 + w - 1) // w
        totals = torch.from_numpy(np.ascontiguousarray(
            g_pts[k][np.arange(g * W) % 64])).to(dev)

        def run():
            return M.msm_horner(totals, g, w)
        row = {"kernel": "msm_horner", "field": f"G{k}", "w": w,
               "groups": g,
               "bound_ms": bound(ops.msm_horner(k, g, W, w),
                                 (g * W + g) * 144 * k),
               "ms": cuda_ms(run), **device_ms(run)}
        if hasattr(M, "msm_horner_geometry"):
            row["geometry"] = M.msm_horner_geometry(k, g)
        rows.append(row)
    # every geometry against its plain version, exactly
    if wanted("ed25519_verify"):
        args = ed_args(128)
        checks.append(("ed25519_verify", {}, all(
            torch.equal(g, x) for g, x in zip(E.ed25519_verify(*args),
                                              E.ed25519_verify_plain(*args)))))
    if wanted("batch_pubkey"):
        args = tuple(torch.from_numpy(a).to(dev) for a in B.sign_scalars_host(
            [1, R - 1, R - 2] + [rng.randrange(1, R)
                                 for _ in range(CHECK_ROWS - 3)]))
        checks.append(("batch_pubkey", {}, torch.equal(
            B.batch_pubkey(*args), B.batch_pubkey_plain(*args))))
    if wanted("batch_sign"):
        args = sign_args(CHECK_ROWS)
        args[1][[3, 17]] = True
        for lanes in (4, 2, 1):
            checks.append(("batch_sign", {"lanes": lanes}, torch.equal(
                B.batch_sign(*args, lanes=lanes),
                B.batch_sign_plain(*args, lanes))))
    if wanted("g1_scalar_mul"):
        args = kzg_args(CHECK_ROWS)
        args[2][[5]] = True
        args[3][[0, 1]] = torch.from_numpy(GK.scalar_words([0, GK.X2])).to(
            dev)
        checks.append(("g1_scalar_mul", {}, torch.equal(
            GK.g1_scalar_mul(*args), GK.g1_scalar_mul_plain(*args))))
    if wanted("miller_loop_pairs"):
        args = miller_args(CHECK_ROWS)
        checks.append(("miller_loop_pairs", {}, torch.equal(
            TP.miller_loop_pairs(*args), TP.miller_loop_pairs_plain(*args))))
    if wanted("aggregate_rlc_scale"):
        checks.append(("aggregate_rlc_scale", {}, all(
            torch.equal(g, w) for g, w in zip(
                B.aggregate_rlc_scale(*agg),
                B.aggregate_rlc_scale_plain(*agg)))))
    if wanted("multi_rlc_scale"):
        for cases in (GR.MULTI_EDGES, GR.seeded_multi_cases(seed, 70)):
            args = tuple(torch.from_numpy(a).to(dev)
                         for a in GR.multi_rows(cases, seed))
            want = B.multi_rlc_scale_plain(*args)
            for form, call in multi_forms(len(cases)):
                checks.append(("multi_rlc_scale", {"sets": len(cases),
                                                   "form": form}, all(
                    torch.equal(g, w) for g, w in zip(call(*args), want))))
    for k in (1, 2):
        name = f"g{k}_group_sum"
        if not wanted(name):
            continue
        fn, plain = getattr(B, name), getattr(B, f"{name}_plain")
        cases = [("12 x 256", group_args(k, 12, 256, 131))]
        if planned:  # the plan's edges at this tree's tile
            rows_e, off_e, _ = GR.group_rows(k, seed, B.group_tile(k))
            cases.append(("edges", (torch.from_numpy(rows_e).to(dev),
                                    off_e)))
            geo = B.launch_geometry(name, 1)
            if k == 2 and geo[1] != 32 * B.G2_GROUP_WARPS:
                raise SystemExit(f"{tree}: g2_group_sum's kernel runs "
                                 f"{geo[1]} threads a tile, the plan "
                                 f"{B.G2_GROUP_WARPS} warps")
        for what, (r, o) in cases:
            checks.append((name, {"rows": what}, torch.equal(
                fn(r, o), plain(r, o))))
    if wanted("rlc_partial"):
        for what, spans, seeded in (
                ("64 mixed groups of 0-17", [(0, 1, 2, 8, 9, 16, 17, 5)[i % 8]
                                             for i in range(64)], True),
                ("1 x 512", [512], False)):
            args = partial_args(spans, seeded)
            checks.append(("rlc_partial", {"groups": what}, all(
                torch.equal(g, w) for g, w in zip(
                    B.rlc_partial(*args), B.rlc_partial_plain(*args)))))
    if wanted("g2_decompress_subgroup"):
        DR = _rows_module("decompress_rows")
        edges = torch.from_numpy(np.concatenate(
            [sig_rows[:CHECK_ROWS], DR.edge_rows()[0]])).to(dev)
        checks.append(("g2_decompress_subgroup", {"rows": "edges"}, all(
            torch.equal(g, w) for g, w in zip(
                C.g2_decompress_subgroup(edges),
                C.g2_decompress_subgroup_plain(edges)))))
    if wanted("g2_subgroup_check"):
        SR = _rows_module("subgroup_rows")
        *edge_words, _, _ = SR.edge_rows()
        sub = tuple(torch.from_numpy(np.concatenate([a[:CHECK_ROWS], b])).to(
            dev) for a, b in zip(sub_pts, edge_words))
        checks.append(("g2_subgroup_check", {"rows": "edges"}, torch.equal(
            C.g2_subgroup_check(*sub), C.g2_subgroup_check_plain(*sub))))
    if wanted("msm_horner"):
        HR = _rows_module("horner_rows")
        for k, w in ((1, 4), (2, 8)):
            totals, names, _ = HR.horner_totals(k, w, seed + k)
            totals = torch.from_numpy(totals).to(dev)
            checks.append(("msm_horner", {"field": f"G{k}", "w": w,
                                          "groups": "edges"}, torch.equal(
                M.msm_horner(totals, len(names), w),
                M.msm_horner_plain(totals, len(names), w))))
    return {"tree": arg, "ptxas": ptxas, "stack_limit": _build.stack_limit,
            "nvcc_s": dict(nvcc_s),
            "timings": rows,
            "checks": [{"kernel": k, **v, "equal": ok}
                       for k, v, ok in checks]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--only", default="",
                    help="comma-separated parts of the kernel names to keep")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.trees[0], a.reps, a.seed, a.only)))
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
        path, defines = split_tree(tree)
        spec = ",".join(f"{k}={v}" for k, v in defines.items())
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(path) + (f":{spec}" if spec else ""),
             "--reps", str(a.reps), "--seed", str(a.seed), "--only",
             a.only], capture_output=True, text=True,
            cwd=os.path.abspath(path))
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for src, lines in res["ptxas"].items():
            for line in lines:
                print(f"{tree}: ptxas {src}: {line}")
        print(f"{tree}: stack limit {res['stack_limit']} B "
              f"({', '.join(res['ptxas'])}); nvcc seconds {res['nvcc_s']}")
        for r in res["timings"]:
            shape = ", ".join(f"{k} {v}" for k, v in r.items()
                              if k not in ("kernel", "ms", "device_ms",
                                           "bound_ms", "geometry",
                                           "host_ms", "device_kernels"))
            dev_ms = ("" if "device_ms" not in r else
                      "; device not measured" if r["device_ms"] is None
                      else f"; device {r['device_ms']:.3f} ms (profiler, "
                      f"{r['device_kernels']:g} kernels a call recorded)")
            b_ms = (f"; bound {r['bound_ms']:.4f} ms" if "bound_ms" in r
                    else "")
            geo = (f"; geometry (blocks, threads, shared bytes, blocks an "
                   f"SM) {r['geometry']}" if "geometry" in r else "")
            host = (f"; host {r['host_ms']:.3f} ms a call to enqueue"
                    if "host_ms" in r else "")
            print(f"{tree}: {r['kernel']} ({shape}): {r['ms']:.3f} ms "
                  f"(CUDA events){dev_ms}{host}{b_ms}{geo} [{card}]",
                  flush=True)
        for c in res["checks"]:
            print(f"{tree}: check {c}")
            failed |= not c["equal"]
        print(json.dumps(res), flush=True)
    if failed:
        raise SystemExit("a kernel differs from its plain version")


if __name__ == "__main__":
    main()
