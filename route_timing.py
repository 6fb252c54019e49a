#!/usr/bin/env python3
"""Time the signature paths of one or more checkouts of the port, in
turns, on one card: the verify routes — the grouped route that
`TorchBlsBackend.multi_verify` takes for repeated messages, and the flat
route on the same sets as a control of the host's speed — and the
signing path: the operator slot through the signing plane and one full
bucket through `TorchBlsBackend.batch_sign`.

    python3 route_timing.py TREE [TREE ...]      # e.g. parent change change parent

Each TREE (a directory holding `grandine_tpu_torch/`) runs in a process of
its own, in the order given, on the same seeded sets made by this
script's copy of chip_smoke.py's helpers: the unaggregated attestation
slot (the signers of one slot's committees at --validators keys, each
signing its committee's root) and the sync-committee slot (--sync
signers over one root). Per tree and slot it prints the p50 of
`multi_verify_async` → settle (host prep + enqueue apart from the device
wait) over --rounds rounds of (flat, grouped, grouped, flat), after one
warm-up call of each (--rounds 0 skips the verify routes). Then, with
--sign-rounds above 0, the operator slot: every signer of the slot's
committees attests its committee's root and the sync signers sign
theirs, each a `SigningPlane.submit` (DEFAULT_SIGN_LANES, release gate
on), one warm round and --sign-rounds timed rounds, every released
signature checked against its anchor; per round its time, and per batch
the scheme's batch_sign (hash-to-G2, scalar prep, kernel, readback,
encoding) and release gate (host decode, then the device multi_verify)
on the host clock. Then the full bucket: `MAX_BUCKET` registry keys over
the slot's roots (fewer when there are fewer validators), one warm call
and 3 timed, a sample of 8 checked against `SecretKey.sign`. One JSON
line per tree closes the output. `--device cpu` runs the plain versions
on the CPU (a tiny check of the script: use few validators and signers
there).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This checkout's chip_smoke.py as a module (its helpers only: it
    imports the port inside main())."""
    spec = importlib.util.spec_from_file_location(
        "_route_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, device: str, validators: int, sync: int,
           rounds: int, sign_rounds: int, seed: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from grandine_tpu_torch.crypto import bls as A
    from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, P, R
    from grandine_tpu_torch.crypto.curves import G1
    from grandine_tpu_torch.crypto.fields import batch_inverse
    from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
    from grandine_tpu_torch.gpu import bls as B

    sm = _smoke()
    t0 = time.perf_counter()
    if device == "cuda":
        from grandine_tpu_torch.gpu import _build

        _build.build()
        _build.library()
    build_s = time.perf_counter() - t0

    rng = random.Random(seed)
    sks, pubkeys = sm.make_registry_keys(rng, validators, P, R, G1,
                                         batch_inverse)
    committees = sm.slot_committees(rng, validators)
    roots = [rng.randbytes(32) for _ in committees]
    a0, d0 = sks[0], (sks[1] - sks[0]) % R
    unagg = []  # (root, signature point, validator) in committee order
    for c, com in enumerate(committees):
        h = hash_to_g2(roots[c], DST_SIGNATURE)
        pts = sm.progression_points(h, a0, d0, com, R)
        unagg += [(roots[c], pts[i], i) for i in sorted(com)]
    sync_root = rng.randbytes(32)
    members = sorted(rng.sample(range(validators - 1), sync))
    s_pts = sm.progression_points(hash_to_g2(sync_root, DST_SIGNATURE), a0,
                                  d0, members, R)

    def key(i):
        return A.PublicKey(A.g1_from_bytes(pubkeys[i], subgroup_check=False))

    shapes = {
        "unaggregated": ([m for m, _, _ in unagg],
                         [A.Signature(p) for _, p, _ in unagg],
                         [key(i) for _, _, i in unagg]),
        "sync": ([sync_root] * sync, [A.Signature(s_pts[i]) for i in members],
                 [key(i) for i in members]),
    }
    backend = B.TorchBlsBackend(device=device)
    bits = SimpleNamespace(randbits=random.Random(seed + 1).getrandbits)

    def sync_device():
        if device == "cuda":
            torch.cuda.synchronize()

    out = {"tree": tree, "build_s": build_s, "slots": {}}
    for where, (ml, sl, kl) in (shapes.items() if rounds else ()):
        groups = B.message_groups(ml)
        if not B.grouped_route(len(groups), max(map(len, groups.values())),
                               len(ml)):
            raise SystemExit(f"{where}: the grouped route does not take it")
        fx, fy = B.g1_affine_words([pk.point for pk in kl])
        dx, dy = backend._up(fx), backend._up(fy)
        idx = np.arange(len(ml), dtype=np.int32)
        runs = {
            "flat": lambda: backend._flat_multi_verify_async(
                ml, sl, dx, dy, idx, DST_SIGNATURE, bits, False),
            "grouped": lambda: backend.multi_verify_async(ml, sl, kl,
                                                          rng=bits),
        }
        rows = {"flat": [], "grouped": []}
        for name in ["flat", "grouped"] + ["flat", "grouped", "grouped",
                                           "flat"] * rounds:
            sync_device()
            t0 = time.perf_counter()
            settle = runs[name]()
            t1 = time.perf_counter()
            if settle() is not True:
                raise SystemExit(f"{where}: the {name} route rejected a "
                                 f"valid batch")
            rows[name].append((time.perf_counter() - t0, t1 - t0))
        slot = {"sets": len(ml), "messages": len(groups)}
        for name, rr in rows.items():
            rr = rr[1:]  # the first call of each route warms it up
            total = statistics.median(r[0] for r in rr)
            host = statistics.median(r[1] for r in rr)
            slot[name] = {"p50_ms": total * 1e3, "host_ms": host * 1e3,
                          "wait_ms": (total - host) * 1e3, "n": len(rr)}
        out["slots"][where] = slot
    if sign_rounds:
        requests = ([("attestation", m, i, p) for m, p, i in unagg]
                    + [("sync_message", sync_root, i, s_pts[i])
                       for i in members])
        out["sign"] = sign_paths(sm, A, B, backend, requests, sks, key,
                                 sorted(set(roots)), device, sign_rounds,
                                 sync_device)
    return out


def sign_paths(sm, A, B, backend, requests, sks, key, roots, device,
               rounds, sync_device) -> dict:
    """The operator slot through the signing plane (`requests`: (duty,
    root, validator, anchor point)) and the full bucket, timed."""
    from grandine_tpu_torch.gpu import schemes
    from grandine_tpu_torch.runtime.sign_plane import (
        DEFAULT_SIGN_LANES, SigningPlane)

    anchors = [A.g2_to_bytes(p) for _, _, _, p in requests]
    secret = {i: A.SecretKey(sks[i]) for _, _, i, _ in requests}
    pubkey = {i: key(i) for _, _, i, _ in requests}
    base, batches = schemes.get("bls"), []

    def batch_sign(be, messages, secret_keys):
        t = time.perf_counter()
        out = base.signing.batch_sign(be, messages, secret_keys)
        batches.append({"n": len(messages), "sign_s": time.perf_counter() - t})
        return out

    def release_verify(be, messages, sig_bytes, public_keys):
        timer = sm.SignTimer(be)
        t = time.perf_counter()
        ok = base.signing.release_verify(timer, messages, sig_bytes,
                                         public_keys)
        batches.append({"n": len(messages),
                        "gate_s": time.perf_counter() - t,
                        "verify_s": timer.verify_s})
        return ok

    twin = schemes.Scheme(
        "bls", field_bits=base.field_bits, curve=base.curve,
        make_backend=base.make_backend, host_check=base.host_check,
        device_dispatch=base.device_dispatch, async_seam=base.async_seam,
        kernel_label=base.kernel_label, canary=base.canary,
        signing=schemes.SigningDescriptor(
            batch_sign=batch_sign, host_sign=base.signing.host_sign,
            release_verify=release_verify))
    sign_backend = B.TorchBlsBackend(device=device)
    plane = SigningPlane(backend=sign_backend, lanes=DEFAULT_SIGN_LANES,
                         device=device,
                         settle_timeout_s=5.0 if device == "cuda" else 600.0)
    schemes.register(twin)
    times = []
    try:
        for r in range(1 + rounds):
            del batches[:]
            sync_device()
            t0 = time.perf_counter()
            tickets = [plane.submit(m, secret[i], duty_kind=duty,
                                    public_key=pubkey[i])
                       for duty, m, i, _ in requests]
            got = [t.result(300.0) for t in tickets]
            elapsed = time.perf_counter() - t0
            if got != anchors:
                raise SystemExit("operator slot: a released signature "
                                 "differs from its anchor")
            if r:  # the first round warms the plane and the caches up
                times.append({"round_s": elapsed, "batches": list(batches)})
        totals = sm.plane_totals(plane)
    finally:
        plane.stop()
        schemes.register(base)
    if totals["device_batches"] != totals["batches"] or any(
            totals[k] for k in ("degraded", "device_faults", "gate_failures",
                                "expired")):
        raise SystemExit(f"operator slot: not every batch ran on the device "
                         f"({totals})")

    def total(name):
        return sum(b.get(name, 0.0) for t in times for b in t["batches"])

    gate, verify, sign = total("gate_s"), total("verify_s"), total("sign_s")
    slot = {"requests": len(requests), "rounds": len(times),
            "round_ms": [t["round_s"] * 1e3 for t in times],
            "p50_ms": statistics.median(t["round_s"] for t in times) * 1e3,
            "sign_ms": sign * 1e3 / len(times),
            "decode_ms": (gate - verify) * 1e3 / len(times),
            "verify_ms": verify * 1e3 / len(times),
            "gate_share": gate / (gate + sign)}

    n_full = min(B.MAX_BUCKET, len(sks))
    msgs = [roots[i % len(roots)] for i in range(n_full)]
    keys = [A.SecretKey(sks[i]) for i in range(n_full)]
    bucket = []
    for r in range(4):
        sync_device()
        t0 = time.perf_counter()
        sigs = backend.batch_sign(msgs, keys)
        bucket.append((time.perf_counter() - t0) * 1e3)
    pick = range(0, n_full, n_full // 8)
    if [sigs[j].to_bytes() for j in pick] != [
            keys[j].sign(msgs[j]).to_bytes() for j in pick]:
        raise SystemExit("full bucket: a sampled signature differs from "
                         "SecretKey.sign")
    return {"operator_slot": slot,
            "full_bucket": {"rows": n_full, "ms": bucket[1:],
                            "p50_ms": statistics.median(bucket[1:])}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--validators", type=int, default=50_000)
    ap.add_argument("--sync", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--sign-rounds", type=int, default=0)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.trees[0], a.device, a.validators, a.sync,
                                a.rounds, a.sign_rounds, a.seed)))
        return
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu for the "
                             "plain versions)")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"card: {card}", flush=True)
    results = []
    for tree in a.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(tree),
             "--device", a.device, "--validators", str(a.validators),
             "--sync", str(a.sync), "--rounds", str(a.rounds),
             "--sign-rounds", str(a.sign_rounds), "--seed", str(a.seed)],
            capture_output=True, text=True,
            cwd=os.path.abspath(tree))
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        for where, slot in res["slots"].items():
            print(f"{tree}: {where} slot, {slot['sets']} sets over "
                  f"{slot['messages']} messages: " + "; ".join(
                      f"{name} p50 {slot[name]['p50_ms']:.1f} ms (host "
                      f"{slot[name]['host_ms']:.1f}, wait "
                      f"{slot[name]['wait_ms']:.1f}, n = {slot[name]['n']})"
                      for name in ("grouped", "flat")), flush=True)
        if "sign" in res:
            op, fb = res["sign"]["operator_slot"], res["sign"]["full_bucket"]
            print(f"{tree}: operator slot, {op['requests']} signatures a "
                  f"round: p50 {op['p50_ms']:.1f} ms over {op['rounds']} "
                  f"rounds ({', '.join(f'{v:.1f}' for v in op['round_ms'])})"
                  f"; a round's batches: sign {op['sign_ms']:.1f} ms, gate "
                  f"host decode {op['decode_ms']:.1f} ms + device verify "
                  f"{op['verify_ms']:.1f} ms (gate share "
                  f"{op['gate_share']:.3f}); full bucket of {fb['rows']}: "
                  f"p50 {fb['p50_ms']:.1f} ms ("
                  f"{', '.join(f'{v:.1f}' for v in fb['ms'])})", flush=True)
    for res in results:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
