"""MSM window calibration on the card, the port's counterpart of
grandine_tpu/tpu/autotune.py.

`bls.pick_msm_window`'s op model predicts the cheapest Pippenger window;
this module measures it. For each probed (points, groups, field) cell it
times `msm.msm_bucket_sum` — the plan's upload and the three kernels,
what a verify pays per plane — with CUDA events after a warm-up, once per
candidate window, and keeps the fastest. The winners persist as
{"windows": {"<n>:<g>": w}} in the port's own table (`bls.msm_tune_path()`,
gpu/msm_tune.json), which `pick_msm_window` reads ahead of the model.

    python -m grandine_tpu_torch.gpu.autotune    # on a card: sweep, write

Nothing on the verify path calls it; a run without a card raises.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm as M

#: candidate window widths (pick_msm_window's range)
WINDOWS = (4, 5, 6, 7, 8)

#: the grouped route's cells, (points, groups, field) at the keys
#: pick_msm_window looks up: the unaggregated slot's keys (1,562 over 12
#: roots: bucket 2,048, bm = 16) and signatures, the sync committee's 512
#: keys over one root (bm = 4) and signatures
DEFAULT_SHAPES = ((2048, 16, 1), (512, 4, 1), (2048, 1, 2), (512, 1, 2))


def _probe_rows(n: int, k: int, seed: int) -> "tuple[np.ndarray, ...]":
    """(x, y) canonical words of n pseudo-random G1 (k = 1) or G2 (k = 2)
    coordinates. The kernels' work does not depend on the points being on
    the curve, only on the plan, so field elements time like points."""
    rng = np.random.default_rng(seed)

    def coords():
        vals = [int.from_bytes(rng.bytes(48), "big") % L.P
                for _ in range(n * k)]
        return L.ints_to_words(vals).reshape(
            (n,) + ((2,) if k == 2 else ()) + (12,)).copy()

    return coords(), coords()


def time_window(n_points: int, n_groups: int, wbits: int, field: int = 1,
                repeats: int = 3, seed: int = 7, device=None) -> float:
    """Best of `repeats` CUDA-event times (ms) of one msm_bucket_sum over
    n_points random RLC pairs in n_groups groups at window `wbits`, after
    one warm-up call."""
    dev = B.resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("autotune measures the card: no CUDA device given")
    rng = np.random.default_rng(seed)
    lo = rng.integers(1, 1 << 32, size=n_points, dtype=np.uint64)
    hi = rng.integers(1, 1 << 32, size=n_points, dtype=np.uint64)
    groups = None if n_groups == 1 else np.arange(n_points) % n_groups
    plan = M.plan_msm(lo, hi, np.zeros(n_points, bool), groups, n_groups,
                      window_bits=wbits)
    x, y = (torch.from_numpy(a).to(dev) for a in _probe_rows(n_points, field,
                                                               seed))
    live = torch.ones((n_points,), dtype=torch.bool, device=dev)
    M.msm_bucket_sum(x, y, live, plan)  # warm-up
    best = None
    for _ in range(max(1, int(repeats))):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        e0.record()
        M.msm_bucket_sum(x, y, live, plan)
        e1.record()
        torch.cuda.synchronize(dev)
        ms = e0.elapsed_time(e1)
        best = ms if best is None else min(best, ms)
    return best


def sweep(shapes=DEFAULT_SHAPES, windows=WINDOWS, repeats: int = 3,
          verbose=print, times: "dict | None" = None,
          device=None) -> "dict[str, int]":
    """Time every (cell, window); returns the fastest window per cell keyed
    as pick_msm_window looks it up. `times`, where given, receives every
    measurement as {(key, field, w): ms}."""
    table: "dict[str, int]" = {}
    for n_points, n_groups, field in shapes:
        n_b, g_b = B._bucket(n_points), B._bucket(max(1, n_groups), lo=1)
        key = "%d:%d" % (n_b, g_b)  # as pick_msm_window looks it up
        best_w, best_ms = None, None
        for w in windows:
            ms = time_window(n_b, g_b, w, field, repeats=repeats,
                             device=device)
            if times is not None:
                times[(key, field, w)] = ms
            if verbose is not None:
                verbose(f"  msm {key} G{field} w={w}: {ms:.3f} ms")
            if best_ms is None or ms < best_ms:
                best_w, best_ms = w, ms
        table[key] = int(best_w)
        if verbose is not None:
            verbose(f"  msm {key} G{field} -> w={best_w}")
    return table


def write_tuning(table: "dict[str, int]", path=None) -> str:
    """Persist the table where `bls.load_msm_tuning` reads it and drop the
    cached table, so that this process reads it next."""
    path = path or B.msm_tune_path()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump({"windows": {k: int(v) for k, v in sorted(table.items())}},
                  fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    B.set_msm_tuning(None)
    return path


def autotune(shapes=DEFAULT_SHAPES, windows=WINDOWS, repeats: int = 3,
             path=None, verbose=print, device=None) -> "dict[str, int]":
    """Sweep, persist, reload."""
    table = sweep(shapes=shapes, windows=windows, repeats=repeats,
                  verbose=verbose, device=device)
    out = write_tuning(table, path=path)
    if verbose is not None:
        verbose(f"wrote {len(table)} tuned windows -> {out}")
    return table


__all__ = ["WINDOWS", "DEFAULT_SHAPES", "time_window", "sweep",
           "write_tuning", "autotune"]


if __name__ == "__main__":
    autotune()
