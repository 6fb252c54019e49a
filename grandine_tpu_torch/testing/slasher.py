"""Seeded inputs of the slasher plane, shared by the tests and
chip_smoke.py: edge-case operands of the span-grid kernel, and epoch
windows of attestation aggregates in which every validator votes once."""

from __future__ import annotations

import numpy as np

from grandine_tpu_torch.gpu.spans import INT32_UNSET, SPAN_GRID_EPOCHS as E

LIMIT = (1 << 31) - 1


def span_edge_rows(n, base, seed):
    """n grid rows at `base`: the first rows are the edge cases (not
    valid, s below the grid, t at or past its end, s = t − 1, s past the
    grid, s = t), the rest seeded (s, t) around the grid; blocks mix
    UNSET, 0 and seeded int32 values. Returns numpy (min, max, src, tgt,
    valid)."""
    rng = np.random.default_rng(seed)
    lo = max(0, base - 80)
    hi = min(base + 140, LIMIT - 80)
    src = rng.integers(lo, hi, n, dtype=np.int64)
    tgt = np.minimum(src + rng.integers(0, 80, n), LIMIT)
    valid = rng.random(n) < 0.9
    special = [  # (s, t, valid)
        (base + 10, base + 20, False),
        (max(0, base - 5), base + 10, True),
        (base + 10, min(base + 100, LIMIT), True),
        (base + 30, base + 31, True),
        (min(base + 70, LIMIT - 1), min(base + 75, LIMIT), True),
        (base + 7, base + 7, True),
        (base, base + E - 1, True),
        (base, base + E, True),
    ]
    for r, (s, t, v) in enumerate(special[:n]):
        src[r], tgt[r], valid[r] = s, t, v
    pick = rng.integers(0, 4, (2, n, E))
    vals = rng.integers(-(1 << 31), 1 << 31, (2, n, E), dtype=np.int64)
    near = base + rng.integers(0, 2 * E, (2, n, E))
    blocks = np.where(pick == 0, INT32_UNSET,
                      np.where(pick == 1, 0, np.where(pick == 2, near, vals)))
    blocks = np.clip(blocks, -(1 << 31), LIMIT)
    return (blocks[0].astype(np.int32), blocks[1].astype(np.int32),
            src.astype(np.int32), tgt.astype(np.int32), valid)


def epoch_window(n_validators, target, seed, slots=32, roots_per_slot=3):
    """One epoch's attestation aggregates at `target` (source target − 1),
    as `on_attestations_bulk` takes them: the validators shuffled from
    `seed` into `slots` × the spec's committee count (max(1, min(64, n //
    slots // 128))) committees, each committee one aggregate of its sorted
    indices over one of its slot's `roots_per_slot` seeded data roots.
    Every validator votes once."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_validators)
    count = max(1, min(64, n_validators // slots // 128))
    n_comm = slots * count
    out = []
    for slot in range(slots):
        roots = [rng.bytes(32) for _ in range(roots_per_slot)]
        for c in range(count):
            members = np.sort(perm[slot * count + c::n_comm]).tolist()
            out.append((members, target - 1, target,
                        roots[c % roots_per_slot]))
    return out
