"""Σ rᵢ·Pᵢ as the verify kernels compute it: one GLV ladder per row, then
a strided tree sum (plain versions).

The JAX package computes the signature side Σ rᵢ·sigᵢ as a bucket MSM
(grandine_tpu/tpu/msm.py expand_glv_points + msm_bucket_scan over a host
plan). The port computes the same function as per-row dual 32-bit GLV
ladders (csrc/aggregate.cu aggregate_rlc_scale, one warp per aggregate)
and a tree sum (rlc_finish): on the card that needs no host plan, and
a bucket redesign is queued as a later performance change (ROADMAP.md).

`strided_tree_sum` fixes the summation order the kernels use — thread t
of a block of T threads accumulates rows t, t + T, … and the block then
folds position t + s into t for s = pow2ceil(T)/2 … 1 — so a kernel's
Jacobian output equals its plain version's bit for bit;
`sum_points_contiguous` applies it per group of a flat batch.
"""

from __future__ import annotations

import numpy as np
import torch

from grandine_tpu_torch.gpu import curve as C

#: threads of the kernels' summation trees (BLS_TREE in csrc/bls12_381.cuh)
TREE = 128


def _pad_inf(points, ax, n, ops):
    """Append n ∞ points (1, 1, 0) along batch axis `ax`."""
    X, Y, Z = points
    one = ops.one(X.shape[:ax] + (n,), X.device)
    return (torch.cat([X, one], ax), torch.cat([Y, one], ax),
            torch.cat([Z, torch.zeros_like(one)], ax))


def strided_tree_sum(points, live, ops, tree: int = TREE):
    """Sum (…, N) Jacobian points along the last batch axis in the order
    of a `tree`-thread block: thread t adds rows t, t + tree, … and the
    block then folds position t + s into t (t + s < tree) for s =
    pow2ceil(tree)/2 … 1, which equals folding a tree padded with ∞ to a
    power of two (∞ + P returns P's words). Rows with live=False count as
    ∞."""
    X = points[0]
    ax = len(ops.batch(X)) - 1
    n = X.shape[ax]
    chunks = max(1, -(-n // tree))
    pad = chunks * tree - n
    if pad:
        points = _pad_inf(points, ax, pad, ops)
        live = torch.cat([live, live.new_zeros(live.shape[:-1] + (pad,))], -1)
    pts = C._mask_inf(points, ~live, ops)
    one = ops.one(X.shape[:ax] + (tree,), X.device)
    acc = (one, one, torch.zeros_like(one))
    for c in range(chunks):
        acc = C.point_add_complete(
            acc, tuple(t.narrow(ax, c * tree, tree) for t in pts), ops)
    width = 1 << (tree - 1).bit_length()
    if width > tree:
        acc = _pad_inf(acc, ax, width - tree, ops)
    return C.sum_points_grouped(acc, ops)


def group_rows(offsets, device):
    """(M, K) row indices and live mask of M groups given by offsets
    (M + 1 ints): group m holds rows offsets[m] … offsets[m+1] − 1, K the
    widest group (at least 1); padding positions index row 0."""
    off = np.asarray(offsets, np.int64)
    counts = np.diff(off)
    k = max(1, int(counts.max(initial=0)))
    pos = np.arange(k)
    live = pos[None, :] < counts[:, None]
    idx = np.where(live, off[:-1, None] + pos[None, :], 0)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(live).to(device))


def sum_points_contiguous(points, offsets, ops, tree: int = TREE):
    """Per-group sums of a flat (N,) batch of Jacobian points over the
    contiguous groups [offsets[m], offsets[m+1]) — ∞ for an empty group —
    each in the order of a `tree`-thread block (strided_tree_sum). The
    counterpart of grandine_tpu/tpu/curve.py sum_points_contiguous (groups
    of one power-of-two width there; any offsets here)."""
    if points[0].shape[0] == 0:  # every group empty: give the gather a row
        points = _pad_inf(points, 0, 1, ops)
    idx, live = group_rows(offsets, points[0].device)
    return strided_tree_sum(tuple(c[idx] for c in points), live, ops, tree)


__all__ = ["TREE", "strided_tree_sum", "sum_points_contiguous",
           "group_rows"]
