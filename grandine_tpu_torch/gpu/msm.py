"""Σ rᵢ·Pᵢ as the verify kernels compute it: one GLV ladder per row, then
a strided tree sum (plain versions).

The JAX package computes the signature side Σ rᵢ·sigᵢ as a bucket MSM
(grandine_tpu/tpu/msm.py expand_glv_points + msm_bucket_scan over a host
plan). The port computes the same function as per-row dual 32-bit GLV
ladders (csrc/aggregate.cu aggregate_rlc_scale, one warp per aggregate)
and a tree sum (rlc_finish): on the card that needs no host plan, and
a bucket redesign is queued as a later performance change (ROADMAP.md).

`strided_tree_sum` fixes the summation order the kernels use — thread t
of a TREE-wide block accumulates rows t, t + TREE, … and the block then
folds position t + s into t for s = TREE/2 … 1 — so a kernel's Jacobian
output equals its plain version's bit for bit.
"""

from __future__ import annotations

import torch

from grandine_tpu_torch.gpu import curve as C

#: threads of the kernels' summation trees (BLS_TREE in csrc/bls12_381.cuh)
TREE = 128


def strided_tree_sum(points, live, ops):
    """Sum (…, N) Jacobian points along the last batch axis in the
    kernels' order; rows with live=False count as ∞."""
    X, Y, Z = points
    ax = len(ops.batch(X)) - 1
    n = X.shape[ax]
    chunks = max(1, -(-n // TREE))
    pad = chunks * TREE - n
    if pad:
        one = ops.one(X.shape[:ax] + (pad,), X.device)
        X = torch.cat([X, one], ax)
        Y = torch.cat([Y, one], ax)
        Z = torch.cat([Z, torch.zeros_like(one)], ax)
        live = torch.cat([live, live.new_zeros(live.shape[:-1] + (pad,))], -1)
    pts = C._mask_inf((X, Y, Z), ~live, ops)
    one = ops.one(X.shape[:ax] + (TREE,), X.device)
    acc = (one, one, torch.zeros_like(one))
    for c in range(chunks):
        acc = C.point_add_complete(
            acc, tuple(t.narrow(ax, c * TREE, TREE) for t in pts), ops)
    return C.sum_points_grouped(acc, ops)


__all__ = ["TREE", "strided_tree_sum"]
