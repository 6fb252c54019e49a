"""The slasher's span-grid merge on the card: the port of
grandine_tpu/tpu/spans.py.

The slasher's chunked min/max target spans (slasher.py) take one range
update per attesting validator. `on_attestations_bulk` merges a whole
window's solo validators in one chunk-aligned epoch grid: for each row v
with attestation (s_v, t_v), over the grid [base, base + SPAN_GRID_EPOCHS),

  new_min[v][e] = min(old_min[v][e], t_v if e < s_v else UNSET)
  new_max[v][e] = max(old_max[v][e], t_v if s_v < e <= t_v else 0)

Epochs ride as int32: the min-side UNSET sentinel maps uint64 0xFFFF..FF
↔ INT32_UNSET at the host boundary (slasher._merge_grid), and rows whose
epochs reach 2^30 stay on the host walk.

`span_update_grid` runs the CUDA kernel of csrc/spans.cu on CUDA tensors
and its plain version on CPU tensors. `SpanPlane` is the slasher's façade:
numpy in, one launch, numpy out. Unlike the reference it pads no rows to a
bucket: a CUDA kernel has no compiled shapes, so any row count is one
launch (the JAX package's device path refuses more than 16,384 rows,
grandine_tpu/tpu/bls.py MAX_BUCKET).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: epochs per device grid — four span chunks (slasher.CHUNK_EPOCHS × 4)
SPAN_GRID_EPOCHS = 64

#: int32 stand-in for the slasher's uint64 UNSET min sentinel
INT32_UNSET = 0x7FFF_FFFF

#: the largest grid base: e = base + 63 must stay an int32
MAX_BASE = (1 << 31) - SPAN_GRID_EPOCHS


def span_update_grid_plain(min_block, max_block, src, tgt, valid, base):
    """Plain version of `span_update_grid`: grandine_tpu/tpu/spans.py
    `_span_grid_compute` in int32 torch ops."""
    e = int(base) + torch.arange(SPAN_GRID_EPOCHS, dtype=torch.int32,
                                 device=min_block.device)[None, :]
    s = src[:, None]
    t = tgt[:, None]
    v = valid[:, None]
    new_min = torch.minimum(min_block, torch.where(v & (e < s), t,
                                                   INT32_UNSET))
    new_max = torch.maximum(max_block, torch.where(v & (e > s) & (e <= t),
                                                   t, 0))
    return new_min, new_max


def _check(min_block, max_block, src, tgt, valid, base) -> int:
    if min_block.dim() != 2:
        raise ValueError("span_update_grid: min_block must be (n, 64) int32")
    n = min_block.shape[0]
    grid = (n, SPAN_GRID_EPOCHS)
    if (tuple(min_block.shape) != grid or tuple(max_block.shape) != grid
            or tuple(src.shape) != (n,) or tuple(tgt.shape) != (n,)
            or tuple(valid.shape) != (n,)):
        raise ValueError("span_update_grid: min_block, max_block (n, 64), "
                         "src, tgt, valid (n,)")
    if any(a.dtype != torch.int32 for a in (min_block, max_block, src, tgt)) \
            or valid.dtype != torch.bool:
        raise ValueError("span_update_grid: int32 blocks, src and tgt, bool "
                         "valid")
    if len({a.device for a in (min_block, max_block, src, tgt, valid)}) != 1:
        raise ValueError("span_update_grid: every tensor on one device")
    if isinstance(base, bool) or not isinstance(base, (int, np.integer)) \
            or not 0 <= int(base) <= MAX_BASE:
        raise ValueError(f"span_update_grid: base must be an int in "
                         f"[0, {MAX_BASE}], got {base!r}")
    return n


def span_update_grid(min_block, max_block, src, tgt, valid, base):
    """One grid window of the slasher's span merge: min_block, max_block
    (n, 64) int32 (the min side sentinel-mapped to INT32_UNSET), src, tgt
    (n,) int32 each row's attestation epochs, valid (n,) bool, base the
    grid's first epoch (an int in [0, 2³¹ − 64], so that every grid epoch
    is an int32). Returns the new (min, max) blocks, out of place. CUDA
    kernel `span_update_grid` (csrc/spans.cu) on CUDA tensors, the plain
    version on CPU tensors; raises on a wrong dtype, shape or base.

    Replaces the JAX program span_update_grid (grandine_tpu/tpu/spans.py:45
    `_span_grid_compute`). Bound: bytes — each row reads 2 × 256 B of
    blocks and 9 B of (s, t, valid) and writes 2 × 256 B, for a handful of
    integer compares a value, so the kernel is a memory-bound elementwise
    pass: one thread takes 4 consecutive epochs of one row through 16-byte
    int4 loads and stores (coalesced across the warp), and the row's
    operands come from one cache line its 16 threads share."""
    n = _check(min_block, max_block, src, tgt, valid, base)
    if min_block.device.type == "cpu":
        return span_update_grid_plain(min_block, max_block, src, tgt, valid,
                                      base)
    from grandine_tpu_torch.gpu import _build

    args = [a.contiguous() for a in (min_block, max_block, src, tgt, valid)]
    if any(a.data_ptr() % 16 for a in args[:2]):
        raise ValueError("span_update_grid: the blocks must be 16-byte "
                         "aligned (int4 loads)")
    out_min = torch.empty_like(args[0])
    out_max = torch.empty_like(args[1])
    if n:
        _build.launch("span_update_grid", *args, ctypes.c_int(n),
                      ctypes.c_int(int(base)), out_min, out_max)
        span_update_grid.launches += 1
    return out_min, out_max


span_update_grid.launches = 0


class SpanPlane:
    """The slasher's façade for the span-grid kernel, the port of
    grandine_tpu/tpu/spans.py SpanPlane. Runs on `device`, CUDA unless
    "cpu" is passed, and raises with no card; on CUDA the constructor
    loads the kernel library (a kernel that does not build raises here).
    Stateless apart from `metrics`, which, when given, counts each launch
    as the reference does."""

    def __init__(self, device=None, metrics=None) -> None:
        from grandine_tpu_torch.gpu.bls import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from grandine_tpu_torch.gpu import _build

            _build.library()
        self.metrics = metrics

    def _count_kernel(self, kernel: str) -> None:
        if self.metrics is not None:
            self.metrics.device_kernel_calls.labels(kernel).inc()

    def update(self, min_block, max_block, src, tgt, base_epoch: int):
        """Merge one grid window: `min_block`/`max_block` (n,
        SPAN_GRID_EPOCHS) int32 numpy (min side already sentinel-mapped),
        `src`/`tgt` (n,) int32 numpy, `base_epoch` the grid's first epoch.
        Copies to the device, makes one launch at any n, and returns
        (new_min, new_max) as (n, SPAN_GRID_EPOCHS) int32 numpy arrays."""
        n = int(min_block.shape[0])
        dev = self.device
        mn, mx = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                  for a in (min_block, max_block))
        sr, tg = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                  for a in (src, tgt))
        va = torch.ones((n,), dtype=torch.bool, device=dev)
        self._count_kernel("span_update_grid")
        out_min, out_max = span_update_grid(mn, mx, sr, tg, va,
                                            int(base_epoch))
        return out_min.cpu().numpy(), out_max.cpu().numpy()


def grid_merge_host(min_block, max_block, src, tgt, base_epoch: int):
    """Numpy mirror of `_span_grid_compute` (grandine_tpu/tpu/spans.py:
    126-142), the reference's oracle for the kernel."""
    e = np.int64(base_epoch) + np.arange(SPAN_GRID_EPOCHS, dtype=np.int64)
    e = e[None, :]
    src_c = np.asarray(src, np.int64)[:, None]
    tgt_c = np.asarray(tgt, np.int64)[:, None]
    new_min = np.minimum(
        np.asarray(min_block, np.int64),
        np.where(e < src_c, tgt_c, np.int64(INT32_UNSET)),
    )
    new_max = np.maximum(
        np.asarray(max_block, np.int64),
        np.where((e > src_c) & (e <= tgt_c), tgt_c, 0),
    )
    return new_min.astype(np.int32), new_max.astype(np.int32)


__all__ = [
    "SPAN_GRID_EPOCHS",
    "INT32_UNSET",
    "MAX_BASE",
    "SpanPlane",
    "grid_merge_host",
    "span_update_grid",
    "span_update_grid_plain",
]
