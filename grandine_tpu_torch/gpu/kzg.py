"""The device half of the EIP-4844 blob-KZG plane (kzg/eip4844.py): the G1
ladder over 255-bit public scalars and the two device passes built on it.

  `lincomb` — Σ kᵢ·Lᵢ over a trusted setup's Lagrange points, the MSM
  behind every commitment and proof: `g1_scalar_mul` over the setup's
  rows, then `g1_group_sum` over one group — replacing the JAX program
  kzg_msm (grandine_tpu/kzg/eip4844.py:150 `_msm_device.msm_kernel`).

  `blob_verify` — the batch blob-proof equation e(Σ rⁱ(Cᵢ − yᵢG1 +
  zᵢWᵢ), G2)·e(−Σ rⁱWᵢ, τG2) == 1 laid out as four contiguous groups of
  scalar-multiplied rows (commitments·rⁱ | proofs·rⁱzᵢ | G1·(−Σrⁱyᵢ) |
  proofs·(−rⁱ)): `g1_scalar_mul`, `g1_group_sum` over the four groups,
  `miller_loop_pairs` against [G2, G2, G2, τG2] and `rlc_finish` with one
  group of four Fp12 terms and no signature term — replacing the JAX
  program kzg_blob_verify (eip4844.py:370 `_blob_verify_kernel`).

Each runs as one device pass: the kernels queue on one stream and the
host reads back only the result. `g1_scalar_mul` is the only kernel of
its own (csrc/kzg.cu); the rest are the BLS verify path's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grandine_tpu_torch.crypto.constants import R
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import pairing as TP

#: bits of a scalar below r, the ladder's trip count
SCALAR_BITS = 255
#: r as 8 little-endian 32-bit words
R_WORDS = tuple((R >> (32 * i)) & 0xFFFFFFFF for i in range(8))


def scalar_words(scalars) -> np.ndarray:
    """Scalars in [0, 2²⁵⁶) → (N, 8) int32, each as 8 little-endian 32-bit
    words (read as uint32)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in scalars)
    return np.frombuffer(buf, "<u4").reshape(-1, 8).view(np.int32).copy()


def _below_r(k: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the scalar of each row of (N, 8) words is below r."""
    w = k.to(torch.int64) & 0xFFFFFFFF
    lt = torch.zeros(k.shape[0], dtype=torch.bool, device=k.device)
    eq = torch.ones_like(lt)
    for i in range(7, -1, -1):
        lt |= eq & (w[:, i] < R_WORDS[i])
        eq &= w[:, i] == R_WORDS[i]
    return lt


# --- g1_scalar_mul -----------------------------------------------------------


def g1_scalar_mul_plain(px, py, inf, k):
    """Plain version of `g1_scalar_mul`: gpu/curve.py scalar_mul over the
    255 bits of each scalar, MSB first."""
    bits = C._bits_msb(k.to(torch.int64) & 0xFFFFFFFF, SCALAR_BITS)
    out = C.scalar_mul(L.from_words(px), L.from_words(py), inf, bits,
                       C.FP_OPS)
    return C.jac_to_words(out, 1)


def g1_scalar_mul(px, py, inf, k):
    """[kᵢ]Pᵢ for N affine G1 rows: px, py (N, 12) canonical words, inf
    (N,) bool (an ∞ row gives ∞ whatever its scalar), k (N, 8) int32 the
    scalars as little-endian 32-bit words (`scalar_words`), each below r
    (ValueError otherwise: the mixed additions are safe only there).
    Returns (N, 3, 12) Jacobian words, ∞ as Z = 0. CUDA kernel
    `g1_scalar_mul` (csrc/kzg.cu) on CUDA tensors, the plain version on
    CPU tensors.

    Replaces the scalar plane of the JAX programs kzg_msm and
    kzg_blob_verify (grandine_tpu/kzg/eip4844.py:150 and :370, both
    grandine_tpu/tpu/curve.py scalar_mul :259 over 255 MSB-first bits).
    One thread a row, one warp a block: 255 doublings, and a mixed
    addition at each set bit after the first — the scalars are public, so
    the ladder branches on them. Bound: operations — 255 doublings (7 Fp
    products) and about 127 mixed additions (11) a row, ~3,200 Fp
    products, against 129 bytes in and 144 out; each row is one thread's
    dependent chain, so the kernel is latency-bound on one ladder: a batch
    verify's 16–32 rows take one SM, a setup's 4,096 rows 128 one-warp
    blocks in one wave. A GLV split and several threads a ladder are the
    queued speed-ups."""
    n = inf.shape[0]
    if (px.shape != (n, 12) or py.shape != (n, 12) or k.shape != (n, 8)
            or k.dtype != torch.int32):
        raise ValueError("g1_scalar_mul: px, py (N, 12), inf (N,), k (N, 8) "
                         "int32")
    if not bool(_below_r(k).all()):
        raise ValueError("g1_scalar_mul: every scalar must be below r")
    if inf.device.type == "cpu":
        return g1_scalar_mul_plain(px, py, inf, k)
    from grandine_tpu_torch.gpu import _build

    out = torch.empty((n, 3, 12), dtype=torch.int32, device=inf.device)
    _build.launch("g1_scalar_mul", px.contiguous(), py.contiguous(),
                  inf.contiguous(), k.contiguous(), ctypes.c_int(n), out)
    g1_scalar_mul.launches += 1
    return out


g1_scalar_mul.launches = 0


# --- the two device passes ---------------------------------------------------


def lincomb(px, py, inf, k):
    """Σ kᵢ·Pᵢ over the rows of `g1_scalar_mul` (a setup's Lagrange
    points and a polynomial's evaluations): one ladder launch and one
    group sum. Returns (1, 3, 12) Jacobian words without waiting."""
    return B.g1_group_sum(g1_scalar_mul(px, py, inf, k), [0, inf.shape[0]])


def blob_verify(px, py, inf, k, q2, groups: int):
    """The batch blob-proof verdict of one packed batch: rows of
    `g1_scalar_mul` in four contiguous groups of `groups` rows (padding
    rows ∞ with scalar 0), q2 (4, 2, 2, 12) the affine G2 words [G2, G2,
    G2, τG2]. A group sum may be ∞ (adversarial cancellation): its pair
    then contributes one (the pairing's mask), never a failure, so
    `rlc_finish` gets no aggregate flag. Returns the (1,) uint8 verdict
    tensor without waiting."""
    rows = g1_scalar_mul(px, py, inf, k)
    sums = B.g1_group_sum(rows, range(0, 4 * groups + 1, groups))
    sum_inf = (sums[:, 2] == 0).all(-1)
    f = TP.miller_loop_pairs(sums, q2, sum_inf)
    dev = f.device
    none = torch.zeros((0,), dtype=torch.bool, device=dev)
    return B.rlc_finish(f, torch.zeros((0, 3, 2, 12), dtype=torch.int32,
                                       device=dev),
                        torch.zeros_like(sum_inf), none, none, [0, 4], [0, 0])


__all__ = ["SCALAR_BITS", "scalar_words", "g1_scalar_mul",
           "g1_scalar_mul_plain", "lincomb", "blob_verify"]
