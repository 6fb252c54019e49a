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

from grandine_tpu_torch.crypto.constants import R, X
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import pairing as TP

#: r as 8 little-endian 32-bit words
R_WORDS = tuple((R >> (32 * i)) & 0xFFFFFFFF for i in range(8))
#: x²: G1's endomorphism φ acts as [x²], and k = k1·x² + k0 with both
#: halves below 2¹²⁸ for k < r
X2 = X * X
#: bits of each half k0, k1
HALF_BITS = 128
#: bits of each signed window of `g1_scalar_mul`'s ladders (csrc/kzg.cu
#: KZG_W): of 3, 4 and 5 bits, measured on an H100 80GB HBM3 at 700 W,
#: 5 was the fastest at 32 and at 4,096 rows (PERF.md)
KZG_WINDOW = 5


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


def scalar_halves(k: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 scalar words → (N, 2, 4) int64 words of [k0, k1],
    k = k1·x² + k0 (the kernel's long division; any exact division gives
    the same halves)."""
    rows = k.cpu().numpy().astype("<i4")
    halves = [divmod(int.from_bytes(r.tobytes(), "little"), X2)[::-1]
              for r in rows]
    buf = b"".join(h.to_bytes(16, "little") for pair in halves for h in pair)
    w = np.frombuffer(buf, "<u4").reshape(-1, 2, 4).astype(np.int64)
    return torch.from_numpy(w).to(k.device)


def booth_digits(h: torch.Tensor):
    """(…, 4) int64 words of 128-bit halves → the signed w-bit windows (w =
    KZG_WINDOW), top first, as (…,) int64 digits in [−2^(w−1), 2^(w−1)]:
    window i reads bits w·i − 1 … w·i + w − 1 (zero outside 0 … 127),
    ⌈129 / w⌉ windows."""
    w = KZG_WINDOW
    def bit(b):
        if b < 0 or b >= HALF_BITS:
            return torch.zeros(h.shape[:-1], dtype=torch.int64,
                               device=h.device)
        return (h[..., b // 32] >> (b % 32)) & 1

    out = []
    for i in range((HALF_BITS + w) // w - 1, -1, -1):
        u = sum(bit(w * i - 1 + j) << j for j in range(w + 1))
        out.append((u >> 1) + (u & 1) - ((u >> w) << w))
    return out


def g1_scalar_mul_plain(px, py, inf, k):
    """Plain version of `g1_scalar_mul`, in the kernel's steps: the halves
    k0, k1, lane 0 over P and lane 1 over φ(P) (a batch axis of two), each
    with its table [1..2^(w−1)] of multiples and the signed windows, then
    the lanes' sums by the complete addition (w = KZG_WINDOW)."""
    w = KZG_WINDOW
    n, dev, ops = inf.shape[0], inf.device, C.FP_OPS
    x, y = L.from_words(px), L.from_words(py)
    bx, by = C.g1_endo(dev)
    phx, phy = ops.mul_many([x, y], [bx, by])
    qx, qy = torch.stack([x, phx], 1), torch.stack([y, phy], 1)
    one = L.one_fp((n, 2), dev)
    table = [(qx, qy, one)]
    t = C.point_double(table[0], ops)
    table.append(t)
    for _ in range(2, 1 << (w - 1)):
        t = C.point_madd_unsafe(t, qx, qy, ops)
        table.append(t)
    tab = [torch.stack([e[c] for e in table]) for c in range(3)]
    st = (one, one, torch.zeros_like(qx))
    digits = booth_digits(scalar_halves(k))
    for i, dg in enumerate(digits):
        for _ in range(w if i else 0):
            st = C.point_double(st, ops)
        at = (dg.abs() - 1).clamp(min=0)[None, :, :, None].expand(
            1, n, 2, L.NLIMBS)
        e = tuple(c.gather(0, at)[0] for c in tab)
        e = (e[0], L.select(dg < 0, L.neg_mod(e[1]), e[1]), e[2])
        st = C._sel3(dg != 0, C.point_add_complete(st, e, ops), st)
    out = C.point_add_complete(tuple(c[:, 0] for c in st),
                               tuple(c[:, 1] for c in st), ops)
    return C.jac_to_words(C._mask_inf(out, inf, ops), 1)


def g1_scalar_mul(px, py, inf, k):
    """[kᵢ]Pᵢ for N affine G1 rows: px, py (N, 12) canonical words, inf
    (N,) bool (an ∞ row gives ∞ whatever its scalar), k (N, 8) int32 the
    scalars as little-endian 32-bit words (`scalar_words`), each below r
    (ValueError otherwise: the halves are 128-bit only there). Returns
    (N, 3, 12) Jacobian words, ∞ as Z = 0. CUDA kernel `g1_scalar_mul`
    (csrc/kzg.cu) on CUDA tensors, the plain version on CPU tensors.

    Replaces the scalar plane of the JAX programs kzg_msm and
    kzg_blob_verify (grandine_tpu/kzg/eip4844.py:150 and :370, both
    grandine_tpu/tpu/curve.py scalar_mul :259 over 255 MSB-first bits).
    Two lanes a row (16 rows a one-warp block): φ acts on G1 as [x²], so
    k = k1·x² + k0 (a long division in the lane) gives [k]P = [k0]P +
    [k1]φ(P); lane 0 runs [k0]P and lane 1 [k1]φ(P), each 128 bits of
    signed 5-bit windows from a table of [1..16] multiples in shared
    memory: 5 doublings, then the digit's entry added (a zero digit a
    select), at the same steps in every lane — where the one-thread
    ladder branched on each bit, so a warp paid both sides at nearly every
    step. Then one shuffle and one complete addition. Bound: operations —
    at the function's least work 128 doublings (7 Fp products) and
    popcount(k0) + popcount(k1) − 1 mixed additions (11) a row, ~1,600
    Fp products, against 129 bytes in and 144 out; a row's chain is one
    lane's 26 windows, so a batch verify's 32 rows (2 blocks) are
    latency-bound on one lane, and a setup's 4,096 rows (256 blocks) fill
    every SM."""
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


__all__ = ["KZG_WINDOW", "scalar_words", "scalar_halves", "booth_digits",
           "g1_scalar_mul", "g1_scalar_mul_plain", "lincomb", "blob_verify"]
