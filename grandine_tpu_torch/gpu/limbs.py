"""Fp arithmetic for BLS12-381 on torch tensors: the plain versions of the
CUDA kernels' field layer.

Rest format (every public function and kernel boundary of this package):
an Fp element is a CANONICAL value in [0, p) stored as a ``(…, 12)``
``torch.int32`` tensor of little-endian 32-bit words, each read as uint32.
Fp2 is ``(…, 2, 12)`` as (c0, c1); Fp12 is ``(…, 2, 3, 2, 12)`` over the
tower Fp2[v]/(v³ − ξ), Fp6[w]/(w² − v), ξ = 1 + u. Jacobian points carry
canonical X, Y, Z on a coordinate axis ahead of the field axes. Canonical
words are layout-agnostic, cheap to build on the host (``ints_to_words``)
and compare bit for bit between the CUDA kernels and the plain versions.

Working format of the plain versions (this file): ``(…, 24)`` ``int64``
tensors of 16-bit limbs in Montgomery form with R = 2³⁸⁴ — the same R as
the kernels' 12×32-bit limbs (csrc/bls12_381.cuh), so every Montgomery
value a kernel holds is the value a plain version holds. Every operation
returns a fully reduced value in [0, p); the kernels do the same, which is
what lets a kernel and its plain version agree exactly at every stage.

A Montgomery product runs as three limb convolutions (a·b, the low half
times −p⁻¹ mod R, m·p), each one broadcast multiply and one skewed sum,
with carries resolved by a few parallel carry passes plus one carry-chain
resolution on bit masks packed into an int64 — about a hundred tensor ops
whatever the batch, so the plain versions run at any width on the CPU and
on the card alike.
"""

from __future__ import annotations

import numpy as np
import torch

from grandine_tpu_torch.crypto.constants import P

LIMB_BITS = 16
NLIMBS = 24
NWORDS = 12
MASK = (1 << LIMB_BITS) - 1
R_MONT = 1 << (LIMB_BITS * NLIMBS)  # 2^384, the kernels' R too
R2 = R_MONT * R_MONT % P
NPRIME = (-pow(P, -1, R_MONT)) % R_MONT  # −p⁻¹ mod R


def _int_limbs(v: int, n: int = NLIMBS) -> "list[int]":
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(n)]


_CONST_CACHE: dict = {}


def _const(name: str, value: int, device) -> torch.Tensor:
    key = (name, str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.tensor(_int_limbs(value), dtype=torch.int64, device=device)
        _CONST_CACHE[key] = t
    return t


def _shifts(n: int, device) -> torch.Tensor:
    key = ("shifts", n, str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.arange(n, dtype=torch.int64, device=device)
        _CONST_CACHE[key] = t
    return t


# --- host conversions (canonical ints ↔ rest-format words) ---------------


def ints_to_words(values) -> np.ndarray:
    """[v, …] canonical ints → (n, 12) int32 words (little-endian uint32)."""
    n = len(values)
    buf = bytearray(48 * n)
    for i, v in enumerate(values):
        buf[48 * i : 48 * (i + 1)] = int(v).to_bytes(48, "little")
    return np.frombuffer(bytes(buf), "<u4").reshape(n, NWORDS).view(np.int32)


def words_to_ints(words) -> "list[int]":
    """(…, 12) words (tensor or array) → flat list of ints, row-major."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    w = np.ascontiguousarray(np.asarray(words, dtype=np.int32))
    raw = w.reshape(-1, NWORDS).view("<u4").tobytes()
    return [int.from_bytes(raw[48 * i : 48 * (i + 1)], "little")
            for i in range(len(raw) // 48)]


# --- word ↔ limb conversion ----------------------------------------------


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(…, 12) int32 words → (…, 24) int64 16-bit limbs (same value)."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & MASK, u >> LIMB_BITS], dim=-1).reshape(
        *w.shape[:-1], NLIMBS
    )


def limbs_to_words(a: torch.Tensor) -> torch.Tensor:
    """(…, 24) normalized limbs → (…, 12) int32 words."""
    pairs = a.reshape(*a.shape[:-1], NWORDS, 2)
    u = pairs[..., 0] | (pairs[..., 1] << LIMB_BITS)
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """Canonical words → Montgomery limbs (the plain versions' entry)."""
    return to_mont(words_to_limbs(w))


def to_words(a: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs → canonical words (the plain versions' exit)."""
    return limbs_to_words(from_mont(a))


def const_fp(value: int, shape=(), device="cpu") -> torch.Tensor:
    """Montgomery form of an int, broadcast to `shape` + (24,)."""
    t = _const("mont%x" % value, value * R_MONT % P, device)
    return t.expand(*shape, NLIMBS).clone()


def one_fp(shape=(), device="cpu") -> torch.Tensor:
    return const_fp(1, shape, device)


# --- carries -------------------------------------------------------------


def _carry(x: torch.Tensor, passes: int):
    """Normalize non-negative limbs to [0, 2¹⁶): `passes` parallel carry
    passes bring every limb to at most 2¹⁶ (the caller picks enough for its
    input bound), then one carry-chain resolution: limb i generates a carry
    when it is 2¹⁶ and propagates one when it is 2¹⁶ − 1; packing both
    masks into int64 bit vectors G and GP, G + GP runs the whole chain as
    one integer addition. Returns (limbs, carry out of the top limb)."""
    n = x.shape[-1]
    out = 0
    for _ in range(passes):
        c = x >> LIMB_BITS
        out = out + c[..., -1]
        x = x & MASK
        x[..., 1:] += c[..., :-1]
    w = _shifts(n, x.device)
    G = ((x >> LIMB_BITS) << w).sum(-1)
    GP = (((x + 1) >> LIMB_BITS) << w).sum(-1)
    chain = (GP + G) ^ GP ^ G  # bit i = carry into limb i
    x = (x + ((chain.unsqueeze(-1) >> w) & 1)) & MASK
    return x, out + (chain >> n)


def _conv(a: torch.Tensor, b: torch.Tensor, n_out: int) -> torch.Tensor:
    """Column sums c_k = Σ_{i+j=k} a_i·b_j (unnormalized) for k < n_out,
    via one broadcast product and a skewed reshape."""
    n = a.shape[-1]
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)  # (…, n, n)
    batch = outer.shape[:-2]
    padded = torch.nn.functional.pad(outer, (0, n))  # (…, n, 2n)
    flat = padded.reshape(*batch, 2 * n * n)[..., : n * (2 * n - 1)]
    return flat.reshape(*batch, n, 2 * n - 1).sum(-2)[..., :n_out]


# --- Fp operations (Montgomery limbs in, canonical Montgomery limbs out) --
#
# Each modular add/sub normalizes its two candidates (with and without the
# correction by p) in ONE stacked carry call and keeps the one whose carry
# out of 2³⁸⁴ says it is in range.


def _pick(cands, passes):
    y, top = _carry(cands, passes)
    return torch.where((top[..., 1] > 0).unsqueeze(-1), y[..., 1, :],
                       y[..., 0, :])


def add_mod(a, b):
    """s = a + b < 2p; s − p = s + (2³⁸⁴ − p) − 2³⁸⁴ carries out iff s ≥ p."""
    s = a + b
    return _pick(torch.stack(
        torch.broadcast_tensors(s, s + _const("negp", R_MONT - P, s.device)),
        -2), 2)


def double_mod(a):
    return add_mod(a, a)


def sub_mod(a, b):
    """d = a + ¬b + 1 = a − b + 2³⁸⁴ carries out iff a ≥ b; otherwise
    d + p − 2³⁸⁴ = a − b + p is the answer."""
    d = a + (MASK - b)
    d = d + _const("one", 1, d.device)
    cands = torch.stack([d + _const("p", P, d.device), d], -2)
    return _pick(cands, 2)


def neg_mod(a):
    return sub_mod(torch.zeros_like(a), a)


def montmul(a, b):
    """a·b·R⁻¹ mod p (R = 2³⁸⁴), product scanning; the final conditional
    subtraction rides in the same carry call as the reduction."""
    t = _conv(a, b, 2 * NLIMBS - 1)
    t = torch.nn.functional.pad(t, (0, 1))  # (…, 48), columns < 2^37
    m = _conv(t[..., :NLIMBS], _const("nprime", NPRIME, t.device), NLIMBS)
    m, _ = _carry(m, 4)  # columns < 2^58 → m = t·(−p⁻¹) mod R
    u = t + torch.nn.functional.pad(
        _conv(m, _const("p", P, t.device), 2 * NLIMBS - 1), (0, 1))
    negp = torch.nn.functional.pad(_const("negp", R_MONT - P, u.device),
                                   (NLIMBS, 0))
    y, top = _carry(torch.stack([u, u + negp], -2), 3)
    # u ≡ 0 mod R and u/R < 2p: the high half, or the high half − p
    return torch.where((top[..., 1] > 0).unsqueeze(-1), y[..., 1, NLIMBS:],
                       y[..., 0, NLIMBS:])


def montsq(a):
    return montmul(a, a)


def to_mont(a):
    """Canonical limbs → Montgomery limbs."""
    return montmul(a, _const("r2", R2, a.device))


def from_mont(a):
    """Montgomery limbs → canonical limbs."""
    return montmul(a, _const("one", 1, a.device))


def pow_fixed(a, exponent: int):
    """a^e for a host-known exponent (MSB-first square and multiply; the
    multiply runs only on set bits — the exponent is public)."""
    if exponent == 0:
        return one_fp(a.shape[:-1], a.device)
    out = a
    for bit in bin(exponent)[3:]:
        out = montsq(out)
        if bit == "1":
            out = montmul(out, a)
    return out


def inv_mod(a):
    """a⁻¹ by Fermat; inv(0) = 0."""
    return pow_fixed(a, P - 2)


def is_zero(a) -> torch.Tensor:
    return (a == 0).all(-1)


def eq(a, b) -> torch.Tensor:
    return (a == b).all(-1)


def select(cond, a, b):
    """cond ? a : b, cond of the batch shape (broadcast over the limbs and
    any field axes between the batch and the limbs)."""
    c = cond
    while c.dim() < a.dim():
        c = c.unsqueeze(-1)
    return torch.where(c, a, b)


# --- packed transfer format (host) -----------------------------------------


#: words of one coordinate in the packed transfer format: 12 little-endian
#: uint32 words of the canonical value and a 13th, zero here
PACKED_WORDS = 13


def pack_fp_words_host(values) -> np.ndarray:
    """Canonical ints → (N, 13) uint32 little-endian words, the 13th zero:
    the JAX package's packed transfer format (grandine_tpu/tpu/limbs.py
    pack_fp_words_host), which `gpu.bls.unpack_words` takes (as int32)."""
    vals = [int(v) for v in values]
    assert all(0 <= v < R_MONT for v in vals)
    out = np.zeros((len(vals), PACKED_WORDS), np.uint32)
    out[:, :NWORDS] = ints_to_words(vals).view(np.uint32)
    return out


def geq_const(a_canon, value: int) -> torch.Tensor:
    """value(a) ≥ value for normalized (canonical) limbs."""
    _, top = _carry(a_canon + _const("neg%x" % value, R_MONT - value,
                                     a_canon.device), 1)
    return top > 0


__all__ = [
    "P", "R_MONT", "NLIMBS", "NWORDS", "ints_to_words", "words_to_ints",
    "words_to_limbs", "limbs_to_words", "from_words",
    "to_words", "const_fp", "one_fp", "add_mod", "double_mod",
    "neg_mod", "sub_mod", "montmul", "montsq", "to_mont", "from_mont",
    "pow_fixed", "inv_mod", "is_zero", "eq", "select", "geq_const",
    "PACKED_WORDS", "pack_fp_words_host",
]
