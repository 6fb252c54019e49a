"""BLS batch verification on the card: the verify kernels that follow
decompression, and the host-facing backend.

`TorchBlsBackend` is the counterpart of grandine_tpu/tpu/bls.py
TpuBlsBackend with its verify seams and their edge semantics. Two
families of batches run on the same kernels:

  fast-aggregate (M aggregates, each one message over many signers —
  gossip): g2_decompress_subgroup or g2_subgroup_check (gpu/curve.py),
  aggregate_rlc_scale (this module: apkᵢ = Σ members, rᵢ·apkᵢ, rᵢ·sigᵢ),
  miller_loop_pairs (gpu/pairing.py), rlc_finish (this module: ∏ fᵢ ·
  f(−g1, Σ rᵢ·sigᵢ), final exponentiation, verdict) — replacing the JAX
  programs aggregate_fast_verify_msm{,_idx}{,_comp};

  flat (N signature sets, one signer key each — a block's sets, a replay
  window): the same signature plane, multi_rlc_scale (this module: rᵢ·pkᵢ
  and rᵢ·sigᵢ), miller_loop_pairs, rlc_finish — replacing
  multi_verify_msm{,_idx,_comp}.

Keyed seams upload their keys' affine coordinates as the gather source
and pass an index plane over them, so the registry-indexed and keyed
seams of each family share one kernel. The uncompressed seams run
`g2_subgroup_check` on the same stream and fold its mask into the
verdict, as the JAX package fuses the ψ ladder into its verify programs
by default; the compressed seams get it from the decompression kernel.

Host prep per batch: the row pack of the wire bytes or the affine
conversion of the signature points, hash-to-G2 of each distinct message
(LRU-cached), the RLC pairs and the index plane — no field arithmetic on
the card's behalf.
"""

from __future__ import annotations

import ctypes
import secrets
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto import constants
from grandine_tpu_torch.crypto.curves import G1
from grandine_tpu_torch.crypto.fields import batch_inverse
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm
from grandine_tpu_torch.gpu import pairing as TP

#: largest batch one verification covers; bigger batches are split into
#: chunks of this size, each one RLC check (all must pass)
MAX_BUCKET = 1 << 14

#: entries of the hash-to-G2 point cache (one per distinct signing root;
#: a slot at mainnet width has at most 64 committees)
H2C_CACHE_CAP = 4096


def resolve_device(device) -> torch.device:
    """`device` or CUDA; raises when CUDA is asked for and absent (the
    port never moves to the CPU unless the caller says so)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    return dev


# --- aggregate_rlc_scale ------------------------------------------------------


def aggregate_rlc_scale_plain(src_x, src_y, idx, cnt, sig_x, sig_y,
                              sig_mask, r01):
    """Plain version of `aggregate_rlc_scale`: gather members
    src[idx[m, :cnt[m]]], sum them, rᵢ·apkᵢ (complete-add GLV ladder) and
    rᵢ·sigᵢ (mixed-add GLV ladder) with rᵢ = r01[m, 0] + r01[m, 1]·λ."""
    m, k = idx.shape
    dev = idx.device
    rows = idx.long()
    mx = L.from_words(src_x[rows])
    my = L.from_words(src_y[rows])
    live = torch.arange(k, device=dev).unsqueeze(0) < cnt.long().unsqueeze(1)
    apk = msm.strided_tree_sum((mx, my, L.one_fp((m, k), dev)), live,
                               C.FP_OPS)
    agg_inf = L.is_zero(apk[2])
    r = r01.to(torch.int64) & 0xFFFFFFFF
    rpk = C.scalar_mul_jac_glv(apk, agg_inf, r[:, 0], r[:, 1],
                               C.g1_endo(dev), C.FP_OPS)
    rsig = C.scalar_mul_glv(L.from_words(sig_x), L.from_words(sig_y),
                            sig_mask, r[:, 0], r[:, 1], C.g2_endo(dev),
                            C.FP2_OPS)
    return C.jac_to_words(rpk, 1), agg_inf, C.jac_to_words(rsig, 2)


def aggregate_rlc_scale(src_x, src_y, idx, cnt, sig_x, sig_y, sig_mask, r01):
    """Per aggregate: gather its members' G1 keys by index, sum them,
    then rᵢ·apkᵢ and rᵢ·sigᵢ. src_x/src_y (rows, 12) affine canonical
    words (the registry, or a keyed batch's uploaded members); idx (M, K)
    int32 with cnt (M,) members each; sig_x/sig_y (M, 2, 12) affine with
    sig_mask (M,) (∞ or rejected rows); r01 (M, 2) the 32-bit RLC halves.
    Returns rpk (M, 3, 12) Jacobian, agg_inf (M,), rsig (M, 3, 2, 12).
    CUDA kernel `aggregate_rlc_scale` (csrc/aggregate.cu) on CUDA tensors, the plain version
    on CPU tensors.

    Replaces, in the JAX programs aggregate_fast_verify_msm_idx_comp /
    _comp (grandine_tpu/tpu/bls.py:839, :815), the registry gather
    (bls.py:851-854), grandine_tpu/tpu/curve.py sum_points_grouped and
    scalar_mul_jac_glv (G1), and the per-row rᵢ·sigᵢ of the signature MSM.
    One block of 128 threads per aggregate: the threads sum the members
    in a strided loop and a shared-memory tree, then warp 0 runs the G1
    ladder and warp 1 the G2 ladder at once. Bound: operations — one
    complete G1 addition a member (16 Fp products), the tree, and two
    32-step ladders (~4,800 Fp products an aggregate of 130) against 100
    bytes a member (index and gathered row); the two
    ladders run on one thread each, so the kernel is latency-bound on the
    ladders, which later work splits across a warp."""
    if idx.device.type == "cpu":
        return aggregate_rlc_scale_plain(src_x, src_y, idx, cnt, sig_x,
                                         sig_y, sig_mask, r01)
    from grandine_tpu_torch.gpu import _build

    m, k = idx.shape
    dev = idx.device
    rpk = torch.empty((m, 3, 12), dtype=torch.int32, device=dev)
    agg_inf = torch.empty((m,), dtype=torch.bool, device=dev)
    rsig = torch.empty((m, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.launch("aggregate_rlc_scale", src_x, src_y, idx, cnt,
                  ctypes.c_int(m), ctypes.c_int(k), sig_x, sig_y, sig_mask,
                  r01, rpk, agg_inf, rsig)
    aggregate_rlc_scale.launches += 1
    return rpk, agg_inf, rsig


aggregate_rlc_scale.launches = 0


# --- multi_rlc_scale --------------------------------------------------------


def multi_rlc_scale_plain(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """Plain version of `multi_rlc_scale`: rᵢ·pkᵢ with pkᵢ = src[idx[i]]
    and rᵢ·sigᵢ, both by the mixed-add GLV ladder."""
    n = idx.shape[0]
    dev = idx.device
    rows = idx.long()
    r = r01.to(torch.int64) & 0xFFFFFFFF
    rpk = C.scalar_mul_glv(L.from_words(src_x[rows]), L.from_words(src_y[rows]),
                           torch.zeros((n,), dtype=torch.bool, device=dev),
                           r[:, 0], r[:, 1], C.g1_endo(dev), C.FP_OPS)
    rsig = C.scalar_mul_glv(L.from_words(sig_x), L.from_words(sig_y),
                            sig_mask, r[:, 0], r[:, 1], C.g2_endo(dev),
                            C.FP2_OPS)
    return C.jac_to_words(rpk, 1), C.jac_to_words(rsig, 2)


def multi_rlc_scale(src_x, src_y, idx, sig_x, sig_y, sig_mask, r01):
    """Per signature set: rᵢ·pkᵢ (G1 GLV ladder from the affine key
    src[idx[i]]) and rᵢ·sigᵢ (G2 GLV ladder), rᵢ = r01[i, 0] + r01[i, 1]·λ.
    src_x/src_y (rows, 12) affine canonical words (the registry, or a
    keyed batch's uploaded keys, none ∞); idx (N,) int32; sig_x/sig_y
    (N, 2, 12) affine with sig_mask (N,) (∞ or rejected rows); r01 (N, 2)
    the 32-bit RLC halves. Returns rpk (N, 3, 12) and rsig (N, 3, 2, 12)
    Jacobian, the layouts `miller_loop_pairs` and `rlc_finish` take. CUDA
    kernel `multi_rlc_scale` (csrc/multi.cu) on CUDA tensors, the plain
    version on CPU tensors.

    Replaces, in the JAX programs multi_verify_msm{,_idx,_comp}
    (grandine_tpu/tpu/bls.py:592, :610, :790), the registry gather
    (:629-632), the per-signature G1 scalar_mul_glv and the G2 scalar
    plane of `_flat_msm_verify_tail` (:556-589). One thread per ladder:
    the first ⌈N/32⌉ warps run the G1 ladders and the warps after them
    the G2 ladders, one warp a block, so no warp holds both branches and
    the G1 and G2 warps land on separate SMs (N = 1,048 is 66 warps on
    132 SMs, one wave). Bound: operations — 32 doublings and ~32 mixed
    additions on each group (~2,300 Fp products a set) against ~640 bytes
    a set; each ladder is one thread's dependent chain, so the kernel is
    latency-bound on the G2 ladder (3 Fp products to each of G1's)."""
    if idx.device.type == "cpu":
        return multi_rlc_scale_plain(src_x, src_y, idx, sig_x, sig_y,
                                     sig_mask, r01)
    from grandine_tpu_torch.gpu import _build

    n = idx.shape[0]
    if (idx.dtype != torch.int32 or sig_x.shape != (n, 2, 12)
            or sig_y.shape != (n, 2, 12) or sig_mask.shape != (n,)
            or r01.shape != (n, 2)):
        raise ValueError("multi_rlc_scale: idx (N,) int32, sig_x/sig_y "
                         "(N, 2, 12), sig_mask (N,), r01 (N, 2)")
    dev = idx.device
    rpk = torch.empty((n, 3, 12), dtype=torch.int32, device=dev)
    rsig = torch.empty((n, 3, 2, 12), dtype=torch.int32, device=dev)
    _build.launch("multi_rlc_scale", src_x, src_y, idx, ctypes.c_int(n),
                  sig_x, sig_y, sig_mask, r01, rpk, rsig)
    multi_rlc_scale.launches += 1
    return rpk, rsig


multi_rlc_scale.launches = 0


# --- rlc_finish -----------------------------------------------------------------


def rlc_sig_miller_plain(rsig):
    """f(−g1, Σ rᵢ·sigᵢ): the signature terms (M, 3, 2, 12) summed in the
    kernel's order, then the Miller loop against −g1; a (1, …) Fp12."""
    dev = rsig.device
    m = rsig.shape[0]
    sig = msm.strided_tree_sum(
        tuple(c.unsqueeze(0) for c in C.jac_from_words(rsig, 2)),
        torch.ones((1, m), dtype=torch.bool, device=dev), C.FP2_OPS)
    neg = (-G1).to_affine()
    ng = (L.const_fp(neg[0].n, (1,), dev), L.const_fp(neg[1].n, (1,), dev),
          L.one_fp((1,), dev))
    return TP.miller_loop(ng, TP.jacobian_to_homogeneous(sig),
                          F.fp2_is_zero(sig[2]))


def rlc_finish_plain(f, rsig, agg_inf, sig_ok, sig_sub):
    """Plain version of `rlc_finish`: (1,) uint8 verdict; the product in
    the kernel's order (strided loop, then tree)."""
    prod = F.fp12_mul(TP.strided_tree_product(L.from_words(f), msm.TREE),
                      rlc_sig_miller_plain(rsig)[0])
    one = F.fp12_is_one(TP.final_exponentiation(prod))
    ok = one & ~agg_inf.any() & sig_ok.all() & sig_sub.all()
    return ok.reshape(1).to(torch.uint8)


def rlc_finish(f, rsig, agg_inf, sig_ok, sig_sub):
    """The verdict of one RLC batch: Σ rᵢ·sigᵢ, its Miller loop against
    −g1, the product with every fᵢ (M, 2, 3, 2, 12), the final
    exponentiation, and the folds: product is one, no aggregate summed to
    ∞ (agg_inf), every signature row decoded (sig_ok) and in G2
    (sig_sub). Returns a (1,) uint8 tensor. CUDA kernel `rlc_finish`
    (csrc/pairing.cu) on CUDA tensors, the plain version on CPU tensors.

    Replaces grandine_tpu/tpu/bls.py `_rlc_finish` (:162) with
    grandine_tpu/tpu/pairing.py fp12_product_tree (:334) and
    final_exp_is_one (:300), the tree sum of the signature MSM, and the
    verdict folds of bls.py:703-724 and :857-865 (fast-aggregate) and of
    `_flat_msm_verify_tail` (flat sets, agg_inf all False). One block of
    128 threads: a strided loop gives each thread a share of the signature
    terms and of the N Fp12 terms; a shared-memory tree folds the partial
    G2 sums and another the 128 partial Fp12 products (72 KiB, dynamic
    shared memory); then one thread runs the Miller loop of (−g1, Σ),
    the last product and the final exponentiation. Bound: operations —
    ~66 Fp products a term plus ~30,000 for the Miller loop and the final
    exponentiation, which stay sequential on one thread, so the kernel is
    latency-bound on them; the N-term product is ⌈N/128⌉ + 7 sequential
    Fp12 products deep instead of N, and the reduction across blocks that
    the TPU carried in a scan needs this second launch on the card."""
    if f.device.type == "cpu":
        return rlc_finish_plain(f, rsig, agg_inf, sig_ok, sig_sub)
    from grandine_tpu_torch.gpu import _build

    m = f.shape[0]
    verdict = torch.empty((1,), dtype=torch.uint8, device=f.device)
    _build.launch("rlc_finish", f, rsig, agg_inf, sig_ok, sig_sub,
                  ctypes.c_int(m), verdict)
    rlc_finish.launches += 1
    return verdict


rlc_finish.launches = 0


def signature_plane(sig_x, sig_y, sig_inf):
    """Uploaded affine signatures as the verify kernels take them:
    (sig_x, sig_y, mask, decoded, in_subgroup), `g2_subgroup_check`
    running on the same stream (the JAX package's fused ψ ladder)."""
    return (sig_x, sig_y, sig_inf, torch.ones_like(sig_inf),
            C.g2_subgroup_check(sig_x, sig_y, sig_inf))


def signature_plane_compressed(sig_rows, sig_inf):
    """(B, 96) wire rows decompressed on the card, the ψ check fused:
    (sig_x, sig_y, mask, decoded, in_subgroup); `sig_inf` is the host's
    wire infinity-flag mask."""
    sx, sy, dinf, dok, _be, _bc, _bi, sub = C.g2_decompress_subgroup(sig_rows)
    return sx, sy, sig_inf | dinf | ~dok, dok, sub


def verify_aggregates(src_x, src_y, idx, cnt, plane, msg, msg_inf, r01):
    """One fast-aggregate RLC verification on the device of its inputs;
    returns the (1,) uint8 verdict tensor without waiting for it."""
    sx, sy, mask, ok, sub = plane
    rpk, agg_inf, rsig = aggregate_rlc_scale(src_x, src_y, idx, cnt, sx, sy,
                                             mask, r01)
    f = TP.miller_loop_pairs(rpk, msg, agg_inf | msg_inf)
    return rlc_finish(f, rsig, agg_inf, ok, sub)


def verify_sets(src_x, src_y, idx, plane, msg, msg_inf, r01):
    """One flat RLC verification of N (message, signature, key) sets on
    the device of its inputs; returns the (1,) uint8 verdict tensor
    without waiting for it."""
    sx, sy, mask, ok, sub = plane
    rpk, rsig = multi_rlc_scale(src_x, src_y, idx, sx, sy, mask, r01)
    f = TP.miller_loop_pairs(rpk, msg, msg_inf)
    return rlc_finish(f, rsig, torch.zeros_like(msg_inf), ok, sub)


# --- host helpers ------------------------------------------------------------


class _LruCache:
    """Bounded thread-safe LRU (the hash-to-G2 point cache)."""

    def __init__(self, cap: int) -> None:
        self.cap = max(1, int(cap))
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()

    def get(self, key):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
            return hit

    def put(self, key, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)


def g2_affine_words(pt) -> "tuple[np.ndarray, bool]":
    """Host G2 point → ((2, 2, 12) int32 [x, y] canonical words, is_inf)."""
    x, y, inf = g2_affine_words_many([pt])
    return np.stack([x[0], y[0]]), bool(inf[0])


def g1_affine_words(points) -> "tuple[np.ndarray, np.ndarray]":
    """Host G1 points (any Z, none ∞) → (N, 12) x and y canonical words,
    with one batched inversion."""
    p = L.P
    zinv = batch_inverse([pt.z.n for pt in points], p)
    xs, ys = [], []
    for pt, zi in zip(points, zinv):
        zi2 = zi * zi % p
        xs.append(pt.x.n * zi2 % p)
        ys.append(pt.y.n * zi2 % p * zi % p)
    w = L.ints_to_words(xs + ys)
    return w[: len(points)], w[len(points):]


def g2_affine_words_many(points):
    """Host G2 points (any Z) → ((N, 2, 12) x, (N, 2, 12) y canonical
    words, zero on ∞ rows; (N,) ∞ mask), with one batched inversion."""
    p = L.P
    n = len(points)
    inf = np.array([pt.is_infinity() for pt in points], bool).reshape(n)
    live = [pt for pt, i in zip(points, inf) if not i]
    ninv = batch_inverse([(pt.z.c0.n ** 2 + pt.z.c1.n ** 2) % p
                          for pt in live], p)
    vals = []
    for pt, ni in zip(live, ninv):
        z0, z1 = pt.z.c0.n * ni % p, -pt.z.c1.n * ni % p  # 1/Z = conj(Z)/|Z|
        a0, a1 = (z0 * z0 - z1 * z1) % p, 2 * z0 * z1 % p  # 1/Z²
        b0, b1 = (a0 * z0 - a1 * z1) % p, (a0 * z1 + a1 * z0) % p  # 1/Z³
        x0, x1, y0, y1 = pt.x.c0.n, pt.x.c1.n, pt.y.c0.n, pt.y.c1.n
        vals += [(x0 * a0 - x1 * a1) % p, (x0 * a1 + x1 * a0) % p,
                 (y0 * b0 - y1 * b1) % p, (y0 * b1 + y1 * b0) % p]
    xy = np.zeros((n, 2, 2, 12), np.int32)
    xy[~inf] = L.ints_to_words(vals).reshape(-1, 2, 2, 12)
    return xy[:, 0], xy[:, 1], inf


def rlc_pairs_words(pairs) -> np.ndarray:
    """[(r0, r1), …] 32-bit halves → (M, 2) int32 (read as uint32)."""
    return np.array(pairs, dtype=np.uint32).reshape(-1, 2).view(np.int32)


def rlc_bits_host(pairs) -> np.ndarray:
    """[(r0, r1), …] → (M, 64) int32 bits [r0 MSB first | r1 MSB first]:
    the JAX package's RLC bit layout, for comparisons."""
    out = np.zeros((len(pairs), 64), np.int32)
    for i, (r0, r1) in enumerate(pairs):
        for b in range(32):
            out[i, b] = (r0 >> (31 - b)) & 1
            out[i, 32 + b] = (r1 >> (31 - b)) & 1
    return out


def g1_decompress_rows(rows, device):
    """g1_decompress on (B, 48) uint8 numpy rows placed on
    `device`; the registry's ingest seam."""
    t = torch.as_tensor(np.ascontiguousarray(rows), dtype=torch.uint8)
    return C.g1_decompress(t.to(device))


# --- backend ------------------------------------------------------------------


class TorchBlsBackend:
    """Host façade over the verify kernels, with the edge semantics of
    grandine_tpu/tpu/bls.py TpuBlsBackend's seams: an empty batch is True;
    a length mismatch, an empty member list, an out-of-range index, an
    identity key or a wrong-length signature is False; batches over
    MAX_BUCKET run in chunks; an indexed batch past MAX_BUCKET (a wider
    committee, or more flat sets) goes to the keyed seam through the
    registry's host mirror. The RLC pairs are drawn from `rng` in the JAX
    package's order, one per set after the batch's messages are hashed.
    Flat batches always take the flat kernels (the JAX package's grouped
    route for batches with repeated messages gives the same verdict and is
    not ported)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._h2c_cache = _LruCache(H2C_CACHE_CAP)

    # -- host prep ---------------------------------------------------------

    def _up(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, order="C")).to(self.device)

    def _hash_to_g2_words(self, message: bytes, dst: bytes):
        key = (bytes(message), dst)
        hit = self._h2c_cache.get(key)
        if hit is None:
            hit = g2_affine_words(hash_to_g2(message, dst))
            self._h2c_cache.put(key, hit)
        return hit

    @staticmethod
    def _rlc_pair(rng) -> "tuple[int, int]":
        """A nonzero (r0, r1) pair of 32-bit halves: the RLC scalar is
        r0 + r1·λ (λ = x² mod r), drawn in the JAX package's order."""
        a, b = 0, 0
        while a == 0 and b == 0:
            a, b = rng.randbits(32), rng.randbits(32)
        return a, b

    @staticmethod
    def _pack_sig_rows(signatures, b: int):
        """(b, 96) uint8 signature rows + the wire infinity-flag mask;
        padding rows carry the canonical infinity encoding. Raises
        ValueError on a wrong-length blob."""
        rows = C.compressed_rows(signatures, 96)
        n = rows.shape[0]
        sig_rows = np.zeros((b, 96), np.uint8)
        sig_rows[:, 0] = C.COMPRESSED_FLAG | C.INFINITY_FLAG
        sig_rows[:n] = rows
        sig_inf = np.ones((b,), bool)
        sig_inf[:n] = C.compressed_infinity_flags(rows)
        return sig_rows, sig_inf

    def _sig_plane(self, signatures, compressed: bool):
        """The signature operands on the card (`signature_plane*`): wire
        bytes, or `Signature`s converted to affine words on the host.
        None for a wrong-length blob."""
        if compressed:
            try:
                rows, inf = self._pack_sig_rows(signatures, len(signatures))
            except ValueError:
                return None
            return signature_plane_compressed(self._up(rows), self._up(inf))
        sx, sy, inf = g2_affine_words_many([s.point for s in signatures])
        return signature_plane(self._up(sx), self._up(sy), self._up(inf))

    def _messages(self, messages, dst):
        m = len(messages)
        msg = np.zeros((m, 2, 2, 12), np.int32)
        msg_inf = np.zeros((m,), bool)
        for i, message in enumerate(messages):
            msg[i], msg_inf[i] = self._hash_to_g2_words(message, dst)
        return self._up(msg), self._up(msg_inf)

    def _keys_src(self, points):
        """Affine words of host G1 keys (none ∞) uploaded as a gather
        source."""
        fx, fy = g1_affine_words(points)
        return self._up(fx), self._up(fy)

    @staticmethod
    def _chunked(fn, m, *seqs):
        first = fn(*(s[0:MAX_BUCKET] for s in seqs))

        def settle_chunks() -> bool:
            pending = first
            for i in range(MAX_BUCKET, m, MAX_BUCKET):
                nxt = fn(*(s[i : i + MAX_BUCKET] for s in seqs))
                if not pending():
                    return False
                pending = nxt
            return pending()

        return settle_chunks

    @staticmethod
    def _settle(verdict):
        return lambda: bool(verdict.item())

    # -- the two families ----------------------------------------------------

    def _aggregate_async(self, messages, signatures, members, registry, dst,
                         rng, compressed: bool):
        """Fast-aggregate seams: `members` are PublicKey lists (registry
        None) or index lists into `registry`."""
        m = len(messages)
        if not (m == len(signatures) == len(members)):
            return lambda: False
        if m == 0:
            return lambda: True
        if any(len(ks) == 0 for ks in members):
            return lambda: False
        if m > MAX_BUCKET:
            return self._chunked(
                lambda a, b, c: self._aggregate_async(
                    a, b, c, registry, dst, rng, compressed),
                m, messages, signatures, members)
        widest = max(len(ks) for ks in members)
        if registry is not None:
            reg_x, reg_y, reg_n = registry.arrays()
            if reg_x is None or any(
                not 0 <= int(i) < reg_n for ix in members for i in ix
            ):
                return lambda: False
            if widest > MAX_BUCKET:
                return self._aggregate_async(
                    messages, signatures,
                    [registry.public_keys(ix) for ix in members], None, dst,
                    rng, compressed)
            src_x, src_y = reg_x, reg_y
            idx = np.zeros((m, widest), np.int32)
            for i, ix in enumerate(members):
                idx[i, : len(ix)] = np.fromiter((int(v) for v in ix),
                                                np.int32, count=len(ix))
        else:
            if any(pk.point.is_infinity() for ks in members for pk in ks):
                return lambda: False
            if widest > MAX_BUCKET:
                members = [
                    ks if len(ks) <= MAX_BUCKET else [A.PublicKey.aggregate(ks)]
                    for ks in members
                ]
                widest = max(len(ks) for ks in members)
            src_x, src_y = self._keys_src(
                [pk.point for ks in members for pk in ks])
            idx = np.zeros((m, widest), np.int32)
            pos = 0
            for i, ks in enumerate(members):
                idx[i, : len(ks)] = np.arange(pos, pos + len(ks),
                                              dtype=np.int32)
                pos += len(ks)
        cnt = np.array([len(ks) for ks in members], np.int32)
        plane = self._sig_plane(signatures, compressed)
        if plane is None:
            return lambda: False
        msg, msg_inf = self._messages(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(m)]
        return self._settle(verify_aggregates(
            src_x, src_y, self._up(idx), self._up(cnt), plane, msg, msg_inf,
            self._up(rlc_pairs_words(pairs))))

    def _flat_async(self, messages, signatures, keys, registry, dst, rng,
                    compressed: bool):
        """Flat seams: `keys` are PublicKeys (registry None) or registry
        indices, one signer per set."""
        n = len(messages)
        if not (n == len(signatures) == len(keys)):
            return lambda: False
        if n == 0:
            return lambda: True
        if registry is not None:
            reg_x, reg_y, reg_n = registry.arrays()
            if reg_x is None or any(not 0 <= int(i) < reg_n for i in keys):
                return lambda: False
            if n > MAX_BUCKET:
                return self._flat_async(messages, signatures,
                                        registry.public_keys(keys), None,
                                        dst, rng, compressed)
            src_x, src_y = reg_x, reg_y
            idx = np.fromiter((int(v) for v in keys), np.int32, count=n)
        else:
            if n > MAX_BUCKET:
                return self._chunked(
                    lambda a, b, c: self._flat_async(
                        a, b, c, None, dst, rng, compressed),
                    n, messages, signatures, keys)
            if any(pk.point.is_infinity() for pk in keys):
                return lambda: False
            src_x, src_y = self._keys_src([pk.point for pk in keys])
            idx = np.arange(n, dtype=np.int32)
        plane = self._sig_plane(signatures, compressed)
        if plane is None:
            return lambda: False
        msg, msg_inf = self._messages(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(n)]
        return self._settle(verify_sets(
            src_x, src_y, self._up(idx), plane, msg, msg_inf,
            self._up(rlc_pairs_words(pairs))))

    # -- flat seams ------------------------------------------------------------

    def multi_verify(self, messages, signatures, public_keys,
                     dst: bytes = constants.DST_SIGNATURE,
                     rng=secrets) -> bool:
        return self.multi_verify_async(messages, signatures, public_keys,
                                       dst, rng)()

    def multi_verify_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        public_keys: Sequence["A.PublicKey"],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """Flat RLC verify of N (message, signature, key) sets: launches
        now and returns a zero-arg callable giving the verdict, so the
        caller's host work overlaps the device run."""
        return self._flat_async(messages, signatures, public_keys, None, dst,
                                rng, compressed=False)

    def multi_verify_compressed(self, messages, signatures, public_keys,
                                dst: bytes = constants.DST_SIGNATURE,
                                rng=secrets) -> bool:
        return self.multi_verify_compressed_async(
            messages, signatures, public_keys, dst, rng)()

    def multi_verify_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        public_keys: Sequence["A.PublicKey"],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """multi_verify_async with signatures as 96-byte wire rows,
        decompressed and ψ-checked on the card."""
        return self._flat_async(messages, signatures, public_keys, None, dst,
                                rng, compressed=True)

    def multi_verify_indexed(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        indices: Sequence[int],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ) -> bool:
        """Flat RLC verify with each set's signer key gathered on the card
        from the registry by validator index; an index the registry does
        not cover fails."""
        return self._flat_async(messages, signatures, indices, registry, dst,
                                rng, compressed=False)()

    def g2_subgroup_check_batch(self, points) -> np.ndarray:
        return self.g2_subgroup_check_batch_async(points)()

    def g2_subgroup_check_batch_async(self, points):
        """ψ-criterion membership of host G2 points (on the curve) in one
        launch; the callable gives an (N,) bool array, ∞ rows True."""
        if not points:
            return lambda: np.zeros((0,), bool)
        sx, sy, inf = g2_affine_words_many(points)
        out = C.g2_subgroup_check(self._up(sx), self._up(sy), self._up(inf))
        return lambda: out.cpu().numpy()

    # -- fast-aggregate seams --------------------------------------------------

    def fast_aggregate_verify_batch(self, messages, signatures, member_keys,
                                    dst: bytes = constants.DST_SIGNATURE,
                                    rng=secrets) -> bool:
        return self.fast_aggregate_verify_batch_async(
            messages, signatures, member_keys, dst, rng)()

    def fast_aggregate_verify_batch_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        member_keys: Sequence[Sequence["A.PublicKey"]],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as `Signature`s, their member keys as PublicKeys
        (uploaded as the gather source)."""
        return self._aggregate_async(messages, signatures, member_keys, None,
                                     dst, rng, compressed=False)

    def fast_aggregate_verify_batch_indexed(
        self, messages, signatures, member_indices, registry,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_indexed_async(
            messages, signatures, member_indices, registry, dst, rng)()

    def fast_aggregate_verify_batch_indexed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence["A.Signature"],
        member_indices: Sequence[Sequence[int]],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as `Signature`s whose member keys are rows of the
        device-resident registry (gpu/registry.py), gathered on the card."""
        return self._aggregate_async(messages, signatures, member_indices,
                                     registry, dst, rng, compressed=False)

    def fast_aggregate_verify_batch_compressed(
        self, messages, signatures, member_keys,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_compressed_async(
            messages, signatures, member_keys, dst, rng)()

    def fast_aggregate_verify_batch_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        member_keys: Sequence[Sequence["A.PublicKey"]],
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as wire bytes with their member keys given as
        PublicKeys."""
        return self._aggregate_async(messages, signatures, member_keys, None,
                                     dst, rng, compressed=True)

    def fast_aggregate_verify_batch_indexed_compressed(
        self, messages, signatures, member_indices, registry,
        dst: bytes = constants.DST_SIGNATURE, rng=secrets,
    ) -> bool:
        return self.fast_aggregate_verify_batch_indexed_compressed_async(
            messages, signatures, member_indices, registry, dst, rng)()

    def fast_aggregate_verify_batch_indexed_compressed_async(
        self,
        messages: Sequence[bytes],
        signatures: Sequence[bytes],
        member_indices: Sequence[Sequence[int]],
        registry,
        dst: bytes = constants.DST_SIGNATURE,
        rng=secrets,
    ):
        """M aggregates as wire bytes whose member keys are registry rows
        gathered on the card by index."""
        return self._aggregate_async(messages, signatures, member_indices,
                                     registry, dst, rng, compressed=True)


__all__ = [
    "TorchBlsBackend", "MAX_BUCKET", "resolve_device", "aggregate_rlc_scale",
    "aggregate_rlc_scale_plain", "multi_rlc_scale", "multi_rlc_scale_plain",
    "rlc_finish", "rlc_finish_plain", "rlc_sig_miller_plain",
    "signature_plane",
    "signature_plane_compressed", "verify_aggregates", "verify_sets",
    "g1_decompress_rows", "rlc_pairs_words", "rlc_bits_host",
    "g2_affine_words", "g2_affine_words_many", "g1_affine_words",
]
