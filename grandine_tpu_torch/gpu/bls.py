"""BLS aggregate verification on the card: the two verify kernels that
follow decompression, and the host-facing backend.

`TorchBlsBackend` is the counterpart of grandine_tpu/tpu/bls.py
TpuBlsBackend with the two seams the compressed dispatch needs
(`fast_aggregate_verify_batch_indexed_compressed_async` and
`fast_aggregate_verify_batch_compressed_async`, each with its sync twin)
and their edge semantics. One batch of M aggregates runs four kernels:

  g2_decompress_subgroup   (gpu/curve.py)   wire bytes → sigᵢ, masks, ψ check
  aggregate_rlc_scale      (this module)    apkᵢ = Σ members, rᵢ·apkᵢ, rᵢ·sigᵢ
  miller_loop_pairs        (gpu/pairing.py) fᵢ = f(rᵢ·apkᵢ, H(mᵢ))
  rlc_finish               (this module)    ∏ fᵢ · f(−g1, Σ rᵢ·sigᵢ), final
                                            exponentiation, verdict

which together replace the JAX programs aggregate_fast_verify_msm_idx_comp
(member keys gathered from the registry by index) and
aggregate_fast_verify_msm_comp (member keys uploaded): on the card the
keyed seam uploads its members' affine coordinates as the gather source
and passes an index plane over them, so both seams share one kernel.

Host prep per batch: the row pack of the wire bytes, hash-to-G2 of each
distinct message (LRU-cached), the RLC pairs and the index plane — no
field arithmetic.
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


# --- rlc_finish -----------------------------------------------------------------


def rlc_finish_plain(f, rsig, agg_inf, sig_ok, sig_sub):
    """Plain version of `rlc_finish`: (1,) uint8 verdict."""
    dev = f.device
    m = f.shape[0]
    sig = msm.strided_tree_sum(
        tuple(c.unsqueeze(0) for c in C.jac_from_words(rsig, 2)),
        torch.ones((1, m), dtype=torch.bool, device=dev), C.FP2_OPS)
    sig_inf = F.fp2_is_zero(sig[2])
    neg = (-G1).to_affine()
    ng = (L.const_fp(neg[0].n, (1,), dev), L.const_fp(neg[1].n, (1,), dev),
          L.one_fp((1,), dev))
    f_sig = TP.miller_loop(ng, TP.jacobian_to_homogeneous(sig), sig_inf)
    prod = TP.fp12_product(torch.cat([f_sig, L.from_words(f)], 0))
    one = F.fp12_is_one(TP.final_exponentiation(prod))
    ok = one & ~agg_inf.any() & sig_ok.all() & sig_sub.all()
    return ok.reshape(1).to(torch.uint8)


def rlc_finish(f, rsig, agg_inf, sig_ok, sig_sub):
    """The verdict of one RLC batch: Σ rᵢ·sigᵢ, its Miller loop against
    −g1, the product with every fᵢ (M, 2, 3, 2, 12), the final
    exponentiation, and the folds: product is one, no aggregate summed to
    ∞ (agg_inf), every signature row decoded (sig_ok) and in G2
    (sig_sub). Returns a (1,) uint8 tensor. CUDA kernel `rlc_finish` (csrc/pairing.cu) on
    CUDA tensors, the plain version on CPU tensors.

    Replaces grandine_tpu/tpu/bls.py `_rlc_finish` (:162) with
    grandine_tpu/tpu/pairing.py fp12_product_tree (:334) and
    final_exp_is_one (:300), the tree sum of the signature MSM, and the
    verdict folds of bls.py:703-724 and :857-865. One block: 128 threads
    sum the signature terms (strided loop, shared-memory tree), then one
    thread runs the Miller loop, the M-term product and the final
    exponentiation. Bound: operations — ~50,000 Fp products at M = 192,
    almost all sequential, so the kernel is latency-bound on one
    thread; the reduction across blocks that the TPU carried in a scan
    needs this second launch on the card."""
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


def verify_batch(src_x, src_y, idx, cnt, sig_rows, sig_inf, msg, msg_inf,
                 r01):
    """One RLC verification on the device of its inputs; returns the (1,)
    uint8 verdict tensor without waiting for it."""
    sx, sy, dinf, dok, _be, _bc, _bi, sub = C.g2_decompress_subgroup(sig_rows)
    sig_mask = sig_inf | dinf | ~dok
    rpk, agg_inf, rsig = aggregate_rlc_scale(src_x, src_y, idx, cnt, sx, sy,
                                             sig_mask, r01)
    f = TP.miller_loop_pairs(rpk, msg, agg_inf | msg_inf)
    return rlc_finish(f, rsig, agg_inf, dok, sub)


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
    aff = pt.to_affine()
    if aff is None:
        return np.zeros((2, 2, 12), np.int32), True
    x, y = aff
    w = L.ints_to_words([x.c0.n, x.c1.n, y.c0.n, y.c1.n])
    return w.reshape(2, 2, 12), False


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
    grandine_tpu/tpu/bls.py TpuBlsBackend's compressed seams: an empty
    batch is True; a length mismatch, an empty member list, an
    out-of-range index, an identity member key or a wrong-length signature
    is False; batches over MAX_BUCKET run in chunks; an indexed batch with
    a committee wider than MAX_BUCKET goes to the keyed seam."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._h2c_cache = _LruCache(H2C_CACHE_CAP)

    # -- host prep ---------------------------------------------------------

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

    def _messages(self, messages, dst):
        m = len(messages)
        msg = np.zeros((m, 2, 2, 12), np.int32)
        msg_inf = np.zeros((m,), bool)
        for i, message in enumerate(messages):
            msg[i], msg_inf[i] = self._hash_to_g2_words(message, dst)
        return msg, msg_inf

    def _dispatch(self, src_x, src_y, idx, cnt, sig_rows, sig_inf, msg,
                  msg_inf, pairs):
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        verdict = verify_batch(
            src_x, src_y, up(idx), up(cnt), up(sig_rows), up(sig_inf),
            up(msg), up(msg_inf), up(rlc_pairs_words(pairs)))
        return lambda: bool(verdict.item())

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

    # -- seams ---------------------------------------------------------------

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
        """M aggregates with their member keys given as PublicKeys: the
        members' affine coordinates are uploaded as the gather source."""
        m = len(messages)
        if not (m == len(signatures) == len(member_keys)):
            return lambda: False
        if m == 0:
            return lambda: True
        if any(not ks for ks in member_keys):
            return lambda: False
        if m > MAX_BUCKET:
            return self._chunked(
                lambda a, b, c: self.fast_aggregate_verify_batch_compressed_async(
                    a, b, c, dst, rng),
                m, messages, signatures, member_keys)
        if any(pk.point.is_infinity() for ks in member_keys for pk in ks):
            return lambda: False
        if max(len(ks) for ks in member_keys) > MAX_BUCKET:
            member_keys = [
                ks if len(ks) <= MAX_BUCKET else [A.PublicKey.aggregate(ks)]
                for ks in member_keys
            ]
        try:
            sig_rows, sig_inf = self._pack_sig_rows(signatures, m)
        except ValueError:
            return lambda: False
        k = max(len(ks) for ks in member_keys)
        flat = [pk.point for ks in member_keys for pk in ks]
        fx, fy = g1_affine_words(flat)
        idx = np.zeros((m, k), np.int32)
        cnt = np.zeros((m,), np.int32)
        pos = 0
        for i, ks in enumerate(member_keys):
            idx[i, : len(ks)] = np.arange(pos, pos + len(ks), dtype=np.int32)
            cnt[i] = len(ks)
            pos += len(ks)
        msg, msg_inf = self._messages(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(m)]
        dev = self.device
        return self._dispatch(torch.from_numpy(fx.copy()).to(dev),
                              torch.from_numpy(fy.copy()).to(dev), idx, cnt,
                              sig_rows, sig_inf, msg, msg_inf, pairs)

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
        """M aggregates whose member keys are rows of the device-resident
        registry (gpu/registry.py), gathered on the card by index."""
        m = len(messages)
        if not (m == len(signatures) == len(member_indices)):
            return lambda: False
        if m == 0:
            return lambda: True
        if any(len(ix) == 0 for ix in member_indices):
            return lambda: False
        if m > MAX_BUCKET:
            return self._chunked(
                lambda a, b, c: self.fast_aggregate_verify_batch_indexed_compressed_async(
                    a, b, c, registry, dst, rng),
                m, messages, signatures, member_indices)
        reg_x, reg_y, reg_n = registry.arrays()
        widest = max(len(ix) for ix in member_indices)
        if reg_x is None or any(
            not 0 <= int(i) < reg_n for ix in member_indices for i in ix
        ):
            return lambda: False
        if widest > MAX_BUCKET:
            return self.fast_aggregate_verify_batch_compressed_async(
                messages, signatures,
                [registry.public_keys(ix) for ix in member_indices], dst, rng)
        try:
            sig_rows, sig_inf = self._pack_sig_rows(signatures, m)
        except ValueError:
            return lambda: False
        idx = np.zeros((m, widest), np.int32)
        cnt = np.zeros((m,), np.int32)
        for i, ix in enumerate(member_indices):
            idx[i, : len(ix)] = np.fromiter((int(v) for v in ix), np.int32,
                                            count=len(ix))
            cnt[i] = len(ix)
        msg, msg_inf = self._messages(messages, dst)
        pairs = [self._rlc_pair(rng) for _ in range(m)]
        return self._dispatch(reg_x, reg_y, idx, cnt, sig_rows, sig_inf, msg,
                              msg_inf, pairs)


__all__ = [
    "TorchBlsBackend", "MAX_BUCKET", "resolve_device", "aggregate_rlc_scale",
    "aggregate_rlc_scale_plain", "rlc_finish", "rlc_finish_plain",
    "verify_batch", "g1_decompress_rows", "rlc_pairs_words", "rlc_bits_host",
    "g2_affine_words", "g1_affine_words",
]
