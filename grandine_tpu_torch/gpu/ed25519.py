"""Batched Ed25519 verification on the card: the curve25519 entry of the
scheme table (gpu/schemes.py `get("ed25519")`), the port of
grandine_tpu/tpu/ed25519.py.

Rest format: an element of 2²⁵⁵ − 19 is a CANONICAL value in [0, p)
stored as a ``(…, 8)`` ``torch.int32`` tensor of little-endian 32-bit
words (each read as uint32) — gpu/limbs.py's rule for Fp at the smaller
width. Affine-extended rows are x, y, t = xy; points are extended
projective (X, Y, Z, T) on an axis ahead of the words. No Montgomery form:
the kernel and the plain versions both return fully reduced values after
every operation, so they agree word for word at every stage, and their
(X, Y, Z, T) are the same field elements as the JAX program's after
`from_mont` (same formula, same order, exact arithmetic mod p).

Working format of the plain versions: ``(…, 16)`` ``int64`` 16-bit limbs,
with gpu/limbs.py's convolution and carry passes. A product folds its high
half by 38 (2²⁵⁶ ≡ 38), then the bits from 2²⁵⁵ up by 19, then subtracts p
once if needed.

Verification is the cofactored RFC 8032 batch equation under a random
linear combination. `Ed25519Backend.prepare` draws 128-bit zᵢ, folds the
Sᵢ into one base-point scalar c_B = Σ zᵢSᵢ mod L and negates Rᵢ and Aᵢ, so
the card evaluates ONE multi-scalar multiplication

    T = [c_B]B + Σ [zᵢ](−Rᵢ) + Σ [zᵢkᵢ mod L](−Aᵢ)

as a 253-step MSB-first ladder per row, a sum tree (stride n/2 first, the
result in row 0), three unified doublings ([8]T) and the identity test
X ≡ 0 ∧ Y ≡ Z: `ed25519_verify`, one launch (csrc/ed25519.cu). Reducing
zᵢkᵢ mod L is sound only because the ×8 follows the sum; the host twin
(crypto/ed25519.py) is cofactored for the same reason.
"""

from __future__ import annotations

import ctypes
import secrets

import numpy as np
import torch

from grandine_tpu_torch.crypto import ed25519 as HE
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu.limbs import _carry, _conv
from grandine_tpu_torch.tracing import NULL_TRACER

P = HE.P
NWORDS = 8
LIMB_BITS = 16
NLIMBS = 16
MASK = (1 << LIMB_BITS) - 1
#: ladder bit width: every RLC scalar is below 2²⁵³ (c_B and zᵢkᵢ are
#: reduced mod L < 2²⁵³; the zᵢ are 128-bit)
NBITS = 253
#: the ladder buckets (rows = 2n + 1 padded up): fewer shapes than powers
#: of two, at the cost of ≤ 4× padding rows
BUCKETS = (8, 32, 128)
#: 2d, the unified addition's constant
K2D = 2 * HE.D % P

_CONST: dict = {}


def _const(value: int, device) -> torch.Tensor:
    key = (value, str(device))
    t = _CONST.get(key)
    if t is None:
        t = torch.tensor([(value >> (LIMB_BITS * i)) & MASK
                          for i in range(NLIMBS)], dtype=torch.int64,
                         device=device)
        _CONST[key] = t
    return t


# --- host conversions --------------------------------------------------------


def ints_to_words(values) -> np.ndarray:
    """[v, …] ints in [0, 2²⁵⁶) → (n, 8) int32 little-endian words."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, "<u4").reshape(-1, NWORDS).view(np.int32).copy()


def words_to_ints(words) -> "list[int]":
    """(…, 8) words (tensor or array) → flat list of ints, row-major."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    raw = np.ascontiguousarray(np.asarray(words, np.int32)).view(
        "<u4").tobytes()
    return [int.from_bytes(raw[32 * i: 32 * (i + 1)], "little")
            for i in range(len(raw) // 32)]


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(…, 8) int32 words → (…, 16) int64 16-bit limbs (same value)."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & MASK, u >> LIMB_BITS], -1).reshape(
        *w.shape[:-1], NLIMBS)


def limbs_to_words(a: torch.Tensor) -> torch.Tensor:
    """(…, 16) normalized limbs → (…, 8) int32 words."""
    pairs = a.reshape(*a.shape[:-1], NWORDS, 2)
    u = pairs[..., 0] | (pairs[..., 1] << LIMB_BITS)
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


# --- the field 2²⁵⁵ − 19 (canonical limbs in, canonical limbs out) -----------


def _pick(cands: torch.Tensor, passes: int) -> torch.Tensor:
    """Normalize the two candidates of (…, 2, 16) in one carry call; keep
    the second when it carries out of 2²⁵⁶."""
    y, top = _carry(cands, passes)
    return torch.where((top[..., 1] > 0).unsqueeze(-1), y[..., 1, :],
                       y[..., 0, :])


def fe_add(a, b):
    """a + b mod p: s < 2p, and s + (2²⁵⁶ − p) carries out iff s ≥ p."""
    s = a + b
    return _pick(torch.stack(torch.broadcast_tensors(
        s, s + _const((1 << 256) - P, s.device)), -2), 2)


def fe_sub(a, b):
    """a − b mod p: d = a + ¬b + 1 = a − b + 2²⁵⁶ carries out iff a ≥ b;
    otherwise d + p − 2²⁵⁶ = a − b + p."""
    d = a + (MASK - b) + _const(1, a.device)
    return _pick(torch.stack([d + _const(P, d.device), d], -2), 2)


def fe_mul(a, b):
    """a·b mod p: column sums below 2³⁶, the high half folded by 38, one
    carry, the bits from 2²⁵⁵ up (the carry out included) folded by 19,
    then at most one subtraction of p, riding in the last carry."""
    t = _conv(a, b, 2 * NLIMBS - 1)  # (…, 31)
    lo = t[..., :NLIMBS] + 38 * torch.nn.functional.pad(t[..., NLIMBS:],
                                                        (0, 1))
    x, top = _carry(lo, 3)  # x < 2^256, top < 2^27
    h = (x[..., -1] >> (LIMB_BITS - 1)) + 2 * top
    x = torch.cat([x[..., :1] + 19 * h.unsqueeze(-1), x[..., 1:-1],
                   x[..., -1:] & (MASK >> 1)], -1)  # < 2^255 + 2^32 < 2p
    return _pick(torch.stack([x, x + _const((1 << 256) - P, x.device)], -2),
                 3)


# --- the Edwards curve (a = −1), points (…, 4, 16) as (X, Y, Z, T) -----------


def ed_add(p, q):
    """Unified add-2008-hwcd-3 (a = −1), complete on correctly extended
    points, also the doubling: grandine_tpu/tpu/ed25519.py `ed_add`, its 9
    products (a, b, t₁·2d, ·t₂, z₁z₂, then e·f, g·h, f·g, e·h) in three
    stacked product calls."""
    x1, y1, z1, t1 = p.unbind(-2)
    x2, y2, z2, t2 = q.unbind(-2)
    ys = torch.stack(torch.broadcast_tensors(y1, y2), -2)
    xs = torch.stack(torch.broadcast_tensors(x1, x2), -2)
    dm, sm = fe_sub(ys, xs), fe_add(ys, xs)
    left = torch.stack(torch.broadcast_tensors(dm[..., 0, :], sm[..., 0, :],
                                               t1, z1), -2)
    right = torch.stack(torch.broadcast_tensors(
        dm[..., 1, :], sm[..., 1, :], _const(K2D, t1.device), z2), -2)
    a, b, tk, zz = fe_mul(left, right).unbind(-2)
    c = fe_mul(tk, t2)
    d = fe_add(zz, zz)
    e, f = fe_sub(torch.stack([b, d], -2), torch.stack([a, c], -2)).unbind(-2)
    g, h = fe_add(torch.stack([d, b], -2), torch.stack([c, a], -2)).unbind(-2)
    return fe_mul(torch.stack([e, g, f, e], -2), torch.stack([f, h, g, h], -2))


def identity(shape=(), device="cpu") -> torch.Tensor:
    """(0, 1, 1, 0) broadcast to `shape` + (4, 16)."""
    one = _const(1, device)
    pt = torch.stack([torch.zeros_like(one), one, one, torch.zeros_like(one)])
    return pt.expand(*shape, 4, NLIMBS).clone()


def _scalar_bits(k: torch.Tensor) -> torch.Tensor:
    """(…, 8) scalar words → (NBITS, …) bool, MSB first."""
    w = k.to(torch.int64) & 0xFFFFFFFF
    s = torch.arange(NBITS - 1, -1, -1, device=k.device)
    return ((w[..., s >> 5] >> (s & 31)) & 1).movedim(-1, 0).bool()


def ladder_plain(px, py, pt, k) -> torch.Tensor:
    """[kᵢ]Pᵢ as (…, 4, 16) limbs for rows of (…, 8) words: the JAX
    `_ladder` — from the identity, 253 steps MSB first, each a doubling
    and, on a set bit, an addition of (x, y, 1, t) (the JAX ladder
    computes both and selects)."""
    shape = px.shape[:-1]
    dev = px.device
    base = torch.stack([words_to_limbs(px), words_to_limbs(py),
                        _const(1, dev).expand(*shape, NLIMBS),
                        words_to_limbs(pt)], -2)
    acc = identity(shape, dev)
    for bit in _scalar_bits(k):
        acc = ed_add(acc, acc)
        acc = torch.where(bit[..., None, None], ed_add(acc, base), acc)
    return acc


def sum_tree_plain(pts: torch.Tensor) -> torch.Tensor:
    """Σ over the first axis of (B, …, 4, 16) points, B a power of two, in
    the JAX `_sum_tree`'s order: for s = B/2 … 1, row i += row i + s; the
    result is row 0."""
    s = pts.shape[0] // 2
    while s:
        pts = ed_add(pts[:s], pts[s:2 * s])
        s //= 2
    return pts[0]


def ed25519_verify_plain(px, py, pt, k):
    """Plain version of `ed25519_verify`: the ladder, the sum tree, three
    doublings and the identity test. Also takes (B, …, 8) operands, the
    axes after the first being independent batches (rows (B, …, 4, 8),
    total (…, 4, 8), one verdict each), so that many recorded launches of
    one bucket are checked in one pass."""
    rows = ladder_plain(px, py, pt, k)
    total = sum_tree_plain(rows)
    for _ in range(3):
        total = ed_add(total, total)
    x, y, z, _ = total.unbind(-2)
    ok = (x == 0).all(-1) & (y == z).all(-1)
    return (ok.reshape(ok.shape or (1,)), limbs_to_words(rows),
            limbs_to_words(total))


def ed25519_verify(px, py, pt, k):
    """One cofactored RLC batch verdict. px, py, pt: (B, 8) canonical words
    of the rows' affine x, y and t = xy; k: (B, 8) int32 scalar words, each
    below 2²⁵³; B ∈ {8, 32, 128} (ValueError otherwise). Returns (verdict
    (1,) bool, rows (B, 4, 8) the ladder's [kᵢ]Pᵢ, total (4, 8) [8]Σ) in
    extended projective words, without waiting. CUDA kernel
    `ed25519_verify` (csrc/ed25519.cu) on CUDA tensors, the plain version
    on CPU tensors.

    Replaces the JAX program ed25519_verify (grandine_tpu/tpu/ed25519.py:298
    `verify_kernel`). One block a batch, one thread a row: each thread
    runs its row's ladder (253 doublings, an addition at each set bit —
    the scalars are public RLC values, so the ladder branches on them),
    the block sums the rows in the JAX tree's order through shared memory,
    and thread 0 clears the cofactor and tests for the identity. Bound:
    operations — about 3,400 field products a row of 145 32-bit multiplies
    each, against 128 bytes in and 128 out a row; each row is one thread's
    dependent chain, so the kernel is latency-bound on one ladder plus the
    log₂B tree levels. Several threads a ladder, a fixed-base table for
    [c_B]B and a Straus/Pippenger MSM are the queued speed-ups."""
    n = px.shape[0]
    if n not in BUCKETS or any(a.shape != (n, NWORDS) or a.dtype != torch.int32
                               for a in (px, py, pt, k)):
        raise ValueError(f"ed25519_verify: px, py, pt, k (B, 8) int32 with B "
                         f"in {BUCKETS}")
    if bool(((k[:, -1].to(torch.int64) & 0xFFFFFFFF) >> (NBITS - 224)).any()):
        raise ValueError("ed25519_verify: every scalar must be below 2^253")
    if px.device.type == "cpu":
        return ed25519_verify_plain(px, py, pt, k)
    from grandine_tpu_torch.gpu import _build

    verdict = px.new_empty((1,), dtype=torch.bool)
    rows = px.new_empty((n, 4, NWORDS))
    total = px.new_empty((4, NWORDS))
    _build.launch("ed25519_verify", px.contiguous(), py.contiguous(),
                  pt.contiguous(), k.contiguous(), ctypes.c_int(n), verdict,
                  rows, total)
    ed25519_verify.launches += 1
    return verdict, rows, total


ed25519_verify.launches = 0


# --- the backend -------------------------------------------------------------


def ladder_bucket(m: int) -> int:
    """The bucket of {8, 32, 128} that m MSM rows pad into."""
    for b in BUCKETS:
        if m <= b:
            return b
    raise ValueError(f"{m} rows exceed the largest bucket {BUCKETS[-1]}")


class Ed25519Backend:
    """The ed25519 scheme backend (gpu/schemes.py `get("ed25519")`, one per
    lane), the port of grandine_tpu/tpu/ed25519.py Ed25519Backend. Host
    prep decodes strictly (canonical y, S < L), draws the RLC coefficients
    and buckets the MSM; the card runs one `ed25519_verify` pass.

    Runs on `device`, CUDA unless "cpu" is passed, and raises with no card;
    on CUDA the constructor loads the kernel library (a kernel that does
    not build raises here, not in the first settle). `rng` is the
    randbits source of the RLC coefficients (tests inject a deterministic
    one); `metrics`, when given, counts kernel calls as the reference
    does; `tracer` opens a "device_dispatch" span around each launch.
    `mesh` is accepted and unused, as in the reference
    (grandine_tpu/tpu/ed25519.py:339): a batch runs on one device."""

    ASYNC_SEAM = ("verify_batch_async",)
    #: beyond this the 2n + 1-row MSM leaves the 128-row bucket: prepare
    #: reports "oversize" and the scheduler degrades the batch to the host
    #: twin
    MAX_ITEMS = 63

    def __init__(self, device=None, *, metrics=None, tracer=None,
                 lane: str = "ed25519", mesh=None, rng=None) -> None:
        self.device = B.resolve_device(device)
        if self.device.type == "cuda":
            from grandine_tpu_torch.gpu import _build

            _build.library()
        self.metrics = metrics
        self.tracer = tracer or NULL_TRACER
        self.lane = lane
        self.rng = rng if rng is not None else secrets

    def _count_kernel(self, kernel: str, sigs: int) -> None:
        if self.metrics is not None:
            self.metrics.device_kernel_calls.labels(kernel).inc()
            if sigs:
                self.metrics.device_kernel_sigs.labels(kernel).inc(sigs)

    def prepare(self, items):
        """(status, payload): "ok" → (px, py, pt, k, n) host words for
        `verify_batch_async`, "invalid" → some item can never verify (bad
        encoding, S ≥ L: the batch must FAIL so bisection isolates),
        "oversize" → degrade to the host path."""
        n = len(items)
        if n == 0:
            return "ok", ()
        if n > self.MAX_ITEMS:
            return "oversize", None
        decoded = []
        for it in items:
            keys = it.public_keys
            if keys is None or len(keys) != 1:
                return "invalid", None
            sig = bytes(it.signature)
            if len(sig) != 64:
                return "invalid", None
            pk = bytes(keys[0])
            a_pt = HE.point_decompress(pk)
            r_pt = HE.point_decompress(sig[:32])
            if a_pt is None or r_pt is None:
                return "invalid", None
            s = int.from_bytes(sig[32:], "little")
            if s >= HE.L:  # malleability bound, the twin's rule
                return "invalid", None
            k = int.from_bytes(
                HE.sha512(sig[:32] + pk + bytes(it.message)), "little"
            ) % HE.L
            decoded.append((a_pt, r_pt, s, k))
        zs = [self.rng.randbits(128) | 1 for _ in range(n)]
        c_b = sum(z * s for z, (_, _, s, _) in zip(zs, decoded)) % HE.L
        # MSM rows: [c_B]B, [zᵢ](−Rᵢ), [zᵢkᵢ](−Aᵢ); pads are the identity
        # with scalar zero
        points = [(HE.BASE[0], HE.BASE[1])]
        scalars = [c_b]
        for z, (_, r_pt, _, _) in zip(zs, decoded):
            points.append(((P - r_pt[0]) % P, r_pt[1]))
            scalars.append(z)
        for z, (a_pt, _, _, k) in zip(zs, decoded):
            points.append(((P - a_pt[0]) % P, a_pt[1]))
            scalars.append(z * k % HE.L)
        bm = ladder_bucket(len(points))
        points += [(0, 1)] * (bm - len(points))
        scalars += [0] * (bm - len(scalars))
        words = ints_to_words([x for x, _ in points] + [y for _, y in points]
                              + [x * y % P for x, y in points])
        return "ok", (words[:bm], words[bm:2 * bm], words[2 * bm:],
                      ints_to_words(scalars), n)

    def verify_batch_async(self, prep):
        """Launch the prepared batch; returns the zero-arg settle giving
        the device verdict."""
        if not prep:
            return lambda: True
        *host, n = prep
        px, py, pt, k = (torch.from_numpy(a).to(self.device) for a in host)
        self._count_kernel("ed25519_verify", n)
        with self.tracer.span("device_dispatch", {
                "kernel": "ed25519_verify", "lane": self.lane}):
            verdict, _rows, _total = ed25519_verify(px, py, pt, k)
        return lambda: bool(verdict.item())


__all__ = ["BUCKETS", "NBITS", "Ed25519Backend", "ed25519_verify",
           "ed25519_verify_plain", "ed_add", "fe_add", "fe_mul", "fe_sub",
           "identity", "ints_to_words", "ladder_bucket", "ladder_plain",
           "limbs_to_words", "sum_tree_plain", "words_to_ints",
           "words_to_limbs"]
