"""Trusted setup loading — the port's copy of grandine_tpu/kzg/setup.py
(reference: kzg_utils/src/trusted_setup.rs, the embedded ceremony output,
lazily parsed into library settings).

Two sources:
  - `official_setup()`: the public KZG-ceremony file, kept byte for byte
    in this package (data/trusted_setup.txt — 4096 Lagrange-form G1
    points + 65 monomial G2 points). Decompressing the 4096 G1 points is
    pure-Python square-root work (seconds), so their affine coordinates
    are cached beside the file after the first load
    (data/trusted_setup.cache.npz, keyed by the file's SHA-256).
  - `dev_setup(n)`: an INSECURE synthetic setup from a known tau, any
    power-of-two size — for tests and small-degree development; never for
    production verification of real blobs.

Per the deneb spec, the G1 Lagrange points are stored and used in
bit-reversal-permuted order. Besides the host points a setup keeps, per
device, the rows the kernels take (`device_g1`, `device_g2`), built once.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto.curves import B1, G1, G2, Point, g1_infinity
from grandine_tpu_torch.crypto.fields import Fq
from grandine_tpu_torch.kzg import fr

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
_OFFICIAL_TXT = os.path.join(_DATA_DIR, "trusted_setup.txt")
_OFFICIAL_CACHE = os.path.join(_DATA_DIR, "trusted_setup.cache.npz")


class TrustedSetup:
    """g1_lagrange_brp: [L_i(tau)]·G1 in bit-reversed order (length n);
    g2_monomial: [tau^i]·G2 (length >= 2); roots_brp: matching roots."""

    def __init__(self, g1_lagrange_brp, g2_monomial, name: str) -> None:
        self.g1_lagrange_brp = list(g1_lagrange_brp)
        self.g2_monomial = list(g2_monomial)
        self.name = name
        self.width = len(self.g1_lagrange_brp)
        assert self.width & (self.width - 1) == 0
        self.roots_brp = fr.bit_reversal_permutation(
            fr.compute_roots_of_unity(self.width)
        )
        self._dev_cache: dict = {}  # (kind, device) → kernel rows

    @property
    def tau_g2(self):
        return self.g2_monomial[1]

    @classmethod
    def from_arrays(cls, g1_xy, g2_compressed, name: str) -> "TrustedSetup":
        """A setup from arrays in the layout of the ceremony cache: g1_xy
        (N, 2, 48) uint8, the big-endian affine x and y of each Lagrange
        point in the file's (natural) order, an all-zero row for ∞ (no
        curve point has x = y = 0); g2_compressed (M ≥ 2, 96) uint8, the
        compressed monomial G2 points. Ceremony data: no subgroup check,
        as the reference loads it."""
        g1_xy = np.asarray(g1_xy, np.uint8)
        g2_compressed = np.asarray(g2_compressed, np.uint8)
        points = []
        for row in g1_xy:
            x = int.from_bytes(row[0].tobytes(), "big")
            y = int.from_bytes(row[1].tobytes(), "big")
            points.append(Point.from_affine(Fq(x), Fq(y), B1)
                          if x or y else g1_infinity())
        g2 = [A.g2_from_bytes(g2_compressed[i].tobytes(), subgroup_check=False)
              for i in range(min(2, g2_compressed.shape[0]))]
        return cls(fr.bit_reversal_permutation(points), g2, name)

    def device_g1(self, device: torch.device):
        """The Lagrange points as the kernels take them, on `device`: (w,
        12) x and y canonical words (zero on ∞ rows) and the (w,) ∞ mask,
        built once per device (one batched inversion)."""
        from grandine_tpu_torch.gpu.bls import g1_affine_words

        key = ("g1", str(device))
        hit = self._dev_cache.get(key)
        if hit is None:
            inf = np.array([pt.is_infinity() for pt in self.g1_lagrange_brp],
                           bool)
            xs = np.zeros((self.width, 12), np.int32)
            ys = np.zeros((self.width, 12), np.int32)
            if (~inf).any():
                xs[~inf], ys[~inf] = g1_affine_words(
                    [pt for pt, i in zip(self.g1_lagrange_brp, inf) if not i])
            hit = self._dev_cache[key] = tuple(
                torch.from_numpy(a).to(device) for a in (xs, ys, inf))
        return hit

    def device_g2(self, device: torch.device) -> torch.Tensor:
        """The G2 side of the batch pairing, [G2, G2, G2, τG2], as (4, 2,
        2, 12) affine canonical words [x, y] on `device`, built once per
        device."""
        from grandine_tpu_torch.gpu.bls import g2_affine_words_many

        key = ("g2", str(device))
        hit = self._dev_cache.get(key)
        if hit is None:
            x, y, _ = g2_affine_words_many([G2, G2, G2, self.tau_g2])
            hit = self._dev_cache[key] = torch.from_numpy(
                np.stack([x, y], 1)).to(device)
        return hit


_OFFICIAL: "Optional[TrustedSetup]" = None
_DEV: dict = {}


def official_setup() -> TrustedSetup:
    """The production setup (FIELD_ELEMENTS_PER_BLOB = 4096)."""
    global _OFFICIAL
    if _OFFICIAL is None:
        arrays = _load_cached_official()
        if arrays is None:
            arrays = _parse_official_txt()
            _store_cache(arrays)
        _OFFICIAL = TrustedSetup.from_arrays(*arrays, "official")
    return _OFFICIAL


def dev_setup(n: int = 64, tau: int = 0x1337_F00D_D00D_5EED) -> TrustedSetup:
    """INSECURE known-tau setup for tests/dev (tau is public!)."""
    key = (n, tau)
    hit = _DEV.get(key)
    if hit is not None:
        return hit
    roots = fr.compute_roots_of_unity(n)
    # Lagrange basis at tau: L_i(tau) = (tau^n - 1) * w^i / (n * (tau - w^i))
    R = fr.BLS_MODULUS
    tau %= R
    tn = (pow(tau, n, R) - 1) % R
    n_inv = pow(n % R, R - 2, R)
    denoms = fr.batch_inverse([(tau - w) % R for w in roots])
    lag = [tn * w % R * d % R * n_inv % R for w, d in zip(roots, denoms)]
    g1_points = [G1.mul(v) if v else g1_infinity() for v in lag]
    g2_points = [G2.mul(pow(tau, i, R)) for i in range(2)]
    setup = TrustedSetup(
        fr.bit_reversal_permutation(g1_points), g2_points, f"dev-{n}"
    )
    _DEV[key] = setup
    return setup


# ----------------------------------------------------------------- parsing


def _parse_official_txt() -> "tuple[np.ndarray, np.ndarray]":
    """The ceremony file → (g1_xy, g2_compressed) as `from_arrays` takes
    them: every G1 point decompressed (no subgroup check)."""
    with open(_OFFICIAL_TXT) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n_g1 = int(lines[0])
    n_g2 = int(lines[1])
    g1_hex = lines[2 : 2 + n_g1]
    g2_hex = lines[2 + n_g1 : 2 + n_g1 + n_g2]
    g1_xy = np.zeros((n_g1, 2, 48), np.uint8)
    for i, h in enumerate(g1_hex):
        aff = A.g1_from_bytes(bytes.fromhex(h),
                              subgroup_check=False).to_affine()
        g1_xy[i, 0] = np.frombuffer(aff[0].n.to_bytes(48, "big"), np.uint8)
        g1_xy[i, 1] = np.frombuffer(aff[1].n.to_bytes(48, "big"), np.uint8)
    g2 = np.stack([np.frombuffer(bytes.fromhex(h), np.uint8) for h in g2_hex])
    return g1_xy, g2


def _txt_digest() -> bytes:
    with open(_OFFICIAL_TXT, "rb") as f:
        return hashlib.sha256(f.read()).digest()


def _load_cached_official():
    """npz cache (no pickle: nothing executable in the file), keyed on a
    content hash of the source txt; None when absent, stale or corrupt."""
    try:
        with np.load(_OFFICIAL_CACHE, allow_pickle=False) as z:
            if bytes(z["digest"].tobytes()) != _txt_digest():
                return None
            return z["g1"], z["g2"]
    except Exception:
        # any unreadable/corrupt cache (incl. zipfile.BadZipFile from a
        # truncated write) falls back to re-parsing the source txt
        return None


def _store_cache(arrays) -> None:
    g1_xy, g2 = arrays
    try:
        tmp = _OFFICIAL_CACHE + ".tmp"
        np.savez(tmp, digest=np.frombuffer(_txt_digest(), np.uint8),
                 g1=g1_xy, g2=g2)
        os.replace(tmp + ".npz", _OFFICIAL_CACHE)  # atomic publish
    except OSError:
        pass


__all__ = ["TrustedSetup", "official_setup", "dev_setup"]
