"""Device-resident validator pubkey registry (counterpart of
grandine_tpu/tpu/registry.py).

The validator set's G1 pubkeys stay on the card as two (capacity, 12)
int32 tensors of canonical affine words; the verify kernels gather rows
by index, so a batch uploads 4 bytes of index per member instead of the
key. Ingest uploads the raw 48-byte compressed rows and decompresses them
on the card with the `g1_decompress` kernel (gpu/curve.py).

Freshness model, as in the JAX package: `ensure(pubkeys)` takes the head
state's compressed-pubkey tuple — an identical tuple object is a free
hit; a tuple that extends the previous one appends only the new rows; any
other tuple rebuilds. `mark_stale()` demotes the next ensure from the
identity hit to the prefix check, `invalidate()` drops everything.
Capacity grows in powers of two (at least MIN_CAPACITY). Rows are never
the identity: `_raw_rows` rejects the infinity encoding before a row
enters the mirror; a wire-well-formed row that does not decompress
(corrupted input) comes back zeroed from the kernel, fail-closed.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from grandine_tpu_torch.consensus.keys import decompress_pubkey
from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto.constants import P
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu.bls import g1_decompress_rows, resolve_device

MIN_CAPACITY = 16


def _next_pow2(n: int, lo: int = MIN_CAPACITY) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


class DevicePubkeyRegistry:
    """The validator set's G1 pubkeys, on `device` (default CUDA; raises
    without one unless the caller passes device="cpu")."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._pubkeys: "Optional[tuple]" = None
        self._stale = False
        self._hraw: "Optional[np.ndarray]" = None
        self._hcount = 0
        self._x: "Optional[torch.Tensor]" = None
        self._y: "Optional[torch.Tensor]" = None
        self.stats = {"hits": 0, "misses": 0, "appends": 0, "refreshes": 0,
                      "uploaded_bytes": 0, "host_grows": 0}

    # --------------------------------------------------------------- state

    @property
    def count(self) -> int:
        with self._lock:
            return 0 if self._pubkeys is None else len(self._pubkeys)

    @property
    def capacity(self) -> int:
        with self._lock:
            return 0 if self._x is None else int(self._x.shape[0])

    def arrays(self):
        """(x, y, count): rows past `count` are zero padding."""
        with self._lock:
            return self._x, self._y, self.count

    def public_keys(self, indices: "Sequence[int]"):
        """PublicKeys for `indices` from the host mirror (registry keys
        passed KeyValidate at deposit: no subgroup check here)."""
        with self._lock:
            pks = self._pubkeys or ()
        return [decompress_pubkey(pks[int(i)], trusted=True)
                for i in indices]

    # ------------------------------------------------------------ lifecycle

    def mark_stale(self) -> None:
        with self._lock:
            self._stale = True

    def invalidate(self) -> None:
        with self._lock:
            self._pubkeys = None
            self._hraw = None
            self._hcount = 0
            self._x = self._y = None
            self._stale = False

    def ensure(self, pubkeys: "Sequence[bytes]") -> bool:
        """Cover `pubkeys`: identity hit, prefix append, or full refresh.
        Returns True when the device arrays are usable."""
        if not isinstance(pubkeys, tuple):
            pubkeys = tuple(bytes(b) for b in pubkeys)
        if len(pubkeys) == 0:
            return False
        with self._lock:
            old = self._pubkeys
            if old is pubkeys and not self._stale:
                self.stats["hits"] += 1
                return True
            self.stats["misses"] += 1
            if (old is not None and len(pubkeys) >= len(old)
                    and pubkeys[: len(old)] == old):
                if len(pubkeys) > len(old):
                    self._append(pubkeys, start=len(old))
                self._pubkeys = pubkeys
            else:
                self._refresh(pubkeys)
            self._stale = False
            return True

    # ------------------------------------------------------------ internals

    def _raw_rows(self, pubkey_bytes: "Sequence[bytes]") -> np.ndarray:
        """Compressed bytes → (n, 48) uint8 rows; raises BlsError on what
        the wire alone answers: wrong length, no compression flag, the
        identity encoding."""
        try:
            rows = C.compressed_rows(pubkey_bytes, 48)
        except ValueError as e:
            raise A.BlsError(str(e)) from None
        if rows.shape[0]:
            flags = rows[:, 0]
            if ((flags & C.COMPRESSED_FLAG) == 0).any():
                raise A.BlsError("uncompressed pubkey in registry input")
            if ((flags & C.INFINITY_FLAG) != 0).any():
                raise A.BlsError("identity pubkey can not enter the registry")
        return rows

    def _decompress_dev(self, raw: np.ndarray):
        x, y, *_ = g1_decompress_rows(raw, self.device)
        return x, y

    def _host_reserve(self, rows: int) -> None:
        cur = 0 if self._hraw is None else int(self._hraw.shape[0])
        if rows <= cur:
            return
        nraw = np.zeros((_next_pow2(rows), 48), np.uint8)
        if self._hraw is not None and self._hcount:
            nraw[: self._hcount] = self._hraw[: self._hcount]
        self._hraw = nraw
        self.stats["host_grows"] += 1

    def _append(self, pubkeys: tuple, start: int) -> None:
        raw = self._raw_rows(pubkeys[start:])
        end = len(pubkeys)
        n_new = end - start
        self._host_reserve(end)
        self._hraw[start:end] = raw
        self._hcount = end
        if end <= self.capacity:
            pad = np.zeros((_next_pow2(n_new), 48), np.uint8)
            pad[:n_new] = raw
            dx, dy = self._decompress_dev(pad)
            self._x[start:end] = dx[:n_new]  # in place: O(new) rows
            self._y[start:end] = dy[:n_new]
            self.stats["uploaded_bytes"] += int(pad.nbytes)
        else:
            self._upload_full(end)
        self._pubkeys = pubkeys
        self.stats["appends"] += 1

    def _refresh(self, pubkeys: tuple) -> None:
        raw = self._raw_rows(pubkeys)
        self._hraw = None
        self._hcount = 0
        self._host_reserve(len(pubkeys))
        self._hraw[: len(pubkeys)] = raw
        self._hcount = len(pubkeys)
        self._pubkeys = pubkeys
        self._upload_full(len(pubkeys))
        self.stats["refreshes"] += 1

    def _upload_full(self, count: int) -> None:
        """(Re)build the device arrays at power-of-two capacity from the
        host mirror: one raw upload, one g1_decompress launch."""
        cap = _next_pow2(count)
        praw = np.zeros((cap, 48), np.uint8)
        praw[:count] = self._hraw[:count]
        self._x, self._y = self._decompress_dev(praw)
        self.stats["uploaded_bytes"] += int(praw.nbytes)


def registry_from_jax_arrays(reg_x, reg_y, count: int, raw_rows,
                             device=None) -> DevicePubkeyRegistry:
    """A port registry equivalent to a JAX DevicePubkeyRegistry's state,
    given as numpy: reg_x/reg_y (cap, 26) int32 Montgomery digits (signed
    15-bit, R = 2³⁹⁰) and the (≥count, 48) raw mirror. Digits → canonical
    int → canonical words; no decompression is redone."""
    reg_x = np.asarray(reg_x)
    reg_y = np.asarray(reg_y)
    r_inv = pow(1 << 390, -1, P)

    def canon(row) -> int:
        v = sum(int(d) << (15 * i) for i, d in enumerate(row))
        return v * r_inv % P

    cap = reg_x.shape[0]
    xs = L.ints_to_words([canon(r) for r in reg_x])
    ys = L.ints_to_words([canon(r) for r in reg_y])
    reg = DevicePubkeyRegistry(device=device)
    raw = np.ascontiguousarray(np.asarray(raw_rows, np.uint8)[:count])
    with reg._lock:
        reg._pubkeys = tuple(bytes(r) for r in raw)
        reg._host_reserve(count)
        reg._hraw[:count] = raw
        reg._hcount = count
        reg._x = torch.from_numpy(xs.reshape(cap, 12).copy()).to(reg.device)
        reg._y = torch.from_numpy(ys.reshape(cap, 12).copy()).to(reg.device)
    return reg


__all__ = ["DevicePubkeyRegistry", "MIN_CAPACITY", "registry_from_jax_arrays"]
