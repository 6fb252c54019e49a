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

With a `VerifyMesh` (gpu/mesh.py) the rows are row-sharded as in the
reference (tpu/registry.py:84-94, `P("batch")`): D contiguous blocks of
capacity/D rows, block d on shard d's device, ingested there by its own
`g1_decompress` launch; capacity is at least the next power of two of D.
`rows_for` is the counterpart of XLA's cross-shard gather: the rows a
batch names, gathered on the shards that own them and copied to the
dispatch device. Stats, `count`, `capacity` and `public_keys` are those
of one device.
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
from grandine_tpu_torch.gpu.mesh import resolve_mesh

MIN_CAPACITY = 16


def _next_pow2(n: int, lo: int = MIN_CAPACITY) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


class DevicePubkeyRegistry:
    """The validator set's G1 pubkeys, on `device` (default CUDA; raises
    without one unless the caller passes device="cpu"), or row-sharded
    over `mesh` (its first device is then the registry's device; a
    conflicting `device` raises)."""

    def __init__(self, device=None, mesh=None) -> None:
        self.mesh, device = resolve_mesh(mesh, device)
        self.device = resolve_device(device)
        #: the devices of the row blocks, in row order
        self._devices = (self.mesh.devices if self.mesh is not None
                         else (self.device,))
        self._lock = threading.RLock()
        self._pubkeys: "Optional[tuple]" = None
        self._stale = False
        self._hraw: "Optional[np.ndarray]" = None
        self._hcount = 0
        #: the row blocks, one a device of `_devices` (None: empty)
        self._x: "Optional[list]" = None
        self._y: "Optional[list]" = None
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
            return 0 if self._x is None else sum(int(b.shape[0])
                                                 for b in self._x)

    def arrays(self):
        """(x, y, count): rows past `count` are zero padding. With a mesh,
        x and y are tuples of the D row blocks (`rows_for` gathers a
        batch's rows from them)."""
        with self._lock:
            if self._x is None:
                return None, None, self.count
            if self.mesh is None:
                return self._x[0], self._y[0], self.count
            return tuple(self._x), tuple(self._y), self.count

    def rows_for(self, indices, device):
        """The gather source and index plane of a batch naming registry
        rows `indices` (an int array, values below `capacity`): (src_x,
        src_y, idx) with row idx[…] of src the key of indices[…]. On one
        device the registry's own arrays and the indices. With a mesh the
        batch's distinct rows, each gathered on the shard that owns it and
        copied to `device` (stream-ordered), in a compact source, with idx
        remapped onto it."""
        idx = np.asarray(indices).astype(np.int64)
        with self._lock:
            xs, ys = self._x, self._y
        if self.mesh is None:
            return xs[0], ys[0], idx.astype(np.int32)
        rows, inv = np.unique(idx.reshape(-1), return_inverse=True)
        per = int(xs[0].shape[0])
        cuts = np.searchsorted(rows, np.arange(len(xs) + 1) * per)
        parts_x, parts_y = [], []
        for d in range(len(xs)):
            lo, hi = cuts[d], cuts[d + 1]
            if lo == hi:
                continue
            (local,) = self.mesh.put([rows[lo:hi] - d * per], d)
            parts_x.append(xs[d][local].to(device, non_blocking=True))
            parts_y.append(ys[d][local].to(device, non_blocking=True))
        if not parts_x:
            empty = torch.zeros((0, 12), dtype=torch.int32, device=device)
            return empty, empty, inv.reshape(idx.shape).astype(np.int32)
        return (torch.cat(parts_x), torch.cat(parts_y),
                inv.reshape(idx.shape).astype(np.int32))

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

    def _decompress_dev(self, raw: np.ndarray, device):
        x, y, *_ = g1_decompress_rows(raw, device)
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
            dx, dy = self._decompress_dev(pad, self.device)
            per = int(self._x[0].shape[0])
            for d in range(start // per, (end - 1) // per + 1):
                # in place: O(new) rows, each into the block that owns it
                lo, hi = max(start, d * per), min(end, (d + 1) * per)
                dev = self._devices[d]
                self._x[d][lo - d * per: hi - d * per] = dx[
                    lo - start: hi - start].to(dev)
                self._y[d][lo - d * per: hi - d * per] = dy[
                    lo - start: hi - start].to(dev)
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
        host mirror: one raw upload and one g1_decompress launch a row
        block, on the block's device."""
        cap = max(_next_pow2(count), _next_pow2(len(self._devices)))
        per = cap // len(self._devices)
        praw = np.zeros((cap, 48), np.uint8)
        praw[:count] = self._hraw[:count]
        blocks = [self._decompress_dev(praw[d * per: (d + 1) * per], dev)
                  for d, dev in enumerate(self._devices)]
        self._x = [x for x, _ in blocks]
        self._y = [y for _, y in blocks]
        self.stats["uploaded_bytes"] += int(praw.nbytes)


def registry_from_jax_arrays(reg_x, reg_y, count: int, raw_rows,
                             device=None, mesh=None) -> DevicePubkeyRegistry:
    """A port registry equivalent to a JAX DevicePubkeyRegistry's state,
    given as numpy: reg_x/reg_y (cap, 26) int32 Montgomery digits (signed
    15-bit, R = 2³⁹⁰) and the (≥count, 48) raw mirror. Digits → canonical
    int → canonical words; no decompression is redone. With `mesh` (a JAX
    registry's `mesh=` state, read back whole) the rows land as the D
    blocks of a sharded port registry; the mesh must divide the
    capacity."""
    reg_x = np.asarray(reg_x)
    reg_y = np.asarray(reg_y)
    r_inv = pow(1 << 390, -1, P)

    def canon(row) -> int:
        v = sum(int(d) << (15 * i) for i, d in enumerate(row))
        return v * r_inv % P

    cap = reg_x.shape[0]
    xs = L.ints_to_words([canon(r) for r in reg_x]).reshape(cap, 12)
    ys = L.ints_to_words([canon(r) for r in reg_y]).reshape(cap, 12)
    reg = DevicePubkeyRegistry(device=device, mesh=mesh)
    n_blocks = len(reg._devices)
    if cap % n_blocks:
        raise ValueError(f"a capacity of {cap} rows does not shard over "
                         f"{n_blocks} devices")
    per = cap // n_blocks
    raw = np.ascontiguousarray(np.asarray(raw_rows, np.uint8)[:count])
    with reg._lock:
        reg._pubkeys = tuple(bytes(r) for r in raw)
        reg._host_reserve(count)
        reg._hraw[:count] = raw
        reg._hcount = count
        reg._x = [torch.from_numpy(xs[d * per: (d + 1) * per].copy()).to(dev)
                  for d, dev in enumerate(reg._devices)]
        reg._y = [torch.from_numpy(ys[d * per: (d + 1) * per].copy()).to(dev)
                  for d, dev in enumerate(reg._devices)]
    return reg


__all__ = ["DevicePubkeyRegistry", "MIN_CAPACITY", "registry_from_jax_arrays"]
