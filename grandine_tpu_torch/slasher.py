"""Slasher: the port of grandine_tpu/slasher.py, with the same keys and
the same bytes in every value, so the two packages' databases come out
equal and either reads the other's. Its bulk merge runs on the card
through `gpu.spans.SpanPlane` (one `span_update_grid` launch a window),
or on the kernel's plain version when built with `device="cpu"`.

Reference: `slasher` crate (slasher/src/slasher.rs:50:
surround/double-vote detection over mdbx DBs of indexed attestations and
chunked min/max target spans, plus proposer double-block detection; emits
slashings toward the proposer pipeline).

Scale design (the reference's chunked span scheme, numpy-native):
for validator v and epoch e,
  min_targets[v][e] = min target among v's attestations with source > e
  max_targets[v][e] = max target among v's attestations with source < e
Both are MONOTONE non-decreasing in e (larger e → smaller source set for
min / larger for max), which makes range updates amortized O(1): walking
away from the new attestation's source, the update stops at the first
chunk it doesn't change.

Detection per new attestation (s, t) of validator v is O(1) chunk reads:
  min_targets[v][s] < t  →  the new vote SURROUNDS a recorded one
  max_targets[v][s] > t  →  the new vote IS SURROUNDED by a recorded one
  a recorded (v, t) with a different data root  →  double vote

Batched ingest: span chunks are indexed [row=validator] and records are
keyed (validator, target), so one attestation's effect on validator v
depends only on prior updates to v itself. Within one aggregate (shared
source/target/root) distinct indices therefore commute: `on_attestation`
groups an aggregate's indices by vchunk and applies one vectorized
min/max range-update and one vectorized surround/double-vote gather per
touched chunk instead of a Python loop per validator. The same argument
lets `on_attestations_bulk` merge a whole replay window's solo
validators in one chunk-aligned epoch grid — one launch of the span-grid
kernel through `gpu.spans.SpanPlane` — while validators that appear more
than once in the window (or twice in one aggregate: re-recording a
double vote changes what the next occurrence sees) fall back to the
sequential reference path. The original per-validator loop survives as
`on_attestation_reference`, the oracle for the differential tests and
the bench's batched-vs-loop diagnostic.

Storage: (VALIDATORS_PER_CHUNK × CHUNK_EPOCHS) uint64 arrays in the K-V
store (the reference's mdbx chunk tables), an in-memory LRU chunk cache
flushed per call, per-(validator, target) attestation records for
evidence retrieval, and epoch-ordered index rows (`sl:e:`, `sl:t:`) so
`prune()` walks only the doomed prefix instead of scanning every key
per finalization.
"""

from __future__ import annotations

import time
from collections import Counter as _Counter
from collections import OrderedDict
from typing import Optional

import numpy as np

from grandine_tpu_torch.gpu import spans as SP
from grandine_tpu_torch.storage.database import Database

CHUNK_EPOCHS = 16
VALIDATORS_PER_CHUNK = 256
_UNSET_MIN = np.uint64(0xFFFF_FFFF_FFFF_FFFF)

#: epoch values at or above this stay on the host path — the device grid
#: carries epochs as int32 and needs headroom below the sentinel
_GRID_EPOCH_LIMIT = 1 << 30

_PREFIX_MIN = b"sl:m:"    # vchunk_be8 + echunk_be8 -> uint64[VPC, CE]
_PREFIX_MAX = b"sl:x:"
_PREFIX_REC = b"sl:r:"    # validator_be8 + target_be8 -> source_be8 + root32
_PREFIX_BLOCK = b"sl:b:"  # validator_be8 + slot_be8 -> header root
#: prune indexes, ascending in the pruned dimension so finalization
#: walks exactly the doomed prefix: echunk_be8 + kind(m/x) + vchunk_be8
_PREFIX_ECHUNK_IDX = b"sl:e:"
#: target_be8 + validator_be8 (record prune index)
_PREFIX_TGT_IDX = b"sl:t:"


class Slashing:
    """A detected offense with the evidence needed to build the on-chain
    operation."""

    __slots__ = ("kind", "validator_index", "evidence")

    def __init__(self, kind: str, validator_index: int, evidence: dict) -> None:
        self.kind = kind
        self.validator_index = validator_index
        self.evidence = evidence

    def __repr__(self) -> str:
        return f"Slashing({self.kind}, validator={self.validator_index})"


class Slasher:
    """The reference's Slasher with one more argument, `device`: when no
    `span_plane` is given it builds `SpanPlane(device, metrics)`, so the
    bulk merge runs on the card (and the constructor raises with no card)
    unless `device="cpu"`, which runs the kernel's plain version."""

    def __init__(self, database: "Optional[Database]" = None,
                 history_epochs: int = 4096, metrics=None,
                 span_plane=None, cache_chunks: int = 4096,
                 device=None) -> None:
        self.db = database or Database.in_memory()
        self.history_epochs = history_epochs
        self.metrics = metrics
        #: the gpu.spans.SpanPlane of the bulk-replay grid merge
        self.span_plane = (span_plane if span_plane is not None
                           else SP.SpanPlane(device, metrics))
        self.cache_chunks = cache_chunks
        self.detected: "list[Slashing]" = []
        #: (kind, vchunk, echunk) -> uint64[VPC, CE]; LRU-ordered, dirty
        #: entries flushed to the K-V store at the end of every mutating
        #: call and pinned against eviction until then
        self._chunks: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._dirty: "set[tuple]" = set()

    # ------------------------------------------------------------- chunks

    def _cache_event(self, event: str) -> None:
        if self.metrics is not None:
            self.metrics.slasher_chunk_cache_events.labels(event).inc()

    def _sync_cache_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.slasher_chunk_cache_size.set(len(self._chunks))

    def _chunk_key(self, kind: str, vchunk: int, echunk: int) -> bytes:
        prefix = _PREFIX_MIN if kind == "min" else _PREFIX_MAX
        return prefix + vchunk.to_bytes(8, "big") + echunk.to_bytes(8, "big")

    def _chunk(self, kind: str, vchunk: int, echunk: int) -> np.ndarray:
        key = (kind, vchunk, echunk)
        arr = self._chunks.get(key)
        if arr is not None:
            self._chunks.move_to_end(key)
            self._cache_event("hit")
            return arr
        self._cache_event("miss")
        raw = self.db.get(self._chunk_key(kind, vchunk, echunk))
        if raw is not None:
            arr = (
                np.frombuffer(bytes(raw), dtype=np.uint64)
                .reshape(VALIDATORS_PER_CHUNK, CHUNK_EPOCHS)
                .copy()
            )
        else:
            fill = _UNSET_MIN if kind == "min" else np.uint64(0)
            arr = np.full(
                (VALIDATORS_PER_CHUNK, CHUNK_EPOCHS), fill, np.uint64
            )
        self._chunks[key] = arr
        if len(self._chunks) > self.cache_chunks:
            # LRU: oldest clean entries first; dirty chunks are pinned
            # until flush writes them back
            for k in list(self._chunks.keys()):
                if len(self._chunks) <= self.cache_chunks:
                    break
                if k in self._dirty or k == key:
                    continue
                del self._chunks[k]
                self._cache_event("evict")
        self._sync_cache_gauge()
        return arr

    def flush(self) -> None:
        if not self._dirty:
            return
        batch = []
        for kind, vchunk, echunk in self._dirty:
            batch.append((
                self._chunk_key(kind, vchunk, echunk),
                self._chunks[(kind, vchunk, echunk)].tobytes(),
            ))
            batch.append((
                _PREFIX_ECHUNK_IDX
                + echunk.to_bytes(8, "big")
                + (b"m" if kind == "min" else b"x")
                + vchunk.to_bytes(8, "big"),
                b"",
            ))
        self.db.put_batch(batch)
        self._dirty.clear()

    # ------------------------------------------------------------ records

    def _rec_key(self, index: int, target: int) -> bytes:
        return (
            _PREFIX_REC
            + int(index).to_bytes(8, "big")
            + int(target).to_bytes(8, "big")
        )

    def _rec_rows(self, index: int, source: int, target: int,
                  data_root: bytes) -> "list[tuple[bytes, bytes]]":
        return [
            (self._rec_key(index, target),
             source.to_bytes(8, "big") + data_root),
            (_PREFIX_TGT_IDX + target.to_bytes(8, "big")
             + index.to_bytes(8, "big"), b""),
        ]

    def _put_record(self, index: int, source: int, target: int,
                    data_root: bytes) -> None:
        self.db.put_batch(self._rec_rows(index, source, target, data_root))

    def _record(self, index: int, target: int):
        raw = self.db.get(self._rec_key(index, target))
        if raw is None:
            return None
        raw = bytes(raw)
        return int.from_bytes(raw[:8], "big"), raw[8:40]

    def record_for(self, validator_index: int, target: int):
        """Recorded vote of `validator_index` at `target`, as
        (source_epoch, data_root) — or None when the validator has no
        recorded attestation for that target epoch. The public read used
        by the firehose and replay feeds to assemble double-vote
        evidence."""
        return self._record(int(validator_index), int(target))

    # -------------------------------------------------------- attestations

    def on_attestation(
        self, attesting_indices, source_epoch: int, target_epoch: int,
        data_root: bytes,
    ) -> "list[Slashing]":
        """Record one indexed attestation; returns any detected offenses.
        The aggregate's index set is processed as a batch: grouped by
        vchunk, one vectorized check gather and one vectorized range
        update per touched chunk. A repeated index inside one aggregate
        is order-dependent (its first occurrence can rewrite the record
        the second one reads), so those rare aggregates take the
        sequential reference path instead."""
        s, t = int(source_epoch), int(target_epoch)
        data_root = bytes(data_root)
        ids = [int(i) for i in attesting_indices]
        t0 = time.perf_counter()
        if len(set(ids)) != len(ids):
            out = self._on_attestation_seq(ids, s, t, data_root)
        else:
            out = self._on_attestation_batched(ids, s, t, data_root)
        self.flush()
        self._observe_span_update(t0, len(ids))
        self.detected.extend(out)
        return out

    def on_attestation_reference(
        self, attesting_indices, source_epoch: int, target_epoch: int,
        data_root: bytes,
    ) -> "list[Slashing]":
        """The original per-validator loop, byte-for-byte semantics.
        Kept as the oracle for the batched path's differential tests and
        the bench's batched-vs-loop diagnostic."""
        s, t = int(source_epoch), int(target_epoch)
        data_root = bytes(data_root)
        ids = [int(i) for i in attesting_indices]
        out = self._on_attestation_seq(ids, s, t, data_root)
        self.flush()
        self.detected.extend(out)
        return out

    def _on_attestation_seq(self, ids, s: int, t: int,
                            data_root: bytes) -> "list[Slashing]":
        out = []
        for i in ids:
            hit = self._check_one(i, s, t, data_root)
            if hit is not None:
                out.append(hit)
            self._put_record(i, s, t, data_root)
            self._update_spans(i, s, t)
        return out

    def _on_attestation_batched(self, ids, s: int, t: int,
                                data_root: bytes) -> "list[Slashing]":
        checks = self._check_rows(ids, s, t, data_root)
        out = [hit for hit in checks if hit is not None]
        rows = []
        for i in ids:
            rows.extend(self._rec_rows(i, s, t, data_root))
        if rows:
            self.db.put_batch(rows)
        ids_arr = np.asarray(ids, dtype=np.int64)
        vchunks = ids_arr // VALIDATORS_PER_CHUNK
        for vc in np.unique(vchunks):
            self._update_spans_rows(
                int(vc), ids_arr[vchunks == vc] % VALIDATORS_PER_CHUNK,
                s, t,
            )
        return out

    def _check_rows(self, ids, s: int, t: int, data_root: bytes):
        """Vectorized `_check_one` over an aggregate's (unique) indices:
        one gather per touched chunk, detection precedence per validator
        identical to the scalar path (double vote, surround,
        surrounded). Returns a list aligned with `ids`, None for clean
        rows."""
        n = len(ids)
        echunk_s, col_s = divmod(s, CHUNK_EPOCHS)
        ids_arr = np.asarray(ids, dtype=np.int64)
        vchunks = ids_arr // VALIDATORS_PER_CHUNK
        rows = ids_arr % VALIDATORS_PER_CHUNK
        min_vals = np.empty(n, np.uint64)
        max_vals = np.empty(n, np.uint64)
        for vc in np.unique(vchunks):
            m = vchunks == vc
            r = rows[m]
            min_vals[m] = self._chunk("min", int(vc), echunk_s)[r, col_s]
            max_vals[m] = self._chunk("max", int(vc), echunk_s)[r, col_s]
        unset = int(_UNSET_MIN)
        out = []
        for pos, i in enumerate(ids):
            existing = self._record(i, t)
            if existing is not None and existing[1] != data_root:
                out.append(Slashing("double_vote", i, {
                    "target_epoch": t,
                    "roots": [existing[1].hex(), data_root.hex()],
                }))
                continue
            min_t = int(min_vals[pos])
            if min_t != unset and min_t < t:
                rec = self._record(i, min_t)
                out.append(Slashing("surround_vote", i, {
                    "existing": [rec[0] if rec else -1, min_t],
                    "new": [s, t],
                }))
                continue
            max_t = int(max_vals[pos])
            if max_t > t:
                rec = self._record(i, max_t)
                out.append(Slashing("surrounded_vote", i, {
                    "existing": [rec[0] if rec else -1, max_t],
                    "new": [s, t],
                }))
                continue
            out.append(None)
        return out

    def _check_one(self, i: int, s: int, t: int, data_root: bytes):
        existing = self._record(i, t)
        if existing is not None and existing[1] != data_root:
            return Slashing("double_vote", i, {
                "target_epoch": t,
                "roots": [existing[1].hex(), data_root.hex()],
            })
        vchunk, row = divmod(i, VALIDATORS_PER_CHUNK)
        echunk, col = divmod(s, CHUNK_EPOCHS)
        min_t = int(self._chunk("min", vchunk, echunk)[row, col])
        if min_t != int(_UNSET_MIN) and min_t < t:
            rec = self._record(i, min_t)
            return Slashing("surround_vote", i, {
                "existing": [rec[0] if rec else -1, min_t],
                "new": [s, t],
            })
        max_t = int(self._chunk("max", vchunk, echunk)[row, col])
        if max_t > t:
            rec = self._record(i, max_t)
            return Slashing("surrounded_vote", i, {
                "existing": [rec[0] if rec else -1, max_t],
                "new": [s, t],
            })
        return None

    def _update_spans(self, i: int, s: int, t: int) -> None:
        """Amortized range update: min_targets over e ∈ [floor, s),
        max_targets over e ∈ (s, t], early-exiting on the first unchanged
        chunk (valid by monotonicity, see module docstring)."""
        vchunk, row = divmod(i, VALIDATORS_PER_CHUNK)
        tval = np.uint64(t)

        # ---- min_targets: epochs below the source
        floor = max(0, s - self.history_epochs)
        e_hi = s - 1  # inclusive
        while e_hi >= floor:
            echunk = e_hi // CHUNK_EPOCHS
            e_lo = max(floor, echunk * CHUNK_EPOCHS)
            arr = self._chunk("min", vchunk, echunk)
            sl = arr[row, e_lo - echunk * CHUNK_EPOCHS : e_hi - echunk * CHUNK_EPOCHS + 1]
            if not (sl > tval).any():
                break  # monotone: everything below is already ≤ t
            np.minimum(sl, tval, out=sl)
            self._dirty.add(("min", vchunk, echunk))
            e_hi = e_lo - 1

        # ---- max_targets: epochs above the source, bounded by the target
        # (an attestation with source past the target cannot be surrounded
        # by this one — target ≥ source always)
        e_lo = s + 1
        while e_lo <= t:
            echunk = e_lo // CHUNK_EPOCHS
            e_hi2 = min(t, echunk * CHUNK_EPOCHS + CHUNK_EPOCHS - 1)
            arr = self._chunk("max", vchunk, echunk)
            sl = arr[row, e_lo - echunk * CHUNK_EPOCHS : e_hi2 - echunk * CHUNK_EPOCHS + 1]
            if not (sl < tval).any():
                break  # monotone: everything above is already ≥ t
            np.maximum(sl, tval, out=sl)
            self._dirty.add(("max", vchunk, echunk))
            e_lo = e_hi2 + 1

    def _update_spans_rows(self, vchunk: int, rows, s: int, t: int) -> None:
        """`_update_spans` for many rows of one vchunk sharing (s, t):
        one vectorized chunk op per step of the walk, with the per-row
        early exit carried as a shrinking active set (a row leaves the
        walk at the first chunk it doesn't change, exactly where the
        scalar loop would have stopped)."""
        rows = np.asarray(rows, dtype=np.int64)
        tval = np.uint64(t)

        # ---- min_targets
        floor = max(0, s - self.history_epochs)
        active = rows
        e_hi = s - 1
        while e_hi >= floor and active.size:
            echunk = e_hi // CHUNK_EPOCHS
            e_lo = max(floor, echunk * CHUNK_EPOCHS)
            arr = self._chunk("min", vchunk, echunk)
            c0 = e_lo - echunk * CHUNK_EPOCHS
            c1 = e_hi - echunk * CHUNK_EPOCHS + 1
            full = active.size == arr.shape[0]
            sub = arr[:, c0:c1] if full else arr[active, c0:c1]
            mask = (sub > tval).any(axis=1)
            if mask.all():
                if full:
                    np.minimum(sub, tval, out=sub)  # `sub` is a view
                else:
                    arr[active, c0:c1] = np.minimum(sub, tval)
                self._dirty.add(("min", vchunk, echunk))
            elif mask.any():
                # `sub` rows follow chunk order when full, `active` order
                # otherwise — pick the matching row index either way
                active = np.nonzero(mask)[0] if full else active[mask]
                arr[active, c0:c1] = np.minimum(sub[mask], tval)
                self._dirty.add(("min", vchunk, echunk))
            else:
                break  # monotone: every active row already ≤ t below here
            e_hi = e_lo - 1

        # ---- max_targets
        active = rows
        e_lo = s + 1
        while e_lo <= t and active.size:
            echunk = e_lo // CHUNK_EPOCHS
            e_hi2 = min(t, echunk * CHUNK_EPOCHS + CHUNK_EPOCHS - 1)
            arr = self._chunk("max", vchunk, echunk)
            c0 = e_lo - echunk * CHUNK_EPOCHS
            c1 = e_hi2 - echunk * CHUNK_EPOCHS + 1
            full = active.size == arr.shape[0]
            sub = arr[:, c0:c1] if full else arr[active, c0:c1]
            mask = (sub < tval).any(axis=1)
            if mask.all():
                if full:
                    np.maximum(sub, tval, out=sub)  # `sub` is a view
                else:
                    arr[active, c0:c1] = np.maximum(sub, tval)
                self._dirty.add(("max", vchunk, echunk))
            elif mask.any():
                active = np.nonzero(mask)[0] if full else active[mask]
                arr[active, c0:c1] = np.maximum(sub[mask], tval)
                self._dirty.add(("max", vchunk, echunk))
            else:
                break  # monotone: every active row already ≥ t above here
            e_lo = e_hi2 + 1

    # ---------------------------------------------------- bulk-replay feed

    def on_attestations_bulk(self, attestations) -> "list[list[Slashing]]":
        """Ingest a replay window's attestations at once:
        `[(attesting_indices, source, target, data_root), ...]` →
        per-attestation slashing lists, semantics identical to calling
        `on_attestation` in order.

        Validators that appear once in the whole window ("solo") have
        order-independent effects (per-validator decomposability, see
        module docstring): their checks batch per aggregate against the
        pre-window chunk state and their span updates merge into one
        chunk-aligned epoch grid — a single launch through `span_plane`.
        Validators seen more than once keep the exact sequential path,
        interleaved at their original positions."""
        norm = []
        for indices, source, target, root in attestations:
            norm.append((
                [int(i) for i in indices], int(source), int(target),
                bytes(root),
            ))
        if not norm:
            return []
        t0 = time.perf_counter()
        counts = _Counter()
        for ids, _s, _t, _root in norm:
            counts.update(ids)
        collision = {i for i, c in counts.items() if c > 1}

        hits: "dict[tuple[int, int], Slashing]" = {}
        solo_updates: "list[tuple[int, int, int]]" = []
        record_rows: "list[tuple[bytes, bytes]]" = []
        n_indices = 0
        for a, (ids, s, t, root) in enumerate(norm):
            n_indices += len(ids)
            solo_pos = [p for p, i in enumerate(ids) if i not in collision]
            for p, i in enumerate(ids):
                if i in collision:
                    hit = self._check_one(i, s, t, root)
                    if hit is not None:
                        hits[(a, p)] = hit
                    self._put_record(i, s, t, root)
                    self._update_spans(i, s, t)
            if solo_pos:
                solo_ids = [ids[p] for p in solo_pos]
                for p, hit in zip(solo_pos,
                                  self._check_rows(solo_ids, s, t, root)):
                    if hit is not None:
                        hits[(a, p)] = hit
                for i in solo_ids:
                    record_rows.extend(self._rec_rows(i, s, t, root))
                    solo_updates.append((i, s, t))
        if solo_updates:
            self._merge_span_updates(solo_updates)
        if record_rows:
            self.db.put_batch(record_rows)
        self.flush()
        self._observe_span_update(t0, n_indices)

        out: "list[list[Slashing]]" = [[] for _ in norm]
        for a, p in sorted(hits):
            out[a].append(hits[(a, p)])
        for lst in out:
            self.detected.extend(lst)
        return out

    def _merge_span_updates(self, updates) -> None:
        """Merge span updates for distinct validators `(i, s, t)` in one
        epoch-grid pass. The grid is the SPAN_GRID_EPOCHS window whose
        top chunk holds the batch's max target; a row rides the grid
        when its whole update range fits the int32 device contract
        (epochs below the grid take the vectorized host walk — the long
        min tail early-exits almost immediately). Rows that don't fit
        (tiny history floors above the grid base, ancient chunk values,
        epochs ≥ 2^30) fall back to the shared-(s, t) chunk walk."""
        grid_chunks = SP.SPAN_GRID_EPOCHS // CHUNK_EPOCHS
        max_t = max(t for _i, _s, t in updates)
        grid_lo_chunk = max(0, max_t // CHUNK_EPOCHS - (grid_chunks - 1))
        grid_lo = grid_lo_chunk * CHUNK_EPOCHS

        grid_rows = []      # (vchunk, row, s, t, floor)
        fallback = {}       # (vchunk, s, t) -> [rows]
        for i, s, t in updates:
            vchunk, row = divmod(i, VALIDATORS_PER_CHUNK)
            floor = max(0, s - self.history_epochs)
            if s >= grid_lo and floor <= grid_lo and t < _GRID_EPOCH_LIMIT:
                grid_rows.append((vchunk, row, s, t, floor))
            else:
                fallback.setdefault((vchunk, s, t), []).append(row)

        if grid_rows:
            self._merge_grid(grid_rows, grid_lo, grid_lo_chunk, grid_chunks,
                             fallback)
        for (vchunk, s, t), rows in fallback.items():
            self._update_spans_rows(vchunk, rows, s, t)

    def _merge_grid(self, grid_rows, grid_lo: int, grid_lo_chunk: int,
                    grid_chunks: int, fallback: dict) -> None:
        echunks = range(grid_lo_chunk, grid_lo_chunk + grid_chunks)
        by_vchunk: "dict[int, list]" = {}
        for entry in grid_rows:
            by_vchunk.setdefault(entry[0], []).append(entry)

        refs = []           # (vchunk, row, floor) per stacked grid row
        mins, maxs, srcs, tgts = [], [], [], []
        limit = np.uint64(_GRID_EPOCH_LIMIT)
        for vchunk, entries in by_vchunk.items():
            rows = np.asarray([e[1] for e in entries], np.int64)
            min_blk = np.hstack([
                self._chunk("min", vchunk, ec)[rows, :] for ec in echunks
            ])
            max_blk = np.hstack([
                self._chunk("max", vchunk, ec)[rows, :] for ec in echunks
            ])
            # int32 contract: every carried value must be UNSET or small.
            # Anything else (never on a real chain) exiles the row to the
            # host walk.
            ok = (
                ((min_blk == _UNSET_MIN) | (min_blk < limit)).all(axis=1)
                & (max_blk < limit).all(axis=1)
            )
            for pos, e in enumerate(entries):
                _vc, row, s, t, floor = e
                if ok[pos]:
                    refs.append((vchunk, row, floor))
                    mins.append(np.where(min_blk[pos] == _UNSET_MIN,
                                         np.uint64(SP.INT32_UNSET),
                                         min_blk[pos]).astype(np.int32))
                    maxs.append(max_blk[pos].astype(np.int32))
                    srcs.append(s)
                    tgts.append(t)
                else:
                    fallback.setdefault((vchunk, s, t), []).append(row)
        if not refs:
            return

        in_min = np.stack(mins)
        in_max = np.stack(maxs)
        src = np.asarray(srcs, np.int32)
        tgt = np.asarray(tgts, np.int32)
        out_min, out_max = self.span_plane.update(
            in_min, in_max, src, tgt, grid_lo
        )

        # scatter changed segments back and run the below-grid min tail
        changed_min = out_min != in_min
        changed_max = out_max != in_max
        new_min = np.where(out_min == SP.INT32_UNSET, _UNSET_MIN,
                           out_min.astype(np.int64).astype(np.uint64))
        new_max = out_max.astype(np.int64).astype(np.uint64)
        refs_vc = np.asarray([r[0] for r in refs], np.int64)
        refs_row = np.asarray([r[1] for r in refs], np.int64)
        refs_floor = np.asarray([r[2] for r in refs], np.int64)
        for vchunk in np.unique(refs_vc):
            sel = np.nonzero(refs_vc == vchunk)[0]
            rows = refs_row[sel]
            for k, ec in enumerate(echunks):
                seg = slice(k * CHUNK_EPOCHS, (k + 1) * CHUNK_EPOCHS)
                mmask = changed_min[sel, seg].any(axis=1)
                if mmask.any():
                    arr = self._chunk("min", int(vchunk), ec)
                    arr[rows[mmask], :] = new_min[sel[mmask], seg]
                    self._dirty.add(("min", int(vchunk), ec))
                xmask = changed_max[sel, seg].any(axis=1)
                if xmask.any():
                    arr = self._chunk("max", int(vchunk), ec)
                    arr[rows[xmask], :] = new_max[sel[xmask], seg]
                    self._dirty.add(("max", int(vchunk), ec))
            below = refs_floor[sel] < grid_lo
            if grid_lo > 0 and below.any():
                bs = sel[below]
                self._walk_min_below(
                    int(vchunk), refs_row[bs],
                    tgt[bs].astype(np.uint64), refs_floor[bs],
                    grid_lo - 1,
                )

    def _walk_min_below(self, vchunk: int, rows, tvals, floors,
                        e_start: int) -> None:
        """Vectorized min-side walk below the grid: per-row target values
        and history floors, shrinking active set for the monotone early
        exit (same stopping chunk as the scalar walk for every row)."""
        active = np.arange(len(rows))
        e_hi = e_start
        while e_hi >= 0 and active.size:
            active = active[floors[active] <= e_hi]
            if not active.size:
                break
            echunk = e_hi // CHUNK_EPOCHS
            e_lo_chunk = echunk * CHUNK_EPOCHS
            c1 = e_hi - e_lo_chunk + 1
            cols = np.arange(e_lo_chunk, e_lo_chunk + c1)
            arr = self._chunk("min", vchunk, echunk)
            sub = arr[rows[active], 0:c1]
            eligible = cols[None, :] >= floors[active][:, None]
            gt = eligible & (sub > tvals[active][:, None])
            rowmask = gt.any(axis=1)
            if rowmask.any():
                upd = active[rowmask]
                submat = arr[rows[upd], 0:c1]
                el = cols[None, :] >= floors[upd][:, None]
                hit = el & (submat > tvals[upd][:, None])
                arr[np.ix_(rows[upd], np.arange(c1))] = np.where(
                    hit, tvals[upd][:, None], submat
                )
                self._dirty.add(("min", vchunk, echunk))
            active = active[rowmask]
            e_hi = e_lo_chunk - 1

    def _observe_span_update(self, t0: float, n_indices: int) -> None:
        if self.metrics is None:
            return
        self.metrics.slasher_span_update_seconds.observe(
            time.perf_counter() - t0
        )
        self.metrics.slasher_span_indices.inc(n_indices)

    # ------------------------------------------------------------- pruning

    def prune(self, finalized_epoch: int) -> int:
        """Drop span chunks and records wholly below the history window
        (the reference prunes its span DBs at finalization). Incremental:
        the `sl:e:`/`sl:t:` indexes are ascending in epoch, so the walk
        visits exactly the doomed prefix and stops — O(pruned), not
        O(database)."""
        floor = max(0, finalized_epoch - self.history_epochs)
        floor_chunk = floor // CHUNK_EPOCHS
        dropped = 0
        doomed = []
        off = len(_PREFIX_ECHUNK_IDX)
        for key, _ in self.db.iterate_prefix(_PREFIX_ECHUNK_IDX):
            echunk = int.from_bytes(key[off : off + 8], "big")
            if echunk >= floor_chunk:
                break
            kind = "min" if key[off + 8 : off + 9] == b"m" else "max"
            vchunk = int.from_bytes(key[off + 9 : off + 17], "big")
            doomed.append((key, self._chunk_key(kind, vchunk, echunk)))
        for idx_key, data_key in doomed:
            self.db.delete(data_key)
            self.db.delete(idx_key)
            dropped += 1
        doomed = []
        off = len(_PREFIX_TGT_IDX)
        for key, _ in self.db.iterate_prefix(_PREFIX_TGT_IDX):
            target = int.from_bytes(key[off : off + 8], "big")
            if target >= floor:
                break
            validator = int.from_bytes(key[off + 8 : off + 16], "big")
            doomed.append((key, self._rec_key(validator, target)))
        for idx_key, data_key in doomed:
            self.db.delete(data_key)
            self.db.delete(idx_key)
            dropped += 1
        self._chunks = OrderedDict(
            (k, v)
            for k, v in self._chunks.items()
            if k[2] >= floor_chunk or k in self._dirty
        )
        self._sync_cache_gauge()
        return dropped

    # -------------------------------------------------------------- blocks

    def on_block(self, proposer_index: int, slot: int,
                 header_root: bytes) -> "Optional[Slashing]":
        key = _PREFIX_BLOCK + int(proposer_index).to_bytes(8, "big") \
            + int(slot).to_bytes(8, "big")
        existing = self.db.get(key)
        if existing is not None and bytes(existing) != bytes(header_root):
            hit = Slashing("double_block", int(proposer_index), {
                "slot": slot,
                "roots": [bytes(existing).hex(), bytes(header_root).hex()],
            })
            self.detected.append(hit)
            return hit
        self.db.put(key, bytes(header_root))
        return None

    def drain(self) -> "list[Slashing]":
        out = self.detected
        self.detected = []
        return out


__all__ = ["Slasher", "Slashing", "CHUNK_EPOCHS", "VALIDATORS_PER_CHUNK"]
