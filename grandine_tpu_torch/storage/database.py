"""Key-value database abstraction: the port's own copy of
grandine_tpu/storage/database.py (same keys, same snappy-framed values,
so a database file that one package writes the other reads) — reference:
database/src/lib.rs
(`Database::{persistent, in_memory}` :21-70: libmdbx env or `im::OrdMap`,
snappy value compression, prefix iteration).

Backends:
  Database.in_memory()        — sorted dict (tests, light nodes)
  Database.persistent(path)   — sqlite3 B-tree, WAL mode

Values are snappy-framed (the in-tree codec) like the reference's
compressed puts; keys are raw bytes ordered lexicographically.
"""

from __future__ import annotations

import bisect
import sqlite3
import threading
from typing import Iterator, Optional, Tuple

from grandine_tpu_torch.spec_tests.snappy import (
    frame_compress, frame_decompress)


class Database:
    """Interface; construct via `in_memory()` / `persistent(path)`."""

    @staticmethod
    def in_memory() -> "Database":
        return _MemoryDatabase()

    @staticmethod
    def persistent(path: str) -> "Database":
        return _SqliteDatabase(path)

    # -- operations --------------------------------------------------------

    def get(self, key: bytes) -> "Optional[bytes]":
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def put_batch(self, items) -> None:
        for k, v in items:
            self.put(k, v)

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def contains(self, key: bytes) -> bool:
        return self.get(key) is not None

    def iterate_prefix(
        self, prefix: bytes
    ) -> "Iterator[Tuple[bytes, bytes]]":
        """(key, value) pairs with `prefix`, ascending by key."""
        raise NotImplementedError

    def prev(self, prefix: bytes, upto: bytes) -> "Optional[Tuple[bytes, bytes]]":
        """Greatest key <= prefix+upto that still starts with `prefix`
        (the reference's cursor-prev lookups for 'latest at or before').
        Backends override with an indexed reverse lookup — the default
        would decode every value under the prefix."""
        best = None
        limit = prefix + upto
        for k, v in self.iterate_prefix(prefix):
            if k <= limit:
                best = (k, v)
            else:
                break
        return best

    def close(self) -> None:
        pass


def _prefix_upper_bound(prefix: bytes) -> "Optional[bytes]":
    """Smallest byte string greater than every key with `prefix`
    (None when the prefix is all 0xff)."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] != 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return None


class _MemoryDatabase(Database):
    def __init__(self) -> None:
        self._data: "dict[bytes, bytes]" = {}
        self._keys: "list[bytes]" = []
        self._lock = threading.Lock()

    def get(self, key: bytes) -> "Optional[bytes]":
        with self._lock:
            v = self._data.get(bytes(key))
        return None if v is None else frame_decompress(v)

    def put(self, key: bytes, value: bytes) -> None:
        key = bytes(key)
        with self._lock:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = frame_compress(bytes(value))

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._lock:
            if key in self._data:
                del self._data[key]
                i = bisect.bisect_left(self._keys, key)
                del self._keys[i]

    def iterate_prefix(self, prefix: bytes):
        prefix = bytes(prefix)
        with self._lock:
            start = bisect.bisect_left(self._keys, prefix)
            keys = self._keys[start:]
        for k in keys:
            if not k.startswith(prefix):
                break
            v = self.get(k)
            if v is not None:
                yield k, v

    def prev(self, prefix: bytes, upto: bytes):
        """Bisect on the sorted key list; only the hit is decompressed."""
        prefix = bytes(prefix)
        limit = prefix + bytes(upto)
        with self._lock:
            i = bisect.bisect_right(self._keys, limit) - 1
            key = self._keys[i] if 0 <= i < len(self._keys) else None
        if key is None or not key.startswith(prefix):
            return None
        v = self.get(key)
        return None if v is None else (key, v)


class _SqliteDatabase(Database):
    def __init__(self, path: str) -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv"
                " (key BLOB PRIMARY KEY, value BLOB NOT NULL)"
            )
            self._conn.commit()

    def get(self, key: bytes) -> "Optional[bytes]":
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE key = ?", (bytes(key),)
            ).fetchone()
        return None if row is None else frame_decompress(row[0])

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (key, value) VALUES (?, ?)",
                (bytes(key), frame_compress(bytes(value))),
            )
            self._conn.commit()

    def put_batch(self, items) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO kv (key, value) VALUES (?, ?)",
                [(bytes(k), frame_compress(bytes(v))) for k, v in items],
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE key = ?", (bytes(key),))
            self._conn.commit()

    def iterate_prefix(self, prefix: bytes):
        prefix = bytes(prefix)
        upper = _prefix_upper_bound(prefix)
        with self._lock:
            if upper is None:
                rows = self._conn.execute(
                    "SELECT key, value FROM kv WHERE key >= ?"
                    " ORDER BY key ASC",
                    (prefix,),
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT key, value FROM kv WHERE key >= ? AND key < ?"
                    " ORDER BY key ASC",
                    (prefix, upper),
                ).fetchall()
        for k, v in rows:
            if bytes(k).startswith(prefix):
                yield bytes(k), frame_decompress(v)

    def prev(self, prefix: bytes, upto: bytes):
        """One indexed reverse lookup; only the hit is decompressed."""
        prefix = bytes(prefix)
        limit = prefix + bytes(upto)
        with self._lock:
            row = self._conn.execute(
                "SELECT key, value FROM kv WHERE key >= ? AND key <= ?"
                " ORDER BY key DESC LIMIT 1",
                (prefix, limit),
            ).fetchone()
        if row is None or not bytes(row[0]).startswith(prefix):
            return None
        return bytes(row[0]), frame_decompress(row[1])

    def close(self) -> None:
        with self._lock:
            self._conn.close()


__all__ = ["Database"]
