"""The port's storage layer on the CPU against the JAX package, exact: the
snappy framing (spec_tests/snappy.py) byte for byte the reference's, with
the CRC-32C of its native library (native/) equal to the table loop; the
key-value `Database` (storage/database.py) in memory and on sqlite3
operation for operation the reference's; a database file written by one
package read by the other; and slasher state carried across the two
packages both ways — through one sqlite file, and through an in-memory
copy (`put_batch(db.iterate_prefix(b"sl:"))`) — with hits and the final
`sl:` keyspace equal to one JAX slasher that ingested the whole stream."""

import random
import struct

import pytest

import grandine_tpu.slasher as JSL
from grandine_tpu.spec_tests import snappy as JN
from grandine_tpu.storage.database import Database as JaxDatabase
import grandine_tpu_torch.slasher as PSL
import grandine_tpu_torch.storage as PST
from grandine_tpu_torch import native
from grandine_tpu_torch.spec_tests import snappy as N
from grandine_tpu_torch.storage.database import Database
from grandine_tpu_torch.testing.slasher import epoch_window

# --- snappy framing and CRC-32C --------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 40, 32_768, 65_536, 65_537, 200_003])
def test_frame_compress_is_the_reference_bytes(size):
    data = random.Random(size).randbytes(size)
    framed = N.frame_compress(data)
    assert framed == JN.frame_compress(data)
    assert N.frame_decompress(JN.frame_compress(data)) == data
    assert JN.frame_decompress(framed) == data


def test_crc32c_check_value_native_and_table():
    assert N._crc32c(b"123456789") == 0xE3069283
    assert N._crc32c_py(b"123456789") == 0xE3069283
    assert native.crc_lib() is not None
    assert N.crc_engine().startswith("native")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_and_table_crc_agree(seed):
    rng = random.Random(seed)
    lib = native.crc_lib()
    for n in [0, 1, 7, 8, 9, 63, 64, 65] + [rng.randrange(5000)
                                            for _ in range(20)]:
        data = rng.randbytes(n)
        assert lib.gt_crc32c(data, n) == N._crc32c_py(data) == JN._crc32c(
            data)


def test_crc_falls_back_to_the_table_loop(monkeypatch):
    data = random.Random(5).randbytes(3000)
    want = N.frame_compress(data)
    monkeypatch.setattr(native, "crc_lib", lambda: None)
    assert N.crc_engine() == "python (table)"
    assert N.frame_compress(data) == want
    assert N.frame_decompress(want) == data


def _raw_block(out_len, ops):
    """A raw snappy block: varint length, then literal / copy elements."""
    head = bytearray()
    n = out_len
    while True:
        b = n & 0x7F
        n >>= 7
        head.append(b | (0x80 if n else 0))
        if not n:
            break
    return bytes(head) + b"".join(ops)


def _literal(data):
    if len(data) <= 60:
        return bytes([(len(data) - 1) << 2]) + data
    return bytes([61 << 2]) + (len(data) - 1).to_bytes(2, "little") + data


RAW = [
    _raw_block(5, [_literal(b"hello")]),
    # copy, 1-byte offset: 4 bytes from offset 3 (overlapping run)
    _raw_block(7, [_literal(b"abc"), bytes([(0 << 2) | 1, 3])]),
    # copy, 2-byte offset: 10 bytes from offset 70 over a long literal
    _raw_block(90, [_literal(bytes(range(80))),
                    bytes([(9 << 2) | 2]) + (70).to_bytes(2, "little")]),
    # copy, 4-byte offset, run-length of one byte
    _raw_block(33, [_literal(b"z"),
                    bytes([(31 << 2) | 3]) + (1).to_bytes(4, "little")]),
]


@pytest.mark.parametrize("block", RAW)
def test_raw_decompress_is_the_reference(block):
    out = N.raw_decompress(block)
    assert out == JN.raw_decompress(block)
    # and inside a frame, as a compressed chunk with its masked CRC
    body = struct.pack("<I", N._masked_crc(out)) + block
    framed = (N._STREAM_ID + bytes([N._CHUNK_COMPRESSED])
              + len(body).to_bytes(3, "little") + body)
    assert N.frame_decompress(framed) == JN.frame_decompress(framed) == out


BAD = {
    "no stream id": b"\x01\x05\x00\x00abcde",
    "truncated header": N._STREAM_ID + b"\x01\x05",
    "truncated chunk": N._STREAM_ID + b"\x01\x09\x00\x00abc",
    "checksum": N._STREAM_ID + b"\x01\x05\x00\x00\x00\x00\x00\x00x",
    "unknown chunk": N._STREAM_ID + b"\x03\x01\x00\x00x",
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_frames_raise_as_the_reference(case):
    with pytest.raises(ValueError) as port:
        N.frame_decompress(BAD[case])
    with pytest.raises(ValueError) as ref:
        JN.frame_decompress(BAD[case])
    assert str(port.value) == str(ref.value)


# --- Database --------------------------------------------------------------


def _databases(kind, tmp_path):
    if kind == "memory":
        return JaxDatabase.in_memory(), Database.in_memory()
    return (JaxDatabase.persistent(str(tmp_path / "jax.sqlite")),
            Database.persistent(str(tmp_path / "port.sqlite")))


def _script(db):
    """Every operation of the interface; returns what each read saw."""
    seen = []
    db.put(b"a1", b"v1")
    db.put(b"a2", b"v2" * 40_000)
    db.put_batch([(b"x" + bytes([i]), bytes([i]) * 3) for i in range(6)])
    db.put_batch([(b"\xff\xff", b"a"), (b"\xff\xff\x01", b"b"),
                  (b"y\x00", b"other"), (b"a1", b"v1'")])
    db.delete(b"x\x02")
    db.delete(b"missing")
    for key in (b"a1", b"a2", b"x\x02", b"missing"):
        seen.append((db.get(key), db.contains(key)))
    for prefix in (b"x", b"\xff\xff", b"a", b"", b"q"):
        seen.append(list(db.iterate_prefix(prefix)))
    for prefix, upto in ((b"x", b"\x03"), (b"x", b"\x02"), (b"x", b""),
                         (b"a", b"3"), (b"q", b"\x00")):
        seen.append(db.prev(prefix, upto))
    return seen


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_database_matches_the_reference(kind, tmp_path):
    jax_db, port_db = _databases(kind, tmp_path)
    try:
        assert _script(port_db) == _script(jax_db)
    finally:
        jax_db.close()
        port_db.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_file_crosses_packages(writer, tmp_path):
    path = str(tmp_path / "db.sqlite")
    first, second = ((JaxDatabase, Database) if writer == "jax"
                     else (Database, JaxDatabase))
    db = first.persistent(path)
    want = _script(db)
    everything = list(db.iterate_prefix(b""))
    db.close()
    db = second.persistent(path)
    try:
        assert list(db.iterate_prefix(b"")) == everything
        assert db.get(b"a2") == want[1][0] == b"v2" * 40_000
    finally:
        db.close()


def test_storage_package_exports_database_only():
    assert PST.__all__ == ["Database"] and PST.Database is Database


# --- slasher state carried across the packages ------------------------------


def _stream():
    """A slasher stream as (method, args) calls: four epoch windows at 512
    validators through the bulk feed, aggregates one at a time (a
    surround, a double vote), a poisoned window and double proposals."""
    calls = [("on_attestations_bulk", (epoch_window(512, t, seed=t),))
             for t in (96, 97)]
    calls += [("on_block", (5, 3100, b"\x01" * 32)),
              ("on_attestation", ([1, 2, 3], 96, 98, b"\x0a" * 32)),
              ("on_attestation", ([4, 300], 80, 98, b"\x0b" * 32))]
    calls += [("on_attestations_bulk", (epoch_window(512, t, seed=t),))
              for t in (98, 99)]
    last = epoch_window(512, 100, seed=100)
    last.append((last[0][0][:2], 99, 100, b"\xee" * 32))
    last.append((last[7][0][:1], 70, 101, b"\xef" * 32))
    calls += [("on_attestations_bulk", (last,)),
              ("on_block", (5, 3100, b"\x02" * 32)),
              ("on_attestation_reference", ([8, 9], 99, 100, b"\x0c" * 32))]
    return calls


def _run(sl, calls):
    out = []
    for method, args in calls:
        got = getattr(sl, method)(*args)
        hits = got if isinstance(got, list) else [got]
        out.append([[(h.kind, h.validator_index, h.evidence) for h in x]
                    if isinstance(x, list) else
                    x and (x.kind, x.validator_index, x.evidence)
                    for x in hits])
    return out


def _dump(db):
    return [(bytes(k), bytes(v)) for k, v in db.iterate_prefix(b"sl:")]


@pytest.fixture(scope="module")
def whole_stream():
    """One JAX slasher over the whole stream: its hits and keyspace."""
    sl = JSL.Slasher()
    hits = _run(sl, _stream())
    return hits, _dump(sl.db)


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("medium", ["sqlite file", "in-memory copy"])
def test_slasher_state_crosses_packages(first, medium, whole_stream,
                                        tmp_path):
    """One package ingests the first half of the stream, the other the
    rest over the state the first left: hits and the final keyspace are
    those of one JAX slasher that ingested everything."""
    calls = _stream()
    half = len(calls) // 2
    packages = {"jax": (JSL.Slasher, JaxDatabase, {}),
                "port": (PSL.Slasher, Database, {"device": "cpu"})}
    order = [first, "port" if first == "jax" else "jax"]
    path = str(tmp_path / "slasher.sqlite")
    hits, db = [], None
    for k, (part, name) in enumerate(zip((calls[:half], calls[half:]),
                                         order)):
        cls, db_cls, kw = packages[name]
        if medium == "sqlite file":
            db = db_cls.persistent(path)
        elif k == 0:
            db = db_cls.in_memory()
        else:
            copy = db_cls.in_memory()
            copy.put_batch(db.iterate_prefix(b"sl:"))
            db = copy
        hits += _run(cls(db, **kw), part)
        if medium == "sqlite file" and k == 0:
            db.close()
    want_hits, want_dump = whole_stream
    assert hits == want_hits
    assert sum(len(h) for call in hits for h in call
               if isinstance(h, list)) > 0
    assert _dump(db) == want_dump
    if medium == "sqlite file":
        db.close()
