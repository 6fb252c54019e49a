"""Dependency-free snappy codec (framing format + raw block decode): the
port's own copy of grandine_tpu/spec_tests/snappy.py, byte for byte the
same framing, so a database file that one package writes the other reads.

The consensus-spec-tests store SSZ payloads as `.ssz_snappy` (snappy
framing format, RFC-less but specified in google/snappy framing_format.txt).
Decoding handles compressed and uncompressed chunks; encoding emits
uncompressed chunks (valid framing, no compressor needed — we only encode
our own generated vectors).

CRC32-C checksums are verified on decode (the masked CRC of the framing
spec), computed by the port's native library (grandine_tpu_torch/native,
SSE4.2) where it builds, and by a small table-driven loop otherwise.
"""

from __future__ import annotations

import struct

from grandine_tpu_torch import native

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_CHUNK_PADDING = 0xFE

_MAX_CHUNK = 65536


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def _crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _crc32c(data: bytes) -> int:
    """CRC-32C via the port's native library (SSE4.2 hardware instruction)
    when it builds; table-driven Python fallback otherwise. Every DB put
    runs through here, so the native path is load-bearing at scale."""
    lib = native.crc_lib()
    if lib is not None:
        return lib.gt_crc32c(bytes(data), len(data))
    return _crc32c_py(data)


def crc_engine() -> str:
    """Which CRC-32C `_crc32c` runs: "native (SSE4.2)", "native (table)"
    or "python (table)"."""
    lib = native.crc_lib()
    if lib is None:
        return "python (table)"
    return "native (SSE4.2)" if lib.gt_crc32c_hw() else "native (table)"


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ raw decoding


def raw_decompress(data: bytes) -> bytes:
    """Decode one raw snappy block."""
    # varint uncompressed length
    n = 0
    shift = 0
    pos = 0
    while True:
        if pos >= len(data):
            raise ValueError("snappy: truncated varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            out += data[pos : pos + length]
            pos += length
        else:
            if kind == 1:  # copy, 1-byte offset
                length = ((tag >> 2) & 0x07) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:  # copy, 2-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise ValueError("snappy: bad copy offset")
            start = len(out) - offset
            for i in range(length):  # may overlap (run-length semantics)
                out.append(out[start + i])
    if len(out) != n:
        raise ValueError(f"snappy: expected {n} bytes, got {len(out)}")
    return bytes(out)


# --------------------------------------------------------------- framing


def frame_decompress(data: bytes) -> bytes:
    if not data.startswith(_STREAM_ID):
        raise ValueError("snappy: missing stream identifier")
    pos = len(_STREAM_ID)
    out = bytearray()
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError("snappy: truncated chunk header")
        kind = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        chunk = data[pos : pos + length]
        if len(chunk) != length:
            raise ValueError("snappy: truncated chunk")
        pos += length
        if kind == _CHUNK_COMPRESSED or kind == _CHUNK_UNCOMPRESSED:
            crc = struct.unpack("<I", chunk[:4])[0]
            payload = chunk[4:]
            if kind == _CHUNK_COMPRESSED:
                payload = raw_decompress(payload)
            if _masked_crc(payload) != crc:
                raise ValueError("snappy: checksum mismatch")
            out += payload
        elif kind >= 0x80 or kind == _CHUNK_PADDING:
            continue  # skippable
        else:
            raise ValueError(f"snappy: unknown chunk type {kind:#x}")
    return bytes(out)


def frame_compress(data: bytes) -> bytes:
    """Encode with uncompressed chunks (valid framing, zero compression)."""
    out = bytearray(_STREAM_ID)
    for i in range(0, max(len(data), 1), _MAX_CHUNK):
        chunk = data[i : i + _MAX_CHUNK]
        body = struct.pack("<I", _masked_crc(chunk)) + chunk
        out += bytes([_CHUNK_UNCOMPRESSED]) + len(body).to_bytes(3, "little")
        out += body
    return bytes(out)


__all__ = ["frame_compress", "frame_decompress", "raw_decompress",
           "crc_engine"]
