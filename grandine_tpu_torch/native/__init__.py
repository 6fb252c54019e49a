"""The port's host-side native code: CRC-32C for the snappy framing of
its storage (src/crc32c.cpp, the port's own copy of the CRC part of
grandine_tpu/native/src/gtnative.cpp).

`crc_lib()` compiles the source with g++ on first use into the
git-ignored grandine_tpu_torch/csrc/build/ (beside the CUDA libraries),
keyed by a hash of the source and flags, and loads it with ctypes. It
returns None when no toolchain is there or the build fails: the caller
(spec_tests/snappy.py) then takes the table-driven Python loop, as the
reference does without its native extension. Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "src", "crc32c.cpp")
BUILD_DIR = os.path.join(_PKG, "csrc", "build")
LIBRARY = os.path.join(BUILD_DIR, "libcrc32c.so")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_state: dict = {}


def _digest() -> str:
    with open(SOURCE, "rb") as f:
        src = f.read()
    return hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()


def _build() -> bool:
    """(Re)build the library when its stamp differs from the source hash;
    False when g++ is missing or fails. A per-process temporary name keeps
    parallel first builds (test workers) from interleaving writes."""
    digest = _digest()
    stamp = LIBRARY + ".srchash"
    try:
        with open(stamp) as f:
            if f.read().strip() == digest and os.path.exists(LIBRARY):
                return True
    except OSError:
        pass
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, LIBRARY)
        with open(f"{stamp}.{os.getpid()}.tmp", "w") as f:
            f.write(digest)
        os.replace(f"{stamp}.{os.getpid()}.tmp", stamp)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        for leftover in (tmp, f"{stamp}.{os.getpid()}.tmp"):
            try:
                os.unlink(leftover)
            except OSError:
                pass
        return False
    return True


def crc_lib():
    """The loaded CRC-32C library (`gt_crc32c(data, len)`,
    `gt_crc32c_hw()`), built on first use; None when it cannot be built
    or loaded."""
    if "lib" in _state:
        return _state["lib"]
    with _lock:
        if "lib" not in _state:
            lib = None
            if _build():
                try:
                    lib = ctypes.CDLL(LIBRARY)
                    lib.gt_crc32c.argtypes = [ctypes.c_char_p,
                                              ctypes.c_uint64]
                    lib.gt_crc32c.restype = ctypes.c_uint32
                    lib.gt_crc32c_hw.argtypes = []
                    lib.gt_crc32c_hw.restype = ctypes.c_int
                except (OSError, AttributeError):
                    lib = None
            _state["lib"] = lib
    return _state["lib"]


__all__ = ["crc_lib", "LIBRARY", "SOURCE"]
