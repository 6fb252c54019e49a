"""Build and bind the CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into its own shared library
with a plain C interface, loaded with ctypes — no PyTorch headers; the
nvcc processes run in parallel. A library lands in csrc/build/
(git-ignored) beside a `.srchash` file holding the hash of its sources
and flags; a changed source rebuilds on first use, and no binary ships in
the repository. Nothing here runs at import: `library()` builds and loads
on the first launch.

`launch(name, *args)` is the one call site of every kernel: it checks
that each tensor argument lies on the same CUDA device, appends the
device's constant table and PyTorch's current stream, and raises when the
C entry returns a CUDA error (a refused launch never runs, and a later
synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

from grandine_tpu_torch.crypto import curves
from grandine_tpu_torch.crypto.curves import G1
from grandine_tpu_torch.gpu import limbs as L

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
#: the headers every source may include (csrc/*.cuh): part of each
#: library's hash
HEADERS = ("bls12_381.cuh", "finish_tail.cuh", "finish_programs.cuh",
           "glv_halves.cuh")
#: source → the C entries it exports (each `bls_<name>`)
LIBRARIES = {
    "decompress.cu": ("g1_decompress", "g2_decompress_subgroup",
                      "g2_decompress_subgroup_geometry", "g2_subgroup_check",
                      "g2_subgroup_check_geometry", "unpack_words"),
    "aggregate.cu": ("aggregate_rlc_scale",),
    "multi.cu": ("multi_rlc_scale", "g1_group_sum", "g2_group_sum",
                 "launch_geometry"),
    "pairing.cu": ("miller_loop_pairs", "miller_loop_pairs_geometry",
                   "rlc_finish", "rlc_finish_geometry", "rlc_partial",
                   "rlc_partial_geometry"),
    "sign.cu": ("batch_sign", "batch_sign_geometry", "batch_pubkey"),
    "normalize.cu": ("g1_normalize", "g2_normalize"),
    "kzg.cu": ("g1_scalar_mul", "g1_scalar_mul_geometry"),
    "ed25519.cu": ("ed25519_verify",),
    "spans.cu": ("span_update_grid",),
    "msm.cu": ("g1_msm_lane_scan", "g2_msm_lane_scan",
               "g1_msm_bucket_reduce", "g2_msm_bucket_reduce",
               "g1_msm_horner", "g2_msm_horner", "msm_horner_geometry"),
}
#: granule of the per-thread stack limit. The limit `library()` sets is
#: the deepest kernel's need (ptxas "cumulative stack size") rounded up to
#: it: CUDA's default of 1 KiB is too small for the pairing kernels, and a
#: chain deeper than the limit overruns it silently (a wrong verdict, no
#: error). The limit holds for the whole CUDA context and the driver
#: reserves it for every thread the card can hold at once — on an H100
#: (132 SMs × 2,048 threads) 264 MiB of device memory per KiB.
STACK_GRANULE = 1024
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp, _i = ctypes.c_void_p, ctypes.c_int
#: C entry → argument types (tensor pointers, ints), before the trailing
#: constant-table pointer and stream that `launch` appends
SIGNATURES = {
    "g1_decompress": [_vp, _vp, _vp, _vp, _i],
    "g2_decompress_subgroup": [_vp, _vp, _vp, _vp, _i, _vp],
    "g2_decompress_subgroup_geometry": [_i, _vp],
    "g2_subgroup_check": [_vp, _vp, _vp, _vp, _i],
    "g2_subgroup_check_geometry": [_i, _vp],
    "aggregate_rlc_scale": [_vp, _vp, _vp, _vp, _i, _i, _vp, _vp, _vp,
                            _vp, _vp, _vp, _vp],
    "multi_rlc_scale": [_vp, _vp, _vp, _i, _i, _vp, _vp, _vp, _vp, _vp,
                        _vp],
    "miller_loop_pairs": [_vp, _vp, _vp, _vp, _i, _i],
    "miller_loop_pairs_geometry": [_i, _i, _vp],
    "g1_group_sum": [_vp, _vp, _i, _vp],
    "g2_group_sum": [_vp, _vp, _i, _vp],
    "batch_sign": [_vp, _vp, _vp, _i, _i, _vp],
    "batch_sign_geometry": [_i, _i, _vp],
    "g1_scalar_mul": [_vp, _vp, _vp, _vp, _i, _vp],
    "g1_scalar_mul_geometry": [_i, _vp],
    "ed25519_verify": [_vp, _vp, _vp, _vp, _i, _vp, _vp, _vp],
    "span_update_grid": [_vp, _vp, _vp, _vp, _vp, _i, _i, _vp, _vp],
    "launch_geometry": [_i, _i, _i, _vp],
    "rlc_finish": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                   _vp],
    "rlc_finish_geometry": [_i, _i, _i, _i, _vp],
    "rlc_partial": [_vp, _vp, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
    "rlc_partial_geometry": [_i, _vp],
    "batch_pubkey": [_vp, _vp, _i, _vp, _vp],
    "g1_normalize": [_vp, _i, _vp, _vp],
    "g2_normalize": [_vp, _i, _vp, _vp],
    "unpack_words": [_vp, _i, _vp],
    **{f"g{k}_msm_lane_scan": [_vp, _vp, _vp, _i, _vp, _vp, _vp, _i, _i, _vp]
       for k in (1, 2)},
    **{f"g{k}_msm_bucket_reduce": [_vp, _vp, _vp, _i, _i, _i, _vp]
       for k in (1, 2)},
    **{f"g{k}_msm_horner": [_vp, _i, _i, _i, _vp] for k in (1, 2)},
    "msm_horner_geometry": [_i, _i, _vp],
}

_lock = threading.Lock()
_lib = None
_lib_setter = None
_tables: dict = {}
#: devices whose context has the stack limit
_limited: set = set()
#: the per-thread stack limit `library()` set, in bytes
stack_limit = 0
#: nvcc's report of the last build (registers, spills, shared memory)
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_hash(source: str) -> str:
    h = hashlib.sha256()
    for name in (source, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _lib_path(source: str) -> str:
    return os.path.join(BUILD_DIR, "lib" + source[:-3] + ".so")


def build(force: bool = False) -> "dict[str, str]":
    """Compile every library whose sources changed, all nvcc processes at
    once; returns {source: library path}."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for source in LIBRARIES:
        lib = _lib_path(source)
        stamp = lib + ".srchash"
        digest = source_hash(source)
        if not force and all(os.path.exists(f)
                             for f in (lib, stamp, lib + ".log")):
            with open(stamp) as f:
                if f.read().strip() == digest:
                    continue
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib + ".tmp",
               os.path.join(CSRC, source)]
        jobs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        digest)
    t0, outs = time.perf_counter(), {}

    def wait(source, proc):  # each nvcc's output and wall time
        out, _ = proc.communicate()
        outs[source] = (out, time.perf_counter() - t0)

    waiters = [threading.Thread(target=wait, args=(source, proc))
               for source, (proc, _) in jobs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failed = [], []
    for source, (proc, digest) in jobs.items():
        out, secs = outs[source]
        logs.append(f"== {source} ({secs:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(source)
            continue
        lib = _lib_path(source)
        with open(lib + ".log", "w") as f:
            f.write(out)
        os.replace(lib + ".tmp", lib)
        with open(lib + ".srchash", "w") as f:
            f.write(digest)
    if jobs:
        build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    return {source: _lib_path(source) for source in LIBRARIES}


def stack_need(path: str) -> int:
    """The largest per-thread stack ptxas reported for a library's
    kernels (its build log beside it)."""
    with open(path + ".log") as f:
        sizes = re.findall(r"(\d+) bytes cumulative stack size", f.read())
    return max((int(n) for n in sizes), default=0)


def library():
    """{C entry name: ctypes function}, built and loaded on first use; sets
    the per-thread stack limit to the deepest kernel's need."""
    global _lib, _lib_setter
    with _lock:
        if _lib is None:
            fns, need, setter = {}, 0, None
            for source, path in build().items():
                need = max(need, stack_need(path))
                lib = ctypes.CDLL(path)
                for name in LIBRARIES[source]:
                    fn = getattr(lib, "bls_" + name)
                    fn.argtypes = SIGNATURES[name] + [_vp, _vp]
                    fn.restype = ctypes.c_int
                    fns[name] = fn
                if hasattr(lib, "bls_set_stack_limit"):
                    setter = lib.bls_set_stack_limit
                    setter.argtypes = [ctypes.c_size_t]
                    setter.restype = ctypes.c_int
            _set_limit(setter,
                       max(1, -(-need // STACK_GRANULE)) * STACK_GRANULE)
            _lib = fns
            _lib_setter = setter
        return _lib


def _set_limit(setter, nbytes: int) -> None:
    global stack_limit
    err = setter(nbytes)
    if err != 0:
        raise RuntimeError(f"cudaDeviceSetLimit failed: {err}")
    stack_limit = nbytes
    _limited.add(torch.cuda.current_device())


def set_stack_limit(nbytes: int) -> None:
    """cudaDeviceSetLimit(cudaLimitStackSize, nbytes) for the current
    device's context; `library()` sets the kernels' need."""
    library()
    _set_limit(_lib_setter, nbytes)


def constant_table_ints() -> "list[int]":
    """The words of csrc/bls12_381.cuh's constant table (enum ConstIdx),
    as ints, in table order."""
    P = L.P
    R = L.R_MONT

    def mont(v):
        return v * R % P

    endo = curves.endo_constants()
    (cx0, cx1), (cy0, cy1) = curves.psi_constants_ints()
    neg = (-G1).to_affine()
    return [
        L.R2, R % P, mont(4), mont((P + 1) // 2), (P + 1) // 2,
        (P + 1) // 4, P - 2,
        mont(endo["g1"][0]), mont(endo["g1"][1]),
        mont(endo["g2"][0]), mont(endo["g2"][1]),
        mont(cx0), mont(cx1), mont(cy0), mont(cy1),
        mont(neg[0].n), mont(neg[1].n), (P - 3) // 4,
    ]


def constant_table(device) -> torch.Tensor:
    key = str(device)
    t = _tables.get(key)
    if t is None:
        t = torch.from_numpy(L.ints_to_words(constant_table_ints()).copy())
        t = t.to(device)
        _tables[key] = t
    return t


#: (GLV halves, 4-bit windows of a 128-bit half, nonzero digits) of the
#: batch_pubkey comb table (csrc/sign.cu)
COMB_SHAPE = (2, 32, 15)
_comb_ints: "list[int] | None" = None


def comb_table_ints() -> "list[int]":
    """The batch_pubkey comb as ints in table order: the affine x, y of
    T[h][j][d − 1] = [d·16ʲ·λʰ]g1 (λ = x² mod r), Montgomery form. Half 0
    by additions along each window (16ʲ·g1 by four doublings a window),
    half 1 by the endomorphism φ = [λ] on G1, (βx·x, βy·y); once a
    process."""
    global _comb_ints
    if _comb_ints is None:
        P, R = L.P, L.R_MONT
        bx, by = curves.endo_constants()["g1"]
        halves, windows, digits = COMB_SHAPE
        pts, base = [], G1
        for _ in range(windows):
            acc = base
            for _ in range(digits):
                pts.append(acc.to_affine())
                acc = acc + base
            for _ in range(4):
                base = base.double()
        xy = [(x.n, y.n) for x, y in pts]
        xy += [(bx * x % P, by * y % P) for x, y in xy]
        _comb_ints = [v * R % P for pair in xy for v in pair]
    return _comb_ints


def comb_table(device) -> torch.Tensor:
    """The batch_pubkey comb (`comb_table_ints`) as (2, 32, 15, 2, 12)
    int32 words on `device`, built at first use and kept beside the
    constant table (92,160 bytes)."""
    key = ("comb", str(device))
    t = _tables.get(key)
    if t is None:
        t = torch.from_numpy(L.ints_to_words(comb_table_ints()).reshape(
            *COMB_SHAPE, 2, L.NWORDS).copy()).to(device)
        _tables[key] = t
    return t


def launch(name: str, *args) -> None:
    """Call C entry `bls_<name>` with tensors as device pointers (on the
    current device when none is given)."""
    lib = library()
    device = None
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.device.type != "cuda" or not a.is_contiguous():
                raise ValueError(f"{name}: every tensor must be a contiguous "
                                 f"CUDA tensor, got {a.device}")
            if device is None:
                device = a.device
            elif a.device != device:
                raise ValueError(f"{name}: tensors on {device} and {a.device}")
            cargs.append(ctypes.c_void_p(a.data_ptr()))
        else:
            cargs.append(a)
    if device is None:  # a query with no tensor: the current device
        device = torch.device("cuda", torch.cuda.current_device())
    table = constant_table(device)
    with torch.cuda.device(device):
        if device.index not in _limited:
            _set_limit(_lib_setter, stack_limit)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib[name](*cargs, ctypes.c_void_p(table.data_ptr()),
                        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


__all__ = ["build", "library", "launch", "constant_table",
           "constant_table_ints", "comb_table", "comb_table_ints",
           "source_hash", "build_log"]
