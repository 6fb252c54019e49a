"""Cycles of the pieces of `rlc_finish`'s tail, and of the ladder steps of
`batch_sign` and `g1_scalar_mul`, on the card.

    python -m grandine_tpu_torch.gpu.tail_bench

Builds csrc/tail_bench.cu with nvcc (sm_90a) into csrc/build/ and times,
on one warp of one block with clock64: the Fp product, one of the
cyclotomic square's output forms, every warp program of
csrc/finish_programs.cuh (on seeded values: the G2 addition takes its
generic case), the Euclid inversion, the one-thread Fp12 product and G2
addition of the block's folds and a whole final exponentiation; the Fp
addition and subtraction, the G1 doubling and mixed addition (their Fp
products inlined, and on `fpc`, as calls), the G2 doubling and mixed
addition and the Fp2 product, each on every lane of the warp. Prints
the card's name and power limit, one line an operation (cycles, and µs at
the card's maximum SM clock) and one JSON object. Needs a card: it raises
without one.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from grandine_tpu_torch.crypto.constants import P
from grandine_tpu_torch.gpu import _build
from grandine_tpu_torch.gpu import finish_programs as FP
from grandine_tpu_torch.gpu import limbs as L

SOURCE = os.path.join(_build.CSRC, "tail_bench.cu")
LIBRARY = os.path.join(_build.BUILD_DIR, "libtail_bench.so")
#: (name, operation id of tail_bench.cu, repetitions)
PIECES = [("fp_mul (a lane)", -1, 1000), ("form (CYC_SQ output)", -2, 1000),
          ("Euclid inversion (one lane)", -3, 20),
          ("fp12_mul_to (one thread)", -4, 20),
          ("point_add_complete (one thread)", -5, 20),
          ("final exponentiation", -6, 1),
          ("fp_add (a lane)", -7, 1000), ("fp_sub (a lane)", -8, 1000),
          ("G1 point_double (a lane)", -9, 100),
          ("G1 point_madd_unsafe (a lane)", -11, 100),
          ("G2 point_double (a lane)", -12, 50),
          ("G2 point_madd_unsafe (a lane)", -13, 50),
          ("fp2_mul (a lane)", -14, 200),
          ("G1 point_double, products as calls (a lane)", -15, 100),
          ("G1 point_madd_unsafe, products as calls (a lane)", -16, 100)]


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("tail_bench measures the card: no CUDA device")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", LIBRARY,
                    SOURCE], check=True, capture_output=True)
    lib = ctypes.CDLL(LIBRARY)
    card, clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].rsplit(", ", 1)
    hz = float(clock.split()[0]) * 1e6
    K = _build.constant_table(torch.device("cuda"))
    rng = np.random.default_rng(13)
    seed = torch.from_numpy(L.ints_to_words(
        [int.from_bytes(rng.bytes(48), "little") % P for _ in range(200)]
    ).copy()).cuda()
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    names = [p.name for p in FP.programs()]
    pieces = PIECES + [(f"program {n}", i, 20) for i, n in enumerate(names)]
    print(card)
    result = {}
    for name, what, reps in pieces:
        err = lib.tail_bench(what, reps, ctypes.c_void_p(out.data_ptr()),
                             ctypes.c_void_p(seed.data_ptr()),
                             ctypes.c_void_p(K.data_ptr()))
        if err:
            raise RuntimeError(f"tail_bench {name}: CUDA error {err}")
        cycles = int(out[0])
        result[name] = cycles
        print(f"{name}: {cycles} cycles, {cycles / hz * 1e6:.2f} µs at "
              f"{clock}")
    print(json.dumps({"card": card, "max_sm_clock": clock,
                      "cycles": result}))


if __name__ == "__main__":
    main()
