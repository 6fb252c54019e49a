// Cycles (clock64, one warp, one block) of the pieces of rlc_finish's tail
// (csrc/finish_tail.cuh): the Fp product, a form, each warp program, the
// Euclid inversion, the one-thread Fp12 product and G2 addition that the
// block's folds use, a whole final exponentiation. Built and run by
// grandine_tpu_torch/gpu/tail_bench.py; no kernel of the port calls it.
#include <cuda_runtime.h>

#include "finish_tail.cuh"

using namespace bls;

// what < 0: -1 fp_mul, -2 a CYC_SQ output form, -3 the Euclid inversion,
// -4 fp12_mul_to on one thread, -5 point_add_complete on one thread, -6 a
// final exponentiation; what >= 0: warp program `what`. out: cycles per
// operation. Shared memory starts with 200 seed Fp values.
__global__ void tail_bench_kernel(int what, int reps, long long* out,
                                  const uint32_t* seed, const uint32_t* K) {
  extern __shared__ uint4 dyn[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(dyn);
  int lane = threadIdx.x;
  for (int i = lane; i < 200 * 12; i += 32) sm[i] = seed[i];
  __syncwarp();
  uint32_t* buf = sm;  // four groups of 36 Fp values
  uint32_t* scratch = sm + 12 * 200;
  fp x = fp_load(sm + 12 * lane), y = fp_load(sm + 12 * (lane + 32));
  long long t0 = clock64();
  for (int r = 0; r < reps; r++) {
    if (what >= 0) {
      tail::run(what, buf, buf + 432, buf + 864, buf + 1296, scratch);
    } else if (what == -1) {
      x = fp_mul(x, y);
    } else if (what == -2) {
      uint32_t* const g[4] = {buf, buf + 432, buf + 864, buf + 1296};
      const uint16_t* o = tail::TAIL_OUTS +
          3 * (tail::TAIL_PROGS[tail::PROG_CYC_SQ].out0 + lane % 12);
      fp v = tail::eval_form(g, scratch, o[0], o[1]);
      x.l[0] ^= v.l[0];
    } else if (what == -3) {
      if (lane == 0) x = tail::fp_inv_euclid(x);
    } else if (what == -4) {
      fp12* a = reinterpret_cast<fp12*>(buf);
      if (lane == 0) fp12_mul_to(a[0], a[0], a[1]);
    } else if (what == -5) {
      jac<fp2>* a = reinterpret_cast<jac<fp2>*>(buf);
      if (lane == 0) a[0] = point_add_complete(a[0], a[1], K);
    } else {
      tail::final_exp(buf, scratch, K);
    }
    __syncwarp();
  }
  long long t1 = clock64();
  if (lane == 0) out[0] = (t1 - t0) / reps;
  if (lane == 1) out[1] = x.l[0];  // keeps the chains live
}

extern "C" int tail_bench(int what, int reps, long long* out,
                          const uint32_t* seed, const uint32_t* K) {
  int smem = 48 * (200 + TAIL_SCRATCH);
  cudaError_t err = cudaFuncSetAttribute(
      tail_bench_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tail_bench_kernel<<<1, 32, smem>>>(what, reps, out, seed, K);
  return (int)cudaDeviceSynchronize();
}
