// Cycles (clock64, one warp, one block) of the pieces of rlc_finish's tail
// (csrc/finish_tail.cuh): the Fp product, a form, each warp program, the
// Euclid inversion, the one-thread Fp12 product and G2 addition that the
// block's folds use, a whole final exponentiation; and of the ladder steps
// of batch_sign and g1_scalar_mul (Fp addition and subtraction, the G1 and
// G2 doubling and mixed addition, the G1 formulas with their products
// inlined and as calls); the stage clocks of aggregate_rlc_scale and
// its lanes (csrc/aggregate.cu, included: the same kernel and launch);
// and the stage clocks of g2_decompress_subgroup (csrc/decompress.cu,
// included: the same kernel and launch). Built and run by grandine_tpu_torch/gpu/tail_bench.py; no
// kernel of the port calls it.
#include <cuda_runtime.h>

#include "finish_tail.cuh"
#include "aggregate.cu"
#include "decompress.cu"

using namespace bls;

// what < 0: -1 fp_mul, -2 a CYC_SQ output form, -3 the Euclid inversion,
// -4 fp12_mul_to on one thread, -5 point_add_complete on one thread, -6 a
// final exponentiation, -7 fp_add, -8 fp_sub, -9 point_double<fp>, -11
// point_madd_unsafe<fp>, -12 point_double<fp2>, -13
// point_madd_unsafe<fp2>, -14 fp2_mul, -15 point_double<fpc> (products as
// calls), -16 point_madd_unsafe<fpc>, each on every lane; -17 an
// aggregate_rlc_scale G1 lane (32 steps on fpc, lane 0), -18 a G2 half (32
// steps as warp programs); what >= 0: warp program `what`. out: cycles
// per operation. Shared memory starts with 200 seed Fp values.
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
  jac<fp> g = {x, y, fp_load(sm + 12 * (lane + 64))};
  jac<fp2> g2 = {{x, y}, {y, x}, {fp_load(sm + 12 * (lane + 96)), x}};
  fp2 y2 = {y, fp_load(sm + 12 * (lane + 128))};
  jac<fpc> gc = {{x}, {y}, {fp_load(sm + 12 * (lane + 160))}};
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
    } else if (what == -7) {
      x = fp_add(x, y);
    } else if (what == -8) {
      x = fp_sub(x, y);
    } else if (what == -9) {
      g = point_double(g);
    } else if (what == -11) {
      g = point_madd_unsafe(g, x, y);
    } else if (what == -12) {
      g2 = point_double(g2);
    } else if (what == -13) {
      g2 = point_madd_unsafe(g2, y2, g2.z);
    } else if (what == -14) {
      y2 = fp2_mul(y2, g2.x);
    } else if (what == -15) {
      gc = point_double(gc);
    } else if (what == -16) {
      gc = point_madd_unsafe(gc, fpc{x}, fpc{y});
    } else if (what == -17) {
      if (lane == 0) gc = agg_g1_lane(gc, 0x9E3779B9u, 1, K);
    } else if (what == -18) {
      agg_g2_half(scratch, seed, seed + 24, 0x9E3779B9u, 1, K);
    } else {
      tail::final_exp(buf, scratch, K);
    }
    __syncwarp();
  }
  long long t1 = clock64();
  if (lane == 0) out[0] = (t1 - t0) / reps;
  if (lane == 1)  // keeps the chains live
    out[1] = x.l[0] ^ g.x.l[0] ^ g2.x.c0.l[0] ^ y2.c1.l[0] ^ gc.x.v.l[0];
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

// aggregate_rlc_scale's launch (csrc/aggregate.cu) with its stage clocks
// (5 a block; null: none), on the default stream
extern "C" int tail_bench_aggregate(
    const uint32_t* src_x, const uint32_t* src_y, const int32_t* idx,
    const int32_t* cnt, int m, int k, const uint32_t* sig_x,
    const uint32_t* sig_y, const bool* sig_mask, const uint32_t* r01,
    uint32_t* rpk, bool* agg_inf, uint32_t* rsig, const uint32_t* K,
    long long* clocks) {
  return (int)aggregate_launch(src_x, src_y, idx, cnt, m, k, sig_x, sig_y,
                               sig_mask, r01, rpk, agg_inf, rsig, K, clocks,
                               0);
}

// g2_decompress_subgroup over n rows on the default stream (the library's
// launch); clocks null or 3 a row
extern "C" int tail_bench_g2_decompress(const uint8_t* rows, uint32_t* xs,
                                        uint32_t* ys, bool* flags, int n,
                                        const uint32_t* K,
                                        long long* clocks) {
  return (int)g2_decompress_launch(rows, xs, ys, flags, n, K, clocks, 0);
}
