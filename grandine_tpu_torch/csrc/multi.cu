// The per-set kernels of the flat and message-grouped BLS verify paths and
// of aggregate construction: multi_rlc_scale, and group_sum<F> as
// g1_group_sum (fp) and g2_group_sum (fp2).
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. Each C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// each kernel replaces in the JAX package, what bounds it on the card and
// what its design does about that is written beside its Python wrapper
// (gpu/bls.py).
#include <cuda_runtime.h>

#include "bls12_381.cuh"

using namespace bls;

// --- multi_rlc_scale: one thread per set and group --------------------------
//
// Warps 0 .. g1_warps-1 run the G1 GLV ladders r_i*pk_i (pk_i = src[idx[i]],
// affine), the warps after them the G2 GLV ladders r_i*sig_i: a warp never
// holds both ladders, so no warp runs the two branches one after the other.

__global__ void multi_rlc_scale_kernel(const uint32_t* src_x,
                                       const uint32_t* src_y,
                                       const int32_t* idx, int n, int g1_warps,
                                       const uint32_t* sig_x,
                                       const uint32_t* sig_y,
                                       const bool* sig_mask,
                                       const uint32_t* r01, uint32_t* rpk,
                                       uint32_t* rsig, const uint32_t* K) {
  int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  int lane = threadIdx.x & 31;
  bool g2 = warp >= g1_warps;
  int i = (g2 ? warp - g1_warps : warp) * 32 + lane;
  if (i >= n) return;
  uint32_t r0 = r01[2 * i], r1 = r01[2 * i + 1];
  if (!g2) {
    size_t row = (size_t)idx[i];
    fp qx = mont_in(src_x + 12 * row, K);
    fp qy = mont_in(src_y + 12 * row, K);
    jac<fp> out = scalar_mul_glv<fp>(qx, qy, fp_mul(qx, fp_load(K + 12 * K_G1_BX)),
                                     fp_mul(qy, fp_load(K + 12 * K_G1_BY)), r0,
                                     r1, K);
    mont_out(rpk + 36 * (size_t)i, out.x);
    mont_out(rpk + 36 * (size_t)i + 12, out.y);
    mont_out(rpk + 36 * (size_t)i + 24, out.z);
  } else {
    jac<fp2> out = jac_inf<fp2>(K);
    if (!sig_mask[i]) {
      fp2 qx = mont_in2(sig_x + 24 * (size_t)i, K);
      fp2 qy = mont_in2(sig_y + 24 * (size_t)i, K);
      fp wx = fp_load(K + 12 * K_G2_WX), wy = fp_load(K + 12 * K_G2_WY);
      out = scalar_mul_glv<fp2>(qx, qy, fp2_mul_fp(qx, wx),
                                fp2_mul_fp(qy, wy), r0, r1, K);
    }
    mont_out2(rsig + 72 * (size_t)i, out.x);
    mont_out2(rsig + 72 * (size_t)i + 24, out.y);
    mont_out2(rsig + 72 * (size_t)i + 48, out.z);
  }
}

// --- group_sum<F>: one block of BLS_TREE threads per group ------------------
//
// Group m sums the Jacobian rows [offsets[m], offsets[m+1]) of G1 (F = fp)
// or G2 (F = fp2): thread t adds rows t, t + BLS_TREE, ... (complete adds; a
// row with Z = 0 is infinity), block_tree_sum folds the partial sums, thread
// 0 writes the total (infinity for an empty group). Shared memory: BLS_TREE
// points, 18,432 B for G1 and 36,864 B for G2.

template <class F>
__global__ void __launch_bounds__(BLS_TREE)
group_sum_kernel(const uint32_t* rows, const int32_t* offsets, uint32_t* out,
                 const uint32_t* K) {
  constexpr int W = sizeof(F) / sizeof(uint32_t);  // words a coordinate
  __shared__ jac<F> part[BLS_TREE];
  int m = blockIdx.x, t = threadIdx.x;
  jac<F> acc = jac_inf<F>(K);
  for (int i = offsets[m] + t; i < offsets[m + 1]; i += BLS_TREE) {
    const uint32_t* r = rows + 3 * W * (size_t)i;
    jac<F> q;
    f_in(q.x, r, K);
    f_in(q.y, r + W, K);
    f_in(q.z, r + 2 * W, K);
    acc = point_add_complete(acc, q, K);
  }
  block_tree_sum(part, acc, K);
  if (t != 0) return;
  uint32_t* o = out + 3 * W * (size_t)m;
  f_out(o, part[0].x);
  f_out(o + W, part[0].y);
  f_out(o + 2 * W, part[0].z);
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_multi_rlc_scale(const uint32_t* src_x, const uint32_t* src_y,
                        const int32_t* idx, int n, const uint32_t* sig_x,
                        const uint32_t* sig_y, const bool* sig_mask,
                        const uint32_t* r01, uint32_t* rpk, uint32_t* rsig,
                        const uint32_t* K, cudaStream_t stream) {
  if (n > 0) {
    int g1_warps = (n + 31) / 32;
    // one warp a block: the G1 and G2 warps land on separate SMs
    multi_rlc_scale_kernel<<<2 * g1_warps, 32, 0, stream>>>(
        src_x, src_y, idx, n, g1_warps, sig_x, sig_y, sig_mask, r01, rpk,
        rsig, K);
  }
  return (int)cudaGetLastError();
}

int bls_g1_group_sum(const uint32_t* rows, const int32_t* offsets, int m,
                     uint32_t* out, const uint32_t* K, cudaStream_t stream) {
  if (m > 0)
    group_sum_kernel<fp><<<m, BLS_TREE, 0, stream>>>(rows, offsets, out, K);
  return (int)cudaGetLastError();
}

int bls_g2_group_sum(const uint32_t* rows, const int32_t* offsets, int m,
                     uint32_t* out, const uint32_t* K, cudaStream_t stream) {
  if (m > 0)
    group_sum_kernel<fp2><<<m, BLS_TREE, 0, stream>>>(rows, offsets, out, K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of the launch bls_g1_group_sum (g2 = 0) or
// bls_g2_group_sum (g2 = 1) makes over m groups: blocks, threads a block,
// static shared memory bytes, and the most blocks of this shape one SM
// holds at once. Launches nothing.
int bls_group_sum_geometry(int g2, int m, int32_t* geometry,
                           const uint32_t* K, cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err =
      g2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, group_sum_kernel<fp2>, BLS_TREE, 0)
         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, group_sum_kernel<fp>, BLS_TREE, 0);
  geometry[0] = m;
  geometry[1] = BLS_TREE;
  geometry[2] = (int)(BLS_TREE * (g2 ? sizeof(jac<fp2>) : sizeof(jac<fp>)));
  geometry[3] = per_sm;
  return (int)err;
}

}  // extern "C"
