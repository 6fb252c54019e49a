// The per-aggregate kernel of the BLS verify path: aggregate_rlc_scale.
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. Each C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// each kernel replaces in the JAX package, what bounds it on the card and
// what its design does about that is written beside its Python wrapper
// (gpu/curve.py, gpu/bls.py, gpu/pairing.py).
#include <cuda_runtime.h>

#include "bls12_381.cuh"

using namespace bls;

// --- aggregate_rlc_scale: one block of BLS_TREE threads per aggregate ------
//
// Thread t sums members t, t+BLS_TREE, ... of its aggregate (complete
// adds), block_tree_sum folds the partial sums, then warp 0 runs the G1 GLV
// ladder r*apk and warp 1 the G2 GLV ladder r*sig concurrently.

__global__ void __launch_bounds__(BLS_TREE)
aggregate_rlc_scale_kernel(const uint32_t* src_x, const uint32_t* src_y,
                           const int32_t* idx, const int32_t* cnt, int k,
                           const uint32_t* sig_x, const uint32_t* sig_y,
                           const bool* sig_mask, const uint32_t* r01,
                           uint32_t* rpk, bool* agg_inf, uint32_t* rsig,
                           const uint32_t* K) {
  __shared__ jac<fp> part[BLS_TREE];
  int m = blockIdx.x, t = threadIdx.x;
  int c = cnt[m];
  jac<fp> acc = jac_inf<fp>(K);
  fp one = fp_load(K + 12 * K_ONE);
  for (int j = t; j < c; j += BLS_TREE) {
    size_t row = (size_t)idx[(size_t)m * k + j];
    jac<fp> q;
    q.x = mont_in(src_x + 12 * row, K);
    q.y = mont_in(src_y + 12 * row, K);
    q.z = one;
    acc = point_add_complete(acc, q, K);
  }
  block_tree_sum(part, acc, K);
  uint32_t r0 = r01[2 * m], r1 = r01[2 * m + 1];
  if (t == 0) {
    jac<fp> apk = part[0];
    bool inf = fp_is_zero(apk.z);
    jac<fp> out = jac_inf<fp>(K);
    if (!inf) out = scalar_mul_jac_glv_g1(apk, r0, r1, K);
    agg_inf[m] = inf;
    mont_out(rpk + 36 * (size_t)m, out.x);
    mont_out(rpk + 36 * (size_t)m + 12, out.y);
    mont_out(rpk + 36 * (size_t)m + 24, out.z);
  } else if (t == 32) {
    jac<fp2> out = jac_inf<fp2>(K);
    if (!sig_mask[m]) {
      fp2 qx = mont_in2(sig_x + 24 * (size_t)m, K);
      fp2 qy = mont_in2(sig_y + 24 * (size_t)m, K);
      fp wx = fp_load(K + 12 * K_G2_WX), wy = fp_load(K + 12 * K_G2_WY);
      out = scalar_mul_glv<fp2>(qx, qy, fp2_mul_fp(qx, wx),
                                fp2_mul_fp(qy, wy), r0, r1, K);
    }
    mont_out2(rsig + 72 * (size_t)m, out.x);
    mont_out2(rsig + 72 * (size_t)m + 24, out.y);
    mont_out2(rsig + 72 * (size_t)m + 48, out.z);
  }
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_aggregate_rlc_scale(const uint32_t* src_x, const uint32_t* src_y,
                            const int32_t* idx, const int32_t* cnt, int m,
                            int k, const uint32_t* sig_x,
                            const uint32_t* sig_y, const bool* sig_mask,
                            const uint32_t* r01, uint32_t* rpk,
                            bool* agg_inf, uint32_t* rsig, const uint32_t* K,
                            cudaStream_t stream) {
  if (m > 0)
    aggregate_rlc_scale_kernel<<<m, BLS_TREE, 0, stream>>>(
        src_x, src_y, idx, cnt, k, sig_x, sig_y, sig_mask, r01, rpk, agg_inf,
        rsig, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
