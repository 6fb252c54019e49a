// The secret-scalar kernels: batch_sign (the device signing plane) and its
// G1 twin batch_pubkey.
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. The C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// the kernel replaces in the JAX package, what bounds it on the card and
// what its design does about that is written beside its Python wrapper
// (gpu/bls.py batch_sign, batch_pubkey).
//
// The secret scalar never steers control flow: every row runs exactly
// SIGN_BITS steps of one doubling and both mixed additions, and the scalar
// bits, the sign flags and the "started" state choose between computed
// values through word masks (ct_select), never through a branch. The
// field arithmetic of bls12_381.cuh keeps its data-dependent conditional
// reductions, so this is branchless on the scalar, not hardened against
// physical side channels (the caveat of the JAX kernel it replaces).
//
// sign_row and pubkey_row also compile as plain C++ (no __CUDACC__), so the
// ladders can be run on a host against the plain PyTorch versions.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bls12_381.cuh"

using namespace bls;

#define SIGN_BITS 128  // bits of each GLV half (gpu/bls.py SIGN_HALF_BITS)

// mask ? a : b word by word (mask is 0 or all ones): no branch
template <class T>
BLS_HD T ct_select(uint32_t mask, const T& a, const T& b) {
  T r;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
  uint32_t* pr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); i++)
    pr[i] = (pa[i] & mask) | (pb[i] & ~mask);
  return r;
}

// one slot of a ladder step: st + (bx, by) when the bit is set (the base
// itself before the first set bit), st otherwise; both candidates are
// computed every time
template <class F>
BLS_HD void ladder_slot(jac<F>& st, uint32_t& started, uint32_t bit,
                        const F& bx, const F& by, const F& one) {
  jac<F> added = point_madd_unsafe(st, bx, by);
  jac<F> first;
  first.x = bx;
  first.y = by;
  first.z = one;
  st = ct_select(bit, ct_select(started, added, first), st);
  started |= bit;
}

// [±k0 ± k1*lambda] H for one row: msg = [x | y] of H (2 x 24 canonical
// words), k = |k0|, |k1| as 4 + 4 little-endian words, neg = their signs;
// writes the Jacobian result (3 x 24 canonical words), infinity when inf.
BLS_NI void sign_row(const uint32_t* msg, bool inf, const uint32_t* k,
                     const bool* neg, uint32_t* out, const uint32_t* K) {
  fp2 qx = mont_in2(msg, K);
  fp2 qy = mont_in2(msg + 24, K);
  fp2 q2x = fp2_mul_fp(qx, fp_load(K + 12 * K_G2_WX));
  fp2 q2y = fp2_mul_fp(qy, fp_load(K + 12 * K_G2_WY));
  qy = ct_select(0u - (uint32_t)neg[0], fp2_neg(qy), qy);
  q2y = ct_select(0u - (uint32_t)neg[1], fp2_neg(q2y), q2y);
  fp2 one;
  f_one(one, K);
  jac<fp2> st = jac_inf<fp2>(K);
  uint32_t started = 0;
  for (int s = SIGN_BITS - 1; s >= 0; s--) {  // fixed trip count
    uint32_t b0 = 0u - ((k[s >> 5] >> (s & 31)) & 1u);
    uint32_t b1 = 0u - ((k[4 + (s >> 5)] >> (s & 31)) & 1u);
    st = point_double(st);
    ladder_slot(st, started, b0, qx, qy, one);
    ladder_slot(st, started, b1, q2x, q2y, one);
  }
  st = ct_select(0u - (uint32_t)inf, jac_inf<fp2>(K), st);
  mont_out2(out, st.x);
  mont_out2(out + 24, st.y);
  mont_out2(out + 48, st.z);
}

// [±k0 ± k1*lambda] g1 for one row: the G1 twin of sign_row from the
// generator, g1 = (x, -y) of the table's -g1; k = |k0|, |k1| as 4 + 4
// little-endian words, neg = their signs; writes the Jacobian result (3 x
// 12 canonical words).
BLS_NI void pubkey_row(const uint32_t* k, const bool* neg, uint32_t* out,
                       const uint32_t* K) {
  fp qx = fp_load(K + 12 * K_NEG_G1_X);
  fp qy = fp_neg(fp_load(K + 12 * K_NEG_G1_Y));
  fp q2x = fp_mul(qx, fp_load(K + 12 * K_G1_BX));
  fp q2y = fp_mul(qy, fp_load(K + 12 * K_G1_BY));
  qy = ct_select(0u - (uint32_t)neg[0], fp_neg(qy), qy);
  q2y = ct_select(0u - (uint32_t)neg[1], fp_neg(q2y), q2y);
  fp one;
  f_one(one, K);
  jac<fp> st = jac_inf<fp>(K);
  uint32_t started = 0;
  for (int s = SIGN_BITS - 1; s >= 0; s--) {  // fixed trip count
    uint32_t b0 = 0u - ((k[s >> 5] >> (s & 31)) & 1u);
    uint32_t b1 = 0u - ((k[4 + (s >> 5)] >> (s & 31)) & 1u);
    st = point_double(st);
    ladder_slot(st, started, b0, qx, qy, one);
    ladder_slot(st, started, b1, q2x, q2y, one);
  }
  mont_out(out, st.x);
  mont_out(out + 12, st.y);
  mont_out(out + 24, st.z);
}

#ifdef __CUDACC__
// --- batch_sign: one thread per signature, one warp a block -------------------

__global__ void __launch_bounds__(32)
batch_sign_kernel(const uint32_t* msg, const bool* msg_inf, const uint32_t* k,
                  const bool* neg, int n, uint32_t* out, const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sign_row(msg + 48 * (size_t)i, msg_inf[i], k + 8 * (size_t)i, neg + 2 * i,
           out + 72 * (size_t)i, K);
}

// --- batch_pubkey: one thread per key, one warp a block ---------------------

__global__ void __launch_bounds__(32)
batch_pubkey_kernel(const uint32_t* k, const bool* neg, int n, uint32_t* out,
                    const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  pubkey_row(k + 8 * (size_t)i, neg + 2 * i, out + 36 * (size_t)i, K);
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_batch_sign(const uint32_t* msg, const bool* msg_inf,
                   const uint32_t* k, const bool* neg, int n, uint32_t* out,
                   const uint32_t* K, cudaStream_t stream) {
  // one warp a block: a lane batch of 512 rows spreads over 16 SMs and a
  // full bucket of 16,384 rows over every SM
  if (n > 0)
    batch_sign_kernel<<<(n + 31) / 32, 32, 0, stream>>>(msg, msg_inf, k, neg,
                                                        n, out, K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of the launch bls_batch_sign makes over n rows:
// blocks, threads a block, shared memory bytes, and the most blocks of this
// shape one SM holds at once. Launches nothing.
int bls_batch_sign_geometry(int n, int32_t* geometry, const uint32_t* K,
                            cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, batch_sign_kernel, 32, 0);
  geometry[0] = (n + 31) / 32;
  geometry[1] = 32;
  geometry[2] = 0;
  geometry[3] = per_sm;
  return (int)err;
}

int bls_batch_pubkey(const uint32_t* k, const bool* neg, int n, uint32_t* out,
                     const uint32_t* K, cudaStream_t stream) {
  // one warp a block, as batch_sign: a full bucket of 16,384 keys is 512
  // one-warp blocks over every SM
  if (n > 0)
    batch_pubkey_kernel<<<(n + 31) / 32, 32, 0, stream>>>(k, neg, n, out, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
