// The G1 ladder of the EIP-4844 blob-KZG plane: g1_scalar_mul.
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. The C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// the kernel replaces in the JAX package, what bounds it on the card and
// what its design does about that is written beside its Python wrapper
// (gpu/kzg.py g1_scalar_mul).
//
// The scalars are public (blob field elements, Fiat-Shamir powers), so the
// ladder branches on their bits: every step doubles, and a set bit adds the
// base by a mixed addition (the base itself at the first set bit). For
// k < r on a point of prime order the mixed additions never meet P = +-Q;
// the wrapper asserts k < r.
//
// scalar_mul_row also compiles as plain C++ (no __CUDACC__), so the ladder
// can be run on a host against the plain PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bls12_381.cuh"

using namespace bls;

#define KZG_SCALAR_BITS 255  // bits of a scalar below r (gpu/kzg.py)

// [k]P for one row: px, py the affine canonical words of P (12 each), inf
// its infinity flag, k 8 little-endian words; writes the Jacobian result
// (3 x 12 canonical words), infinity (1, 1, 0) when inf. The steps are
// those of gpu/curve.py scalar_mul over KZG_SCALAR_BITS bits, MSB first, so
// the words equal the plain version's (k = 0 included: its Z stays 0).
BLS_NI void scalar_mul_row(const uint32_t* px, const uint32_t* py, bool inf,
                           const uint32_t* k, uint32_t* out,
                           const uint32_t* K) {
  jac<fp> st = jac_inf<fp>(K);
  if (!inf) {
    fp qx = mont_in(px, K), qy = mont_in(py, K);
    fp one = fp_load(K + 12 * K_ONE);
    bool started = false;
    for (int s = KZG_SCALAR_BITS - 1; s >= 0; s--) {
      st = point_double(st);
      if ((k[s >> 5] >> (s & 31)) & 1u) {
        if (started) {
          st = point_madd_unsafe(st, qx, qy);
        } else {
          st.x = qx;
          st.y = qy;
          st.z = one;
          started = true;
        }
      }
    }
  }
  mont_out(out, st.x);
  mont_out(out + 12, st.y);
  mont_out(out + 24, st.z);
}

#ifdef __CUDACC__
// --- g1_scalar_mul: one thread per row, one warp a block ----------------------

__global__ void __launch_bounds__(32)
g1_scalar_mul_kernel(const uint32_t* px, const uint32_t* py, const bool* inf,
                     const uint32_t* k, int n, uint32_t* out,
                     const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  scalar_mul_row(px + 12 * (size_t)i, py + 12 * (size_t)i, inf[i],
                 k + 8 * (size_t)i, out + 36 * (size_t)i, K);
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_g1_scalar_mul(const uint32_t* px, const uint32_t* py, const bool* inf,
                      const uint32_t* k, int n, uint32_t* out,
                      const uint32_t* K, cudaStream_t stream) {
  // one warp a block: a batch verify's 16-32 rows take one SM, a setup's
  // 4,096 rows 128 SMs in one wave
  if (n > 0)
    g1_scalar_mul_kernel<<<(n + 31) / 32, 32, 0, stream>>>(px, py, inf, k, n,
                                                           out, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
