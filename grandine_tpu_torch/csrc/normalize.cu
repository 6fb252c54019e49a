// Jacobian -> affine on the card: g1_normalize and g2_normalize, the two
// instances of one template normalize<F>.
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. Each C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// the kernels replace in the JAX package, what bounds them on the card and
// what their design does about that is written beside their Python
// wrappers (gpu/bls.py g1_normalize, g2_normalize).
//
// normalize_row also compiles as plain C++ (no __CUDACC__), so a row can be
// run on a host against the plain PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bls12_381.cuh"

using namespace bls;

#define NORM_THREADS 64  // threads a block: one row a thread

// a^-1 by Fermat (Fp) or through the norm (Fp2); zero maps to zero
BLS_HD fp f_inv(const fp& a, const uint32_t* K) {
  return fp_pow(a, K + 12 * K_INV_EXP);
}
BLS_HD fp2 f_inv(const fp2& a, const uint32_t* K) { return fp2_inv(a, K); }

// One Jacobian row (X, Y, Z canonical words, 3 x W) -> affine (x, y, 2 x W)
// with x = X z^-2, y = Y z^-3; returns whether Z = 0 (infinity), whose row
// comes out as zero words (z^-1 = 0).
template <class F>
BLS_NI bool normalize_row(const uint32_t* in, uint32_t* out,
                          const uint32_t* K) {
  constexpr int W = (int)(sizeof(F) / 4);
  F x, y, z;
  f_in(x, in, K);
  f_in(y, in + W, K);
  f_in(z, in + 2 * W, K);
  F zi = f_inv(z, K);
  F zi2 = f_mul(zi, zi);
  F zi3 = f_mul(zi2, zi);
  f_out(out, f_mul(x, zi2));
  f_out(out + W, f_mul(y, zi3));
  return f_is_zero(z);
}

#ifdef __CUDACC__
template <class F>
__global__ void __launch_bounds__(NORM_THREADS)
normalize_kernel(const uint32_t* in, int n, uint32_t* out, bool* inf,
                 const uint32_t* K) {
  constexpr int W = (int)(sizeof(F) / 4);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  inf[i] = normalize_row<F>(in + 3 * W * (size_t)i, out + 2 * W * (size_t)i,
                            K);
}

template <class F>
static int launch_normalize(const uint32_t* in, int n, uint32_t* out,
                            bool* inf, const uint32_t* K,
                            cudaStream_t stream) {
  if (n > 0)
    normalize_kernel<F><<<(n + NORM_THREADS - 1) / NORM_THREADS, NORM_THREADS,
                          0, stream>>>(in, n, out, inf, K);
  return (int)cudaGetLastError();
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_g1_normalize(const uint32_t* in, int n, uint32_t* out, bool* inf,
                     const uint32_t* K, cudaStream_t stream) {
  return launch_normalize<fp>(in, n, out, inf, K, stream);
}

int bls_g2_normalize(const uint32_t* in, int n, uint32_t* out, bool* inf,
                     const uint32_t* K, cudaStream_t stream) {
  return launch_normalize<fp2>(in, n, out, inf, K, stream);
}

}  // extern "C"
#endif
