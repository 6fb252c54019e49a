// Point decompression and subgroup kernels of the BLS verify path:
// g1_decompress (registry ingest), g2_decompress_subgroup (signature rows)
// and g2_subgroup_check (uploaded affine signature points).
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


// --- g1_decompress: one thread per 48-byte row -------------------------------

__global__ void g1_decompress_kernel(const uint8_t* rows, uint32_t* xs,
                                     uint32_t* ys, bool* flags, int n,
                                     const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp x, y;
  dec_flags f = g1_decompress_row(rows + 48 * (size_t)i, x, y, K);
  fp_store(xs + 12 * (size_t)i, x);
  fp_store(ys + 12 * (size_t)i, y);
  flags[0 * (size_t)n + i] = f.inf;
  flags[1 * (size_t)n + i] = f.ok;
  flags[2 * (size_t)n + i] = f.bad_encoding;
  flags[3 * (size_t)n + i] = f.bad_curve;
  flags[4 * (size_t)n + i] = f.bad_infinity;
}

// --- g2_decompress_subgroup: one thread per 96-byte row ---------------------

__global__ void g2_decompress_subgroup_kernel(const uint8_t* rows,
                                              uint32_t* xs, uint32_t* ys,
                                              bool* flags, int n,
                                              const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp2 x, y;
  dec_flags f = g2_decompress_row(rows + 96 * (size_t)i, x, y, K);
  bool live = f.ok && !f.inf;
  bool in_sub = !live || psi_check(x, y, K);
  mont_out2(xs + 24 * (size_t)i, x);
  mont_out2(ys + 24 * (size_t)i, y);
  flags[0 * (size_t)n + i] = f.inf;
  flags[1 * (size_t)n + i] = f.ok;
  flags[2 * (size_t)n + i] = f.bad_encoding;
  flags[3 * (size_t)n + i] = f.bad_curve;
  flags[4 * (size_t)n + i] = f.bad_infinity;
  flags[5 * (size_t)n + i] = in_sub;
}

// --- g2_subgroup_check: one thread per affine row ----------------------------

__global__ void g2_subgroup_check_kernel(const uint32_t* sx,
                                         const uint32_t* sy, const bool* s_inf,
                                         bool* in_sub, int n,
                                         const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool ok = true;
  if (!s_inf[i])
    ok = psi_check(mont_in2(sx + 24 * (size_t)i, K),
                   mont_in2(sy + 24 * (size_t)i, K), K);
  in_sub[i] = ok;
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_g1_decompress(const uint8_t* rows, uint32_t* xs, uint32_t* ys,
                      bool* flags, int n, const uint32_t* K,
                      cudaStream_t stream) {
  if (n > 0)
    g1_decompress_kernel<<<(n + 127) / 128, 128, 0, stream>>>(rows, xs, ys,
                                                             flags, n, K);
  return (int)cudaGetLastError();
}

int bls_g2_decompress_subgroup(const uint8_t* rows, uint32_t* xs,
                               uint32_t* ys, bool* flags, int n,
                               const uint32_t* K, cudaStream_t stream) {
  if (n > 0)
    g2_decompress_subgroup_kernel<<<(n + 63) / 64, 64, 0, stream>>>(
        rows, xs, ys, flags, n, K);
  return (int)cudaGetLastError();
}

int bls_g2_subgroup_check(const uint32_t* sx, const uint32_t* sy,
                          const bool* s_inf, bool* in_sub, int n,
                          const uint32_t* K, cudaStream_t stream) {
  if (n > 0)
    g2_subgroup_check_kernel<<<(n + 63) / 64, 64, 0, stream>>>(sx, sy, s_inf,
                                                              in_sub, n, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
