// Point decompression and subgroup kernels of the BLS verify path:
// g1_decompress (registry ingest), g2_decompress_subgroup (signature rows),
// g2_subgroup_check (uploaded affine signature points) and unpack_words
// (coordinates uploaded in the packed transfer format).
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. Each C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// each kernel replaces in the JAX package, what bounds it on the card and
// what its design does about that is written beside its Python wrapper
// (gpu/curve.py, gpu/bls.py, gpu/pairing.py).
//
// unpack_row also compiles as plain C++ (no __CUDACC__), so a row can be
// run on a host against the plain PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bls12_381.cuh"

using namespace bls;

#define UNPACK_THREADS 128  // threads a block: one coordinate a thread

// One packed coordinate (13 little-endian words) -> its canonical value:
// bits 0-389 (the JAX package's 26 limbs of 15 bits, bits 390-415 dropped)
// as hi 2^384 + lo with hi < 2^6, reduced mod p by Montgomery products as
// the reference's to_mont_dev reduces it: (lo mod p + hi (2^384 mod p))
// mod p. Any 390-bit value comes out below p.
BLS_NI void unpack_row(const uint32_t* w, uint32_t* out, const uint32_t* K) {
  fp r2 = fp_load(K + 12 * K_R2);
  fp lo = fp_load(w);
  fp hi = fp_zero();
  hi.l[0] = w[12] & 0x3fu;
  // fp_mul(a, R^2) = a R mod p for any a < 2^384: the Montgomery form of
  // a mod p; once more for hi R = hi 2^384
  fp m = fp_add(fp_mul(lo, r2), fp_mul(fp_mul(hi, r2), r2));
  mont_out(out, m);
}

#ifdef __CUDACC__

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

// --- unpack_words: one thread per packed coordinate -------------------------

__global__ void __launch_bounds__(UNPACK_THREADS)
unpack_words_kernel(const uint32_t* w, int n, uint32_t* out,
                    const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unpack_row(w + 13 * (size_t)i, out + 12 * (size_t)i, K);
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

int bls_unpack_words(const uint32_t* w, int n, uint32_t* out,
                     const uint32_t* K, cudaStream_t stream) {
  if (n > 0)
    unpack_words_kernel<<<(n + UNPACK_THREADS - 1) / UNPACK_THREADS,
                          UNPACK_THREADS, 0, stream>>>(w, n, out, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
