// The Pippenger bucket MSM: msm_lane_scan<F>, msm_bucket_reduce<F> and
// msm_horner<F>, each instantiated for G1 (F = fp) and G2 (F = fp2).
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. Each C entry
// launches on the stream it is given and returns cudaGetLastError(). The
// host plan (gpu/msm.py plan_msm) sorts the expanded entries into a
// (S, T) lane grid and names each bucket's pieces; what each kernel
// replaces in the JAX package, what bounds it on the card and what its
// design does about that is written beside its Python wrapper (gpu/msm.py).
//
// The per-thread bodies (msm_lane, msm_fold, msm_horner_group) also
// compile as plain C++ (no __CUDACC__), so a lane, a digit or a group can
// be run on a host against the plain PyTorch versions.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bls12_381.cuh"

using namespace bls;

#define MSM_LANE_THREADS 32    // one warp a block: the lanes spread over SMs
#define MSM_GROUP_THREADS 32
#define MSM_MAX_DIGITS 256     // B = 2^w, w <= 8

// [lambda](x, y) = (beta_x * x, beta_y * y): the GLV endomorphism of G1
// (Fp constants) or of G2 (Fp scalars on both Fp2 coefficients)
BLS_HD void msm_endo(fp& x, fp& y, const uint32_t* K) {
  x = fp_mul(x, fp_load(K + 12 * K_G1_BX));
  y = fp_mul(y, fp_load(K + 12 * K_G1_BY));
}
BLS_HD void msm_endo(fp2& x, fp2& y, const uint32_t* K) {
  x = fp2_mul_fp(x, fp_load(K + 12 * K_G2_WX));
  y = fp2_mul_fp(y, fp_load(K + 12 * K_G2_WY));
}

template <class F>
BLS_HD jac<F> msm_load(const uint32_t* rows, size_t i, const uint32_t* K) {
  constexpr int W = (int)(sizeof(F) / 4);
  const uint32_t* r = rows + 3 * W * i;
  jac<F> q;
  f_in(q.x, r, K);
  f_in(q.y, r + W, K);
  f_in(q.z, r + 2 * W, K);
  return q;
}

template <class F>
BLS_HD void msm_store(uint32_t* rows, size_t i, const jac<F>& p) {
  constexpr int W = (int)(sizeof(F) / 4);
  uint32_t* r = rows + 3 * W * i;
  f_out(r, p.x);
  f_out(r + W, p.y);
  f_out(r + 2 * W, p.z);
}

// Lane t of the (S, T) grid: slot s holds expanded entry point_idx[s*T + t]
// (e < n: P_e; e >= n: phi(P_{e-n})), added when valid and its point live
// (else infinity is added); at a flush the sum goes to emit slot s*T + t
// and the lane restarts from infinity.
template <class F>
BLS_NI void msm_lane(const uint32_t* x, const uint32_t* y, const bool* live,
                     int n, const int32_t* point_idx, const bool* valid,
                     const bool* flush, int S, int T, int t, uint32_t* emit,
                     const uint32_t* K) {
  constexpr int W = (int)(sizeof(F) / 4);
  jac<F> acc = jac_inf<F>(K);
  for (int s = 0; s < S; s++) {
    size_t slot = (size_t)s * T + t;
    jac<F> pt = jac_inf<F>(K);
    if (valid[slot]) {
      int e = point_idx[slot];
      int row = e < n ? e : e - n;
      if (live[row]) {
        f_in(pt.x, x + W * (size_t)row, K);
        f_in(pt.y, y + W * (size_t)row, K);
        if (e >= n) msm_endo(pt.x, pt.y, K);
        f_one(pt.z, K);
      }
    }
    acc = point_add_complete(acc, pt, K);
    if (flush[slot]) {
      msm_store(emit, slot, acc);
      acc = jac_inf<F>(K);
    }
  }
}

// Digit d of section sec: the sum of its bucket's (at most J) pieces,
// gathered from the lane scan's emit slots; an invalid piece is skipped.
template <class F>
BLS_NI jac<F> msm_fold(const uint32_t* emit, const int32_t* gather_idx,
                       const bool* gather_valid, int J, int n_sec, int B,
                       int sec, int d, const uint32_t* K) {
  jac<F> acc = jac_inf<F>(K);
  for (int j = 0; j < J; j++) {
    size_t at = ((size_t)j * n_sec + sec) * B + d;
    if (gather_valid[at])
      acc = point_add_complete(acc, msm_load<F>(emit, gather_idx[at], K), K);
  }
  return acc;
}

// Group g: acc = 2^w acc + T_win over the windows from the highest down
// (window total of window win at totals[g*W + win]).
template <class F>
BLS_NI jac<F> msm_horner_group(const uint32_t* totals, int W, int w, int g,
                               const uint32_t* K) {
  jac<F> acc = jac_inf<F>(K);
  for (int win = W - 1; win >= 0; win--) {
    for (int i = 0; i < w; i++) acc = point_double(acc);
    acc = point_add_complete(acc, msm_load<F>(totals, (size_t)g * W + win, K),
                             K);
  }
  return acc;
}

#ifdef __CUDACC__
template <class F>
__global__ void __launch_bounds__(MSM_LANE_THREADS)
msm_lane_scan_kernel(const uint32_t* x, const uint32_t* y, const bool* live,
                     int n, const int32_t* point_idx, const bool* valid,
                     const bool* flush, int S, int T, uint32_t* emit,
                     const uint32_t* K) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T)
    msm_lane<F>(x, y, live, n, point_idx, valid, flush, S, T, t, emit, K);
}

// One block a section, one thread a digit (blockDim = B): the fold, then
// in shared memory the Hillis-Steele suffix U_d += U_{d+k} (d + k < B,
// k = 1, 2, ..., B/2), infinity at digit 0 and the tree sum over the
// digits; thread 0 writes the section's total.
template <class F>
__global__ void __launch_bounds__(MSM_MAX_DIGITS)
msm_bucket_reduce_kernel(const uint32_t* emit, const int32_t* gather_idx,
                         const bool* gather_valid, int J, int n_sec,
                         uint32_t* totals, const uint32_t* K) {
  extern __shared__ __align__(16) unsigned char msm_smem[];
  jac<F>* U = reinterpret_cast<jac<F>*>(msm_smem);
  int sec = blockIdx.x, d = threadIdx.x, B = blockDim.x;
  U[d] = msm_fold<F>(emit, gather_idx, gather_valid, J, n_sec, B, sec, d, K);
  __syncthreads();
  for (int k = 1; k < B; k <<= 1) {
    jac<F> nxt = d + k < B ? point_add_complete(U[d], U[d + k], K) : U[d];
    __syncthreads();
    U[d] = nxt;
    __syncthreads();
  }
  jac<F> u = d == 0 ? jac_inf<F>(K) : U[d];
  block_tree_sum_n(U, u, B, K);
  if (d == 0) msm_store(totals, (size_t)sec, U[0]);
}

template <class F>
__global__ void __launch_bounds__(MSM_GROUP_THREADS)
msm_horner_kernel(const uint32_t* totals, int G, int W, int w, uint32_t* out,
                  const uint32_t* K) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) msm_store(out, (size_t)g, msm_horner_group<F>(totals, W, w, g, K));
}

template <class F>
static int launch_lane_scan(const uint32_t* x, const uint32_t* y,
                            const bool* live, int n, const int32_t* point_idx,
                            const bool* valid, const bool* flush, int S,
                            int T, uint32_t* emit, const uint32_t* K,
                            cudaStream_t stream) {
  if (S > 0 && T > 0)
    msm_lane_scan_kernel<F>
        <<<(T + MSM_LANE_THREADS - 1) / MSM_LANE_THREADS, MSM_LANE_THREADS, 0,
           stream>>>(x, y, live, n, point_idx, valid, flush, S, T, emit, K);
  return (int)cudaGetLastError();
}

// B points of shared memory a block: 36,864 B (G1) or 73,728 B (G2) at
// B = 256, above the 48 KiB default for G2, so the kernel opts in to
// that much dynamic shared memory first.
template <class F>
static int launch_bucket_reduce(const uint32_t* emit,
                                const int32_t* gather_idx,
                                const bool* gather_valid, int J, int n_sec,
                                int B, uint32_t* totals, const uint32_t* K,
                                cudaStream_t stream) {
  if (B < 1 || B > MSM_MAX_DIGITS || (B & (B - 1))) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)B * sizeof(jac<F>);
  cudaError_t err = cudaFuncSetAttribute(
      msm_bucket_reduce_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_sec > 0)
    msm_bucket_reduce_kernel<F><<<n_sec, B, smem, stream>>>(
        emit, gather_idx, gather_valid, J, n_sec, totals, K);
  return (int)cudaGetLastError();
}

template <class F>
static int launch_horner(const uint32_t* totals, int G, int W, int w,
                         uint32_t* out, const uint32_t* K,
                         cudaStream_t stream) {
  if (G > 0)
    msm_horner_kernel<F>
        <<<(G + MSM_GROUP_THREADS - 1) / MSM_GROUP_THREADS, MSM_GROUP_THREADS,
           0, stream>>>(totals, G, W, w, out, K);
  return (int)cudaGetLastError();
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_g1_msm_lane_scan(const uint32_t* x, const uint32_t* y,
                         const bool* live, int n, const int32_t* point_idx,
                         const bool* valid, const bool* flush, int S, int T,
                         uint32_t* emit, const uint32_t* K,
                         cudaStream_t stream) {
  return launch_lane_scan<fp>(x, y, live, n, point_idx, valid, flush, S, T,
                              emit, K, stream);
}

int bls_g2_msm_lane_scan(const uint32_t* x, const uint32_t* y,
                         const bool* live, int n, const int32_t* point_idx,
                         const bool* valid, const bool* flush, int S, int T,
                         uint32_t* emit, const uint32_t* K,
                         cudaStream_t stream) {
  return launch_lane_scan<fp2>(x, y, live, n, point_idx, valid, flush, S, T,
                               emit, K, stream);
}

int bls_g1_msm_bucket_reduce(const uint32_t* emit, const int32_t* gather_idx,
                             const bool* gather_valid, int J, int n_sec, int B,
                             uint32_t* totals, const uint32_t* K,
                             cudaStream_t stream) {
  return launch_bucket_reduce<fp>(emit, gather_idx, gather_valid, J, n_sec, B,
                                  totals, K, stream);
}

int bls_g2_msm_bucket_reduce(const uint32_t* emit, const int32_t* gather_idx,
                             const bool* gather_valid, int J, int n_sec, int B,
                             uint32_t* totals, const uint32_t* K,
                             cudaStream_t stream) {
  return launch_bucket_reduce<fp2>(emit, gather_idx, gather_valid, J, n_sec,
                                   B, totals, K, stream);
}

int bls_g1_msm_horner(const uint32_t* totals, int G, int W, int w,
                      uint32_t* out, const uint32_t* K, cudaStream_t stream) {
  return launch_horner<fp>(totals, G, W, w, out, K, stream);
}

int bls_g2_msm_horner(const uint32_t* totals, int G, int W, int w,
                      uint32_t* out, const uint32_t* K, cudaStream_t stream) {
  return launch_horner<fp2>(totals, G, W, w, out, K, stream);
}

}  // extern "C"
#endif
