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
// msm_horner runs a group's chain of doublings and complete additions on
// one thread in G1, on fpc (the Fp product as a call), and on one warp in
// G2, each doubling a G2DBL warp program and each addition warp_g2_join
// (csrc/glv_halves.cuh: G2ADD with point_add_complete's cases); both start
// from the top window's total, so W - 1 windows of w doublings and an
// addition.
//
// The per-thread and per-warp bodies (msm_lane, msm_fold,
// msm_horner_lane, msm_horner_warp) also compile as plain C++ (no
// __CUDACC__): a warp's lanes then run in turn, so a lane, a digit or a
// group can be run on a host against the plain PyTorch versions.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "glv_halves.cuh"

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

// Group g of a G1 launch on one thread, on fpc: acc = 2^w acc + T_win over
// the windows from the highest down (the total of window win at
// totals[g*W + win]), point_double and point_add_complete. acc starts at
// the top window's total: msm_horner_plain doubles (1, 1, 0) to itself
// and adds that total to it, which gives the total's words.
BLS_NI jac<fpc> msm_horner_lane(const uint32_t* totals, int W, int w, int g,
                                const uint32_t* K) {
  jac<fpc> acc = msm_load<fpc>(totals, (size_t)g * W + W - 1, K);
  for (int win = W - 2; win >= 0; win--) {
    for (int i = 0; i < w; i++) acc = point_double(acc);
    acc = point_add_complete(
        acc, msm_load<fpc>(totals, (size_t)g * W + win, K), K);
  }
  return acc;
}

// Fp values of a G2 Horner warp's buffers: two accumulators (6 each; a
// window's addition writes the other), the loaded window total T (6), the
// addition's side values X (4: G2ADD's H and r), then the scratch
enum HornerBuf { HN_ACC = 0, HN_T = 12, HN_X = 18, HN_SCRATCH = 22,
                 HORNER_WS = HN_SCRATCH + AGG_SCRATCH };

// Group g of a G2 launch by the calling warp, msm_horner_lane's chain:
// acc starts at the top window's total, each doubling a G2DBL program,
// each addition warp_g2_join (the cases of point_add_complete in its
// order); the group's 3 x 2 x 12 canonical words to out[g]. `buf` holds
// HORNER_WS Fp values, 16-byte aligned.
BLS_HD void msm_horner_warp(uint32_t* buf, const uint32_t* totals, int W,
                            int w, int g, uint32_t* out, const uint32_t* K) {
  uint32_t *acc = buf + 12 * HN_ACC, *nxt = acc + 72, *T = buf + 12 * HN_T,
           *X = buf + 12 * HN_X, *scratch = buf + 12 * HN_SCRATCH;
  auto load = [&](uint32_t* dst, int win) {
    const uint32_t* t = totals + 72 * ((size_t)g * W + win);
    tail::warp_each([&](int lane) {
      if (lane < 6) fp_store(dst + 12 * lane, mont_in(t + 12 * lane, K));
    });
  };
  load(acc, W - 1);
  for (int win = W - 2; win >= 0; win--) {
    for (int i = 0; i < w; i++)
      tail::run(tail::PROG_G2DBL, acc, acc, nullptr, nullptr, scratch);
    load(T, win);
    warp_g2_join(acc, T, nxt, X, scratch, K);
    uint32_t* done = nxt;
    nxt = acc;
    acc = done;
  }
  tail::warp_each([&](int lane) {
    if (lane < 6)
      mont_out(out + 72 * (size_t)g + 12 * lane, fp_load(acc + 12 * lane));
  });
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

// G1: one thread a group
__global__ void __launch_bounds__(MSM_GROUP_THREADS)
msm_horner_lanes_kernel(const uint32_t* totals, int G, int W, int w,
                        uint32_t* out, const uint32_t* K) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) msm_store(out, (size_t)g, msm_horner_lane(totals, W, w, g, K));
}

// G2: one warp a group, one block a group
__global__ void __launch_bounds__(32)
msm_horner_warps_kernel(const uint32_t* totals, int W, int w, uint32_t* out,
                        const uint32_t* K) {
  __shared__ uint4 smem[HORNER_WS * 3];
  msm_horner_warp(reinterpret_cast<uint32_t*>(smem), totals, W, w,
                  blockIdx.x, out, K);
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

// the launch over G groups: G1 (k = 1) a thread a group, G2 a block
static void horner_shape(int k, int G, int* blocks, int* threads) {
  *threads = k == 1 ? MSM_GROUP_THREADS : 32;
  *blocks = k == 1 ? (G + MSM_GROUP_THREADS - 1) / MSM_GROUP_THREADS : G;
}

static int launch_horner(int k, const uint32_t* totals, int G, int W, int w,
                         uint32_t* out, const uint32_t* K,
                         cudaStream_t stream) {
  int blocks, threads;
  horner_shape(k, G, &blocks, &threads);
  if (G > 0 && k == 1)
    msm_horner_lanes_kernel<<<blocks, threads, 0, stream>>>(totals, G, W, w,
                                                           out, K);
  else if (G > 0)
    msm_horner_warps_kernel<<<blocks, threads, 0, stream>>>(totals, W, w, out,
                                                           K);
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
  return launch_horner(1, totals, G, W, w, out, K, stream);
}

int bls_g2_msm_horner(const uint32_t* totals, int G, int W, int w,
                      uint32_t* out, const uint32_t* K, cudaStream_t stream) {
  return launch_horner(2, totals, G, W, w, out, K, stream);
}

// geometry (host memory) of the msm_horner launch over G groups of G1
// (k = 1) or G2: blocks, threads a block, shared memory bytes, and the
// most blocks of this shape one SM holds at once. Launches nothing.
int bls_msm_horner_geometry(int k, int G, int32_t* geometry,
                            const uint32_t* K, cudaStream_t stream) {
  int blocks, threads, per_sm = 0;
  horner_shape(k, G, &blocks, &threads);
  cudaError_t err =
      k == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, msm_horner_lanes_kernel, threads, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, msm_horner_warps_kernel, threads, 0);
  geometry[0] = blocks;
  geometry[1] = threads;
  geometry[2] = k == 1 ? 0 : HORNER_WS * 48;
  geometry[3] = per_sm;
  return (int)err;
}

}  // extern "C"
#endif
