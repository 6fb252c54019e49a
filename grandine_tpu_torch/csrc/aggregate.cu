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
//
// One block of BLS_TREE threads an aggregate. Thread t sums members t,
// t + BLS_TREE, ... (complete additions), a shared-memory tree folds the
// partial sums into apk, then the GLV ladders split r = r0 + r1*lambda by
// their halves: warp 0's lanes 0 and 1 compute [r0]apk and [r1]phi(apk)
// (phi(x, y) = (bx*x, by*y) = [lambda] on G1), each a 32-step ladder of
// doublings and complete additions, and meet in one shuffle and one
// complete addition; warps 2 and 3 compute [r0]sig and [r1]psi'(sig)
// (psi'(x, y) = (wx*x, wy*y) = [lambda] on G2), each half's 32 doublings
// and mixed additions run as warp programs (G2DBL, G2MADD of
// csrc/finish_programs.cuh) across the warp's lanes, and warp 2 joins them
// by G2ADD with point_add_complete's cases. The G1 arithmetic is fpc's
// (bls12_381.cuh: the Fp product as a call). The RLC scalars are the
// verifier's own draw, so the ladders branch on their bits.
//
// agg_g1_lane, agg_g2_half and agg_g2_join (csrc/glv_halves.cuh, shared
// with multi_rlc_scale) and aggregate_block also compile as plain C++ (no
// __CUDACC__): a block's threads, lanes and warps then run in turn, so a
// host harness reproduces the kernel's words exactly.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "glv_halves.cuh"

using namespace bls;

// Shared memory of a block, in 32-bit words: BLS_TREE Jacobian G1 partial
// sums, then the two G2 warps' buffers
#define AGG_SMEM_WORDS (36 * BLS_TREE + 2 * 12 * AGG_WS)

// `clocks` (null but in gpu/tail_bench.py's timing build): per block,
// clock64 at the start, after thread 0's strided sum, after the tree,
// after the G1 lanes' store (warp 0) and after the G2 join's store
// (warp 2).
#ifdef __CUDACC__
#define AGG_CLOCK(i)                                                  \
  do {                                                                \
    if (clocks) clocks[5 * (size_t)blockIdx.x + (i)] = clock64();     \
  } while (0)
#else
#define AGG_CLOCK(i) (void)clocks
#endif

// Aggregate m by the block's BLS_TREE threads (every thread calls this);
// `sm` holds AGG_SMEM_WORDS words, 16-byte aligned.
BLS_HD void aggregate_block(uint32_t* sm, int m, const uint32_t* src_x,
                            const uint32_t* src_y, const int32_t* idx,
                            const int32_t* cnt, int k, const uint32_t* sig_x,
                            const uint32_t* sig_y, const bool* sig_mask,
                            const uint32_t* r01, uint32_t* rpk, bool* agg_inf,
                            uint32_t* rsig, const uint32_t* K,
                            long long* clocks) {
  const int T = BLS_TREE;
  jac<fpc>* part = reinterpret_cast<jac<fpc>*>(sm);
  uint32_t* g2buf = sm + 36 * T;
  int c = cnt[m];
  tail::block_each(T, [&](int t) {
    if (t == 0) AGG_CLOCK(0);
    jac<fpc> acc = jac_inf<fpc>(K);
    for (int j = t; j < c; j += T) {
      size_t row = (size_t)idx[(size_t)m * k + j];
      jac<fpc> q;
      q.x.v = mont_in(src_x + 12 * row, K);
      q.y.v = mont_in(src_y + 12 * row, K);
      f_one(q.z, K);
      acc = point_add_complete(acc, q, K);
    }
    part[t] = acc;
    if (t == 0) AGG_CLOCK(1);
  });
  for (int s = T / 2; s > 0; s >>= 1)
    tail::block_each(T, [&](int t) {
      if (t < s) part[t] = point_add_complete(part[t], part[t + s], K);
    });
  uint32_t r0 = r01[2 * m], r1 = r01[2 * m + 1];
  bool inf = f_is_zero(part[0].z), masked = sig_mask[m];
  const uint32_t *qx = sig_x + 24 * (size_t)m, *qy = sig_y + 24 * (size_t)m;
  tail::warps_each(T, [&](int w) {
    if (w == 0) {
#ifdef __CUDACC__
      int lane = threadIdx.x & 31;
      if (lane == 0) AGG_CLOCK(2);
      jac<fpc> st = jac_inf<fpc>(K);
      if (lane < 2 && !inf) st = agg_g1_lane(part[0], lane ? r1 : r0, lane, K);
      jac<fpc> hi = shfl_xor_words(st, 1);
      if (lane == 0) {
        agg_inf[m] = inf;
        g1_out(rpk + 36 * (size_t)m,
                inf ? jac_inf<fpc>(K) : point_add_complete(st, hi, K));
        AGG_CLOCK(3);
      }
#else
      agg_inf[m] = inf;
      g1_out(rpk + 36 * (size_t)m,
              inf ? jac_inf<fpc>(K)
                  : point_add_complete(agg_g1_lane(part[0], r0, 0, K),
                                       agg_g1_lane(part[0], r1, 1, K), K));
#endif
    } else if (w >= 2 && !masked) {
      agg_g2_half(g2buf + 12 * AGG_WS * (w - 2), qx, qy, w == 2 ? r0 : r1,
                  w - 2, K);
    }
  });
  tail::warps_each(T, [&](int w) {
    if (w != 2) return;
    uint32_t* a = g2buf;
    if (!masked) agg_g2_join(a, g2buf + 12 * AGG_WS, K);
    tail::warp_each([&](int lane) {
      if (lane < 6) {
        fp v = masked ? (lane == 0 || lane == 2 ? fp_load(K + 12 * K_ONE)
                                                : fp_zero())
                      : fp_load(a + 12 * (A_O + lane));
        mont_out(rsig + 72 * (size_t)m + 12 * lane, v);
      }
    });
#ifdef __CUDACC__
    if ((threadIdx.x & 31) == 0) AGG_CLOCK(4);
#endif
  });
}

#ifdef __CUDACC__
// --- aggregate_rlc_scale: one block of BLS_TREE threads an aggregate -------

__global__ void __launch_bounds__(BLS_TREE)
aggregate_rlc_scale_kernel(const uint32_t* src_x, const uint32_t* src_y,
                           const int32_t* idx, const int32_t* cnt, int k,
                           const uint32_t* sig_x, const uint32_t* sig_y,
                           const bool* sig_mask, const uint32_t* r01,
                           uint32_t* rpk, bool* agg_inf, uint32_t* rsig,
                           const uint32_t* K, long long* clocks) {
  __shared__ uint4 agg_smem[AGG_SMEM_WORDS / 4];
  aggregate_block(reinterpret_cast<uint32_t*>(agg_smem), blockIdx.x, src_x,
                  src_y, idx, cnt, k, sig_x, sig_y, sig_mask, r01, rpk,
                  agg_inf, rsig, K, clocks);
}

// the launch over m aggregates (clocks: see aggregate_block)
static cudaError_t aggregate_launch(
    const uint32_t* src_x, const uint32_t* src_y, const int32_t* idx,
    const int32_t* cnt, int m, int k, const uint32_t* sig_x,
    const uint32_t* sig_y, const bool* sig_mask, const uint32_t* r01,
    uint32_t* rpk, bool* agg_inf, uint32_t* rsig, const uint32_t* K,
    long long* clocks, cudaStream_t stream) {
  if (m > 0)
    aggregate_rlc_scale_kernel<<<m, BLS_TREE, 0, stream>>>(
        src_x, src_y, idx, cnt, k, sig_x, sig_y, sig_mask, r01, rpk, agg_inf,
        rsig, K, clocks);
  return cudaGetLastError();
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
  return (int)aggregate_launch(src_x, src_y, idx, cnt, m, k, sig_x, sig_y,
                               sig_mask, r01, rpk, agg_inf, rsig, K, nullptr,
                               stream);
}

}  // extern "C"
#endif
