// The per-set kernels of the flat and message-grouped BLS verify paths and
// of aggregate construction: multi_rlc_scale, and group_sum<F> as
// g1_group_sum (fpc, a lane a unit) and g2_group_sum (fp2, a warp a unit).
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. Each C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// each kernel replaces in the JAX package, what bounds it on the card and
// what its design does about that is written beside its Python wrapper
// (gpu/bls.py).
//
// The block functions (multi_block, gs_lanes_tile, gs_warps_tile) also
// compile as plain C++ (no __CUDACC__): a block's lanes and warps then run
// in turn and the shuffles become array reads, so a host harness
// reproduces the kernels' words exactly.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "glv_halves.cuh"

using namespace bls;

// threads of a multi_rlc_scale block and of a group_sum lane block
#define MULTI_BLOCK 128
// warps a g2_group_sum tile (one warp a unit of GROUP_CHUNK rows,
// csrc/finish_tail.cuh), mirrored in gpu/bls.py and chosen by
// ladder_timing.py's runs; a build sets another value (-D) only for such
// a run (ladder_timing.py TREE:NAME=V)
#ifndef G2_GROUP_WARPS
#define G2_GROUP_WARPS 8
#endif

// --- multi_rlc_scale: the GLV halves of each set apart --------------------
//
// Set i's [r]pk (pk = src[idx[i]], affine, Z = 1) runs as two G1 lanes
// (agg_g1_lane: [r0]pk and [r1]phi(pk)) of a G1 block, 64 sets a block,
// joined by a shuffle and one complete addition; its [r]sig as two G2
// halves of a G2 block, either warp programs on two warps (agg_g2_half,
// 2 sets a block, joined by agg_g2_join) or, with g2_lanes, two lanes
// (g2_half_lane, 64 sets a block, joined like the G1 lanes). Both G2 forms
// give the same words. The grid holds the G2 blocks first, then the G1
// blocks, so no warp runs both a G1 lane and a G2 half. A masked
// signature row gives infinity (1, 1, 0).

enum { MULTI_LANE_SETS = MULTI_BLOCK / 2, MULTI_WARP_SETS = MULTI_BLOCK / 64 };

// G2 blocks of a launch over n sets
TAIL_HHD int multi_g2_blocks(int n, int g2_lanes) {
  int per = g2_lanes ? MULTI_LANE_SETS : MULTI_WARP_SETS;
  return (n + per - 1) / per;
}

BLS_HD void g2_out(uint32_t* w, const jac<fp2>& v) {
  mont_out2(w, v.x);
  mont_out2(w + 24, v.y);
  mont_out2(w + 48, v.z);
}

// (1, 1, 0) as G2 canonical words
BLS_HD void g2_inf_out(uint32_t* w) {
  for (int i = 0; i < 72; i++) w[i] = i == 0 || i == 24 ? 1u : 0u;
}

// one G1 lane of set i (half = lane & 1): [r_half] of pk or phi(pk)
BLS_HD jac<fpc> multi_g1_lane(const uint32_t* src_x, const uint32_t* src_y,
                              const int32_t* idx, const uint32_t* r01, int i,
                              int half, const uint32_t* K) {
  size_t row = (size_t)idx[i];
  jac<fpc> b;
  b.x.v = mont_in(src_x + 12 * row, K);
  b.y.v = mont_in(src_y + 12 * row, K);
  f_one(b.z, K);
  return agg_g1_lane(b, r01[2 * i + half], half, K);
}

// one G2 lane of set i: [r_half] of sig or psi'(sig), infinity if masked
BLS_HD jac<fp2> multi_g2_lane(const uint32_t* sig_x, const uint32_t* sig_y,
                              const bool* sig_mask, const uint32_t* r01,
                              int i, int half, const uint32_t* K) {
  if (sig_mask[i]) return jac_inf<fp2>(K);
  return g2_half_lane(sig_x + 24 * (size_t)i, sig_y + 24 * (size_t)i,
                      r01[2 * i + half], half, K);
}

// Block b of a launch over n sets (every thread calls this); `sm` holds
// 4 * AGG_WS Fp values, 16-byte aligned.
BLS_HD void multi_block(uint32_t* sm, int b, int n, int g2_lanes,
                        const uint32_t* src_x, const uint32_t* src_y,
                        const int32_t* idx, const uint32_t* sig_x,
                        const uint32_t* sig_y, const bool* sig_mask,
                        const uint32_t* r01, uint32_t* rpk, uint32_t* rsig,
                        const uint32_t* K) {
  int g2_blocks = multi_g2_blocks(n, g2_lanes);
  if (b < g2_blocks && !g2_lanes) {  // G2 halves as warp programs
    tail::warps_each(MULTI_BLOCK, [&](int w) {
      int i = b * MULTI_WARP_SETS + (w >> 1);
      if (i < n && !sig_mask[i])
        agg_g2_half(sm + 12 * AGG_WS * w, sig_x + 24 * (size_t)i,
                    sig_y + 24 * (size_t)i, r01[2 * i + (w & 1)], w & 1, K);
    });
    tail::warps_each(MULTI_BLOCK, [&](int w) {
      int i = b * MULTI_WARP_SETS + (w >> 1);
      if ((w & 1) || i >= n) return;
      uint32_t* a = sm + 12 * AGG_WS * w;
      bool masked = sig_mask[i];
      if (!masked) agg_g2_join(a, a + 12 * AGG_WS, K);
      tail::warp_each([&](int lane) {
        if (lane < 6) {
          fp v = masked ? (lane == 0 || lane == 2 ? fp_load(K + 12 * K_ONE)
                                                  : fp_zero())
                        : fp_load(a + 12 * (A_O + lane));
          mont_out(rsig + 72 * (size_t)i + 12 * lane, v);
        }
      });
    });
    return;
  }
  bool g2 = b < g2_blocks;
  int b0 = g2 ? b : b - g2_blocks;
#ifdef __CUDACC__
  int t = threadIdx.x, i = b0 * MULTI_LANE_SETS + (t >> 1), half = t & 1;
  if (g2) {
    jac<fp2> st = i < n ? multi_g2_lane(sig_x, sig_y, sig_mask, r01, i, half,
                                        K)
                        : jac_inf<fp2>(K);
    jac<fp2> hi = shfl_xor_words(st, 1);
    if (i < n && !half) {
      if (sig_mask[i]) g2_inf_out(rsig + 72 * (size_t)i);
      else g2_out(rsig + 72 * (size_t)i, point_add_complete(st, hi, K));
    }
  } else {
    jac<fpc> st = i < n ? multi_g1_lane(src_x, src_y, idx, r01, i, half, K)
                        : jac_inf<fpc>(K);
    jac<fpc> hi = shfl_xor_words(st, 1);
    if (i < n && !half) g1_out(rpk + 36 * (size_t)i,
                               point_add_complete(st, hi, K));
  }
#else
  for (int j = 0; j < MULTI_LANE_SETS; j++) {
    int i = b0 * MULTI_LANE_SETS + j;
    if (i >= n) break;
    if (!g2) {
      g1_out(rpk + 36 * (size_t)i,
             point_add_complete(
                 multi_g1_lane(src_x, src_y, idx, r01, i, 0, K),
                 multi_g1_lane(src_x, src_y, idx, r01, i, 1, K), K));
    } else if (sig_mask[i]) {
      g2_inf_out(rsig + 72 * (size_t)i);
    } else {
      g2_out(rsig + 72 * (size_t)i,
             point_add_complete(
                 multi_g2_lane(sig_x, sig_y, sig_mask, r01, i, 0, K),
                 multi_g2_lane(sig_x, sig_y, sig_mask, r01, i, 1, K), K));
    }
  }
#endif
}

// blocks of a launch over n sets
TAIL_HHD int multi_blocks(int n, int g2_lanes) {
  return multi_g2_blocks(n, g2_lanes) + (n + MULTI_LANE_SETS - 1) /
                                            MULTI_LANE_SETS;
}

// --- group_sum<F>: a plan's tiles over many threads ---------------------------
//
// A pass sums the items of each tile (start, count) of its plan: unit u of
// the tile adds items u*C .. (u+1)*C - 1 of it in order (C = GROUP_CHUNK),
// from infinity (complete additions; a row with Z = 0 is infinity), then
// the tile's k = ceil(count / C) unit partials fold pairwise, position
// t + s into t where t + s < k for s = pow2ceil(k)/2 .. 1 (gpu/bls.py
// group_sum_plan: no level without two live partials, none for k = 1),
// and the total is the tile's output row (infinity, as (1, 1, 0), for
// count = 0 or a total with Z = 0). The plan, built on the host from the
// offsets alone, runs passes until each group is one tile. G1 (lane form,
// on fpc): a unit is a lane, a tile a warp (32 units, the fold by
// shuffles), 4 tiles a block. G2 (warp form): a unit is a warp running
// G2ADD warp programs (warp_g2_join), a tile a block of G2_GROUP_WARPS
// warps folding through shared memory.

template <class F>
BLS_HD jac<F> gs_row(const uint32_t* in, size_t i, const uint32_t* K) {
  constexpr int W = sizeof(F) / sizeof(uint32_t);  // words a coordinate
  const uint32_t* r = in + 3 * W * i;
  jac<F> q;
  f_in(q.x, r, K);
  f_in(q.y, r + W, K);
  f_in(q.z, r + 2 * W, K);
  return q;
}

// a tile's total to its output row; infinity as (1, 1, 0) whatever the
// words of the row it came from
template <class F>
BLS_HD void gs_store(uint32_t* out, size_t i, const jac<F>& v,
                     const uint32_t* K) {
  constexpr int W = sizeof(F) / sizeof(uint32_t);
  uint32_t* o = out + 3 * W * i;
  const jac<F> w = f_is_zero(v.z) ? jac_inf<F>(K) : v;
  f_out(o, w.x);
  f_out(o + W, w.y);
  f_out(o + 2 * W, w.z);
}

// unit u of the tile (start, count): its items in order, from infinity
template <class F>
BLS_HD jac<F> gs_unit(const uint32_t* in, int start, int count, int u,
                      const uint32_t* K) {
  jac<F> acc = jac_inf<F>(K);
  int end = (u + 1) * GROUP_CHUNK < count ? (u + 1) * GROUP_CHUNK : count;
  for (int i = u * GROUP_CHUNK; i < end; i++)
    acc = point_add_complete(acc, gs_row<F>(in, (size_t)(start + i), K), K);
  return acc;
}

// Tile `tile` of a lane-form pass by the calling warp (every lane calls
// this); on a host, the warp's lanes in turn.
template <class F>
BLS_HD void gs_lanes_tile(const uint32_t* in, const int32_t* tiles, int tile,
                          uint32_t* out, const uint32_t* K) {
  int start = tiles[2 * tile], count = tiles[2 * tile + 1];
  int k = gs_units(count);
#ifdef __CUDACC__
  int lane = threadIdx.x & 31;
  jac<F> acc = lane < k ? gs_unit<F>(in, start, count, lane, K)
                        : jac_inf<F>(K);
  for (int s = gs_top(k); s > 0; s >>= 1) {
    jac<F> o = shfl_xor_words(acc, s);
    if (lane < s && lane + s < k) acc = point_add_complete(acc, o, K);
  }
  if (lane == 0) gs_store(out, (size_t)tile, acc, K);
#else
  jac<F> part[32];
  for (int lane = 0; lane < 32; lane++)
    part[lane] = lane < k ? gs_unit<F>(in, start, count, lane, K)
                          : jac_inf<F>(K);
  for (int s = gs_top(k); s > 0; s >>= 1)
    for (int lane = 0; lane < s && lane + s < k; lane++)
      part[lane] = point_add_complete(part[lane], part[lane + s], K);
  gs_store(out, (size_t)tile, part[0], K);
#endif
}

// Fp values of a warp-form unit's buffers: its partial S (6), the row
// being added Q (6), the join's output O (6) and side values X (4), then
// its scratch
enum GsBuf { G_S = 0, G_Q = 6, G_O = 12, G_X = 18, G_SCRATCH = 22,
             GS_WS = G_SCRATCH + AGG_SCRATCH };

// a G2 row's 6 Fp values, Montgomery, into a warp buffer
BLS_HD void warp_g2_load(uint32_t* dst, const uint32_t* row,
                         const uint32_t* K) {
  tail::warp_each([&](int lane) {
    if (lane < 6) fp_store(dst + 12 * lane, mont_in(row + 12 * lane, K));
  });
}

// Tile `tile` of a warp-form pass by a block of G2_GROUP_WARPS warps
// (every thread calls this); `sm` holds G2_GROUP_WARPS * GS_WS Fp values.
BLS_HD void gs_warps_tile(uint32_t* sm, const uint32_t* in,
                          const int32_t* tiles, int tile, uint32_t* out,
                          const uint32_t* K) {
  constexpr int C = GROUP_CHUNK, T = 32 * G2_GROUP_WARPS;
  int start = tiles[2 * tile], count = tiles[2 * tile + 1];
  int k = gs_units(count);
  tail::warps_each(T, [&](int w) {
    if (w >= k) return;
    uint32_t* b = sm + 12 * GS_WS * w;
    int end = (w + 1) * C < count ? (w + 1) * C : count;
    warp_g2_load(b + 12 * G_S, in + 72 * (size_t)(start + w * C), K);
    for (int i = w * C + 1; i < end; i++) {
      warp_g2_load(b + 12 * G_Q, in + 72 * (size_t)(start + i), K);
      warp_g2_join(b + 12 * G_S, b + 12 * G_Q, b + 12 * G_O, b + 12 * G_X,
                   b + 12 * G_SCRATCH, K);
      tail::warp_copy(b + 12 * G_S, b + 12 * G_O, 6);
    }
  });
  for (int s = gs_top(k); s > 0; s >>= 1)
    tail::warps_each(T, [&](int w) {
      if (w >= s || w + s >= k) return;
      uint32_t* b = sm + 12 * GS_WS * w;
      warp_g2_join(b + 12 * G_S, sm + 12 * (GS_WS * (w + s) + G_S),
                   b + 12 * G_O, b + 12 * G_X, b + 12 * G_SCRATCH, K);
      tail::warp_copy(b + 12 * G_S, b + 12 * G_O, 6);
    });
  tail::warps_each(T, [&](int w) {
    if (w != 0) return;
    bool inf = k == 0 || fp2_is_zero(*reinterpret_cast<const fp2*>(
                             sm + 12 * (G_S + 4)));
    tail::warp_each([&](int lane) {
      if (lane >= 6) return;
      fp v = !inf ? fp_load(sm + 12 * (G_S + lane))
             : lane == 0 || lane == 2 ? fp_load(K + 12 * K_ONE) : fp_zero();
      mont_out(out + 72 * (size_t)tile + 12 * lane, v);
    });
  });
}

#ifdef __CUDACC__
// --- kernels and launches ----------------------------------------------------

// one instance a G2 form, so neither form's registers bound the other's
// occupancy
template <int G2_LANES>
__global__ void __launch_bounds__(MULTI_BLOCK)
multi_rlc_scale_kernel(const uint32_t* src_x, const uint32_t* src_y,
                       const int32_t* idx, int n, const uint32_t* sig_x,
                       const uint32_t* sig_y, const bool* sig_mask,
                       const uint32_t* r01, uint32_t* rpk, uint32_t* rsig,
                       const uint32_t* K) {
  __shared__ uint4 smem[G2_LANES ? 1 : 4 * 12 * AGG_WS / 4];
  multi_block(reinterpret_cast<uint32_t*>(smem), blockIdx.x, n, G2_LANES,
              src_x, src_y, idx, sig_x, sig_y, sig_mask, r01, rpk, rsig, K);
}

__global__ void __launch_bounds__(MULTI_BLOCK)
group_sum_lanes_kernel(const uint32_t* in, const int32_t* tiles, int n_tiles,
                       uint32_t* out, const uint32_t* K) {
  int tile = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (tile >= n_tiles) return;  // the whole warp
  gs_lanes_tile<fpc>(in, tiles, tile, out, K);
}

__global__ void __launch_bounds__(32 * G2_GROUP_WARPS)
group_sum_warps_kernel(const uint32_t* in, const int32_t* tiles,
                       uint32_t* out, const uint32_t* K) {
  __shared__ uint4 smem[G2_GROUP_WARPS * GS_WS * 12 / 4];
  gs_warps_tile(reinterpret_cast<uint32_t*>(smem), in, tiles, blockIdx.x,
                out, K);
}

// blocks of a group_sum pass over n tiles: G1 (4 tiles a block) or G2
static int group_sum_blocks(int g2, int n_tiles) {
  return g2 ? n_tiles : (n_tiles + MULTI_BLOCK / 32 - 1) / (MULTI_BLOCK / 32);
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_multi_rlc_scale(const uint32_t* src_x, const uint32_t* src_y,
                        const int32_t* idx, int n, int g2_lanes,
                        const uint32_t* sig_x, const uint32_t* sig_y,
                        const bool* sig_mask, const uint32_t* r01,
                        uint32_t* rpk, uint32_t* rsig, const uint32_t* K,
                        cudaStream_t stream) {
  if (n > 0 && g2_lanes)
    multi_rlc_scale_kernel<1><<<multi_blocks(n, 1), MULTI_BLOCK, 0, stream>>>(
        src_x, src_y, idx, n, sig_x, sig_y, sig_mask, r01, rpk, rsig, K);
  else if (n > 0)
    multi_rlc_scale_kernel<0><<<multi_blocks(n, 0), MULTI_BLOCK, 0, stream>>>(
        src_x, src_y, idx, n, sig_x, sig_y, sig_mask, r01, rpk, rsig, K);
  return (int)cudaGetLastError();
}

// One pass of a group_sum plan: tiles (n_tiles x (start, count), device
// memory) over the rows `in`, one output row a tile
int bls_g1_group_sum(const uint32_t* in, const int32_t* tiles, int n_tiles,
                     uint32_t* out, const uint32_t* K, cudaStream_t stream) {
  if (n_tiles > 0)
    group_sum_lanes_kernel<<<group_sum_blocks(0, n_tiles), MULTI_BLOCK, 0,
                             stream>>>(in, tiles, n_tiles, out, K);
  return (int)cudaGetLastError();
}

int bls_g2_group_sum(const uint32_t* in, const int32_t* tiles, int n_tiles,
                     uint32_t* out, const uint32_t* K, cudaStream_t stream) {
  if (n_tiles > 0)
    group_sum_warps_kernel<<<n_tiles, 32 * G2_GROUP_WARPS, 0, stream>>>(
        in, tiles, out, K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of a launch: of multi_rlc_scale over n sets
// (what = 0, `arg` its G2 form: 1 for lanes), of a group_sum pass over n
// tiles (what = 1: G1; what = 2: G2; `arg` unused): blocks, threads a
// block, shared memory bytes, and the most blocks of this shape one SM
// holds at once. Launches nothing.
int bls_launch_geometry(int what, int n, int arg, int32_t* geometry,
                        const uint32_t* K, cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err;
  if (what == 0) {
    geometry[0] = multi_blocks(n, arg);
    geometry[1] = MULTI_BLOCK;
    geometry[2] = arg ? 16 : 4 * 12 * AGG_WS * 4;
    err = arg ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, multi_rlc_scale_kernel<1>, MULTI_BLOCK, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, multi_rlc_scale_kernel<0>, MULTI_BLOCK, 0);
  } else if (what == 2) {
    geometry[0] = group_sum_blocks(1, n);
    geometry[1] = 32 * G2_GROUP_WARPS;
    geometry[2] = G2_GROUP_WARPS * GS_WS * 48;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, group_sum_warps_kernel, 32 * G2_GROUP_WARPS, 0);
  } else {
    geometry[0] = group_sum_blocks(0, n);
    geometry[1] = MULTI_BLOCK;
    geometry[2] = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, group_sum_lanes_kernel, MULTI_BLOCK, 0);
  }
  geometry[3] = per_sm;
  return (int)err;
}

}  // extern "C"
#endif
