// The pairing kernels of the BLS verify path: miller_loop_pairs,
// rlc_finish and rlc_partial (the per-shard product of the sharded
// verify programs). All three run warp programs (csrc/finish_tail.cuh).
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
// rlc_partial's tile (partial_tile) also compiles as plain C++ (no
// __CUDACC__): a block's threads and warps then run in turn, so a host
// harness reproduces the kernel's words exactly.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bls12_381.cuh"
#include "finish_tail.cuh"

using namespace bls;

// warps an rlc_partial tile (one warp a unit of GROUP_CHUNK terms), mirrored
// in gpu/bls.py; a build sets another value (-D) only for a
// ladder_timing.py run (TREE:NAME=V)
#ifndef PARTIAL_WARPS
#define PARTIAL_WARPS 8
#endif

// --- rlc_partial: a plan's tiles, a block of warps a tile -------------------
//
// Group g owns the Fp12 terms f[f_off[g] .. f_off[g+1]) with their agg_inf
// flags and the signature rows [s_off[g] .. s_off[g+1]) with sig_ok and
// sig_sub. It gets the product of its f terms (canonical words; one for
// an empty group) and one flag byte: bit 0 any agg_inf of its terms, bit 1
// every signature row decoded and in G2. No Miller loop of the signature
// sum and no final exponentiation: that is the finish's, once, over every
// shard's partial. The product runs the plan of the group sums (gpu/bls.py
// group_sum_plan at PARTIAL_WARPS units a tile), one launch a pass: a
// tile's block of PARTIAL_WARPS warps, warp u multiplying items u*C ..
// (u+1)*C - 1 of the tile (C = GROUP_CHUNK; each converted into Montgomery
// form by 12 lanes) with MUL warp programs, then the units' products folded
// pairwise by MUL programs (finish_tail.cuh warps_mul_level, rlc_finish's
// upper levels), one output row a tile (one for a tile of no item). The
// last pass has one tile a group, in order, and its block also reduces
// the group's flag byte over both of its ranges.

// Shared memory of a tile's block, in 32-bit words: the warps' products
// (Fp12), their term buffers (Fp12), their scratch, two flag words
enum { PT_PART = 0, PT_TERM = 144 * PARTIAL_WARPS,
       PT_SCRATCH = 2 * 144 * PARTIAL_WARPS,
       PT_FLAG = PT_SCRATCH + 12 * FOLD_SCRATCH * PARTIAL_WARPS,
       PT_WORDS = PT_FLAG + 4 };

// the calling warp's 12 lanes: an Fp12 row's canonical words into `dst`
// as Montgomery values
BLS_HD void warp_fp12_in(uint32_t* dst, const uint32_t* row,
                         const uint32_t* K) {
  tail::warp_each([&](int lane) {
    if (lane < 12) fp_store(dst + 12 * lane, mont_in(row + 12 * lane, K));
  });
}

// Tile `tile` of a pass over the rows `in` (every thread of the block calls
// this; `sm` holds PT_WORDS words, 16-byte aligned): its product to
// out[tile]; with `flags`, the last pass, tile = group also gets its flag
// byte.
BLS_HD void partial_tile(uint32_t* sm, const uint32_t* in,
                         const int32_t* tiles, int tile, uint32_t* out,
                         const bool* agg_inf, const bool* sig_ok,
                         const bool* sig_sub, const int32_t* f_off,
                         const int32_t* s_off, uint8_t* flags,
                         const uint32_t* K) {
  constexpr int C = GROUP_CHUNK, T = 32 * PARTIAL_WARPS;
  fp12* part = reinterpret_cast<fp12*>(sm + PT_PART);
  auto scratch = [&](int w) { return sm + PT_SCRATCH + 12 * FOLD_SCRATCH * w; };
  int start = tiles[2 * tile], count = tiles[2 * tile + 1];
  int k = gs_units(count);
  tail::warps_each(T, [&](int w) {
    if (w >= k) return;
    uint32_t *acc = reinterpret_cast<uint32_t*>(part + w),
             *term = sm + PT_TERM + 144 * w;
    int end = (w + 1) * C < count ? (w + 1) * C : count;
    for (int i = w * C; i < end; i++) {
      warp_fp12_in(i == w * C ? acc : term, in + 144 * (size_t)(start + i), K);
      if (i != w * C)
        tail::run(tail::PROG_MUL, acc, term, acc, nullptr, scratch(w));
    }
  });
  for (int s = gs_top(k); s > 0; s >>= 1)
    tail::warps_mul_level(T, part, s, k, scratch);
  tail::warps_each(T, [&](int w) {
    if (w != 0) return;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(part);
    tail::warp_each([&](int lane) {
      if (lane < 12)
        mont_out(out + 144 * (size_t)tile + 12 * lane,
                 k ? fp_load(p + 12 * lane)
                   : lane ? fp_zero() : fp_load(K + 12 * K_ONE));
    });
  });
  if (!flags) return;
  uint32_t* flag = sm + PT_FLAG;
  tail::block_each(T, [&](int t) {
    if (t < 2) flag[t] = 0;
  });
  tail::block_each(T, [&](int t) {
    bool inf = false, bad = false;
    for (int i = f_off[tile] + t; i < f_off[tile + 1]; i += T)
      inf = inf || agg_inf[i];
    for (int i = s_off[tile] + t; i < s_off[tile + 1]; i += T)
      bad = bad || !sig_ok[i] || !sig_sub[i];
    if (inf) flag[0] = 1;
    if (bad) flag[1] = 1;
  });
  tail::block_each(T, [&](int t) {
    if (t == 0) flags[tile] = (uint8_t)((flag[0] ? 1 : 0) | (flag[1] ? 0 : 2));
  });
}

#ifdef __CUDACC__

// --- miller_loop_pairs: one warp a pair -----------------------------------
//
// Pair i = blockIdx.x * W + w runs on warp w of its block (W = blockDim / 32,
// 1 to 4, gpu/pairing.py miller_warps): csrc/finish_tail.cuh miller_pair,
// the coefficient program of P, 63 doubling and 5 addition warp programs
// over the warp's buffers in dynamic shared memory (MILLER_WS Fp values a
// warp), conj(f) out as canonical words. The warps of a block share
// nothing; a warp past the last pair returns at once.

__global__ void __launch_bounds__(BLS_TREE, 4)
miller_loop_pairs_kernel(const uint32_t* rpk, const uint32_t* msg,
                         const bool* pair_inf, uint32_t* f, int n,
                         const uint32_t* K) {
  extern __shared__ uint4 dyn_smem[];
  tail::miller_block(reinterpret_cast<uint32_t*>(dyn_smem), blockDim.x >> 5,
                     blockIdx.x, n, rpk, msg, pair_inf, f, K);
}

// --- rlc_finish: one block a live group, its tail across warp 0 ---------
//
// Group g owns the Fp12 terms f[f_off[g] .. f_off[g+1]) and the signature
// terms rsig[s_off[g] .. s_off[g+1]). Its verdict: the product of its f
// terms times the Miller loop of (-g1, the sum of its signature terms),
// after the final exponentiation, is one; none of its aggregates summed to
// infinity; each of its signature rows decoded and lies in G2. Only the
// live groups (`live`, group ids) are launched, one block each of
// blockDim = 32, 64, 96 or 128 threads (a warp for a group of span <= 32);
// the wrapper writes the others' verdict (1: an empty product and an
// infinite sum). csrc/finish_tail.cuh `finish_group` is the block's
// work: strided products and sums, the sums' tree, the products folded
// warp-wide, then warp 0's tail (the Miller loop, the final
// exponentiation) as warp programs over shared memory.

__global__ void __launch_bounds__(BLS_TREE, 4)
rlc_finish_kernel(const uint32_t* f, const uint32_t* rsig,
                  const bool* agg_inf, const bool* sig_ok,
                  const bool* sig_sub, const int32_t* f_off,
                  const int32_t* s_off, const int32_t* live, int nf_max,
                  int ns_max, uint8_t* verdict, const uint32_t* K) {
  extern __shared__ uint4 dyn_smem[];
  int g = live[blockIdx.x];
  int T = blockDim.x;
  tail::finish_group(reinterpret_cast<uint32_t*>(dyn_smem), T,
                     nf_max < T ? nf_max : T, ns_max < T ? ns_max : T,
                     nf_max > T, f, rsig, agg_inf, sig_ok, sig_sub, f_off[g],
                     f_off[g + 1], s_off[g], s_off[g + 1], K, verdict + g);
}

// --- rlc_partial: one pass of the plan -------------------------------------

__global__ void __launch_bounds__(32 * PARTIAL_WARPS)
rlc_partial_kernel(const uint32_t* in, const int32_t* tiles, uint32_t* out,
                   const bool* agg_inf, const bool* sig_ok,
                   const bool* sig_sub, const int32_t* f_off,
                   const int32_t* s_off, uint8_t* flags, const uint32_t* K) {
  __shared__ uint4 smem[PT_WORDS / 4];
  partial_tile(reinterpret_cast<uint32_t*>(smem), in, tiles, blockIdx.x, out,
               agg_inf, sig_ok, sig_sub, f_off, s_off, flags, K);
}

// --- C interface --------------------------------------------------------

extern "C" {

// dynamic shared memory of a miller_loop_pairs block of `warps` warps
static size_t miller_smem(int warps) {
  return (size_t)warps * tail::MILLER_WS * 48;
}

static cudaError_t miller_allow_smem() {
  return cudaFuncSetAttribute(miller_loop_pairs_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)miller_smem(BLS_TREE / 32));
}

int bls_miller_loop_pairs(const uint32_t* rpk, const uint32_t* msg,
                          const bool* pair_inf, uint32_t* f, int n,
                          int warps, const uint32_t* K, cudaStream_t stream) {
  if (warps < 1 || warps > BLS_TREE / 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = miller_allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    miller_loop_pairs_kernel<<<(n + warps - 1) / warps, 32 * warps,
                               miller_smem(warps), stream>>>(
        rpk, msg, pair_inf, f, n, K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of the launch bls_miller_loop_pairs makes over n
// pairs at `warps` a block: blocks, threads a block, dynamic shared memory
// bytes, and the most blocks of this shape one SM holds at once. Launches
// nothing.
int bls_miller_loop_pairs_geometry(int n, int warps, int32_t* geometry,
                                   const uint32_t* K, cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = miller_allow_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, miller_loop_pairs_kernel, 32 * warps, miller_smem(warps));
  geometry[0] = (n + warps - 1) / warps;
  geometry[1] = 32 * warps;
  geometry[2] = (int)miller_smem(warps);
  geometry[3] = per_sm;
  return (int)err;
}

// dynamic shared memory of an rlc_finish block: `threads` threads, the
// widest group's f and signature terms
static size_t finish_smem(int threads, int nf_max, int ns_max) {
  return 4 * (size_t)tail::finish_layout(
                 threads, nf_max < threads ? nf_max : threads,
                 ns_max < threads ? ns_max : threads, nf_max > threads)
                 .words;
}

static cudaError_t finish_allow_smem() {
  return cudaFuncSetAttribute(rlc_finish_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)finish_smem(BLS_TREE, BLS_TREE + 1,
                                               BLS_TREE));
}

int bls_rlc_finish(const uint32_t* f, const uint32_t* rsig,
                   const bool* agg_inf, const bool* sig_ok,
                   const bool* sig_sub, const int32_t* f_off,
                   const int32_t* s_off, const int32_t* live, int n_live,
                   int threads, int nf_max, int ns_max, uint8_t* verdict,
                   const uint32_t* K, cudaStream_t stream) {
  cudaError_t err = finish_allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (n_live > 0)
    rlc_finish_kernel<<<n_live, threads,
                        finish_smem(threads, nf_max, ns_max), stream>>>(
        f, rsig, agg_inf, sig_ok, sig_sub, f_off, s_off, live, nf_max,
        ns_max, verdict, K);
  return (int)cudaGetLastError();
}

// One pass of an rlc_partial plan: tiles (n_tiles x (start, count), device
// memory) over the rows `in`, one output row a tile; the last pass (one
// tile a group) with the flag operands and `flags`, the others with nulls
int bls_rlc_partial(const uint32_t* in, const int32_t* tiles, int n_tiles,
                    uint32_t* out, const bool* agg_inf, const bool* sig_ok,
                    const bool* sig_sub, const int32_t* f_off,
                    const int32_t* s_off, uint8_t* flags, const uint32_t* K,
                    cudaStream_t stream) {
  if (n_tiles > 0)
    rlc_partial_kernel<<<n_tiles, 32 * PARTIAL_WARPS, 0, stream>>>(
        in, tiles, out, agg_inf, sig_ok, sig_sub, f_off, s_off, flags, K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of a pass over n tiles: blocks, threads a block,
// shared memory bytes, and the most blocks of this shape one SM holds at
// once. Launches nothing.
int bls_rlc_partial_geometry(int n_tiles, int32_t* geometry,
                             const uint32_t* K, cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rlc_partial_kernel, 32 * PARTIAL_WARPS, 0);
  geometry[0] = n_tiles;
  geometry[1] = 32 * PARTIAL_WARPS;
  geometry[2] = 4 * PT_WORDS;
  geometry[3] = per_sm;
  return (int)err;
}

// geometry (host memory) of the launch bls_rlc_finish makes: blocks,
// threads a block, dynamic shared memory bytes, and the most blocks of
// this shape one SM holds at once. Launches nothing.
int bls_rlc_finish_geometry(int n_live, int threads, int nf_max, int ns_max,
                            int32_t* geometry, const uint32_t* K,
                            cudaStream_t stream) {
  int per_sm = 0;
  size_t smem = finish_smem(threads, nf_max, ns_max);
  cudaError_t err = finish_allow_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rlc_finish_kernel, threads, smem);
  geometry[0] = n_live;
  geometry[1] = threads;
  geometry[2] = (int)smem;
  geometry[3] = per_sm;
  return (int)err;
}

// Per-thread stack for the call chains of the kernels (ptxas' cumulative
// stack size; more than the default 1 KiB). The limit holds for the whole
// CUDA context: the driver reserves it for every thread the card can hold
// at once, 264 MiB per KiB on an H100.
int bls_set_stack_limit(size_t bytes) {
  cudaDeviceSetLimit(cudaLimitStackSize, bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
