// The pairing kernels of the BLS verify path: miller_loop_pairs,
// rlc_finish and rlc_partial (the per-shard product of the sharded
// verify programs). miller_loop_pairs and rlc_finish run warp programs
// (csrc/finish_tail.cuh).
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
#include "finish_tail.cuh"

using namespace bls;

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

// --- rlc_partial: one block, or one thread, per group ------------------------
//
// Group g owns the Fp12 terms f[f_off[g] .. f_off[g+1]) with their agg_inf
// flags and the signature rows [s_off[g] .. s_off[g+1]) with sig_ok and
// sig_sub. It writes the product of its f terms (canonical words; one for
// an empty group) to out[g] and one flag byte: bit 0 any agg_inf of its
// terms, bit 1 every signature row decoded and in G2. No Miller loop of
// the signature sum and no final exponentiation: that is the finish's,
// once, over every shard's partial. Every group launches (an empty one
// writes one): per_thread == 1 runs one group a thread, else one block of
// blockDim threads a group with the product tree over dynamic shared
// memory (gpu/bls.py partial_threads).

// Thread t of T multiplies the Fp12 terms f[i], i = f0 + t, f0 + t + T, ... < f1, into
// `prod` and ORs their agg_inf flags into `inf`.
__device__ __forceinline__ void fp12_strided_product(
    fp12& prod, bool& inf, const uint32_t* f, const bool* agg_inf, int f0,
    int f1, int t, int T, const uint32_t* K) {
  fp12 fi;
  for (int i = f0 + t; i < f1; i += T) {
    fi = fp12_in(f + 144 * (size_t)i, K);
    fp12_mul_to(prod, prod, fi);
    inf = inf || agg_inf[i];
  }
}

// Every thread of a T-thread block: its partial product into fpart[t] (T
// Fp12 slots of shared memory), then a tree fold into fpart[0]; returns
// `flag` ORed over the block. The fold multiplies position t + s into t
// for s = pow2ceil(T)/2 ... 1 (t + s < T): a tree padded with ones.
__device__ bool fp12_tree_product(fp12* fpart, const fp12& prod, bool flag,
                                  int t, int T) {
  fpart[t] = prod;
  flag = __syncthreads_or(flag);
  int s = 1;
  while (2 * s < T) s *= 2;
  for (; s > 0; s >>= 1) {
    if (t < s && t + s < T) fp12_mul_to(fpart[t], fpart[t], fpart[t + s]);
    __syncthreads();
  }
  return flag;
}

__global__ void __launch_bounds__(BLS_TREE)
rlc_partial_kernel(const uint32_t* f, const bool* agg_inf,
                   const bool* sig_ok, const bool* sig_sub,
                   const int32_t* f_off, const int32_t* s_off, int n_groups,
                   int per_thread, uint32_t* out, uint8_t* flags,
                   const uint32_t* K) {
  extern __shared__ uint4 dyn_smem[];
  int t = 0, T = 1, g;
  if (per_thread) {
    g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n_groups) return;
  } else {
    g = blockIdx.x;
    t = threadIdx.x;
    T = blockDim.x;
  }
  int f0 = f_off[g], f1 = f_off[g + 1], s0 = s_off[g], s1 = s_off[g + 1];
  bool inf = false, bad = false;
  for (int i = s0 + t; i < s1; i += T) bad = bad || !sig_ok[i] || !sig_sub[i];
  fp12 prod = fp12_one(K);
  fp12_strided_product(prod, inf, f, agg_inf, f0, f1, t, T, K);
  if (!per_thread) {
    fp12* fpart = reinterpret_cast<fp12*>(dyn_smem);
    inf = fp12_tree_product(fpart, prod, inf, t, T);
    bad = __syncthreads_or(bad);
    if (t != 0) return;
    prod = fpart[0];
  }
  fp12_out(out + 144 * (size_t)g, prod);
  flags[g] = (uint8_t)((inf ? 1 : 0) | (bad ? 0 : 2));
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

// The launch of rlc_partial over n groups at `threads` a group (1: one
// thread a group, 32 to a block, no shared memory; else one block a group
// with its product tree in dynamic shared memory): blocks, threads a
// block, bytes.
static void partial_geometry(int n, int threads, int* blocks, int* block,
                             size_t* smem) {
  int per_thread = threads <= 1;
  *block = per_thread ? 32 : threads;
  *blocks = per_thread ? (n + 31) / 32 : n;
  *smem = per_thread ? 0 : (size_t)threads * sizeof(fp12);
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

static cudaError_t partial_allow_smem() {
  return cudaFuncSetAttribute(rlc_partial_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(BLS_TREE * sizeof(fp12)));
}

int bls_rlc_partial(const uint32_t* f, const bool* agg_inf,
                    const bool* sig_ok, const bool* sig_sub,
                    const int32_t* f_off, const int32_t* s_off, int n_groups,
                    int threads, uint32_t* out, uint8_t* flags,
                    const uint32_t* K, cudaStream_t stream) {
  int blocks, block;
  size_t smem;
  partial_geometry(n_groups, threads, &blocks, &block, &smem);
  cudaError_t err = partial_allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0)
    rlc_partial_kernel<<<blocks, block, smem, stream>>>(
        f, agg_inf, sig_ok, sig_sub, f_off, s_off, n_groups, threads <= 1,
        out, flags, K);
  return (int)cudaGetLastError();
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
