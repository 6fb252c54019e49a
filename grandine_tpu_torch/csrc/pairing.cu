// The pairing kernels of the BLS verify path: miller_loop_pairs and
// rlc_finish.
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

// --- miller_loop_pairs: one thread per pair --------------------------------

__global__ void miller_loop_pairs_kernel(const uint32_t* rpk,
                                         const uint32_t* msg,
                                         const bool* pair_inf, uint32_t* f,
                                         int n, const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp12 out = fp12_one(K);
  if (!pair_inf[i]) {
    jac<fp> P;
    P.x = mont_in(rpk + 36 * (size_t)i, K);
    P.y = mont_in(rpk + 36 * (size_t)i + 12, K);
    P.z = mont_in(rpk + 36 * (size_t)i + 24, K);
    jac<fp2> Q;
    Q.x = mont_in2(msg + 48 * (size_t)i, K);
    Q.y = mont_in2(msg + 48 * (size_t)i + 24, K);
    f_one(Q.z, K);
    miller_loop(out, P, Q, K);
  }
  fp12_out(f + 144 * (size_t)i, out);
}

// --- rlc_finish: one block, or one thread, per live group --------------------
//
// Group g owns the Fp12 terms f[f_off[g] .. f_off[g+1]) and the signature
// terms rsig[s_off[g] .. s_off[g+1]). Its verdict: the product of its f
// terms times the Miller loop of (-g1, the sum of its signature terms),
// after the final exponentiation, is one; none of its aggregates summed to
// infinity; each of its signature rows decoded and lies in G2. Only the
// live groups (`live`, group ids) are launched; the wrapper writes the
// others' verdict (1: an empty product and an infinite sum).
//
// per_thread == 0: one block per live group; thread t of the blockDim
// threads takes terms t, t + blockDim, ... (a strided loop), then the
// partial products fold in a tree over dynamic shared memory (blockDim
// Fp12 values) and the partial sums in a tree over the same buffer, past
// the product's slot; thread 0 runs the tail.
// per_thread == 1: one thread per live group (groups of a few terms: its
// strided loop runs them in turn, no tree), no shared memory.

static_assert(2 * sizeof(jac<fp2>) <= sizeof(fp12),
              "the partial sums share the product tree's buffer");

__global__ void __launch_bounds__(BLS_TREE)
rlc_finish_kernel(const uint32_t* f, const uint32_t* rsig,
                  const bool* agg_inf, const bool* sig_ok,
                  const bool* sig_sub, const int32_t* f_off,
                  const int32_t* s_off, const int32_t* live, int n_live,
                  int per_thread, uint8_t* verdict, const uint32_t* K) {
  extern __shared__ uint4 dyn_smem[];
  int t = 0, T = 1, j;
  if (per_thread) {
    j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_live) return;
  } else {
    j = blockIdx.x;
    t = threadIdx.x;
    T = blockDim.x;
  }
  int g = live[j];
  int f0 = f_off[g], f1 = f_off[g + 1], s0 = s_off[g], s1 = s_off[g + 1];
  jac<fp2> acc = jac_inf<fp2>(K);
  bool bad = false;
  fp12 prod = fp12_one(K), fi;
  for (int i = s0 + t; i < s1; i += T) {
    jac<fp2> q;
    q.x = mont_in2(rsig + 72 * (size_t)i, K);
    q.y = mont_in2(rsig + 72 * (size_t)i + 24, K);
    q.z = mont_in2(rsig + 72 * (size_t)i + 48, K);
    acc = point_add_complete(acc, q, K);
    bad = bad || !sig_ok[i] || !sig_sub[i];
  }
  for (int i = f0 + t; i < f1; i += T) {
    fi = fp12_in(f + 144 * (size_t)i, K);
    fp12_mul_to(prod, prod, fi);
    bad = bad || agg_inf[i];
  }
  if (!per_thread) {
    fp12* fpart = reinterpret_cast<fp12*>(dyn_smem);
    fpart[t] = prod;
    bad = __syncthreads_or(bad);
    int s = 1;
    while (2 * s < T) s *= 2;
    for (; s > 0; s >>= 1) {
      if (t < s && t + s < T) fp12_mul_to(fpart[t], fpart[t], fpart[t + s]);
      __syncthreads();
    }
    // the product stays in fpart[0]; the T partial sums (half an Fp12
    // each) fit in the T - 1 slots after it
    jac<fp2>* part = reinterpret_cast<jac<fp2>*>(fpart + 1);
    block_tree_sum_n(part, acc, T, K);
    if (t != 0) return;
    acc = part[0];
    prod = fpart[0];
  }
  fi = fp12_one(K);
  if (!fp2_is_zero(acc.z)) {
    jac<fp2> h;  // Jacobian -> homogeneous (XZ, Y, Z^3)
    h.x = fp2_mul(acc.x, acc.z);
    h.y = acc.y;
    h.z = fp2_mul(fp2_mul(acc.z, acc.z), acc.z);
    jac<fp> ng;
    ng.x = fp_load(K + 12 * K_NEG_G1_X);
    ng.y = fp_load(K + 12 * K_NEG_G1_Y);
    ng.z = fp_load(K + 12 * K_ONE);
    miller_loop(fi, ng, h, K);
  }
  fp12_mul_to(prod, prod, fi);
  final_exponentiation(prod, K);
  verdict[g] = (fp12_is_one(prod, K) && !bad) ? 1 : 0;
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_miller_loop_pairs(const uint32_t* rpk, const uint32_t* msg,
                          const bool* pair_inf, uint32_t* f, int n,
                          const uint32_t* K, cudaStream_t stream) {
  if (n > 0)
    miller_loop_pairs_kernel<<<(n + 63) / 64, 64, 0, stream>>>(
        rpk, msg, pair_inf, f, n, K);
  return (int)cudaGetLastError();
}

// The launch over n_live groups at `threads` a group (1: one thread a
// group, 32 to a block, no shared memory; else one block a group with its
// product tree in dynamic shared memory): blocks, threads a block, bytes.
static void finish_geometry(int n_live, int threads, int* blocks,
                            int* block, size_t* smem) {
  int per_thread = threads <= 1;
  *block = per_thread ? 32 : threads;
  *blocks = per_thread ? (n_live + 31) / 32 : n_live;
  *smem = per_thread ? 0 : (size_t)threads * sizeof(fp12);
}

static cudaError_t finish_allow_smem() {
  return cudaFuncSetAttribute(rlc_finish_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(BLS_TREE * sizeof(fp12)));
}

int bls_rlc_finish(const uint32_t* f, const uint32_t* rsig,
                   const bool* agg_inf, const bool* sig_ok,
                   const bool* sig_sub, const int32_t* f_off,
                   const int32_t* s_off, const int32_t* live, int n_live,
                   int threads, uint8_t* verdict, const uint32_t* K,
                   cudaStream_t stream) {
  int blocks, block;
  size_t smem;
  finish_geometry(n_live, threads, &blocks, &block, &smem);
  cudaError_t err = finish_allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0)
    rlc_finish_kernel<<<blocks, block, smem, stream>>>(
        f, rsig, agg_inf, sig_ok, sig_sub, f_off, s_off, live, n_live,
        threads <= 1, verdict, K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of the launch bls_rlc_finish makes: blocks,
// threads a block, dynamic shared memory bytes, and the most blocks of
// this shape one SM holds at once. Launches nothing.
int bls_rlc_finish_geometry(int n_live, int threads, int32_t* geometry,
                            const uint32_t* K, cudaStream_t stream) {
  int blocks, block, per_sm = 0;
  size_t smem;
  finish_geometry(n_live, threads, &blocks, &block, &smem);
  cudaError_t err = finish_allow_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rlc_finish_kernel, block, smem);
  geometry[0] = blocks;
  geometry[1] = block;
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
