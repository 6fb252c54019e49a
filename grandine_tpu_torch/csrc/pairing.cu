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

// --- rlc_finish: one block ---------------------------------------------------
//
// Sum of r_i*sig_i (a strided loop, then block_tree_sum), the Miller loop
// of (-g1, that sum), the product of every f_i (a strided loop, then a tree
// over the block's partial products), the final exponentiation, and the
// verdict: product == 1, no real aggregate summed to infinity, every
// signature row decoded, every signature row in G2.

#define BLS_FINISH_DYN_SMEM (BLS_TREE * sizeof(fp12))  // 72 KiB

__global__ void __launch_bounds__(BLS_TREE)
rlc_finish_kernel(const uint32_t* f, const uint32_t* rsig,
                  const bool* agg_inf, const bool* sig_ok,
                  const bool* sig_sub, int n, uint8_t* verdict,
                  const uint32_t* K) {
  __shared__ jac<fp2> part[BLS_TREE];
  // the partial Fp12 products: 72 KiB, past the 48 KiB of static shared
  // memory, so dynamic (bls_rlc_finish raises the kernel's limit)
  extern __shared__ uint4 dyn_smem[];
  fp12* fpart = reinterpret_cast<fp12*>(dyn_smem);
  int t = threadIdx.x;
  jac<fp2> acc = jac_inf<fp2>(K);
  bool forged = false, bad = false;
  fp12 prod = fp12_one(K), fi;
  for (int i = t; i < n; i += BLS_TREE) {
    jac<fp2> q;
    q.x = mont_in2(rsig + 72 * (size_t)i, K);
    q.y = mont_in2(rsig + 72 * (size_t)i + 24, K);
    q.z = mont_in2(rsig + 72 * (size_t)i + 48, K);
    acc = point_add_complete(acc, q, K);
    fi = fp12_in(f + 144 * (size_t)i, K);
    fp12_mul_to(prod, prod, fi);
    forged = forged || agg_inf[i];
    bad = bad || !sig_ok[i] || !sig_sub[i];
  }
  fpart[t] = prod;
  forged = __syncthreads_or(forged);
  bad = __syncthreads_or(bad);
  for (int s = BLS_TREE / 2; s > 0; s >>= 1) {
    if (t < s) fp12_mul_to(fpart[t], fpart[t], fpart[t + s]);
    __syncthreads();
  }
  block_tree_sum(part, acc, K);
  if (t != 0) return;
  jac<fp2> sig = part[0];
  fi = fp12_one(K);
  if (!fp2_is_zero(sig.z)) {
    jac<fp2> h;  // Jacobian -> homogeneous (XZ, Y, Z^3)
    h.x = fp2_mul(sig.x, sig.z);
    h.y = sig.y;
    h.z = fp2_mul(fp2_mul(sig.z, sig.z), sig.z);
    jac<fp> ng;
    ng.x = fp_load(K + 12 * K_NEG_G1_X);
    ng.y = fp_load(K + 12 * K_NEG_G1_Y);
    ng.z = fp_load(K + 12 * K_ONE);
    miller_loop(fi, ng, h, K);
  }
  fp12_mul_to(prod, fpart[0], fi);
  final_exponentiation(prod, K);
  verdict[0] = (fp12_is_one(prod, K) && !forged && !bad) ? 1 : 0;
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

int bls_rlc_finish(const uint32_t* f, const uint32_t* rsig,
                   const bool* agg_inf, const bool* sig_ok,
                   const bool* sig_sub, int n, uint8_t* verdict,
                   const uint32_t* K, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rlc_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BLS_FINISH_DYN_SMEM);
  if (err != cudaSuccess) return (int)err;
  rlc_finish_kernel<<<1, BLS_TREE, BLS_FINISH_DYN_SMEM, stream>>>(
      f, rsig, agg_inf, sig_ok, sig_sub, n, verdict, K);
  return (int)cudaGetLastError();
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
