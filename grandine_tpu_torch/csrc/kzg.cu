// The G1 ladder of the EIP-4844 blob-KZG plane: g1_scalar_mul.
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. The C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// the kernel replaces in the JAX package, what bounds it on the card and
// what its design does about that is written beside its Python wrapper
// (gpu/kzg.py g1_scalar_mul).
//
// Two lanes a row by G1's endomorphism: phi(x, y) = (bx*x, by*y) acts as
// [x^2] (x the BLS parameter), so k = k1*x^2 + k0 (k0 = k mod x^2, k1 =
// k div x^2, both below 2^128 for k < r) gives [k]P = [k0]P + [k1]phi(P).
// Lane 0 computes [k0]P, lane 1 [k1]phi(P), each by fixed signed windows
// of KZG_W = 5 bits over its 128-bit half from a table of [1..16]
// multiples of its base kept in shared memory (of 3, 4 and 5 bits, 5 was
// the fastest on an H100: PERF.md); then one shuffle and one complete
// addition. Every lane of a warp doubles and adds at the same steps: a
// zero digit is a select, never a branch on a bit. The scalars are public
// (blob field elements, Fiat-Shamir powers), so the final addition may
// branch. The ladder's field is fpc (bls12_381.cuh): each G1 formula
// calls one copy of the Fp product instead of inlining 7-16 of them.
//
// kzg_split, kzg_digit, kzg_lane and kzg_store also compile as plain C++
// (no __CUDACC__), so a row's two lanes can be run in turn on a host
// against the plain PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bls12_381.cuh"

using namespace bls;

#define KZG_HALF_BITS 128    // bits of each half k0, k1 (gpu/kzg.py)
#define KZG_W 5              // bits of a signed window (gpu/kzg.py KZG_WINDOW)
#define KZG_THREADS 32       // threads a block: 16 rows of two lanes

// x^2 as 4 little-endian words: phi acts on G1 as [x^2]
BLS_CONST uint32_t KZG_X2[4] = {0x00000000u, 0x00000001u, 0x0001a402u,
                                0xac45a401u};

// h = k0 = k mod x^2 (half 0) or k1 = k div x^2 (half 1), 4 words, for k
// (8 little-endian words) below 2^255: binary long division from the
// remainder k >> 128 (below 2^127 < x^2), 128 shift-and-subtract steps.
BLS_HD void kzg_split(const uint32_t* k, int half, uint32_t* h) {
  uint32_t q[4] = {0, 0, 0, 0};
  uint32_t rem[5] = {k[4], k[5], k[6], k[7], 0};
#pragma unroll 1
  for (int i = KZG_HALF_BITS - 1; i >= 0; i--) {
#pragma unroll
    for (int w = 4; w > 0; w--) rem[w] = (rem[w] << 1) | (rem[w - 1] >> 31);
    rem[0] = (rem[0] << 1) | ((k[i >> 5] >> (i & 31)) & 1u);
    uint32_t dif[5];
    int64_t br = 0;
#pragma unroll
    for (int w = 0; w < 5; w++) {
      int64_t s = (int64_t)rem[w] - (int64_t)(w < 4 ? KZG_X2[w] : 0u) + br;
      dif[w] = (uint32_t)s;
      br = s >> 32;
    }
    uint32_t take = 0u - (uint32_t)(br == 0);
#pragma unroll
    for (int w = 0; w < 5; w++) rem[w] = (dif[w] & take) | (rem[w] & ~take);
    q[i >> 5] |= (take & 1u) << (i & 31);
  }
#pragma unroll
  for (int w = 0; w < 4; w++) h[w] = half ? q[w] : rem[w];
}

// Signed window i of h (Booth): bits W*i - 1 .. W*i + W - 1 of h (W =
// KZG_W, zero outside 0..127) give a digit in [-2^(W-1), 2^(W-1)], and h =
// sum digit_i * 2^(W*i) over ceil(129 / W) windows (the top window's sign
// bit lies above bit 127).
BLS_HD int kzg_digit(const uint32_t* h, int i) {
  constexpr int W = KZG_W;
  uint32_t u = 0;
#pragma unroll
  for (int j = 0; j <= W; j++) {
    int b = W * i - 1 + j;
    uint32_t bit = (b >= 0 && b < KZG_HALF_BITS)
        ? (h[b >> 5] >> (b & 31)) & 1u : 0u;
    u |= bit << j;
  }
  return (int)((u >> 1) + (u & 1u)) - (int)((u >> W) << W);
}

// table entry e ([e + 1]Q) at word w of a lane's column: tab[(36e + w) *
// stride] (stride = threads a block on the card, so neighbouring lanes
// read neighbouring words)
BLS_HD void tab_store(uint32_t* tab, int stride, int e, const jac<fpc>& v) {
  const uint32_t* pv = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int w = 0; w < 36; w++) tab[(36 * e + w) * stride] = pv[w];
}

BLS_HD jac<fpc> tab_load(const uint32_t* tab, int stride, int e) {
  jac<fpc> v;
  uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int w = 0; w < 36; w++) pv[w] = tab[(36 * e + w) * stride];
  return v;
}

// One lane of a row: [k0]P (half 0) or [k1]phi(P) (half 1), px, py the
// affine canonical words of P, k 8 little-endian words (k < r). The table
// holds [1]Q (affine, Z = 1), [2]Q by doubling and [j]Q = [j - 1]Q + Q by
// mixed additions up to 2^(W-1) (W = KZG_W; never +-Q: 2 <= j - 1 <
// r - 1). Each window: W doublings (none before the top one), then the
// digit's entry, negated for a negative digit, added by the complete
// addition (the state is infinity before the first nonzero digit, [a]Q
// with a = 2^W * A, A >= 1 the Booth prefix, after it: a > 2^(W-1) >=
// |digit|, so the generic case); a zero digit keeps the state by a select.
BLS_HD jac<fpc> kzg_lane(const uint32_t* px, const uint32_t* py,
                         const uint32_t* k, int half, uint32_t* tab,
                         int stride, const uint32_t* K) {
  constexpr int W = KZG_W;
  constexpr int E = 1 << (W - 1);
  constexpr int NWIN = (KZG_HALF_BITS + W) / W;  // ceil(129 / W)
  uint32_t h[4];
  kzg_split(k, half, h);
  fp x = mont_in(px, K), y = mont_in(py, K);
  uint32_t ph = 0u - (uint32_t)(half != 0);
  fpc qx = {ct_select(ph, fp_mul(x, fp_load(K + 12 * K_G1_BX)), x)};
  fpc qy = {ct_select(ph, fp_mul(y, fp_load(K + 12 * K_G1_BY)), y)};
  jac<fpc> t;
  t.x = qx;
  t.y = qy;
  f_one(t.z, K);
  tab_store(tab, stride, 0, t);
  t = point_double(t);
  tab_store(tab, stride, 1, t);
#pragma unroll 1
  for (int e = 2; e < E; e++) {
    t = point_madd_unsafe(t, qx, qy);
    tab_store(tab, stride, e, t);
  }
  jac<fpc> st = jac_inf<fpc>(K);
#pragma unroll 1
  for (int i = NWIN - 1; i >= 0; i--) {
    if (i < NWIN - 1)
      for (int s = 0; s < W; s++) st = point_double(st);
    int dg = kzg_digit(h, i);
    int mag = dg < 0 ? -dg : dg;
    uint32_t nz = 0u - (uint32_t)(dg != 0), neg = 0u - (uint32_t)(dg < 0);
    jac<fpc> e = tab_load(tab, stride, mag > 0 ? mag - 1 : 0);
    e.y.v = ct_select(neg, fp_neg(e.y.v), e.y.v);
    st = ct_select(nz, point_add_complete(st, e, K), st);
  }
  return st;
}

// the row's result (3 x 12 canonical words): lane 0's sum plus lane 1's
// by the complete addition, infinity (1, 1, 0) when P is
BLS_HD void kzg_store(uint32_t* out, const jac<fpc>& lo, const jac<fpc>& hi,
                      bool inf, const uint32_t* K) {
  jac<fpc> st = inf ? jac_inf<fpc>(K) : point_add_complete(lo, hi, K);
  mont_out(out, st.x.v);
  mont_out(out + 12, st.y.v);
  mont_out(out + 24, st.z.v);
}

#ifdef __CUDACC__
// --- g1_scalar_mul: two lanes a row, one warp a block -----------------------

// Thread t runs lane t & 1 of row t >> 1 with its table column in dynamic
// shared memory; threads past the last row run its ladder again (the
// warp's shuffle takes every lane) and store nothing.
__global__ void __launch_bounds__(KZG_THREADS)
g1_scalar_mul_kernel(const uint32_t* px, const uint32_t* py, const bool* inf,
                     const uint32_t* k, int n, uint32_t* out,
                     const uint32_t* K) {
  extern __shared__ uint32_t kzg_tab[];
  int t = blockIdx.x * KZG_THREADS + threadIdx.x;
  int row = t >> 1, half = t & 1;
  int r = row < n ? row : n - 1;
  jac<fpc> st = kzg_lane(px + 12 * (size_t)r, py + 12 * (size_t)r,
                         k + 8 * (size_t)r, half, kzg_tab + threadIdx.x,
                         KZG_THREADS, K);
  jac<fpc> hi = shfl_xor_words(st, 1);
  if (half == 0 && row < n)
    kzg_store(out + 36 * (size_t)row, st, hi, inf[row], K);
}

// dynamic shared memory a block: each thread's table of 2^(KZG_W - 1)
// Jacobian entries
#define KZG_SMEM ((1 << (KZG_W - 1)) * 36 * 4 * KZG_THREADS)

// --- C interface --------------------------------------------------------

extern "C" {

int bls_g1_scalar_mul(const uint32_t* px, const uint32_t* py, const bool* inf,
                      const uint32_t* k, int n, uint32_t* out,
                      const uint32_t* K, cudaStream_t stream) {
  // one warp a block, 16 rows: a batch verify's 32 rows take 2 SMs, a
  // setup's 4,096 rows 256 blocks over every SM
  cudaError_t err = cudaFuncSetAttribute(
      g1_scalar_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KZG_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    g1_scalar_mul_kernel<<<(2 * n + KZG_THREADS - 1) / KZG_THREADS,
                           KZG_THREADS, KZG_SMEM, stream>>>(
        px, py, inf, k, n, out, K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of the launch bls_g1_scalar_mul makes over n rows:
// blocks, threads a block, shared memory bytes, and the most blocks of
// this shape one SM holds at once. Launches nothing.
int bls_g1_scalar_mul_geometry(int n, int32_t* geometry, const uint32_t* K,
                               cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      g1_scalar_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KZG_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, g1_scalar_mul_kernel, KZG_THREADS, KZG_SMEM);
  geometry[0] = (2 * n + KZG_THREADS - 1) / KZG_THREADS;
  geometry[1] = KZG_THREADS;
  geometry[2] = KZG_SMEM;
  geometry[3] = per_sm;
  return (int)err;
}

}  // extern "C"
#endif
