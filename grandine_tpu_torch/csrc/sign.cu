// The secret-scalar kernels: batch_sign (the device signing plane) and its
// G1 twin batch_pubkey.
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). Every field value
// crossing a kernel boundary is a canonical value as 12 little-endian
// uint32 words; Montgomery form lives only inside a kernel. The C entry
// launches on the stream it is given and returns cudaGetLastError(). What
// the kernel replaces in the JAX package, what bounds it on the card and
// what its design does about that is written beside its Python wrapper
// (gpu/bls.py batch_sign, batch_pubkey).
//
// batch_sign splits each signature across LANES (1, 2 or 4) lanes of a warp
// by G2's endomorphism: psi acts on G2 as [x] (x < 0, the BLS parameter),
// so B_i = (-psi)^i(H) = [|x|^i]H, and with the secret's base-|x| digits
// (sk = d0 + d1|x| + d2|x|^2 + d3|x|^3, each d_i < |x| < 2^64, since
// r < |x|^4) [sk]H = sum [d_i]B_i. A lane runs one 64-step ladder over
// its 4 / LANES bases, then the lanes' sums meet in a shuffle tree of
// complete additions.
//
// The secret never steers control flow: every lane runs exactly
// SIGN_DIGIT_BITS steps of one doubling and a mixed addition a base, the
// digit bits and the "started" state choose between computed values
// through word masks (ct_select); the tree's addition (point_add_ct)
// computes every case of the complete addition and selects by masks. No
// branch and no loop bound depends on a digit or on a point derived from
// one; the lane index and the row count are public. The field arithmetic
// of bls12_381.cuh keeps its data-dependent conditional reductions, so
// this is branchless on the secret, not hardened against physical side
// channels (the caveat of the JAX kernel it replaces).
//
// batch_pubkey is a fixed-base comb from the generator: with the GLV halves
// sk = +-k0 +- k1*lambda (each below 2^128), k_h = sum d_j 16^j over 32
// 4-bit windows, and [sk]g1 = sum_h sum_j [+-d_j](16^j lambda^h g1), each
// term a lookup in a table of T[h][j][d-1] = [d 16^j lambda^h]g1 (960
// affine points, gpu/_build.py comb_table). PUBKEY_LANES lanes a key each
// add up 64 / PUBKEY_LANES windows by mixed additions on fpc, then meet in
// the same shuffle tree of complete additions; no doubling at all. Every
// lane reads all 15 entries of its window and selects by masks, so no
// branch, loop bound or address depends on a digit.
//
// sign_lane, pubkey_lane, point_add_ct, sign_store and pubkey_store also
// compile as plain C++ (no __CUDACC__), so a row's lanes can be run in turn
// on a host, the shuffle tree emulated, against the plain PyTorch versions.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bls12_381.cuh"

using namespace bls;

#define SIGN_DIGIT_BITS 64  // bits of each base-|x| digit (gpu/bls.py)
#define PUBKEY_WINDOWS 32  // windows of a GLV half (_build.py COMB_SHAPE)
#define PUBKEY_DIGITS 15   // entries of a window: the nonzero digits
// lanes a key (gpu/bls.py PUBKEY_LANES): the fastest at a full bucket of
// 16,384 keys, where the warps share the schedulers' issue slots and each
// level of the join costs every lane a complete addition
#define PUBKEY_LANES 2

// all ones when every word of a is zero, else 0: no branch
template <class T>
BLS_HD uint32_t ct_zero_mask(const T& a) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); i++) acc |= pa[i];
  return 0u - (uint32_t)(acc == 0);
}

// one slot of a ladder step: st + (bx, by) when the bit is set (the base
// itself before the first set bit), st otherwise; both candidates are
// computed every time
template <class F>
BLS_HD void ladder_slot(jac<F>& st, uint32_t& started, uint32_t bit,
                        const F& bx, const F& by, const F& one) {
  jac<F> added = point_madd_unsafe(st, bx, by);
  jac<F> first;
  first.x = bx;
  first.y = by;
  first.z = one;
  st = ct_select(bit, ct_select(started, added, first), st);
  started |= bit;
}

// (x, y) <- -psi(x, y), affine Montgomery: [|x|](x, y) on G2
BLS_HD void neg_psi(fp2& x, fp2& y, const uint32_t* K) {
  x = fp2_mul(kfp2(K, K_PSI_CX0, K_PSI_CX1), fp2_conj(x));
  y = fp2_neg(fp2_mul(kfp2(K, K_PSI_CY0, K_PSI_CY1), fp2_conj(y)));
}

// The complete addition of bls12_381.cuh point_add_complete without a
// branch: the generic sum, the doubling and infinity are all computed and
// chosen by masks in the priority of gpu/curve.py point_add_complete
// (p infinite -> q, q infinite -> p, equal -> [2]p, opposite -> infinity).
template <class F>
BLS_NI jac<F> point_add_ct(const jac<F>& p, const jac<F>& q,
                           const uint32_t* K) {
  F Z1Z1 = f_mul(p.z, p.z), Z2Z2 = f_mul(q.z, q.z);
  F U1 = f_mul(p.x, Z2Z2), U2 = f_mul(q.x, Z1Z1);
  F t1 = f_mul(q.z, Z2Z2), t2 = f_mul(p.z, Z1Z1);
  F Z1Z2 = f_mul(p.z, q.z);
  F H = f_sub(U2, U1);
  F H2 = f_add(H, H);
  F ZZ2 = f_add(Z1Z2, Z1Z2);
  F S1 = f_mul(p.y, t1), S2 = f_mul(q.y, t2);
  F r = f_sub(S2, S1);
  r = f_add(r, r);
  uint32_t p_inf = ct_zero_mask(p.z), q_inf = ct_zero_mask(q.z);
  uint32_t eq_x = ct_zero_mask(H), eq_y = ct_zero_mask(r);
  F I = f_mul(H2, H2);
  jac<F> o;
  o.z = f_mul(ZZ2, H);
  F J = f_mul(H, I), V = f_mul(U1, I), R2 = f_mul(r, r);
  o.x = f_sub(R2, f_add(J, f_add(V, V)));
  F t = f_mul(r, f_sub(V, o.x)), S1J = f_mul(S1, J);
  o.y = f_sub(t, f_add(S1J, S1J));
  o = ct_select(eq_x & ~eq_y & ~p_inf & ~q_inf, jac_inf<F>(K), o);
  o = ct_select(eq_x & eq_y, point_double(p), o);
  o = ct_select(q_inf, p, o);
  return ct_select(p_inf, q, o);
}

// Lane `lane` of LANES of one signature: msg = [x | y] of H (2 x 24
// canonical words), d the four base-|x| digits as 4 x 2 little-endian
// words. The lane's bases are B_i = (-psi)^i(H) for i = lane * PER ..
// lane * PER + PER - 1 (PER = 4 / LANES), the first reached through masks
// so every lane runs the same (LANES - 1) * PER maps; returns
// sum [d_i]B_i over them by one joint ladder of SIGN_DIGIT_BITS steps.
//
// Its mixed additions never meet P = +-Q, nor an infinite accumulator once
// started. The lane's bases are [|x|^i]B for its first base B. Before the
// slot of base i adds, the accumulator is [c]B with c = sum u_j |x|^j, u_j
// the prefix of digit j read so far: this step's bit included for the
// slots before i, doubled (even) for i and after. Every u_j <= d_j < |x|
// (sign_digits_host), so the u_j are c's base-|x| digits, and c > 0 once
// started. c != |x|^i since u_i is even. With one or two bases c < x^2 < r,
// so c != -|x|^i mod r and c != 0 mod r. With four (LANES = 1) c < x^4 =
// r + x^2 - 1: c = |x|^i mod r needs c = r + |x|^i (i <= 1), c = -|x|^i
// needs c = r - |x|^i, and c = 0 needs c = r. In base |x| each of r + 1,
// r - 1 (i = 0), r + |x|, r - |x| (i = 1) and r - x^2 (i = 2) has an odd
// digit at j >= i, where u_j is even; r - |x|^3 = (1, 0, |x| - 1, |x| - 2)
// and r = (1, 0, |x| - 1, |x| - 1) need every prefix at its full digit,
// that is sk = r.
template <int LANES>
BLS_HD jac<fp2> sign_lane(const uint32_t* msg, const uint32_t* d, int lane,
                          const uint32_t* K) {
  constexpr int PER = 4 / LANES;
  fp2 bx[PER], by[PER];
  bx[0] = mont_in2(msg, K);
  by[0] = mont_in2(msg + 24, K);
  for (int j = 1; j <= (LANES - 1) * PER; j++) {  // the lane's first base
    fp2 nx = bx[0], ny = by[0];
    neg_psi(nx, ny, K);
    uint32_t take = 0u - (uint32_t)(j <= lane * PER);
    bx[0] = ct_select(take, nx, bx[0]);
    by[0] = ct_select(take, ny, by[0]);
  }
  for (int i = 1; i < PER; i++) {
    bx[i] = bx[i - 1];
    by[i] = by[i - 1];
    neg_psi(bx[i], by[i], K);
  }
  fp2 one;
  f_one(one, K);
  jac<fp2> st = jac_inf<fp2>(K);
  uint32_t started = 0;
  const uint32_t* dl = d + 2 * PER * lane;
#pragma unroll 1
  for (int s = SIGN_DIGIT_BITS - 1; s >= 0; s--) {  // fixed trip count
    st = point_double(st);
#pragma unroll
    for (int i = 0; i < PER; i++) {
      uint32_t bit = 0u - ((dl[2 * i + (s >> 5)] >> (s & 31)) & 1u);
      ladder_slot(st, started, bit, bx[i], by[i], one);
    }
  }
  return st;
}

// the row's result (3 x 24 canonical words), infinity when inf
BLS_HD void sign_store(uint32_t* out, const jac<fp2>& st, bool inf,
                       const uint32_t* K) {
  jac<fp2> r = ct_select(0u - (uint32_t)inf, jac_inf<fp2>(K), st);
  mont_out2(out, r.x);
  mont_out2(out + 24, r.y);
  mont_out2(out + 48, r.z);
}

// Lane `lane` of PUBKEY_LANES of one key: k = |k0|, |k1| as 4 + 4
// little-endian words, neg their signs, T the comb table (2 x 32 x 15
// affine Montgomery points, 24 words each). The lane takes half h = lane /
// HL (HL = PUBKEY_LANES / 2) and its W = 32 / HL windows j = j0 .. j0 + W
// - 1, j0 = W * (lane % HL), in ascending order: each step selects entry d - 1 of window j (d
// the window's digit) from all 15 by masks, negates y by the half's sign
// mask, and adds it by the mixed addition under the "started" mask
// (ladder_slot); a zero digit keeps the accumulator. Returns the lane's
// sum, infinity when every digit of its windows is zero.
//
// Its mixed additions never meet P = +-Q, nor an infinite accumulator once
// started. With B = +-lambda^h g1, before window j the accumulator is [c]B
// with c = sum_{j0 <= i < j} d_i 16^i < 16^j <= d 16^j, and the entry is
// [d 16^j]B, so c != d 16^j; c + d 16^j < 16^(j + 1) <= 2^128 < r, so
// c != -d 16^j mod r; and c = 0 only before the first nonzero digit, which
// the mask covers.
BLS_HD jac<fpc> pubkey_lane(const uint32_t* k, const bool* neg, int lane,
                            const uint32_t* T, const uint32_t* K) {
  constexpr int HL = PUBKEY_LANES / 2;        // lanes of a half
  constexpr int W = PUBKEY_WINDOWS / HL;      // windows of a lane
  int h = lane / HL, j0 = W * (lane % HL);
  const uint32_t* kh = k + 4 * h;
  uint32_t sign = 0u - (uint32_t)neg[h];
  fpc one;
  f_one(one, K);
  jac<fpc> st = jac_inf<fpc>(K);
  uint32_t started = 0;
#pragma unroll 1
  for (int s = 0; s < W; s++) {  // fixed trip count
    int j = j0 + s;
    uint32_t d = (kh[j >> 3] >> (4 * (j & 7))) & 15u;
    const uint32_t* win = T + 24 * PUBKEY_DIGITS * (PUBKEY_WINDOWS * h + j);
    fpc qx, qy;
    qx.v = fp_zero();
    qy.v = fp_zero();
#pragma unroll
    for (int e = 0; e < PUBKEY_DIGITS; e++) {
      uint32_t m = 0u - (uint32_t)(d == (uint32_t)(e + 1));
#pragma unroll
      for (int w = 0; w < 12; w++) {
        qx.v.l[w] |= win[24 * e + w] & m;
        qy.v.l[w] |= win[24 * e + 12 + w] & m;
      }
    }
    qy.v = ct_select(sign, fp_neg(qy.v), qy.v);
    ladder_slot(st, started, 0u - (uint32_t)(d != 0), qx, qy, one);
  }
  return st;
}

// a key's result (3 x 12 canonical words)
BLS_HD void pubkey_store(uint32_t* out, const jac<fpc>& st) {
  mont_out(out, st.x.v);
  mont_out(out + 12, st.y.v);
  mont_out(out + 24, st.z.v);
}

#ifdef __CUDACC__
// --- batch_sign: LANES lanes a signature, one warp a block ------------------

// Thread t runs lane t % LANES of row t / LANES; lanes past the last row
// run its ladder again (every lane of the warp takes part in the shuffles)
// and store nothing. The tree adds lane m's sum into lane 0's side at each
// level (m = 1, 2): lane 0 ends with (P0 + P1) + (P2 + P3).
template <int LANES>
__global__ void __launch_bounds__(32)
batch_sign_kernel(const uint32_t* msg, const bool* msg_inf, const uint32_t* d,
                  int n, uint32_t* out, const uint32_t* K) {
  int t = blockIdx.x * 32 + threadIdx.x;
  int row = t / LANES, lane = t % LANES;
  int r = row < n ? row : n - 1;
  jac<fp2> st = sign_lane<LANES>(msg + 48 * (size_t)r, d + 8 * (size_t)r,
                                 lane, K);
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1)
    st = point_add_ct(st, shfl_xor_words(st, m), K);
  if (lane == 0 && row < n)
    sign_store(out + 72 * (size_t)row, st, msg_inf[row], K);
}

// --- batch_pubkey: PUBKEY_LANES lanes a key, one warp a block --------------

// Thread t runs lane t % PUBKEY_LANES of key t / PUBKEY_LANES; lanes past
// the last key run its comb again (every lane of the warp takes part in
// the shuffles) and store nothing. The tree adds lane m's sum into lane
// 0's side at each level (m = 1, ...): lane 0 ends with P0 + P1.
__global__ void __launch_bounds__(32)
batch_pubkey_kernel(const uint32_t* k, const bool* neg, int n, uint32_t* out,
                    const uint32_t* T, const uint32_t* K) {
  int t = blockIdx.x * 32 + threadIdx.x;
  int row = t / PUBKEY_LANES, lane = t % PUBKEY_LANES;
  int r = row < n ? row : n - 1;
  jac<fpc> st = pubkey_lane(k + 8 * (size_t)r, neg + 2 * (size_t)r, lane, T,
                            K);
#pragma unroll
  for (int m = 1; m < PUBKEY_LANES; m <<= 1)
    st = point_add_ct(st, shfl_xor_words(st, m), K);
  if (lane == 0 && row < n) pubkey_store(out + 36 * (size_t)row, st);
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_batch_sign(const uint32_t* msg, const bool* msg_inf,
                   const uint32_t* d, int n, int lanes, uint32_t* out,
                   const uint32_t* K, cudaStream_t stream) {
  // one warp a block, 32 / lanes signatures a warp: a lane batch of 512
  // rows at 4 lanes is 64 blocks, one warp on each of 64 SMs
  int blocks = (int)(((long long)n * lanes + 31) / 32);
  if (lanes != 1 && lanes != 2 && lanes != 4)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && lanes == 4)
    batch_sign_kernel<4><<<blocks, 32, 0, stream>>>(msg, msg_inf, d, n, out,
                                                    K);
  else if (n > 0 && lanes == 2)
    batch_sign_kernel<2><<<blocks, 32, 0, stream>>>(msg, msg_inf, d, n, out,
                                                    K);
  else if (n > 0)
    batch_sign_kernel<1><<<blocks, 32, 0, stream>>>(msg, msg_inf, d, n, out,
                                                    K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of the launch bls_batch_sign makes over n rows at
// `lanes` lanes a row: blocks, threads a block, shared memory bytes, and
// the most blocks of this shape one SM holds at once. Launches nothing.
int bls_batch_sign_geometry(int n, int lanes, int32_t* geometry,
                            const uint32_t* K, cudaStream_t stream) {
  if (lanes != 1 && lanes != 2 && lanes != 4)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lanes == 4 ? batch_sign_kernel<4>
               : lanes == 2 ? batch_sign_kernel<2> : batch_sign_kernel<1>,
      32, 0);
  geometry[0] = (int)(((long long)n * lanes + 31) / 32);
  geometry[1] = 32;
  geometry[2] = 0;
  geometry[3] = per_sm;
  return (int)err;
}

int bls_batch_pubkey(const uint32_t* k, const bool* neg, int n, uint32_t* out,
                     const uint32_t* T, const uint32_t* K,
                     cudaStream_t stream) {
  // one warp a block, 32 / PUBKEY_LANES keys a warp: a full bucket of
  // 16,384 keys is 1,024 one-warp blocks, ~7.8 warps an SM
  int blocks = (int)(((long long)n * PUBKEY_LANES + 31) / 32);
  if (n > 0)
    batch_pubkey_kernel<<<blocks, 32, 0, stream>>>(k, neg, n, out, T, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
