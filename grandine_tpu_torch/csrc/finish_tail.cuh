// rlc_finish for the H100: one block a live group, its tail across a warp;
// and miller_loop_pairs: one warp a pair, on the same warp programs.
//
// A group's block folds its terms with all of its threads, then warp 0
// runs the Miller loop of (-g1, the sum of its signature terms), the
// product with its f terms and the final exponentiation as a sequence of
// warp programs (csrc/finish_programs.cuh, generated by
// gpu/finish_programs.py): each program is rounds of at most 32
// independent Fp products, one a lane, whose operands are linear forms of
// earlier values, then an output stage writing each output Fp value (a
// linear form of the products) from its own lane. Every square of the
// Miller loop is the 36-product fp12_sq_fast, every line enters as the
// 42-product sparse product, every square of the hard part is a 18-product
// cyclotomic square, and the one Fp inversion (of the Fp12 value's norm)
// is a binary extended Euclid on one lane, off the Fermat chain. All Fp12
// values live in shared memory; a lane holds only the Fp values of the
// product or form it is computing.
//
// miller_loop_pairs runs, on each warp, one pair's loop: the coefficient
// program of its Jacobian P (yP, zP^3, -xP zP), then 63 doubling and 5
// addition programs with those coefficients and its affine Q, and writes
// conj(f) as canonical words (miller_pair below).
//
// The same code compiles as plain C++ (no __CUDACC__): a stage's 32 lanes
// (or a block's threads, or its warps) then run in turn between the
// synchronisation points, so a host harness reproduces the kernel's words
// exactly.
#pragma once
#include "bls12_381.cuh"

#ifdef __CUDACC__
#define BLS_GTABLE __device__ const
#else
#define BLS_GTABLE static const
#endif
#include "finish_programs.cuh"

// rows a unit of a group-sum or rlc_partial tile folds in order, mirrored
// in gpu/bls.py (its group_sum_plan) and chosen by ladder_timing.py's
// runs; a build sets another value (-D) only for such a run
// (ladder_timing.py TREE:NAME=V)
#ifndef GROUP_CHUNK
#define GROUP_CHUNK 2
#endif

namespace bls {

// the live units of a plan's tile of `count` items (gpu/bls.py
// group_sum_plan), and the first level of their fold
BLS_HD int gs_units(int count) {
  return (count + GROUP_CHUNK - 1) / GROUP_CHUNK;
}
BLS_HD int gs_top(int k) {
  int s = 1;
  while (s < k) s <<= 1;
  return s >> 1;
}

namespace tail {

// --- stages ----------------------------------------------------------------

#ifdef __CUDACC__
// fn(lane) on each lane of the calling warp, then the warp synchronises
template <class Fn>
__device__ __forceinline__ void warp_each(Fn fn) {
  fn((int)(threadIdx.x & 31));
  __syncwarp();
}
// fn(thread) on each of the block's T threads, then the block synchronises
template <class Fn>
__device__ __forceinline__ void block_each(int, Fn fn) {
  fn((int)threadIdx.x);
  __syncthreads();
}
// fn(warp) on each warp of the block, then the block synchronises
template <class Fn>
__device__ __forceinline__ void warps_each(int, Fn fn) {
  fn((int)(threadIdx.x >> 5));
  __syncthreads();
}
// fn(warp) on the calling warp, with no synchronisation (the warps of the
// block are independent)
template <class Fn>
__device__ __forceinline__ void each_warp(int, Fn fn) {
  fn((int)(threadIdx.x >> 5));
}
BLS_HD int ctz32(uint32_t x) { return __ffs(x) - 1; }
#define TAIL_HHD __host__ __device__ __forceinline__
#else
template <class Fn>
static inline void warp_each(Fn fn) {
  for (int l = 0; l < 32; l++) fn(l);
}
template <class Fn>
static inline void block_each(int T, Fn fn) {
  for (int t = 0; t < T; t++) fn(t);
}
template <class Fn>
static inline void warps_each(int T, Fn fn) {
  for (int w = 0; w < T / 32; w++) fn(w);
}
template <class Fn>
static inline void each_warp(int W, Fn fn) {
  for (int w = 0; w < W; w++) fn(w);
}
BLS_HD int ctz32(uint32_t x) { return __builtin_ctz(x); }
#define TAIL_HHD static inline
#endif

// --- linear forms ------------------------------------------------------------

// the Fp value of a slot: one of the program's four groups, its scratch or
// a constant
BLS_HD uint32_t* slot_ptr(uint32_t* const g[4], uint32_t* scratch,
                          uint32_t slot) {
  uint32_t kind = slot >> 12, idx = slot & 0xFFFu;
  uint32_t* base = kind == 0   ? g[0]
                   : kind == 1 ? g[1]
                   : kind == 2 ? g[2]
                   : kind == 3 ? g[3]
                   : kind == 4 ? scratch
                               : (uint32_t*)TAIL_CONSTS;
  return base + 12 * idx;
}

// s (13 words, s < 2^388) mod p: for q = floor(hi * d) with hi =
// floor(s / 2^352) and d = floor(2^64 / (p_11 + 1)) / 2^64, q is at most
// the quotient and s - q*p < 3p; s - (q + k)*p for k = 0, 1, 2 run as
// three independent borrow chains and the largest k not below zero wins
// (every lane of a warp takes the same path, whatever its form)
BLS_HD fp fp_reduce_wide(const uint32_t* s) {
  const uint64_t d = 0xFFFFFFFFFFFFFFFFull / 0x1a0111ebull;  // p_11 + 1
  uint64_t hi = ((uint64_t)s[12] << 32) | s[11];
#ifdef __CUDACC__
  uint32_t q = (uint32_t)__umul64hi(hi, d);
#else
  uint32_t q = (uint32_t)(((unsigned __int128)hi * d) >> 64);
#endif
  fp r[3];
  uint64_t c[3] = {0, 0, 0};
  int64_t br[3] = {0, 0, 0};
#pragma unroll
  for (int i = 0; i < 12; i++)
#pragma unroll
    for (int k = 0; k < 3; k++) {
      c[k] += (uint64_t)(q + k) * P[i];
      int64_t v = (int64_t)s[i] - (int64_t)(uint32_t)c[k] + br[k];
      r[k].l[i] = (uint32_t)v;
      br[k] = v >> 32;
      c[k] >>= 32;
    }
  bool two = (int64_t)s[12] - (int64_t)c[2] + br[2] >= 0;
  bool one = (int64_t)s[12] - (int64_t)c[1] + br[1] >= 0;
  fp out;
#pragma unroll
  for (int i = 0; i < 12; i++)
    out.l[i] = two ? r[2].l[i] : one ? r[1].l[i] : r[0].l[i];
  return out;
}

// an Fp value of a slot (16-byte aligned: shared memory, the constant
// table) into registers
BLS_HD fp fp_load_slot(const uint32_t* w) {
#ifdef __CUDACC__
  fp r;
  const uint4* v = reinterpret_cast<const uint4*>(w);
#pragma unroll
  for (int i = 0; i < 3; i++) {
    uint4 x = v[i];
    r.l[4 * i] = x.x;
    r.l[4 * i + 1] = x.y;
    r.l[4 * i + 2] = x.z;
    r.l[4 * i + 3] = x.w;
  }
  return r;
#else
  return fp_load(w);
#endif
}

// coef * value of a term into 64-bit limb sums (coef >= 0)
BLS_HD void add_term(uint64_t* acc, uint32_t* const g[4], uint32_t* scratch,
                     uint32_t term, uint32_t coef) {
  fp x = fp_load_slot(slot_ptr(g, scratch, term & 0xFFFFu));
#pragma unroll
  for (int i = 0; i < 12; i++) acc[i] += (uint64_t)coef * x.l[i];
}

// The form at TAIL_TERMS[off] (len: n_pos | n_neg << 8, its positive
// terms first), reduced: the positive and the negative terms multiply-add
// into two sets of 64-bit limb sums (two terms' loads in flight), the
// negative weight times p keeps the difference non-negative, one carry
// pass and one reduction
BLS_HD fp eval_form(uint32_t* const g[4], uint32_t* scratch, int off,
                    int len) {
  uint64_t pos[12], neg[12];
#pragma unroll
  for (int i = 0; i < 12; i++) pos[i] = neg[i] = 0;
  int n_pos = len & 0xFF, n = n_pos + (len >> 8);
  uint32_t weight = 0;
  for (int k = off; k < off + n_pos; k += 2) {
    uint32_t t0 = TAIL_TERMS[k];
    uint32_t t1 = TAIL_TERMS[k + 1 < off + n_pos ? k + 1 : k];
    add_term(pos, g, scratch, t0, t0 >> 16);
    add_term(pos, g, scratch, t1, k + 1 < off + n_pos ? t1 >> 16 : 0);
  }
  for (int k = off + n_pos; k < off + n; k += 2) {
    uint32_t t0 = TAIL_TERMS[k];
    uint32_t t1 = TAIL_TERMS[k + 1 < off + n ? k + 1 : k];
    uint32_t c0 = (uint32_t)(-(int16_t)(t0 >> 16));
    uint32_t c1 = k + 1 < off + n ? (uint32_t)(-(int16_t)(t1 >> 16)) : 0;
    weight += c0 + c1;
    add_term(neg, g, scratch, t0, c0);
    add_term(neg, g, scratch, t1, c1);
  }
  uint32_t s[13];
  int64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    int64_t v = (int64_t)(pos[i] + (uint64_t)weight * P[i]) -
                (int64_t)neg[i] + carry;
    s[i] = (uint32_t)v;
    carry = v >> 32;
  }
  s[12] = (uint32_t)carry;
  return fp_reduce_wide(s);
}

// --- the interpreter -----------------------------------------------------------

// Program `prog` on groups g0..g3 (Fp values in shared memory, or the
// constant table) with the warp's scratch: every round's products, each
// from its own lane, then every output computed before any is stored, so
// an output group may be an input group.
BLS_NI void run(int prog, uint32_t* g0, uint32_t* g1, uint32_t* g2,
                uint32_t* g3, uint32_t* scratch) {
  uint32_t* const g[4] = {g0, g1, g2, g3};
  const prog_t p = TAIL_PROGS[prog];
  for (int r = p.round0; r < p.round0 + p.n_rounds; r++) {
    int t0 = TAIL_ROUNDS[r], t1 = TAIL_ROUNDS[r + 1];
    warp_each([&](int lane) {
      int t = t0 + lane;
      if (t < t1) {
        const uint16_t* k = TAIL_TASKS + 5 * t;
        fp a = eval_form(g, scratch, k[0], k[1]);
        fp b = eval_form(g, scratch, k[2], k[3]);
        fp_store(slot_ptr(g, scratch, k[4]), fp_mul(a, b));
      }
    });
  }
#ifdef __CUDACC__
  int lane = threadIdx.x & 31;
  fp v;
  const uint16_t* o = TAIL_OUTS + 3 * (p.out0 + lane);
  if (lane < p.n_out) v = eval_form(g, scratch, o[0], o[1]);
  __syncwarp();
  if (lane < p.n_out) fp_store(slot_ptr(g, scratch, o[2]), v);
  __syncwarp();
#else
  fp v[32];
  for (int l = 0; l < p.n_out; l++) {
    const uint16_t* o = TAIL_OUTS + 3 * (p.out0 + l);
    v[l] = eval_form(g, scratch, o[0], o[1]);
  }
  for (int l = 0; l < p.n_out; l++)
    fp_store(slot_ptr(g, scratch, TAIL_OUTS[3 * (p.out0 + l) + 2]), v[l]);
#endif
}

// --- the inversion -------------------------------------------------------------

BLS_HD bool fp_is_canon_one(const fp& a) {
  uint32_t acc = a.l[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < 12; i++) acc |= a.l[i];
  return acc == 0;
}

// a >>= k (0 < k < 32)
BLS_HD void fp_shr(fp& a, int k) {
#pragma unroll
  for (int i = 0; i < 11; i++) a.l[i] = (a.l[i] >> k) | (a.l[i + 1] << (32 - k));
  a.l[11] >>= k;
}

// x * 2^-k mod p (0 < k < 32, x < p): (x + m*p) / 2^k with m = x * (-1/p)
// mod 2^k, which is below p
BLS_HD fp fp_halve_k(const fp& x, int k) {
  uint32_t m = (x.l[0] * BLS_NP0) & ((1u << k) - 1u);
  uint32_t t[13];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    c += (uint64_t)x.l[i] + (uint64_t)m * P[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  t[12] = (uint32_t)c;
  fp r;
#pragma unroll
  for (int i = 0; i < 12; i++) r.l[i] = (t[i] >> k) | (t[i + 1] << (32 - k));
  return r;
}

// a^-1 mod p for canonical a (0 for 0): binary extended Euclid, the value
// public; the invariants x1 * a = u, x2 * a = v (mod p)
BLS_HD fp fp_inv_euclid(const fp& a) {
  if (fp_is_zero(a)) return a;
  fp u = a, v = fp_load(P), x1 = fp_zero(), x2 = fp_zero();
  x1.l[0] = 1;
  while (!fp_is_canon_one(u) && !fp_is_canon_one(v)) {
    if (!(u.l[0] & 1)) {
      int k = u.l[0] ? ctz32(u.l[0]) : 31;
      fp_shr(u, k);
      x1 = fp_halve_k(x1, k);
    } else if (!(v.l[0] & 1)) {
      int k = v.l[0] ? ctz32(v.l[0]) : 31;
      fp_shr(v, k);
      x2 = fp_halve_k(x2, k);
    } else if (fp_geq(u, v)) {  // fp_sub of u >= v takes no p back
      u = fp_sub(u, v);
      x1 = fp_sub(x1, x2);
    } else {
      v = fp_sub(v, u);
      x2 = fp_sub(x2, x1);
    }
  }
  return fp_is_canon_one(u) ? x1 : x2;
}

// Montgomery a*R -> a^-1 * R: the Euclid inverse of the word value
// (a^-1 R^-1), times R^2 twice
BLS_NI void inv_mont(uint32_t* out, const uint32_t* in, const uint32_t* K) {
  fp r2 = fp_load(K + 12 * K_R2);
  fp_store(out, fp_mul(fp_mul(fp_inv_euclid(fp_load(in)), r2), r2));
}

// --- the group's block ------------------------------------------------------------

// Fp values of the tail's buffers (warp 0), in order: F, T, Q, M, T1, U,
// R, N, W
enum TailBuf {
  B_F = 0, B_T = 12, B_Q = 18, B_M = 24, B_T1 = 36, B_U = 48, B_R = 60,
  B_N = 72, B_W = 78, TAIL_WS = 88
};

// Shared memory of one block, in 32-bit words, for T threads, at most NF
// product partials (Fp12) and NS sum partials (Jacobian G2); `terms`: a
// thread takes more than one f term (its second and later ones pass
// through a term buffer, which the sum partials then reuse).
struct layout {
  int fpart, fterm, spart, flag, scratch, tail, words;
};

TAIL_HHD layout finish_layout(int T, int NF, int NS, bool terms) {
  layout l;
  int W = T / 32;
  NF = NF < 1 ? 1 : NF;
  NS = NS < 1 ? 1 : NS;
  l.fpart = 0;
  l.fterm = NF * 144;
  int term_words = terms ? NF * 144 : 0;
  int sum_words = NS * 72;
  l.spart = l.fterm;
  int after = l.fterm + (term_words > sum_words ? term_words : sum_words);
  l.flag = after;
  l.scratch = after + 4;
  // warp 0 runs every program, the others only the fold's and the sum
  // tree's; each has 4 Fp values after its scratch for G2ADD's (H, r)
  l.tail = l.scratch + 12 * (TAIL_SCRATCH + 4 + (W - 1) * (FOLD_SCRATCH + 4));
  l.words = l.tail + 12 * TAIL_WS;
  return l;
}

// warp w's scratch; its 4 side values follow it
BLS_HD uint32_t* warp_scratch(uint32_t* sm, const layout& l, int w) {
  return sm + l.scratch +
         12 * (w == 0 ? 0 : TAIL_SCRATCH + 4 + (w - 1) * (FOLD_SCRATCH + 4));
}

BLS_HD uint32_t* warp_side(uint32_t* scratch, int w) {
  return scratch + 12 * (w == 0 ? TAIL_SCRATCH : FOLD_SCRATCH);
}

// dst <- src, n Fp values (n <= 32), one a lane
BLS_HD void warp_copy(uint32_t* dst, const uint32_t* src, int n) {
  warp_each([&](int lane) {
    if (lane < n) fp_store(dst + 12 * lane, fp_load(src + 12 * lane));
  });
}

BLS_HD void warp_set_one(uint32_t* dst, const uint32_t* K) {
  warp_each([&](int lane) {
    if (lane < 12)
      fp_store(dst + 12 * lane, lane == 0 ? fp_load(K + 12 * K_ONE) : fp_zero());
  });
}

// One level of a product tree by the T-thread block's warps: part[t] *=
// part[t + s] for t < s with t + s < n, warp w taking t = w, w + W, ... (a
// MUL program a product); scratch(w) is warp w's scratch
template <class Scratch>
BLS_HD void warps_mul_level(int T, fp12* part, int s, int n,
                            Scratch scratch) {
  int W = T / 32;
  warps_each(T, [&](int w) {
    for (int t = w; t < s && t + s < n; t += W) {
      uint32_t* a = reinterpret_cast<uint32_t*>(part + t);
      run(PROG_MUL, a, reinterpret_cast<uint32_t*>(part + t + s), a, nullptr,
          scratch(w));
    }
  });
}

// a <- a + b (Jacobian G2) by one warp, with the cases of
// point_add_complete: b at infinity leaves a, a at infinity takes b; the
// generic sum unless H = 0, where the points are equal (r = 0: a doubling
// of b) or opposite (infinity)
BLS_HD void warp_g2_add(uint32_t* a, uint32_t* b, uint32_t* scratch,
                        uint32_t* side, const uint32_t* K) {
  const jac<fp2>& pa = *reinterpret_cast<const jac<fp2>*>(a);
  const jac<fp2>& pb = *reinterpret_cast<const jac<fp2>*>(b);
  if (fp2_is_zero(pb.z)) return;
  if (fp2_is_zero(pa.z)) {
    warp_copy(a, b, 6);
    return;
  }
  run(PROG_G2ADD, a, b, a, side, scratch);
  const fp2& H = *reinterpret_cast<const fp2*>(side);
  const fp2& r = *reinterpret_cast<const fp2*>(side + 24);
  if (!fp2_is_zero(H)) return;
  if (fp2_is_zero(r)) {
    run(PROG_G2DBL, b, a, nullptr, nullptr, scratch);
  } else {
    warp_each([&](int lane) {  // (1, 1, 0)
      if (lane < 6)
        fp_store(a + 12 * lane, (lane == 0 || lane == 2)
                                    ? fp_load(K + 12 * K_ONE) : fp_zero());
    });
  }
}

// base^|x| into acc (cyclotomic base; acc must not be base)
BLS_HD void expx(uint32_t* acc, uint32_t* base, uint32_t* scratch) {
  for (int i = 62; i >= 0; i--)
    run((BLS_ABS_X >> i) & 1 ? PROG_CYC_SQ_MUL : PROG_CYC_SQ,
        i == 62 ? base : acc, base, acc, nullptr, scratch);
}

// buf[B_F] <- buf[B_F]^(3(p^12 - 1)/r), the chain of final_exponentiation
BLS_HD void final_exp(uint32_t* buf, uint32_t* scratch, const uint32_t* K) {
  uint32_t *F = buf + 12 * B_F, *M = buf + 12 * B_M, *T1 = buf + 12 * B_T1,
           *U = buf + 12 * B_U, *R = buf + 12 * B_R, *N = buf + 12 * B_N,
           *W = buf + 12 * B_W;
  run(PROG_INV_N6, F, N, nullptr, nullptr, scratch);
  run(PROG_INV_N2, N, W, nullptr, nullptr, scratch);
  warp_each([&](int lane) {
    if (lane == 0) inv_mont(W + 12 * 9, W + 12 * 8, K);
  });
  run(PROG_INV_EASY, F, W, M, nullptr, scratch);  // m = t^(p^2 + 1)
  expx(R, M, scratch);
  run(PROG_MUL_CONJ_OUT, R, M, T1, nullptr, scratch);  // t1
  expx(R, T1, scratch);
  run(PROG_MUL_CONJ_OUT, R, T1, U, nullptr, scratch);  // t2
  expx(R, U, scratch);
  run(PROG_CONJ_MUL_FROB, R, U, T1, nullptr, scratch);  // t3
  expx(R, T1, scratch);
  expx(U, R, scratch);  // t4 = (t3^|x|)^|x|
  run(PROG_MUL_FROB2_CONJ, U, T1, F, nullptr, scratch);  // t4 t3^(p^2) conj(t3)
  run(PROG_CYC_SQ_MUL, M, M, R, nullptr, scratch);  // m^3
  run(PROG_MUL, F, R, F, nullptr, scratch);
}

// One live group: its verdict. Every thread of the T-thread block calls
// this (no thread leaves before the last synchronisation); `sm` holds
// finish_layout(T, NF, NS, terms).words words.
BLS_HD void finish_group(uint32_t* sm, int T, int NF, int NS, bool terms,
                         const uint32_t* f, const uint32_t* rsig,
                         const bool* agg_inf, const bool* sig_ok,
                         const bool* sig_sub, int f0, int f1, int s0, int s1,
                         const uint32_t* K, uint8_t* verdict) {
  const layout l = finish_layout(T, NF, NS, terms);
  fp12* fpart = reinterpret_cast<fp12*>(sm + l.fpart);
  fp12* fterm = reinterpret_cast<fp12*>(sm + l.fterm);
  jac<fp2>* spart = reinterpret_cast<jac<fp2>*>(sm + l.spart);
  uint32_t* flag = sm + l.flag;
  int nf = f1 - f0 < T ? f1 - f0 : T, ns = s1 - s0 < T ? s1 - s0 : T;
  block_each(T, [&](int t) {
    if (t == 0) *flag = 0;
  });
  // thread t: the product of f terms t, t + T, ... into fpart[t]
  block_each(T, [&](int t) {
    bool bad = false;
    uint32_t* acc = reinterpret_cast<uint32_t*>(fpart + t);
    for (int i = f0 + t; i < f1; i += T) {
      uint32_t* dst = i == f0 + t ? acc : reinterpret_cast<uint32_t*>(fterm + t);
      for (int c = 0; c < 12; c++)
        fp_store(dst + 12 * c, mont_in(f + 144 * (size_t)i + 12 * c, K));
      if (i != f0 + t) fp12_mul_to(fpart[t], fpart[t], fterm[t]);
      bad = bad || agg_inf[i];
    }
    if (bad) *flag = 1;
  });
  // thread t: the sum of signature terms t, t + T, ... into spart[t]
  block_each(T, [&](int t) {
    bool bad = false;
    if (t < ns) {
      jac<fp2> acc = jac_inf<fp2>(K);
      for (int i = s0 + t; i < s1; i += T) {
        jac<fp2> q;
        q.x = mont_in2(rsig + 72 * (size_t)i, K);
        q.y = mont_in2(rsig + 72 * (size_t)i + 24, K);
        q.z = mont_in2(rsig + 72 * (size_t)i + 48, K);
        acc = point_add_complete(acc, q, K);
        bad = bad || !sig_ok[i] || !sig_sub[i];
      }
      spart[t] = acc;
    }
    if (bad) *flag = 1;
  });
  // the sums: spart[t] += spart[t + s] for s = pow2ceil(ns)/2 .. 1, a
  // thread an addition while a level holds more than 4 a warp, then the
  // warps' G2ADD programs, a warp an addition (on an H100 a thread's
  // point_add_complete takes about as long as 3.7 G2ADD programs)
  int s = 1, W = T / 32;
  while (2 * s < ns) s *= 2;
  for (; s > 0 && ns > 1; s >>= 1) {
    if (s > 4 * W) {
      block_each(T, [&](int t) {
        if (t < s && t + s < ns)
          spart[t] = point_add_complete(spart[t], spart[t + s], K);
      });
    } else {
      warps_each(T, [&](int w) {
        uint32_t* scratch = warp_scratch(sm, l, w);
        for (int t = w; t < s && t + s < ns; t += W)
          warp_g2_add(reinterpret_cast<uint32_t*>(spart + t),
                      reinterpret_cast<uint32_t*>(spart + t + s), scratch,
                      warp_side(scratch, w), K);
      });
    }
  }
  // the products: fpart[t] *= fpart[t + s] for s = pow2ceil(nf)/2 .. 1, a
  // thread a product (fp12_mul_to) while a level holds more than 8 a warp,
  // then the warps' MUL programs, a warp a product (on an H100 a thread's
  // fp12_mul_to takes about as long as 9 MUL programs)
  for (s = 1; 2 * s < nf;) s *= 2;
  for (; s > 0 && nf > 1; s >>= 1) {
    if (s > 8 * W) {
      block_each(T, [&](int t) {
        if (t < s && t + s < nf) fp12_mul_to(fpart[t], fpart[t], fpart[t + s]);
      });
    } else {
      warps_mul_level(T, fpart, s, nf,
                      [&](int w) { return warp_scratch(sm, l, w); });
    }
  }
  warps_each(T, [&](int w) {
    if (w != 0) return;
    uint32_t* scratch = warp_scratch(sm, l, 0);
    uint32_t* buf = sm + l.tail;
    uint32_t *F = buf + 12 * B_F, *Tt = buf + 12 * B_T, *Q = buf + 12 * B_Q,
             *Pr = reinterpret_cast<uint32_t*>(fpart);
    if (nf == 0) warp_set_one(Pr, K);
    if (ns > 0 && !fp2_is_zero(spart[0].z)) {
      run(PROG_HOMOG, reinterpret_cast<uint32_t*>(spart), Q, nullptr,
          nullptr, scratch);
      warp_copy(Tt, Q, 6);
      warp_set_one(F, K);
      for (int i = 62; i >= 0; i--) {
        run(PROG_DBL, F, Tt, Q, nullptr, scratch);
        if ((BLS_ABS_X >> i) & 1) run(PROG_ADD, F, Tt, Q, nullptr, scratch);
      }
      run(PROG_MUL_CONJ_B, Pr, F, F, nullptr, scratch);  // f terms * conj(f)
    } else {
      warp_copy(F, Pr, 12);
    }
    final_exp(buf, scratch, K);
    warp_each([&](int lane) {
      if (lane == 0)
        *verdict = (fp12_is_one(*reinterpret_cast<const fp12*>(F), K) &&
                    !*flag) ? 1 : 0;
    });
  });
}

// --- miller_loop_pairs: one warp a pair ------------------------------------

// Fp values of a pair's buffers: F (12), T (6), Q affine (4), P's
// coefficients (3), then the warp's scratch; MILLER_WS in all
enum MillerBuf {
  M_F = 0, M_T = 12, M_Q = 18, M_P = 22, M_SCRATCH = 25,
  MILLER_WS = M_SCRATCH + MILLER_SCRATCH
};

// One pair by the calling warp, in `sm` (MILLER_WS Fp values): f =
// conj(f_{|x|,Q}(P)) for P Jacobian (rpk: 3 x 12 canonical words) and Q
// affine (msg: 2 x 2 x 12), or one for a pair_inf row; 144 canonical
// words to `f`. P's Jacobian words pass through F before PCOEF turns them
// into its coefficients; T starts as Q (Z = 1).
BLS_HD void miller_pair(uint32_t* sm, const uint32_t* rpk,
                        const uint32_t* msg, bool inf, uint32_t* f,
                        const uint32_t* K) {
  uint32_t *F = sm + 12 * M_F, *Tt = sm + 12 * M_T, *Q = sm + 12 * M_Q,
           *Pc = sm + 12 * M_P, *scratch = sm + 12 * M_SCRATCH;
  if (inf) {
    warp_each([&](int lane) {
      if (lane < 12) {
        fp one = fp_zero();
        one.l[0] = lane == 0;
        fp_store(f + 12 * lane, one);
      }
    });
    return;
  }
  warp_each([&](int lane) {
    if (lane < 3) fp_store(F + 12 * lane, mont_in(rpk + 12 * lane, K));
    else if (lane < 7)
      fp_store(Q + 12 * (lane - 3), mont_in(msg + 12 * (lane - 3), K));
  });
  run(PROG_PCOEF, F, Pc, nullptr, nullptr, scratch);
  warp_each([&](int lane) {
    if (lane < 12)
      fp_store(F + 12 * lane, lane == 0 ? fp_load(K + 12 * K_ONE) : fp_zero());
    else if (lane < 16)
      fp_store(Tt + 12 * (lane - 12), fp_load(Q + 12 * (lane - 12)));
    else if (lane < 18)
      fp_store(Tt + 12 * (lane - 12),
               lane == 16 ? fp_load(K + 12 * K_ONE) : fp_zero());
  });
  for (int i = 62; i >= 0; i--) {
    run(PROG_DBL_P, F, Tt, Q, Pc, scratch);
    if ((BLS_ABS_X >> i) & 1) run(PROG_ADD_P, F, Tt, Q, Pc, scratch);
  }
  // conj(f): its c1 half (values 6..11) negated on the way out
  warp_each([&](int lane) {
    if (lane < 12) {
      fp v = fp_load(F + 12 * lane);
      mont_out(f + 12 * lane, lane < 6 ? v : fp_neg(v));
    }
  });
}

// Block b of a launch of W warps a block over n pairs: warp w takes pair
// b * W + w (none past n); `sm` holds W * MILLER_WS Fp values
BLS_HD void miller_block(uint32_t* sm, int W, int b, int n,
                         const uint32_t* rpk, const uint32_t* msg,
                         const bool* pair_inf, uint32_t* f,
                         const uint32_t* K) {
  each_warp(W, [&](int w) {
    size_t i = (size_t)b * W + w;
    if (i < (size_t)n)
      miller_pair(sm + 12 * MILLER_WS * w, rpk + 36 * i, msg + 48 * i,
                  pair_inf[i], f + 144 * i, K);
  });
}

}  // namespace tail
}  // namespace bls
