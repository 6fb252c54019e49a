// BLS12-381 device arithmetic for the verify kernels (csrc/*.cu).
//
// Fp: 12 x 32-bit little-endian limbs in Montgomery form, R = 2^384,
// multiplied by CIOS with 64-bit accumulators; every operation returns a
// fully reduced value in [0, p), so a kernel's values equal, bit for bit,
// those of the plain torch versions (grandine_tpu_torch/gpu/limbs.py, the
// same R over 24 x 16-bit limbs). Tower Fp2 = Fp[u]/(u^2 + 1),
// Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v), xi = 1 + u. Curve
// formulas (dbl-2009-l, madd-2007-bl, add-2007-bl with its doubling and
// infinity cases) are those of grandine_tpu_torch/gpu/curve.py, which are
// those of the JAX package (grandine_tpu/tpu/curve.py); the Miller loop
// and the final exponentiation are csrc/finish_tail.cuh's warp programs.
//
// Constants that derive from the curve (Montgomery one, R^2, b, 1/2, the
// GLV and psi constants, -g1) reach every kernel as one table
// of canonical-or-Montgomery words built by grandine_tpu_torch/gpu/_build.py
// from the host derivations in crypto/; only p, -p^-1 mod 2^32 and |x|
// are written here.
//
// The header also compiles as plain C++ (no __CUDACC__), so the same
// arithmetic can be exercised on a host.
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define BLS_HD __device__ __forceinline__
#define BLS_NI __device__ __noinline__
#define BLS_CONST __constant__
#else
#define BLS_HD static inline
#define BLS_NI static __attribute__((noinline))
#define BLS_CONST static const
#endif

namespace bls {

BLS_CONST uint32_t P[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
#define BLS_NP0 0xfffcfffdu       // -p^-1 mod 2^32
#define BLS_ABS_X 0xd201000000010000ull  // |x|, x the (negative) BLS parameter

// Constant table layout (12 words per entry), filled by _build.py.
enum ConstIdx {
  K_R2 = 0,        // R^2 mod p (canonical)
  K_ONE,           // R mod p: Montgomery one
  K_B,             // 4 (Montgomery)
  K_HALF,          // (p+1)/2 (Montgomery)
  K_HALF_CANON,    // (p+1)/2 (canonical)
  K_SQRT_EXP,      // (p+1)/4 (plain integer)
  K_INV_EXP,       // p-2 (plain integer)
  K_G1_BX, K_G1_BY,            // G1 endomorphism (Montgomery)
  K_G2_WX, K_G2_WY,            // G2 endomorphism, Fp scalars (Montgomery)
  K_PSI_CX0, K_PSI_CX1, K_PSI_CY0, K_PSI_CY1,  // psi constants
  K_NEG_G1_X, K_NEG_G1_Y,      // -g1 affine (Montgomery)
  K_QR_EXP,        // (p-3)/4 (plain integer)
  K_COUNT
};

struct fp { uint32_t l[12]; };
struct fp2 { fp c0, c1; };
struct fp6 { fp2 c0, c1, c2; };
struct fp12 { fp6 c0, c1; };
template <class F> struct jac { F x, y, z; };

// --- Fp ---------------------------------------------------------------------

BLS_HD fp fp_load(const uint32_t* w) {
  fp r;
#pragma unroll
  for (int i = 0; i < 12; i++) r.l[i] = w[i];
  return r;
}

BLS_HD void fp_store(uint32_t* w, const fp& a) {
#pragma unroll
  for (int i = 0; i < 12; i++) w[i] = a.l[i];
}

BLS_HD fp fp_zero() {
  fp r;
#pragma unroll
  for (int i = 0; i < 12; i++) r.l[i] = 0;
  return r;
}

BLS_HD bool fp_is_zero(const fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) acc |= a.l[i];
  return acc == 0;
}

BLS_HD bool fp_eq(const fp& a, const fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) acc |= a.l[i] ^ b.l[i];
  return acc == 0;
}

// a >= b as 384-bit integers
BLS_HD bool fp_geq(const fp& a, const fp& b) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    int64_t d = (int64_t)a.l[i] - (int64_t)b.l[i] + br;
    br = d >> 32;  // 0 or -1
  }
  return br == 0;
}

BLS_HD bool fp_geq_p(const fp& a) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    int64_t d = (int64_t)a.l[i] - (int64_t)P[i] + br;
    br = d >> 32;
  }
  return br == 0;
}

// t (13 words, value < 2p) -> t mod p
BLS_HD fp fp_reduce_once(const uint32_t* t) {
  fp d;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    int64_t s = (int64_t)t[i] - (int64_t)P[i] + br;
    d.l[i] = (uint32_t)s;
    br = s >> 32;
  }
  bool take = (t[12] != 0) || (br == 0);
  fp r;
#pragma unroll
  for (int i = 0; i < 12; i++) r.l[i] = take ? d.l[i] : t[i];
  return r;
}

BLS_HD fp fp_add(const fp& a, const fp& b) {
  uint32_t t[13];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    c += (uint64_t)a.l[i] + b.l[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  t[12] = (uint32_t)c;
  return fp_reduce_once(t);
}

BLS_HD fp fp_sub(const fp& a, const fp& b) {
  fp d;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    int64_t s = (int64_t)a.l[i] - (int64_t)b.l[i] + br;
    d.l[i] = (uint32_t)s;
    br = s >> 32;
  }
  if (br) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
      c += (uint64_t)d.l[i] + P[i];
      d.l[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

BLS_HD fp fp_neg(const fp& a) { return fp_sub(fp_zero(), a); }

BLS_HD fp fp_dbl(const fp& a) { return fp_add(a, a); }

// CIOS Montgomery product: a*b*2^-384 mod p, for a < 2^384, b < p.
BLS_HD fp fp_mul(const fp& a, const fp& b) {
  uint32_t t[14];
#pragma unroll
  for (int i = 0; i < 14; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; j++) {
      c += (uint64_t)t[j] + (uint64_t)a.l[j] * b.l[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[12];
    t[12] = (uint32_t)c;
    t[13] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * BLS_NP0;
    c = ((uint64_t)t[0] + (uint64_t)m * P[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 12; j++) {
      c += (uint64_t)t[j] + (uint64_t)m * P[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[12];
    t[11] = (uint32_t)c;
    t[12] = t[13] + (uint32_t)(c >> 32);
  }
  return fp_reduce_once(t);
}

BLS_HD fp fp_sq(const fp& a) { return fp_mul(a, a); }

BLS_HD fp fp_select(bool c, const fp& a, const fp& b) { return c ? a : b; }

// a^e for e given as 12 little-endian words (MSB-first square and multiply
// from the top set bit; the exponent is public).
BLS_NI fp fp_pow(const fp& a, const uint32_t* e) {
  int top = 383;
  while (top > 0 && !((e[top >> 5] >> (top & 31)) & 1)) top--;
  fp r = a;
  for (int i = top - 1; i >= 0; i--) {
    r = fp_sq(r);
    if ((e[i >> 5] >> (i & 31)) & 1) r = fp_mul(r, a);
  }
  return r;
}

// --- Fp2 --------------------------------------------------------------------

BLS_HD fp2 fp2_add(const fp2& a, const fp2& b) {
  return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
BLS_HD fp2 fp2_sub(const fp2& a, const fp2& b) {
  return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
BLS_HD fp2 fp2_neg(const fp2& a) { return {fp_neg(a.c0), fp_neg(a.c1)}; }
BLS_HD fp2 fp2_conj(const fp2& a) { return {a.c0, fp_neg(a.c1)}; }
BLS_HD fp2 fp2_mul_by_xi(const fp2& a) {
  return {fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)};
}
BLS_HD fp2 fp2_mul_fp(const fp2& a, const fp& k) {
  return {fp_mul(a.c0, k), fp_mul(a.c1, k)};
}
BLS_HD bool fp2_is_zero(const fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
BLS_HD fp2 fp2_select(bool c, const fp2& a, const fp2& b) { return c ? a : b; }

BLS_NI fp2 fp2_mul(const fp2& a, const fp2& b) {
  fp t0 = fp_mul(a.c0, b.c0);
  fp t1 = fp_mul(a.c1, b.c1);
  fp t2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return {fp_sub(t0, t1), fp_sub(t2, fp_add(t0, t1))};
}

BLS_HD fp2 fp2_sq(const fp2& a) { return fp2_mul(a, a); }

BLS_NI fp2 fp2_inv(const fp2& a, const uint32_t* K) {
  fp n = fp_add(fp_sq(a.c0), fp_sq(a.c1));
  fp ni = fp_pow(n, K + 12 * K_INV_EXP);
  if (fp_is_zero(n)) ni = fp_zero();
  return {fp_mul(a.c0, ni), fp_neg(fp_mul(a.c1, ni))};
}

// --- Fp6 / Fp12 -------------------------------------------------------------

BLS_HD fp6 fp6_add(const fp6& a, const fp6& b) {
  return {fp2_add(a.c0, b.c0), fp2_add(a.c1, b.c1), fp2_add(a.c2, b.c2)};
}
BLS_HD fp6 fp6_sub(const fp6& a, const fp6& b) {
  return {fp2_sub(a.c0, b.c0), fp2_sub(a.c1, b.c1), fp2_sub(a.c2, b.c2)};
}
BLS_HD fp6 fp6_neg(const fp6& a) {
  return {fp2_neg(a.c0), fp2_neg(a.c1), fp2_neg(a.c2)};
}
BLS_HD fp6 fp6_mul_by_v(const fp6& a) {
  return {fp2_mul_by_xi(a.c2), a.c0, a.c1};
}

BLS_NI fp6 fp6_mul(const fp6& a, const fp6& b) {
  fp2 t0 = fp2_mul(a.c0, b.c0);
  fp2 t1 = fp2_mul(a.c1, b.c1);
  fp2 t2 = fp2_mul(a.c2, b.c2);
  fp2 t12 = fp2_mul(fp2_add(a.c1, a.c2), fp2_add(b.c1, b.c2));
  fp2 t01 = fp2_mul(fp2_add(a.c0, a.c1), fp2_add(b.c0, b.c1));
  fp2 t02 = fp2_mul(fp2_add(a.c0, a.c2), fp2_add(b.c0, b.c2));
  fp6 r;
  r.c0 = fp2_add(t0, fp2_mul_by_xi(fp2_sub(t12, fp2_add(t1, t2))));
  r.c1 = fp2_add(fp2_sub(t01, fp2_add(t0, t1)), fp2_mul_by_xi(t2));
  r.c2 = fp2_add(fp2_sub(t02, fp2_add(t0, t2)), t1);
  return r;
}

// The Fp12 operations write through `r`, which may alias an operand: an
// Fp12 is 576 bytes, and each one returned by value would take a slot of
// its own in the caller's stack frame.

// r = a * b
BLS_NI void fp12_mul_to(fp12& r, const fp12& a, const fp12& b) {
  fp6 t0 = fp6_mul(a.c0, b.c0);
  fp6 t1 = fp6_mul(a.c1, b.c1);
  fp6 t2 = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(b.c0, b.c1));
  r.c0 = fp6_add(t0, fp6_mul_by_v(t1));
  r.c1 = fp6_sub(t2, fp6_add(t0, t1));
}

BLS_HD fp2 kfp2(const uint32_t* K, int i0, int i1) {
  return {fp_load(K + 12 * i0), fp_load(K + 12 * i1)};
}

BLS_HD bool fp2_eq(const fp2& a, const fp2& b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

BLS_HD bool fp12_is_one(const fp12& a, const uint32_t* K) {
  fp2 one = {fp_load(K + 12 * K_ONE), fp_zero()};
  return fp2_eq(a.c0.c0, one) && fp2_is_zero(a.c0.c1) &&
         fp2_is_zero(a.c0.c2) && fp2_is_zero(a.c1.c0) &&
         fp2_is_zero(a.c1.c1) && fp2_is_zero(a.c1.c2);
}

// --- field-generic helpers for the curve formulas ----------------------------

BLS_HD fp f_mul(const fp& a, const fp& b) { return fp_mul(a, b); }
BLS_HD fp2 f_mul(const fp2& a, const fp2& b) { return fp2_mul(a, b); }
BLS_HD fp f_add(const fp& a, const fp& b) { return fp_add(a, b); }
BLS_HD fp2 f_add(const fp2& a, const fp2& b) { return fp2_add(a, b); }
BLS_HD fp f_sub(const fp& a, const fp& b) { return fp_sub(a, b); }
BLS_HD fp2 f_sub(const fp2& a, const fp2& b) { return fp2_sub(a, b); }
BLS_HD bool f_is_zero(const fp& a) { return fp_is_zero(a); }
BLS_HD bool f_is_zero(const fp2& a) { return fp2_is_zero(a); }
BLS_HD void f_one(fp& r, const uint32_t* K) { r = fp_load(K + 12 * K_ONE); }
BLS_HD void f_one(fp2& r, const uint32_t* K) {
  r.c0 = fp_load(K + 12 * K_ONE);
  r.c1 = fp_zero();
}
BLS_HD void f_zero(fp& r) { r = fp_zero(); }
BLS_HD void f_zero(fp2& r) { r.c0 = fp_zero(); r.c1 = fp_zero(); }

// Fp with its product as one call. A G1 formula inlines 7-16 unrolled Fp
// products, ~100 KB of straight-line code: on one warp a G1 doubling took
// 55,516 cycles against ~27,000 for its products and additions alone,
// where the G2 formulas, whose fp2_mul is a call, take what their parts
// take (gpu/tail_bench.py). The curve templates take fpc as their field
// (jac<fpc>), so a formula's products share one copy of the code.
struct fpc { fp v; };
BLS_NI fp fp_mul_call(const fp& a, const fp& b) { return fp_mul(a, b); }
BLS_HD fpc f_mul(const fpc& a, const fpc& b) {
  return {fp_mul_call(a.v, b.v)};
}
BLS_HD fpc f_add(const fpc& a, const fpc& b) { return {fp_add(a.v, b.v)}; }
BLS_HD fpc f_sub(const fpc& a, const fpc& b) { return {fp_sub(a.v, b.v)}; }
BLS_HD bool f_is_zero(const fpc& a) { return fp_is_zero(a.v); }
BLS_HD void f_one(fpc& r, const uint32_t* K) { r.v = fp_load(K + 12 * K_ONE); }
BLS_HD void f_zero(fpc& r) { r.v = fp_zero(); }

template <class F>
BLS_HD jac<F> jac_inf(const uint32_t* K) {
  jac<F> r;
  f_one(r.x, K);
  f_one(r.y, K);
  f_zero(r.z);
  return r;
}

// dbl-2009-l (a = 0)
template <class F>
BLS_NI jac<F> point_double(const jac<F>& p) {
  F A = f_mul(p.x, p.x), Bq = f_mul(p.y, p.y), YZ = f_mul(p.y, p.z);
  F XB = f_add(p.x, Bq);
  F E = f_add(f_add(A, A), A);
  F C = f_mul(Bq, Bq), T1 = f_mul(XB, XB), Fv = f_mul(E, E);
  F D = f_sub(T1, f_add(A, C));
  D = f_add(D, D);
  jac<F> r;
  r.x = f_sub(Fv, f_add(D, D));
  F t = f_mul(E, f_sub(D, r.x));
  F C2 = f_add(C, C), C4 = f_add(C2, C2), C8 = f_add(C4, C4);
  r.y = f_sub(t, C8);
  r.z = f_add(YZ, YZ);
  return r;
}

// madd-2007-bl: Jacobian + affine, P != +-Q, neither infinity
template <class F>
BLS_NI jac<F> point_madd_unsafe(const jac<F>& p, const F& qx, const F& qy) {
  F Z2 = f_mul(p.z, p.z);
  F U2 = f_mul(qx, Z2), ZZZ = f_mul(p.z, Z2);
  F H = f_sub(U2, p.x);
  F S2 = f_mul(qy, ZZZ), HH = f_mul(H, H);
  F I = f_add(HH, HH);
  I = f_add(I, I);
  F r = f_sub(S2, p.y);
  r = f_add(r, r);
  F J = f_mul(H, I), V = f_mul(p.x, I), R2 = f_mul(r, r);
  jac<F> o;
  o.x = f_sub(R2, f_add(J, f_add(V, V)));
  F ZH = f_add(p.z, H);
  F t = f_mul(r, f_sub(V, o.x)), YJ = f_mul(p.y, J), ZH2 = f_mul(ZH, ZH);
  o.y = f_sub(t, f_add(YJ, YJ));
  o.z = f_sub(ZH2, f_add(Z2, HH));
  return o;
}

// add-2007-bl with the infinity / doubling / opposite cases; the case
// priority is that of the select chain in gpu/curve.py point_add_complete.
template <class F>
BLS_NI jac<F> point_add_complete(const jac<F>& p, const jac<F>& q,
                                 const uint32_t* K) {
  if (f_is_zero(p.z)) return q;
  if (f_is_zero(q.z)) return p;
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
  if (f_is_zero(H)) {
    if (f_is_zero(r)) return point_double(p);
    return jac_inf<F>(K);
  }
  F I = f_mul(H2, H2), Z3 = f_mul(ZZ2, H);
  F J = f_mul(H, I), V = f_mul(U1, I), R2 = f_mul(r, r);
  jac<F> o;
  o.x = f_sub(R2, f_add(J, f_add(V, V)));
  F t = f_mul(r, f_sub(V, o.x)), S1J = f_mul(S1, J);
  o.y = f_sub(t, f_add(S1J, S1J));
  o.z = Z3;
  return o;
}

// mask ? a : b word by word (mask is 0 or all ones): no branch
template <class T>
BLS_HD T ct_select(uint32_t mask, const T& a, const T& b) {
  T r;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
  uint32_t* pr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); i++)
    pr[i] = (pa[i] & mask) | (pb[i] & ~mask);
  return r;
}

template <class F>
BLS_HD jac<F> jac_select(bool c, const jac<F>& a, const jac<F>& b) {
  return c ? a : b;
}

// [k]Q, affine Q, k given MSB first as `nbits` bits of a 64-bit word
template <class F>
BLS_NI jac<F> scalar_mul_bits(const F& qx, const F& qy, uint64_t k, int nbits,
                              const uint32_t* K) {
  jac<F> st = jac_inf<F>(K);
  bool started = false;
  F one;
  f_one(one, K);
  for (int i = nbits - 1; i >= 0; i--) {
    st = point_double(st);
    if ((k >> i) & 1) {
      if (started) {
        st = point_madd_unsafe(st, qx, qy);
      } else {
        st.x = qx; st.y = qy; st.z = one;
      }
      started = true;
    }
  }
  return st;
}

// [r0 + r1*lambda]Q for affine Q: the dual 32-bit GLV ladder, mixed adds
template <class F>
BLS_NI jac<F> scalar_mul_glv(const F& qx, const F& qy, const F& q2x,
                             const F& q2y, uint32_t r0, uint32_t r1,
                             const uint32_t* K) {
  jac<F> st = jac_inf<F>(K);
  bool started = false;
  F one;
  f_one(one, K);
  for (int i = 31; i >= 0; i--) {
    st = point_double(st);
    if ((r0 >> i) & 1) {
      if (started) st = point_madd_unsafe(st, qx, qy);
      else { st.x = qx; st.y = qy; st.z = one; }
      started = true;
    }
    if ((r1 >> i) & 1) {
      if (started) st = point_madd_unsafe(st, q2x, q2y);
      else { st.x = q2x; st.y = q2y; st.z = one; }
      started = true;
    }
  }
  return st;
}

// --- square roots and decompression -------------------------------------

// (root, ok): root = a^((p+1)/4), ok iff root^2 = a
BLS_HD fp fq_sqrt(const fp& a, bool& ok, const uint32_t* K) {
  fp s = fp_pow(a, K + 12 * K_SQRT_EXP);
  ok = fp_eq(fp_sq(s), a);
  return s;
}

// 48 big-endian payload bytes (flags already masked) -> canonical limbs
BLS_HD fp fp_from_be(const uint8_t* b) {
  fp r;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const uint8_t* q = b + 44 - 4 * i;
    r.l[i] = ((uint32_t)q[0] << 24) | ((uint32_t)q[1] << 16) |
             ((uint32_t)q[2] << 8) | (uint32_t)q[3];
  }
  return r;
}

struct dec_flags {
  bool inf, ok, bad_encoding, bad_curve, bad_infinity;
};

BLS_HD dec_flags decode_masks(uint8_t flags, bool payload_zero, bool lt_p,
                              bool y_ok) {
  bool c = flags & 0x80, i = flags & 0x40, s = flags & 0x20;
  dec_flags f;
  f.inf = c && i && !s && payload_zero;
  f.bad_infinity = c && i && !f.inf;
  f.bad_encoding = !c || (c && !i && !lt_p);
  f.bad_curve = c && !i && lt_p && !y_ok;
  f.ok = f.inf || (c && !i && lt_p && y_ok);
  return f;
}

// One G1 row: x, y canonical (zero unless a live point).
BLS_NI dec_flags g1_decompress_row(const uint8_t* row, fp& x_out, fp& y_out,
                                   const uint32_t* K) {
  uint8_t b[48];
  bool pz = true;
  for (int i = 0; i < 48; i++) {
    b[i] = row[i];
    if (i == 0) b[i] &= 0x1f;
    pz = pz && (b[i] == 0);
  }
  fp xc = fp_from_be(b);
  bool lt_p = !fp_geq_p(xc);
  fp x = fp_mul(xc, fp_load(K + 12 * K_R2));
  fp y2 = fp_add(fp_mul(fp_sq(x), x), fp_load(K + 12 * K_B));
  bool y_ok;
  fp y = fq_sqrt(y2, y_ok, K);
  fp one_c = fp_zero();
  one_c.l[0] = 1;
  fp yc = fp_mul(y, one_c);
  bool larger = fp_geq(yc, fp_load(K + 12 * K_HALF_CANON));
  bool sgn = row[0] & 0x20;
  if (sgn != larger) y = fp_neg(y);
  dec_flags f = decode_masks(row[0], pz, lt_p, y_ok);
  bool live = f.ok && !f.inf;
  x_out = live ? fp_mul(x, one_c) : fp_zero();
  y_out = live ? fp_mul(y, one_c) : fp_zero();
  return f;
}

// --- canonical-word I/O ------------------------------------------------------

BLS_HD fp mont_in(const uint32_t* w, const uint32_t* K) {
  return fp_mul(fp_load(w), fp_load(K + 12 * K_R2));
}

BLS_HD void mont_out(uint32_t* w, const fp& a) {
  fp one_c = fp_zero();
  one_c.l[0] = 1;
  fp_store(w, fp_mul(a, one_c));
}

BLS_HD fp2 mont_in2(const uint32_t* w, const uint32_t* K) {
  return {mont_in(w, K), mont_in(w + 12, K)};
}

BLS_HD void mont_out2(uint32_t* w, const fp2& a) {
  mont_out(w, a.c0);
  mont_out(w + 12, a.c1);
}

// one coordinate of G1 (fp) or G2 (fp2), for code templated on the field
BLS_HD void f_in(fp& r, const uint32_t* w, const uint32_t* K) {
  r = mont_in(w, K);
}
BLS_HD void f_in(fp2& r, const uint32_t* w, const uint32_t* K) {
  r = mont_in2(w, K);
}
BLS_HD void f_in(fpc& r, const uint32_t* w, const uint32_t* K) {
  r.v = mont_in(w, K);
}
BLS_HD void f_out(uint32_t* w, const fp& a) { mont_out(w, a); }
BLS_HD void f_out(uint32_t* w, const fp2& a) { mont_out2(w, a); }
BLS_HD void f_out(uint32_t* w, const fpc& a) { mont_out(w, a.v); }

// --- block reduction ---------------------------------------------------------

#define BLS_TREE 128  // threads of the per-aggregate and final-sum trees

#ifdef __CUDACC__
// v of lane (this lane ^ m) of the warp, word by word; every lane of the
// warp takes part
template <class T>
__device__ __forceinline__ T shfl_xor_words(const T& v, int m) {
  T r;
  const uint32_t* pv = reinterpret_cast<const uint32_t*>(&v);
  uint32_t* pr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); i++)
    pr[i] = __shfl_xor_sync(0xffffffffu, pv[i], m);
  return r;
}

// Folds n partial sums `acc` (thread t < n holds one) pairwise in shared
// memory: part[t] += part[t + s] for s = pow2ceil(n)/2 .. 1 where t + s < n
// (the order of gpu/msm.py strided_tree_sum); the total lands in part[0].
// Every thread of the block takes part; part holds n points.
template <class F>
__device__ void block_tree_sum_n(jac<F>* part, const jac<F>& acc, int n,
                                 const uint32_t* K) {
  int t = threadIdx.x;
  if (t < n) part[t] = acc;
  __syncthreads();
  int s = 1;
  while (2 * s < n) s *= 2;
  for (; s > 0; s >>= 1) {
    if (t < s && t + s < n) part[t] = point_add_complete(part[t], part[t + s], K);
    __syncthreads();
  }
}

#endif

}  // namespace bls
