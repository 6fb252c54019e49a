// The Ed25519 batch verify of the ed25519 scheduler lane: ed25519_verify.
//
// Behind a plain C interface loaded with ctypes (grandine_tpu_torch/gpu/
// _build.py, one library per source, built in parallel). A field element of
// 2^255 - 19 is a canonical value as 8 little-endian uint32 words, inside the
// kernel as at its boundary: every operation returns a fully reduced value,
// so the words equal those of the plain PyTorch version (gpu/ed25519.py) at
// every stage. No Montgomery form: a product is 64 32x32->64 partial
// products, the high half folded by 38 (2^256 = 38 mod p), the bits from
// 2^255 up folded by 19, then at most one subtraction of p. What the kernel
// replaces in the JAX package and what bounds it on the card is written
// beside its Python wrapper (gpu/ed25519.py ed25519_verify).
//
// Curve: twisted Edwards a = -1 in extended coordinates (X, Y, Z, T), the
// unified add-2008-hwcd-3 for both addition and doubling (complete for
// a = -1), so the identity (0, 1, 1, 0) needs no special case and padding
// rows (0, 1) with scalar 0 stay the identity. The scalars are public RLC
// values, so the ladder branches on their bits: every step doubles, a set
// bit adds the base, which gives exactly the words of the JAX program's
// select.
//
// ladder_row and the field/point layer also compile as plain C++ (no
// __CUDACC__), so the kernel's steps can be run on a host against the plain
// PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ED_HD __device__ __forceinline__
#define ED_NI __device__ __noinline__
#else
#define ED_HD static inline
#define ED_NI static __attribute__((noinline))
#endif
#include <stdint.h>

namespace ed {

#define ED_NBITS 253      // bits of a scalar below 2^253 (gpu/ed25519.py)
#define ED_MAX_ROWS 128   // the largest bucket

struct fe { uint32_t w[8]; };
struct point { fe x, y, z, t; };

// 2d mod p, d = -121665/121666
#define ED_K2D {0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au, \
                0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu}

ED_HD fe fe_const(uint32_t v) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = 0;
  r.w[0] = v;
  return r;
}

// a < 2p: a - p when a >= p (a + 19 reaches 2^255), else a
ED_HD fe fe_reduce_once(const fe& a) {
  fe s;
  uint64_t c = 19;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += a.w[i];
    s.w[i] = (uint32_t)c;
    c >>= 32;
  }
  if (s.w[7] >> 31) {
    s.w[7] &= 0x7fffffffu;
    return s;
  }
  return a;
}

ED_HD fe fe_add(const fe& a, const fe& b) {
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.w[i] + b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return fe_reduce_once(r);  // a + b < 2p < 2^256: no carry out
}

ED_HD fe fe_sub(const fe& a, const fe& b) {
  fe r;
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (int64_t)a.w[i] - b.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;  // arithmetic: 0 or -1
  }
  if (c) {  // borrow: r = a - b + 2^256, add p and drop the 2^256
    const uint32_t p[8] = {0xffffffedu, 0xffffffffu, 0xffffffffu,
                           0xffffffffu, 0xffffffffu, 0xffffffffu,
                           0xffffffffu, 0x7fffffffu};
    uint64_t d = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      d += (uint64_t)r.w[i] + p[i];
      r.w[i] = (uint32_t)d;
      d >>= 32;
    }
  }
  return r;
}

ED_HD fe fe_mul(const fe& a, const fe& b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.w[i] * b.w[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {  // 2^256 = 38
    c += (uint64_t)t[i + 8] * 38 + t[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  // the bits from 2^255 up, the carry (< 39, weight 2^256) included
  c = (uint64_t)((uint32_t)(c << 1) | (r.w[7] >> 31)) * 19;
  r.w[7] &= 0x7fffffffu;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += r.w[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return fe_reduce_once(r);  // < 2^255 + 1501 < 2p
}

ED_HD bool fe_is_zero(const fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.w[i];
  return acc == 0;
}

ED_HD bool fe_eq(const fe& a, const fe& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

// unified add-2008-hwcd-3 (a = -1), the JAX ed_add's 9 products in its
// order: a, b, t1*2d, *t2, z1*z2, then e*f, g*h, f*g, e*h
ED_NI void ed_add(point* out, const point* p, const point* q) {
  const fe k2d = {ED_K2D};
  fe a = fe_mul(fe_sub(p->y, p->x), fe_sub(q->y, q->x));
  fe b = fe_mul(fe_add(p->y, p->x), fe_add(q->y, q->x));
  fe c = fe_mul(fe_mul(p->t, k2d), q->t);
  fe zz = fe_mul(p->z, q->z);
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  out->x = fe_mul(e, f);
  out->y = fe_mul(g, h);
  out->z = fe_mul(f, g);
  out->t = fe_mul(e, h);
}

ED_HD fe fe_load(const uint32_t* w) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = w[i];
  return r;
}

ED_HD void fe_store(uint32_t* w, const fe& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = a.w[i];
}

ED_HD void point_store(uint32_t* w, const point& p) {
  fe_store(w, p.x);
  fe_store(w + 8, p.y);
  fe_store(w + 16, p.z);
  fe_store(w + 24, p.t);
}

// [k]P for one row from the identity: ED_NBITS steps MSB first, a doubling
// each and an addition of (x, y, 1, t) at each set bit
ED_NI void ladder_row(point* acc, const uint32_t* px, const uint32_t* py,
                      const uint32_t* pt, const uint32_t* k) {
  point base;
  base.x = fe_load(px);
  base.y = fe_load(py);
  base.z = fe_const(1);
  base.t = fe_load(pt);
  acc->x = fe_const(0);
  acc->y = fe_const(1);
  acc->z = fe_const(1);
  acc->t = fe_const(0);
  for (int s = ED_NBITS - 1; s >= 0; s--) {
    ed_add(acc, acc, acc);
    if ((k[s >> 5] >> (s & 31)) & 1u) ed_add(acc, acc, &base);
  }
}

// [8]sum: three doublings, then the identity test X = 0 and Y = Z on
// canonical words
ED_HD bool cofactor_identity(point* sum) {
  for (int i = 0; i < 3; i++) ed_add(sum, sum, sum);
  return fe_is_zero(sum->x) && fe_eq(sum->y, sum->z);
}

}  // namespace ed

#ifdef __CUDACC__
using namespace ed;

// --- ed25519_verify: one block a batch, one thread a row ----------------------
//
// Each thread writes its row's [k]P to `rows` and to shared memory (128 rows
// x 128 B = 16 KiB); the block sums them in the JAX tree's order (row i +=
// row i + s for s = n/2 ... 1, the result in row 0), and thread 0 clears the
// cofactor and writes `total` and `verdict`.
__global__ void __launch_bounds__(ED_MAX_ROWS)
ed25519_verify_kernel(const uint32_t* px, const uint32_t* py,
                      const uint32_t* pt, const uint32_t* k, int n,
                      bool* verdict, uint32_t* rows, uint32_t* total) {
  __shared__ point sh[ED_MAX_ROWS];
  int i = threadIdx.x;
  point acc;
  ladder_row(&acc, px + 8 * i, py + 8 * i, pt + 8 * i, k + 8 * i);
  point_store(rows + 32 * i, acc);
  sh[i] = acc;
  __syncthreads();
  for (int s = n >> 1; s > 0; s >>= 1) {
    if (i < s) {
      point a = sh[i], b = sh[i + s];
      ed_add(&a, &a, &b);
      sh[i] = a;
    }
    __syncthreads();
  }
  if (i == 0) {
    point sum = sh[0];
    bool ok = cofactor_identity(&sum);
    point_store(total, sum);
    verdict[0] = ok;
  }
}

// --- C interface --------------------------------------------------------------

extern "C" {

int bls_ed25519_verify(const uint32_t* px, const uint32_t* py,
                       const uint32_t* pt, const uint32_t* k, int n,
                       bool* verdict, uint32_t* rows, uint32_t* total,
                       const uint32_t* /* constant table: unused */,
                       cudaStream_t stream) {
  // n is a power of two of at most ED_MAX_ROWS (the wrapper checks)
  if (n > 0)
    ed25519_verify_kernel<<<1, n, 0, stream>>>(px, py, pt, k, n, verdict,
                                               rows, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
