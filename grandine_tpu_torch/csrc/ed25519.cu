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
// Four lanes a row. An addition has at most three rounds of independent
// products (ed_add_lanes); lane `sub` of the row's group of four computes
// the round's product `sub` and the group trades the four by shuffles, so
// a doubling is three product latencies and an addition of the base two.
// Because every value is canonical, the words of a row's [k]P, of the tree
// and of [8]sum depend only on the formula and on the sequence of point
// operations, not on the order of one formula's products.
//
// The lane layer, ladder_row and cofactor_identity also compile as plain
// C++ (no __CUDACC__): SerialLanes runs a group's four products in turn, so
// the kernel's steps run on a host against the plain PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ED_HD __device__ __forceinline__
#else
#define ED_HD static inline
#endif
#include <stdint.h>

namespace ed {

#define ED_NBITS 253      // bits of a scalar below 2^253 (gpu/ed25519.py)
#define ED_MAX_ROWS 128   // the largest bucket
#define ED_LANES 4        // lanes of a row's group

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

// lane `sub`'s operand of four, by word masks: no branch
ED_HD fe fe_pick(int sub, const fe& a0, const fe& a1, const fe& a2,
                 const fe& a3) {
  uint32_t m0 = 0u - (uint32_t)(sub == 0), m1 = 0u - (uint32_t)(sub == 1);
  uint32_t m2 = 0u - (uint32_t)(sub == 2), m3 = 0u - (uint32_t)(sub == 3);
  fe r;
#pragma unroll
  for (int i = 0; i < 8; i++)
    r.w[i] = (a0.w[i] & m0) | (a1.w[i] & m1) | (a2.w[i] & m2) |
             (a3.w[i] & m3);
  return r;
}

// A row's group of four lanes on the card: lane `sub` computes product
// `sub` (l_sub * r_sub), then every lane of the group reads the four by
// shuffles within the group's mask.
#ifdef __CUDACC__
struct WarpLanes {
  int sub;        // this lane's rank in its group
  int first;      // the group's first lane in the warp
  unsigned mask;  // the group's lanes

  __device__ __forceinline__ void mul(fe out[4], const fe& l0, const fe& l1,
                                      const fe& l2, const fe& l3,
                                      const fe& r0, const fe& r1,
                                      const fe& r2, const fe& r3) const {
    fe v = fe_mul(fe_pick(sub, l0, l1, l2, l3), fe_pick(sub, r0, r1, r2, r3));
#pragma unroll
    for (int j = 0; j < ED_LANES; j++)
#pragma unroll
      for (int i = 0; i < 8; i++)
        out[j].w[i] = __shfl_sync(mask, v.w[i], first + j);
  }
};
#else
// The same group on a host: the four lanes' products in turn.
struct SerialLanes {
  void mul(fe out[4], const fe& l0, const fe& l1, const fe& l2, const fe& l3,
           const fe& r0, const fe& r1, const fe& r2, const fe& r3) const {
    for (int j = 0; j < ED_LANES; j++)
      out[j] = fe_mul(fe_pick(j, l0, l1, l2, l3), fe_pick(j, r0, r1, r2, r3));
  }
};
#endif

// Unified add-2008-hwcd-3 (a = -1), p += q, on a group's lanes (every lane
// holds p and q and ends with the sum). Round 1: a = (y1-x1)(y2-x2),
// b = (y1+x1)(y2+x2), z1*z2 and t1*t2; round 2: c = 2d*(t1*t2), which
// every lane computes; round 3: X = e*f, Y = g*h, Z = f*g, T = e*h. With
// BASE, q is a row's base (x, y, 1, 2d*t): lane 3's product is c itself
// and the addition takes two rounds. The JAX ed_add evaluates (t1*2d)*t2:
// the same canonical value.
template <bool BASE, class Lanes>
ED_HD void ed_add_lanes(point& p, const point& q, const Lanes& lanes) {
  const fe k2d = {ED_K2D};
  fe r1[4], r3[4];
  lanes.mul(r1, fe_sub(p.y, p.x), fe_add(p.y, p.x), p.z, p.t,
            fe_sub(q.y, q.x), fe_add(q.y, q.x), q.z, q.t);
  fe c;
  if constexpr (BASE)
    c = r1[3];
  else
    c = fe_mul(r1[3], k2d);
  fe d = fe_add(r1[2], r1[2]);
  fe e = fe_sub(r1[1], r1[0]), f = fe_sub(d, c), g = fe_add(d, c);
  fe h = fe_add(r1[1], r1[0]);
  lanes.mul(r3, e, g, f, e, f, h, g, h);
  p.x = r3[0];
  p.y = r3[1];
  p.z = r3[2];
  p.t = r3[3];
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

ED_HD point ed_identity() {
  point r;
  r.x = fe_const(0);
  r.y = fe_const(1);
  r.z = fe_const(1);
  r.t = fe_const(0);
  return r;
}

// [k]P for one row from the identity on a group's lanes: ED_NBITS steps MSB
// first, a doubling each and an addition of the base (x, y, 1, 2d*t) at
// each set bit (the bit is the row's, so a group never diverges)
template <class Lanes>
ED_HD point ladder_row(const uint32_t* px, const uint32_t* py,
                       const uint32_t* pt, const uint32_t* k,
                       const Lanes& lanes) {
  const fe k2d = {ED_K2D};
  point base;
  base.x = fe_load(px);
  base.y = fe_load(py);
  base.z = fe_const(1);
  base.t = fe_mul(fe_load(pt), k2d);
  point acc = ed_identity();
#pragma unroll 1
  for (int s = ED_NBITS - 1; s >= 0; s--) {
    ed_add_lanes<false>(acc, acc, lanes);
    if ((k[s >> 5] >> (s & 31)) & 1u) ed_add_lanes<true>(acc, base, lanes);
  }
  return acc;
}

// [8]sum: three doublings, then the identity test X = 0 and Y = Z on
// canonical words
template <class Lanes>
ED_HD bool cofactor_identity(point& sum, const Lanes& lanes) {
#pragma unroll 1
  for (int i = 0; i < 3; i++) ed_add_lanes<false>(sum, sum, lanes);
  return fe_is_zero(sum.x) && fe_eq(sum.y, sum.z);
}

}  // namespace ed

#ifdef __CUDACC__
using namespace ed;

// --- ed25519_verify: the ladders, then the tree ----------------------------
//
// ed25519_ladder_kernel: one warp a block, one row a warp on the group of
// lanes 0-3 (the other 28 lanes idle: eight rows a warp, whose groups
// diverge on their rows' bits, ran 1.05-1.13 ms against 0.82-0.93 at every
// bucket, ladder_timing.py on an H100); a bucket of B rows is B blocks
// over as many SMs. Lane `sub` stores coordinate `sub` of the row's [k]P
// to `rows`.
__global__ void __launch_bounds__(32)
ed25519_ladder_kernel(const uint32_t* px, const uint32_t* py,
                      const uint32_t* pt, const uint32_t* k, uint32_t* rows) {
  int lane = threadIdx.x, i = blockIdx.x;
  if (lane >= ED_LANES) return;
  WarpLanes lanes = {lane, 0, 0xFu};
  point acc = ladder_row(px + 8 * i, py + 8 * i, pt + 8 * i, k + 8 * i,
                         lanes);
  fe_store(rows + 32 * i + 8 * lane, fe_pick(lane, acc.x, acc.y, acc.z,
                                             acc.t));
}

// ed25519_tree_kernel: one block of n / 2 groups reads `rows` into shared
// memory (128 rows x 128 B = 16 KiB) and sums them in the JAX tree's order
// (row i += row i + s for s = n/2 ... 1, the result in row 0; group i adds
// at each level where i < s); group 0 clears the cofactor and writes
// `total` and `verdict`. Same stream as the ladders: no ticket, no fence.
__global__ void __launch_bounds__(ED_LANES * ED_MAX_ROWS / 2)
ed25519_tree_kernel(const uint32_t* rows, int n, bool* verdict,
                    uint32_t* total) {
  __shared__ point sh[ED_MAX_ROWS];
  int t = threadIdx.x, g = t >> 2, lane = t & 31;
  WarpLanes lanes = {lane & 3, lane & ~3, 0xFu << (lane & ~3)};
  uint32_t* shw = reinterpret_cast<uint32_t*>(sh);
  for (int w = t; w < 32 * n; w += blockDim.x) shw[w] = rows[w];
  __syncthreads();
  for (int s = n >> 1; s > 0; s >>= 1) {
    if (g < s) {  // the group's lanes read before their first shuffle
      point a = sh[g];
      ed_add_lanes<false>(a, sh[g + s], lanes);
      if (lanes.sub == 0) sh[g] = a;
    }
    __syncthreads();
  }
  if (g == 0) {
    point sum = sh[0];
    bool ok = cofactor_identity(sum, lanes);
    fe_store(total + 8 * lanes.sub,
             fe_pick(lanes.sub, sum.x, sum.y, sum.z, sum.t));
    if (lanes.sub == 0) verdict[0] = ok;
  }
}

// --- C interface --------------------------------------------------------------

extern "C" {

int bls_ed25519_verify(const uint32_t* px, const uint32_t* py,
                       const uint32_t* pt, const uint32_t* k, int n,
                       bool* verdict, uint32_t* rows, uint32_t* total,
                       const uint32_t* /* constant table: unused */,
                       cudaStream_t stream) {
  // n is a power of two in 8..ED_MAX_ROWS (the wrapper checks), so the
  // tree holds n / 2 whole groups
  if (n <= 0) return (int)cudaGetLastError();
  ed25519_ladder_kernel<<<n, 32, 0, stream>>>(px, py, pt, k, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ed25519_tree_kernel<<<1, ED_LANES * (n / 2), 0, stream>>>(rows, n, verdict,
                                                            total);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
