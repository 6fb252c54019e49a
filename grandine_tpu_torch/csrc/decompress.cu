// Point decompression and subgroup kernels of the BLS verify path:
// g1_decompress (registry ingest), g2_decompress_subgroup (signature rows),
// g2_subgroup_check (uploaded affine signature points) and unpack_words
// (coordinates uploaded in the packed transfer format).
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
// g2_decompress_subgroup runs one warp a row: the square roots of its
// decompression as exponentiations on pairs of lanes, at once where they
// are independent, then the psi check as warp programs
// (csrc/glv_halves.cuh warp_psi_check). g2_subgroup_check runs that psi
// check alone, one warp a row. unpack_row and the warps' rows
// (g2_decompress_warp, g2_subgroup_warp) also compile as plain C++ (no
// __CUDACC__): a warp's lanes then run in turn, so a row can be run on a
// host against the plain PyTorch version.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "glv_halves.cuh"

using namespace bls;

#define UNPACK_THREADS 128  // threads a block: one coordinate a thread

// One packed coordinate (13 little-endian words) -> its canonical value:
// bits 0-389 (the JAX package's 26 limbs of 15 bits, bits 390-415 dropped)
// as hi 2^384 + lo with hi < 2^6, reduced mod p by Montgomery products as
// the reference's to_mont_dev reduces it: (lo mod p + hi (2^384 mod p))
// mod p. Any 390-bit value comes out below p.
BLS_NI void unpack_row(const uint32_t* w, uint32_t* out, const uint32_t* K) {
  fp r2 = fp_load(K + 12 * K_R2);
  fp lo = fp_load(w);
  fp hi = fp_zero();
  hi.l[0] = w[12] & 0x3fu;
  // fp_mul(a, R^2) = a R mod p for any a < 2^384: the Montgomery form of
  // a mod p; once more for hi R = hi 2^384
  fp m = fp_add(fp_mul(lo, r2), fp_mul(fp_mul(hi, r2), r2));
  mont_out(out, m);
}

// rows a g2_decompress_subgroup or g2_subgroup_check block runs, one warp
// a row; a build sets another value (-D) only for a ladder_timing.py run
// (TREE:NAME=V)
#ifndef G2_DEC_WARPS
#define G2_DEC_WARPS 4
#endif

// --- g2_decompress_subgroup: one warp a row ---------------------------------

// Fp values of a row's decompression buffers, after its psi-check buffers
// (glv_halves.cuh PsiBuf, whose Q receives x and y): y^2 (2), its norm,
// -c0 of y^2, the candidates' t (2), their roots (s, c1/(2s) each), three
// exponentiation pairs (warp_pows: 3 each), one value of flag words
enum DecBuf { D_Y2 = 0, D_N = 2, D_NCA = 3, D_T = 4, D_C = 6, D_POW = 10,
              D_W = 19, DEC_WS = 20, G2_DEC_WS = PSI_WS + DEC_WS };
// the flag words at D_W
enum DecWord { W_PZ0 = 0, W_PZ1, W_GE0, W_GE1, W_CAND0, W_CAND1, W_OK_N,
               W_FLAGS };

// Pair k < n of the calling warp's lanes (lane 2k squares, lane 2k + 1
// multiplies) raises the value at pw[3k] to the power e[k] (12 little-endian
// words, public) into pw[3k + 2], which holds one on entry: least
// significant bit first, the product taking the step's square where the
// bit is set — a chain of one Fp product a step, as many steps as the
// widest exponent has bits, where fp_pow's chain also takes a product a
// set bit. The square alternates between pw[3k] and pw[3k + 1]. The
// value is fp_pow's.
BLS_HD void warp_pows(uint32_t* pw, int n, const uint32_t* const* e) {
  int top = 0;
  for (int k = 0; k < n; k++)
    for (int i = 383; i > top; i--)
      if ((e[k][i >> 5] >> (i & 31)) & 1) {
        top = i;
        break;
      }
  for (int i = 0; i <= top; i++)
    tail::warp_each([&](int lane) {
      int k = lane >> 1;
      if (k >= n) return;
      uint32_t* p = pw + 36 * k;
      fp s = fp_load(p + 12 * (i & 1));
      bool prod = lane & 1;
      fp r = fp_mul(prod ? fp_load(p + 24) : s, s);
      if (!prod)
        fp_store(p + 12 * ((i + 1) & 1), r);
      else if ((e[k][i >> 5] >> (i & 31)) & 1)
        fp_store(p + 24, r);
    });
}

// pair k of warp_pows to start from `base`
BLS_HD void pow_start(uint32_t* pw, int k, const fp& base,
                      const uint32_t* K) {
  fp_store(pw + 36 * k, base);
  fp_store(pw + 36 * k + 24, fp_load(K + 12 * K_ONE));
}

// One 96-byte G2 row by the calling warp: its decode flags (the same on
// every lane) and x, y as Montgomery values into buf[Y_Q..] (x0, x1, y0,
// y1; zero unless the row is a live point). y^2 = x^3 + 4(1 + u) takes
// its root by gpu/field.py fq2_sqrt's norm/half algorithm, candidate for
// candidate: sqrt(c0), sqrt(-c0) and sqrt(norm) at once on three lane
// pairs; for c1 != 0 the candidates t = (c0 +- sqrt(norm))/2 at once on
// two pairs, each by one exponentiation u = t^((p-3)/4): s = u t is
// t^((p+1)/4), fq2_sqrt's root, and where t is a nonzero square (u s =
// t^((p-1)/2) = 1) u/2 is the inverse of 2s that fq2_sqrt takes by a
// Fermat exponentiation. A candidate that is not a nonzero square fails
// its check s^2 = t, so its other word is never kept.
BLS_HD dec_flags warp_g2_decompress(uint32_t* buf, const uint8_t* row,
                                    const uint32_t* K) {
  uint32_t *Q = buf + 12 * Y_Q, *d = buf + 12 * PSI_WS;
  uint32_t *w = d + 12 * D_W, *pw = d + 12 * D_POW;
  // lane 0: x0 (bytes 48..95), lane 1: x1 (bytes 0..47, flags masked)
  tail::warp_each([&](int lane) {
    if (lane >= 2) return;
    uint8_t b[48];
    bool pz = true;
    for (int i = 0; i < 48; i++) {
      b[i] = row[48 * (1 - lane) + i];
      if (lane == 1 && i == 0) b[i] &= 0x1f;
      pz = pz && b[i] == 0;
    }
    fp xc = fp_from_be(b);
    w[W_PZ0 + lane] = pz;
    w[W_GE0 + lane] = fp_geq_p(xc);
    fp_store(Q + 12 * lane, fp_mul(xc, fp_load(K + 12 * K_R2)));
  });
  tail::warp_each([&](int lane) {
    if (lane != 0) return;
    fp2 x = {fp_load(Q), fp_load(Q + 12)};
    fp2 b2 = {fp_load(K + 12 * K_B), fp_load(K + 12 * K_B)};
    fp2 y2 = fp2_add(fp2_mul(fp2_sq(x), x), b2);
    fp norm = fp_add(fp_sq(y2.c0), fp_sq(y2.c1)), nca = fp_neg(y2.c0);
    fp_store(d + 12 * D_Y2, y2.c0);
    fp_store(d + 12 * (D_Y2 + 1), y2.c1);
    fp_store(d + 12 * D_N, norm);
    fp_store(d + 12 * D_NCA, nca);
    pow_start(pw, 0, y2.c0, K);
    pow_start(pw, 1, nca, K);
    pow_start(pw, 2, norm, K);
  });
  const uint32_t* e_sqrt = K + 12 * K_SQRT_EXP;
  const uint32_t* e3[3] = {e_sqrt, e_sqrt, e_sqrt};
  warp_pows(pw, 3, e3);
  bool c1_zero = fp_is_zero(fp_load(d + 12 * (D_Y2 + 1)));
  if (!c1_zero) {
    tail::warp_each([&](int lane) {
      if (lane != 0) return;
      fp ca = fp_load(d + 12 * D_Y2), sn = fp_load(pw + 72 + 24);
      fp half = fp_load(K + 12 * K_HALF);
      w[W_OK_N] = fp_eq(fp_sq(sn), fp_load(d + 12 * D_N));
      fp t[2] = {fp_mul(fp_add(ca, sn), half), fp_mul(fp_sub(ca, sn), half)};
      for (int k = 0; k < 2; k++) {
        fp_store(d + 12 * (D_T + k), t[k]);
        pow_start(pw, k, t[k], K);
      }
    });
    const uint32_t* e_qr = K + 12 * K_QR_EXP;
    const uint32_t* e2[2] = {e_qr, e_qr};
    warp_pows(pw, 2, e2);
    tail::warp_each([&](int lane) {  // candidate `lane`
      if (lane >= 2) return;
      fp ca = fp_load(d + 12 * D_Y2), cb = fp_load(d + 12 * (D_Y2 + 1));
      fp t = fp_load(d + 12 * (D_T + lane)), u = fp_load(pw + 36 * lane + 24);
      fp s = fp_mul(u, t), ss = fp_sq(s);
      fp c1b = fp_mul(fp_mul(cb, fp_load(K + 12 * K_HALF)), u);
      bool ok = fp_eq(ss, t) && !fp_is_zero(s);
      fp sq0 = fp_sub(ss, fp_sq(c1b)), sq1 = fp_dbl(fp_mul(s, c1b));
      w[W_CAND0 + lane] = ok && fp_eq(sq0, ca) && fp_eq(sq1, cb);
      fp_store(d + 12 * (D_C + 2 * lane), s);
      fp_store(d + 12 * (D_C + 2 * lane + 1), c1b);
    });
  }
  // lane 0: the root, its sign, the flags
  tail::warp_each([&](int lane) {
    if (lane != 0) return;
    fp2 y;
    bool y_ok;
    if (c1_zero) {
      fp sa = fp_load(pw + 24), sna = fp_load(pw + 36 + 24);
      bool ok_a = fp_eq(fp_sq(sa), fp_load(d + 12 * D_Y2));
      bool ok_na = fp_eq(fp_sq(sna), fp_load(d + 12 * D_NCA));
      y_ok = ok_a || ok_na;
      y.c0 = ok_a ? sa : fp_zero();
      y.c1 = ok_a ? fp_zero() : sna;
    } else {
      int c = w[W_CAND0] ? 0 : 1;
      y_ok = w[W_OK_N] && (w[W_CAND0] || w[W_CAND1]);
      y.c0 = fp_load(d + 12 * (D_C + 2 * c));
      y.c1 = fp_load(d + 12 * (D_C + 2 * c + 1));
    }
    fp one_c = fp_zero();
    one_c.l[0] = 1;
    fp y0c = fp_mul(y.c0, one_c), y1c = fp_mul(y.c1, one_c);
    fp half = fp_load(K + 12 * K_HALF_CANON);
    bool larger = fp_geq(y1c, half) || (fp_is_zero(y1c) && fp_geq(y0c, half));
    bool sgn = row[0] & 0x20;
    if (sgn != larger) y = fp2_neg(y);
    dec_flags f = decode_masks(row[0], w[W_PZ0] && w[W_PZ1],
                               !w[W_GE0] && !w[W_GE1], y_ok);
    bool live = f.ok && !f.inf;
    fp v[4] = {fp_load(Q), fp_load(Q + 12), y.c0, y.c1};
    for (int c = 0; c < 4; c++) fp_store(Q + 12 * c, live ? v[c] : fp_zero());
    w[W_FLAGS] = f.inf | f.ok << 1 | f.bad_encoding << 2 | f.bad_curve << 3 |
                 f.bad_infinity << 4;
  });
  uint32_t m = w[W_FLAGS];
  return {(m & 1) != 0, (m & 2) != 0, (m & 4) != 0, (m & 8) != 0,
          (m & 16) != 0};
}

// `clocks` (null but in a split measurement, gpu/curve.py
// g2_decompress_subgroup_split): per row, clock64 at the start, after the
// decompression and after the psi check's stores
#ifdef __CUDACC__
#define DEC_CLOCK(i)                                                   \
  do {                                                                 \
    if (clocks && (threadIdx.x & 31) == 0)                             \
      clocks[3 * (size_t)r + (i)] = clock64();                         \
  } while (0)
#else
#define DEC_CLOCK(i) (void)clocks
#endif

// Row r of n by the calling warp: x, y canonical words, the six flag rows
// (inf, ok, bad_encoding, bad_curve, bad_infinity, in_subgroup; the psi
// check passes a row that is not a live point); `buf` holds G2_DEC_WS Fp
// values, 16-byte aligned.
BLS_HD void g2_decompress_warp(uint32_t* buf, const uint8_t* rows, int r,
                               int n, uint32_t* xs, uint32_t* ys,
                               bool* flags, const uint32_t* K,
                               long long* clocks) {
  DEC_CLOCK(0);
  dec_flags f = warp_g2_decompress(buf, rows + 96 * (size_t)r, K);
  DEC_CLOCK(1);
  bool in_sub = !(f.ok && !f.inf) || warp_psi_check(buf, K);
  const uint32_t* Q = buf + 12 * Y_Q;
  tail::warp_each([&](int lane) {
    if (lane < 4) {
      mont_out((lane < 2 ? xs : ys) + 24 * (size_t)r + 12 * (lane & 1),
               fp_load(Q + 12 * lane));
    } else if (lane < 10) {
      bool v[6] = {f.inf, f.ok, f.bad_encoding, f.bad_curve, f.bad_infinity,
                   in_sub};
      flags[(size_t)(lane - 4) * n + r] = v[lane - 4];
    }
  });
  DEC_CLOCK(2);
}

// --- g2_subgroup_check: the warp's row ------------------------------------

// Row r of the affine rows sx, sy (2 x 12 canonical words each) by the
// calling warp: x, y into Montgomery form at buf[Y_Q..] (x0, x1, y0, y1,
// one Fp value a lane), warp_psi_check, in_sub[r] from lane 0. A row with
// s_inf set passes with no program (the same on every lane). `buf` holds
// PSI_WS Fp values, 16-byte aligned.
BLS_HD void g2_subgroup_warp(uint32_t* buf, const uint32_t* sx,
                             const uint32_t* sy, const bool* s_inf,
                             bool* in_sub, int r, const uint32_t* K) {
  bool ok = true;
  if (!s_inf[r]) {
    uint32_t* Q = buf + 12 * Y_Q;
    tail::warp_each([&](int lane) {
      if (lane < 4)
        fp_store(Q + 12 * lane,
                 mont_in((lane < 2 ? sx : sy) + 24 * (size_t)r +
                             12 * (lane & 1), K));
    });
    ok = warp_psi_check(buf, K);
  }
  tail::warp_each([&](int lane) {
    if (lane == 0) in_sub[r] = ok;
  });
}

#ifdef __CUDACC__

// --- g1_decompress: one thread per 48-byte row -------------------------------

__global__ void g1_decompress_kernel(const uint8_t* rows, uint32_t* xs,
                                     uint32_t* ys, bool* flags, int n,
                                     const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp x, y;
  dec_flags f = g1_decompress_row(rows + 48 * (size_t)i, x, y, K);
  fp_store(xs + 12 * (size_t)i, x);
  fp_store(ys + 12 * (size_t)i, y);
  flags[0 * (size_t)n + i] = f.inf;
  flags[1 * (size_t)n + i] = f.ok;
  flags[2 * (size_t)n + i] = f.bad_encoding;
  flags[3 * (size_t)n + i] = f.bad_curve;
  flags[4 * (size_t)n + i] = f.bad_infinity;
}

// --- g2_decompress_subgroup: one warp a row, G2_DEC_WARPS rows a block -----

__global__ void __launch_bounds__(32 * G2_DEC_WARPS)
g2_decompress_subgroup_kernel(const uint8_t* rows, uint32_t* xs,
                              uint32_t* ys, bool* flags, int n,
                              const uint32_t* K, long long* clocks) {
  __shared__ uint4 smem[G2_DEC_WARPS * G2_DEC_WS * 3];
  int w = threadIdx.x >> 5, r = blockIdx.x * G2_DEC_WARPS + w;
  if (r >= n) return;  // the whole warp; the block's warps share nothing
  g2_decompress_warp(reinterpret_cast<uint32_t*>(smem) + 12 * G2_DEC_WS * w,
                     rows, r, n, xs, ys, flags, K, clocks);
}

// the launch over n rows (clocks: see g2_decompress_warp)
static cudaError_t g2_decompress_launch(const uint8_t* rows, uint32_t* xs,
                                        uint32_t* ys, bool* flags, int n,
                                        const uint32_t* K, long long* clocks,
                                        cudaStream_t stream) {
  if (n > 0)
    g2_decompress_subgroup_kernel<<<(n + G2_DEC_WARPS - 1) / G2_DEC_WARPS,
                                    32 * G2_DEC_WARPS, 0, stream>>>(
        rows, xs, ys, flags, n, K, clocks);
  return cudaGetLastError();
}

// --- g2_subgroup_check: one warp a row, G2_DEC_WARPS rows a block --------

__global__ void __launch_bounds__(32 * G2_DEC_WARPS)
g2_subgroup_check_kernel(const uint32_t* sx, const uint32_t* sy,
                         const bool* s_inf, bool* in_sub, int n,
                         const uint32_t* K) {
  __shared__ uint4 smem[G2_DEC_WARPS * PSI_WS * 3];
  int w = threadIdx.x >> 5, r = blockIdx.x * G2_DEC_WARPS + w;
  if (r >= n) return;  // the whole warp; the block's warps share nothing
  g2_subgroup_warp(reinterpret_cast<uint32_t*>(smem) + 12 * PSI_WS * w, sx,
                   sy, s_inf, in_sub, r, K);
}

// --- unpack_words: one thread per packed coordinate -------------------------

__global__ void __launch_bounds__(UNPACK_THREADS)
unpack_words_kernel(const uint32_t* w, int n, uint32_t* out,
                    const uint32_t* K) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unpack_row(w + 13 * (size_t)i, out + 12 * (size_t)i, K);
}

// --- C interface --------------------------------------------------------

extern "C" {

int bls_g1_decompress(const uint8_t* rows, uint32_t* xs, uint32_t* ys,
                      bool* flags, int n, const uint32_t* K,
                      cudaStream_t stream) {
  if (n > 0)
    g1_decompress_kernel<<<(n + 127) / 128, 128, 0, stream>>>(rows, xs, ys,
                                                             flags, n, K);
  return (int)cudaGetLastError();
}

// clocks: null, or 3 a row (a split measurement)
int bls_g2_decompress_subgroup(const uint8_t* rows, uint32_t* xs,
                               uint32_t* ys, bool* flags, int n,
                               long long* clocks, const uint32_t* K,
                               cudaStream_t stream) {
  return (int)g2_decompress_launch(rows, xs, ys, flags, n, K, clocks, stream);
}

// geometry (host memory) of the launch over n rows: blocks, threads a
// block, shared memory bytes, and the most blocks of this shape one SM
// holds at once. Launches nothing.
int bls_g2_decompress_subgroup_geometry(int n, int32_t* geometry,
                                        const uint32_t* K,
                                        cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, g2_decompress_subgroup_kernel, 32 * G2_DEC_WARPS, 0);
  geometry[0] = (n + G2_DEC_WARPS - 1) / G2_DEC_WARPS;
  geometry[1] = 32 * G2_DEC_WARPS;
  geometry[2] = G2_DEC_WARPS * G2_DEC_WS * 48;
  geometry[3] = per_sm;
  return (int)err;
}

int bls_g2_subgroup_check(const uint32_t* sx, const uint32_t* sy,
                          const bool* s_inf, bool* in_sub, int n,
                          const uint32_t* K, cudaStream_t stream) {
  if (n > 0)
    g2_subgroup_check_kernel<<<(n + G2_DEC_WARPS - 1) / G2_DEC_WARPS,
                               32 * G2_DEC_WARPS, 0, stream>>>(
        sx, sy, s_inf, in_sub, n, K);
  return (int)cudaGetLastError();
}

// geometry (host memory) of the g2_subgroup_check launch over n rows, as
// bls_g2_decompress_subgroup_geometry gives it. Launches nothing.
int bls_g2_subgroup_check_geometry(int n, int32_t* geometry,
                                   const uint32_t* K, cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, g2_subgroup_check_kernel, 32 * G2_DEC_WARPS, 0);
  geometry[0] = (n + G2_DEC_WARPS - 1) / G2_DEC_WARPS;
  geometry[1] = 32 * G2_DEC_WARPS;
  geometry[2] = G2_DEC_WARPS * PSI_WS * 48;
  geometry[3] = per_sm;
  return (int)err;
}

int bls_unpack_words(const uint32_t* w, int n, uint32_t* out,
                     const uint32_t* K, cudaStream_t stream) {
  if (n > 0)
    unpack_words_kernel<<<(n + UNPACK_THREADS - 1) / UNPACK_THREADS,
                          UNPACK_THREADS, 0, stream>>>(w, n, out, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
