// The GLV halves of the RLC ladders, shared by aggregate_rlc_scale
// (csrc/aggregate.cu) and multi_rlc_scale (csrc/multi.cu).
//
// A scalar r = r0 + r1*lambda (two 32-bit halves, the verifier's own draw,
// so the ladders branch on their bits) splits [r]B into [r0]B and
// [r1]endo(B), each a 32-step ladder of its own, joined by one complete
// addition:
//   G1: agg_g1_lane, one lane a half on fpc (phi(x, y) = (bx*x, by*y) =
//       [lambda]), Jacobian base, complete additions;
//   G2: agg_g2_half, one warp a half running the G2DBL and G2MADD warp
//       programs of csrc/finish_programs.cuh (psi'(x, y) = (wx*x, wy*y) =
//       [lambda]), affine base, and agg_g2_join (G2ADD with the cases of
//       point_add_complete); or g2_half_lane, one thread a half on fp2 with
//       the same doublings and mixed additions, so both G2 forms give the
//       same words.
// Everything here also compiles as plain C++ (no __CUDACC__): a warp's
// lanes then run in turn.
#pragma once
#include "finish_tail.cuh"

namespace bls {

// Fp values of a G2 warp's buffers: its half's state S (6), its base Q
// (affine, 4), the join's output O (6) and side values X (4, G2ADD's H
// and r), then its scratch
enum AggBuf { A_S = 0, A_Q = 6, A_O = 10, A_X = 16, A_SCRATCH = 20,
              AGG_WS = A_SCRATCH + AGG_SCRATCH };

// One G1 lane: [r]B for half 0, [r]phi(B) for half 1, B Jacobian: from
// infinity, 32 steps of a doubling and, where r's bit is set, a complete
// addition of the base (gpu/curve.py scalar_mul_jac_glv's order).
BLS_HD jac<fpc> agg_g1_lane(const jac<fpc>& b, uint32_t r, int half,
                            const uint32_t* K) {
  jac<fpc> base = b;
  if (half) {
    base.x = f_mul(b.x, fpc{fp_load(K + 12 * K_G1_BX)});
    base.y = f_mul(b.y, fpc{fp_load(K + 12 * K_G1_BY)});
  }
  jac<fpc> st = jac_inf<fpc>(K);
  for (int i = 31; i >= 0; i--) {
    st = point_double(st);
    if ((r >> i) & 1) st = point_add_complete(st, base, K);
  }
  return st;
}

// One G2 half by the calling warp, into buf[A_S..]: [r]Q for half 0,
// [r]psi'(Q) for half 1, Q affine (sig_x, sig_y: 2 x 12 canonical words
// each): from infinity, 32 steps of a doubling (G2DBL) and, where r's bit
// is set, the base itself before the first set bit, a mixed addition
// (G2MADD) after it.
BLS_HD void agg_g2_half(uint32_t* buf, const uint32_t* sig_x,
                        const uint32_t* sig_y, uint32_t r, int half,
                        const uint32_t* K) {
  uint32_t *S = buf + 12 * A_S, *Q = buf + 12 * A_Q,
           *scratch = buf + 12 * A_SCRATCH;
  tail::warp_each([&](int lane) {
    if (lane < 4) {  // x0, x1, y0, y1
      fp v = mont_in((lane < 2 ? sig_x : sig_y) + 12 * (lane & 1), K);
      if (half) v = fp_mul(v, fp_load(K + 12 * (lane < 2 ? K_G2_WX : K_G2_WY)));
      fp_store(Q + 12 * lane, v);
    } else if (lane < 10) {  // S = infinity (1, 1, 0)
      int c = lane - 4;
      fp_store(S + 12 * c, c == 0 || c == 2 ? fp_load(K + 12 * K_ONE)
                                            : fp_zero());
    }
  });
  bool started = false;
  for (int i = 31; i >= 0; i--) {
    tail::run(tail::PROG_G2DBL, S, S, nullptr, nullptr, scratch);
    if (!((r >> i) & 1)) continue;
    if (started) {
      tail::run(tail::PROG_G2MADD, S, Q, S, nullptr, scratch);
    } else {
      tail::warp_each([&](int lane) {
        if (lane < 6)
          fp_store(S + 12 * lane, lane < 4 ? fp_load(Q + 12 * lane)
                                  : lane == 4 ? fp_load(K + 12 * K_ONE)
                                              : fp_zero());
      });
      started = true;
    }
  }
}

// O = p + q (Jacobian G2, 6 Fp values each, O apart from p and q) by the
// calling warp, with the cases of point_add_complete in its order: p
// infinite -> q, q infinite -> p, the generic sum (G2ADD, its H and r into
// X) unless H = 0, where r = 0 doubles p (G2DBL) and otherwise gives
// infinity (1, 1, 0)
BLS_HD void warp_g2_join(const uint32_t* p, const uint32_t* q, uint32_t* O,
                         uint32_t* X, uint32_t* scratch, const uint32_t* K) {
  const jac<fp2>& pj = *reinterpret_cast<const jac<fp2>*>(p);
  const jac<fp2>& qj = *reinterpret_cast<const jac<fp2>*>(q);
  if (fp2_is_zero(pj.z) || fp2_is_zero(qj.z)) {
    tail::warp_copy(O, fp2_is_zero(pj.z) ? q : p, 6);
    return;
  }
  tail::run(tail::PROG_G2ADD, const_cast<uint32_t*>(p),
            const_cast<uint32_t*>(q), O, X, scratch);
  const fp2& H = *reinterpret_cast<const fp2*>(X);
  const fp2& rr = *reinterpret_cast<const fp2*>(X + 24);
  if (!fp2_is_zero(H)) return;
  if (fp2_is_zero(rr)) {
    tail::run(tail::PROG_G2DBL, const_cast<uint32_t*>(p), O, nullptr,
              nullptr, scratch);
  } else {
    tail::warp_each([&](int lane) {
      if (lane < 6)
        fp_store(O + 12 * lane, lane == 0 || lane == 2
                                    ? fp_load(K + 12 * K_ONE) : fp_zero());
    });
  }
}

// a's half (p) plus b's (q) by a's warp into a[A_O..]
BLS_HD void agg_g2_join(uint32_t* a, const uint32_t* b, const uint32_t* K) {
  warp_g2_join(a + 12 * A_S, b + 12 * A_S, a + 12 * A_O, a + 12 * A_X,
               a + 12 * A_SCRATCH, K);
}

// One G2 half on one thread: [r]Q for half 0, [r]psi'(Q) for half 1, Q
// affine (sig_x, sig_y as in agg_g2_half), the same steps as agg_g2_half
// on fp2 (point_double, point_madd_unsafe), so the same words.
BLS_HD jac<fp2> g2_half_lane(const uint32_t* sig_x, const uint32_t* sig_y,
                             uint32_t r, int half, const uint32_t* K) {
  fp2 qx = mont_in2(sig_x, K), qy = mont_in2(sig_y, K);
  if (half) {
    qx = fp2_mul_fp(qx, fp_load(K + 12 * K_G2_WX));
    qy = fp2_mul_fp(qy, fp_load(K + 12 * K_G2_WY));
  }
  return scalar_mul_bits<fp2>(qx, qy, r, 32, K);
}

// a G1 point's 3 x 12 canonical words
BLS_HD void g1_out(uint32_t* w, const jac<fpc>& v) {
  mont_out(w, v.x.v);
  mont_out(w + 12, v.y.v);
  mont_out(w + 24, v.z.v);
}

}  // namespace bls
