// The GLV halves of the RLC ladders, shared by aggregate_rlc_scale
// (csrc/aggregate.cu) and multi_rlc_scale (csrc/multi.cu); the G2
// ladder of the psi subgroup check as warp programs (warp_psi_check, of
// g2_decompress_subgroup and g2_subgroup_check, csrc/decompress.cu); and
// the complete G2 addition as warp programs (warp_g2_join, also
// msm_horner's, csrc/msm.cu).
//
// A scalar r = r0 + r1*lambda (two 32-bit halves, the verifier's own draw,
// so the ladders branch on their bits) splits [r]B into [r0]B and
// [r1]endo(B), each a 32-step ladder of its own, joined by one complete
// addition:
//   G1: agg_g1_lane, one lane a half on fpc (phi(x, y) = (bx*x, by*y) =
//       [lambda]), Jacobian base, complete additions;
//   G2: agg_g2_half, one warp a half running the G2DBL and G2MADD warp
//       programs of csrc/finish_programs.cuh (warp_g2_ladder; psi'(x, y) =
//       (wx*x, wy*y) = [lambda]), affine base, and agg_g2_join (G2ADD with
//       the cases of point_add_complete); or g2_half_lane, one thread a
//       half on fp2 with the same doublings and mixed additions, so both
//       G2 forms give the same words.
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

// S = [k]Q by the calling warp, k's low `nbits` bits MSB first, Q affine
// (4 Fp values, Montgomery), S Jacobian (6): from infinity, a doubling
// (G2DBL) a step and, where k's bit is set, the base itself at the first
// set bit, a mixed addition (G2MADD) after it — point_double and
// point_madd_unsafe step for step (scalar_mul_bits). Infinity (1, 1, 0)
// doubles to itself, so the doublings before the first set bit are left
// out: S must hold infinity when k may be 0.
BLS_HD void warp_g2_ladder(uint32_t* S, uint32_t* Q, uint64_t k, int nbits,
                           uint32_t* scratch, const uint32_t* K) {
  bool started = false;
  for (int i = nbits - 1; i >= 0; i--) {
    if (started) tail::run(tail::PROG_G2DBL, S, S, nullptr, nullptr, scratch);
    if (!((k >> i) & 1)) continue;
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

// One G2 half by the calling warp, into buf[A_S..]: [r]Q for half 0,
// [r]psi'(Q) for half 1, Q affine (sig_x, sig_y: 2 x 12 canonical words
// each): a 32-step warp_g2_ladder from infinity.
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
  warp_g2_ladder(S, Q, r, 32, scratch, K);
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

// Fp values of a warp's psi-check buffers: the ladder's state S (6), the
// point Q (affine, 4, Montgomery), psi(Q) with Z = 1 (6), the sum O (6),
// side values X (4, G2ADD's H and r), then the scratch
enum PsiBuf { Y_S = 0, Y_Q = 6, Y_P = 10, Y_O = 16, Y_X = 22, Y_SCRATCH = 26,
              PSI_WS = Y_SCRATCH + AGG_SCRATCH };

// psi(Q) + [|x|]Q == infinity for the point Q at buf[Y_Q..] (on E2, not
// infinity) by the calling warp: gpu/curve.py psi_check's ladder by |x|
// (point_double, point_madd_unsafe) as warp programs (warp_g2_ladder) and
// its complete addition as warp_g2_join; the same on every lane.
BLS_HD bool warp_psi_check(uint32_t* buf, const uint32_t* K) {
  uint32_t *S = buf + 12 * Y_S, *Q = buf + 12 * Y_Q, *Ps = buf + 12 * Y_P,
           *O = buf + 12 * Y_O;
  tail::warp_each([&](int lane) {
    if (lane < 2) {  // psi(Q).x on lane 0, psi(Q).y on lane 1
      fp2 v = {fp_load(Q + 24 * lane), fp_load(Q + 24 * lane + 12)};
      fp2 c = lane ? kfp2(K, K_PSI_CY0, K_PSI_CY1)
                   : kfp2(K, K_PSI_CX0, K_PSI_CX1);
      fp2 r = fp2_mul(c, fp2_conj(v));
      fp_store(Ps + 24 * lane, r.c0);
      fp_store(Ps + 24 * lane + 12, r.c1);
    } else if (lane < 4) {  // Z = 1
      fp_store(Ps + 12 * (lane + 2),
               lane == 2 ? fp_load(K + 12 * K_ONE) : fp_zero());
    }
  });
  warp_g2_ladder(S, Q, BLS_ABS_X, 64, buf + 12 * Y_SCRATCH, K);
  warp_g2_join(S, Ps, O, buf + 12 * Y_X, buf + 12 * Y_SCRATCH, K);
  return fp2_is_zero(*reinterpret_cast<const fp2*>(O + 12 * 4));
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
