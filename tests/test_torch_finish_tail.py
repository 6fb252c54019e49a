"""`rlc_finish`'s warp-wide tail on the CPU: csrc/finish_tail.cuh compiled
as plain C++ (a stage's 32 lanes, or a block's threads, in turn between
the synchronisation points) against the port's plain versions, exact
(canonical ints and verdicts).

- The committed csrc/finish_programs.cuh is what gpu/finish_programs.py
  generates, and every program, run by the C++ interpreter, equals the
  generator's own evaluation on seeded values.
- Each warp-wide operation against gpu/field.py and gpu/pairing.py: the
  general Fp12 product, the Miller loop's doubling (the 36-product square
  and the 42-product sparse line product) and addition steps for −g1 and
  for a general Jacobian P with its coefficient program, the cyclotomic
  square on a cyclotomic value, the Euclid Fp inversion and the Fp12
  inversion's chain through the easy part, the whole final
  exponentiation.
- `miller_loop_pairs`' launch (one warp a pair, four warps a block, its
  blocks and warps in turn) against `miller_loop_pairs_plain` at 1, 31,
  33 and 130 pairs: Z = 1 and Z ≠ 1, −g1, the generator and hashed
  messages, pair_inf rows.
- Whole launches (the kernel's blocks in turn): the tail's Fp12 value of
  each live group against `final_exponentiation` of the plain product and
  Miller loop, and the verdicts against `rlc_finish_plain` — valid,
  forged, an ∞ signature sum, f terms only (the KZG shape), signature
  terms only, the agg_inf / sig_ok / sig_sub folds, a dead group — at one
  warp a group, at two warps, and with more terms than threads.

The harness builds with g++ into the git-ignored csrc/build/; without
g++ the tests skip (decided in the fixture).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from grandine_tpu_torch.crypto.constants import P
from grandine_tpu_torch.crypto.curves import G1, G2
from grandine_tpu_torch.gpu import _build
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import finish_programs as FP
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm
from grandine_tpu_torch.gpu import pairing as TP
from grandine_tpu_torch.testing.pairing_rows import miller_rows

HARNESS = r"""
#include <vector>
#include "finish_tail.cuh"
using namespace bls;
extern "C" {
// program `prog` on canonical groups (n_k Fp values each), in place
void tail_run(int prog, uint32_t* g0, int n0, uint32_t* g1, int n1,
              uint32_t* g2, int n2, uint32_t* g3, int n3,
              const uint32_t* K) {
  uint32_t* g[4] = {g0, g1, g2, g3};
  int n[4] = {n0, n1, n2, n3};
  for (int k = 0; k < 4; k++)
    for (int i = 0; i < n[k]; i++)
      fp_store(g[k] + 12 * i, mont_in(g[k] + 12 * i, K));
  std::vector<uint32_t> scratch(12 * TAIL_SCRATCH);
  tail::run(prog, g0, g1, g2, g3, scratch.data());
  for (int k = 0; k < 4; k++)
    for (int i = 0; i < n[k]; i++)
      mont_out(g[k] + 12 * i, fp_load(g[k] + 12 * i));
}
// s (13 words) mod p by the forms' reduction
void tail_reduce(uint32_t* out, const uint32_t* s) {
  fp_store(out, tail::fp_reduce_wide(s));
}
// the form at TAIL_TERMS[off] with every group and scratch value 0
void tail_zero_form(uint32_t* out, int off, int len) {
  std::vector<uint32_t> z(12 * 4096);
  uint32_t* const g[4] = {z.data(), z.data(), z.data(), z.data()};
  fp_store(out, tail::eval_form(g, z.data(), off, len));
}
// miller_loop_pairs' launch over n (Jacobian G1, affine G2) pairs at
// `warps` warps a block, its blocks in turn (each block's warps in turn):
// canonical words in and out
void tail_miller(uint32_t* f, const uint32_t* rpk, const uint32_t* msg,
                 const bool* pair_inf, int n, int warps, const uint32_t* K) {
  std::vector<uint32_t> sm(12 * tail::MILLER_WS * warps);
  for (int b = 0; b * warps < n; b++)
    tail::miller_block(sm.data(), warps, b, n, rpk, msg, pair_inf, f, K);
}
// canonical a -> a^-1 through the Montgomery inversion of the tail
void tail_inv(uint32_t* out, const uint32_t* in, const uint32_t* K) {
  uint32_t m[12], r[12];
  fp_store(m, mont_in(in, K));
  tail::inv_mont(r, m, K);
  mont_out(out, fp_load(r));
}
// f (canonical, 144 words) <- its final exponentiation
void tail_final_exp(uint32_t* f, const uint32_t* K) {
  std::vector<uint32_t> buf(12 * (tail::TAIL_WS + TAIL_SCRATCH));
  for (int i = 0; i < 12; i++)
    fp_store(buf.data() + 12 * i, mont_in(f + 12 * i, K));
  tail::final_exp(buf.data(), buf.data() + 12 * tail::TAIL_WS, K);
  for (int i = 0; i < 12; i++) mont_out(f + 12 * i, fp_load(buf.data() + 12 * i));
}
// the kernel's launch, its blocks in turn; fe_out: each live group's
// tail value (canonical), 144 words a group
void tail_finish(const uint32_t* f, const uint32_t* rsig, const bool* agg_inf,
                 const bool* sig_ok, const bool* sig_sub,
                 const int32_t* f_off, const int32_t* s_off,
                 const int32_t* live, int n_live, int threads, int nf_max,
                 int ns_max, uint8_t* verdict, uint32_t* fe_out,
                 const uint32_t* K) {
  int T = threads;
  int NF = nf_max < T ? nf_max : T, NS = ns_max < T ? ns_max : T;
  tail::layout l = tail::finish_layout(T, NF, NS, nf_max > T);
  std::vector<uint32_t> sm(l.words);
  for (int j = 0; j < n_live; j++) {
    int g = live[j];
    tail::finish_group(sm.data(), T, NF, NS, nf_max > T, f, rsig, agg_inf,
                       sig_ok, sig_sub, f_off[g], f_off[g + 1], s_off[g],
                       s_off[g + 1], K, verdict + g);
    for (int i = 0; i < 12; i++)
      mont_out(fe_out + 144 * j + 12 * i, fp_load(sm.data() + l.tail + 12 * i));
  }
}
}
"""

FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-I", _build.CSRC]


@pytest.fixture(scope="module")
def lib():
    """The harness, built with g++ into csrc/build/ (hash-stamped, a
    per-process temporary name), loaded."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the tail's host harness cannot be built")
    h = hashlib.sha256(HARNESS.encode() + " ".join(FLAGS).encode())
    for name in _build.HEADERS:
        with open(os.path.join(_build.CSRC, name), "rb") as fh:
            h.update(fh.read())
    path = os.path.join(_build.BUILD_DIR, f"libfinish_tail_{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        src = f"{path}.{os.getpid()}.cpp"
        with open(src, "w") as fh:
            fh.write(HARNESS)
        try:
            subprocess.run(["g++", *FLAGS, "-o", f"{path}.{os.getpid()}", src],
                           check=True, capture_output=True, timeout=300)
            os.replace(f"{path}.{os.getpid()}", path)
        finally:
            os.unlink(src)
    return ctypes.CDLL(path)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


K = L.ints_to_words(_build.constant_table_ints()).astype(np.uint32)


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _rand(rng, n):
    """n canonical Fp values from numpy's generator."""
    w = rng.integers(0, 1 << 32, size=(n, 12), dtype=np.uint64)
    return [int(sum(int(x) << (32 * i) for i, x in enumerate(row))) % P
            for row in w]


def _words(vals):
    return L.ints_to_words(vals).astype(np.uint32).reshape(-1).copy()


def _ints(words):
    return L.words_to_ints(np.asarray(words).astype(np.int32).reshape(-1, 12))


def _limbs(vals, shape):
    return L.from_words(torch.from_numpy(
        L.ints_to_words(vals).astype(np.int32).reshape(shape)))


def _plain_ints(t):
    return L.words_to_ints(L.to_words(t).reshape(-1, 12))


def _run(lib, name, *groups):
    """Program `name` on groups of canonical ints; the groups after it."""
    ws = [_words(g) if g else np.zeros(12, np.uint32) for g in groups]
    ws += [np.zeros(12, np.uint32) for _ in range(4 - len(ws))]
    n = [len(g) for g in groups] + [0] * (4 - len(groups))
    lib.tail_run(FP.prog_index(name), *(a for w, k in zip(ws, n)
                                        for a in (_ptr(w), k)), _ptr(K))
    return [_ints(w) if g else [] for w, g in zip(ws, groups)]


def test_committed_header_is_generated():
    with open(os.path.join(_build.CSRC, "finish_programs.cuh")) as fh:
        assert fh.read() == FP.header()


def test_every_program_equals_the_generator(lib):
    """Seeded values, then values drawn from {0, 1, p − 1, random} (the
    edges of a form's reduction: a lone negated zero is p before it)."""
    rng = np.random.default_rng(0xF1)
    t = FP.build_tables()
    for edges in (False, True):
        for i, pr in enumerate(FP.programs()):
            vals = [_rand(rng, n) for _, n in pr.groups]
            if edges:
                vals = [[(0, 1, P - 1, v)[rng.integers(4)] for v in g]
                        for g in vals]
            got = _run(lib, pr.name, *vals)
            FP.evaluate(t, i, vals)
            assert got == vals, (pr.name, edges)


def test_form_reduction_edges(lib):
    """The forms' reduction of a sum below 2^388 — the widest form's
    weight times p is below 100p — at k·p − 1, k·p, k·p + 1 and random
    points, k up to 150."""
    rng = np.random.default_rng(0xF5)
    t = FP.build_tables()
    widest = max(sum(abs(c) for _, c in t.terms[o:o + (n & 0xFF) + (n >> 8)])
                 for o, n in [(a, na) for a, na, _, _, _ in t.tasks]
                 + [(b, nb) for _, _, b, nb, _ in t.tasks]
                 + [(o, n) for o, n, _ in t.outs])
    assert widest < 100
    vals = [k * P + e for k in range(151) for e in (-1, 0, 1) if k * P + e >= 0]
    vals += [int.from_bytes(rng.bytes(49), "little") % (150 * P)
             for _ in range(200)]
    out = np.zeros(12, np.uint32)
    for v in vals:
        words = np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(13)],
                         np.uint32)
        lib.tail_reduce(_ptr(out), _ptr(words))
        assert _ints(out)[0] == v % P, v


def test_every_form_on_zero_values(lib):
    """Every operand and output form with its group and scratch values 0
    (constants kept): a form of only negated terms then sums to a multiple
    of p that must reduce to 0."""
    t = FP.build_tables()
    forms = [(a, na) for a, na, _, _, _ in t.tasks]
    forms += [(b, nb) for _, _, b, nb, _ in t.tasks]
    forms += [(o, n) for o, n, _ in t.outs]
    out = np.zeros(12, np.uint32)
    for off, n in forms:
        lib.tail_zero_form(_ptr(out), off, n)
        terms = t.terms[off:off + (n & 0xFF) + (n >> 8)]
        want = sum(c * t.consts[s & 0xFFF] for s, c in terms
                   if s >> 12 == FP.KIND_CONST) % P
        # the Montgomery word of the constants' sum
        assert _ints(out)[0] == want * (1 << 384) % P, (off, n)


def test_programs_fit_a_warp():
    t = FP.build_tables()
    for start, end in zip(t.rounds, t.rounds[1:]):
        assert end - start <= FP.WIDTH
    assert all(p["n_out"] <= FP.WIDTH for p in t.progs)
    counts = FP.stats()
    # the function's least work: the general product 54 Fp products, the
    # doubling step with its 36-product square and 42-product sparse line
    # product (the step itself 46 for −g1's constant coefficients, 48 for a
    # general P's: zP³ scales the line), the addition step's line product
    # 42 (the step 46 for an affine Q), the cyclotomic square 18
    assert counts["MUL"] == (54, 2)
    assert counts["CYC_SQ"] == (18, 1)
    assert counts["DBL"][0] == 36 + 42 + 46
    assert counts["DBL_P"][0] == 36 + 42 + 48
    assert counts["ADD_P"][0] == 42 + 46
    assert counts["PCOEF"] == (3, 2)


def test_general_product_and_miller_steps(lib):
    rng = np.random.default_rng(0xF2)
    a, b = _rand(rng, 12), _rand(rng, 12)
    _, _, o = _run(lib, "MUL", a, b, [0] * 12)
    assert o == _plain_ints(F.fp12_mul(_limbs(a, (2, 3, 2, 12)),
                                       _limbs(b, (2, 3, 2, 12))))
    f, T, Q = _rand(rng, 12), _rand(rng, 6), _rand(rng, 6)
    ft = _limbs(f, (2, 3, 2, 12))
    Tt = tuple(_limbs(T, (3, 2, 12)))
    Qt = tuple(_limbs(Q, (3, 2, 12)))
    neg = (-G1).to_affine()
    g1c = TP.prepare_g1((L.const_fp(neg[0].n), L.const_fp(neg[1].n),
                         L.const_fp(1)))
    fo, To, _ = _run(lib, "DBL", f, T, Q)
    T2, line = TP.double_step(Tt, g1c)
    assert fo == _plain_ints(F.fp12_mul(F.fp12_sq(ft),
                                        TP.line_to_fp12(line)))
    assert To == _plain_ints(torch.stack(T2))
    # the sum tree's G2 addition (generic case) and doubling
    A, Bp = _rand(rng, 6), _rand(rng, 6)
    At, Bt = (tuple(_limbs(v, (3, 2, 12))) for v in (A, Bp))
    _, _, o, side = _run(lib, "G2ADD", A, Bp, [0] * 6, [0] * 4)
    assert o == _plain_ints(torch.stack(C.point_add_complete(At, Bt,
                                                             C.FP2_OPS)))
    assert side[:2] != [0, 0]  # H: the generic case
    assert _run(lib, "G2DBL", A, [0] * 6)[1] == _plain_ints(
        torch.stack(C.point_double(At, C.FP2_OPS)))
    fo, To, _ = _run(lib, "ADD", f, T, Q)
    T3, line = TP.add_step(Tt, Qt, g1c)
    assert fo == _plain_ints(F.fp12_mul(ft, TP.line_to_fp12(line)))
    assert To == _plain_ints(torch.stack(T3))


def test_general_p_coefficients_and_miller_steps(lib):
    """miller_loop_pairs' programs: P's coefficients (yP, zP³, −xP·zP) of a
    Jacobian P, and the doubling and addition steps with them and an
    affine Q, against gpu/pairing.py prepare_g1, double_step, add_step."""
    rng = np.random.default_rng(0xF6)
    Pj = _rand(rng, 3)
    g1c = TP.prepare_g1(tuple(_limbs([v], (12,)) for v in Pj))
    coeffs = _run(lib, "PCOEF", Pj, [0] * 3)[1]
    assert coeffs == [_plain_ints(g1c[0][0])[0], _plain_ints(g1c[2])[0],
                      _plain_ints(g1c[1])[0]]
    f, T, Q = _rand(rng, 12), _rand(rng, 6), _rand(rng, 4)
    ft = _limbs(f, (2, 3, 2, 12))
    Tt = tuple(_limbs(T, (3, 2, 12)))
    Qt = (*_limbs(Q, (2, 2, 12)), F.fp2_one(()))
    fo, To, _, _ = _run(lib, "DBL_P", f, T, Q, coeffs)
    T2, line = TP.double_step(Tt, g1c)
    assert fo == _plain_ints(F.fp12_mul(F.fp12_sq(ft),
                                        TP.line_to_fp12(line)))
    assert To == _plain_ints(torch.stack(T2))
    fo, To, _, _ = _run(lib, "ADD_P", f, T, Q, coeffs)
    T3, line = TP.add_step(Tt, Qt, g1c)
    assert fo == _plain_ints(F.fp12_mul(ft, TP.line_to_fp12(line)))
    assert To == _plain_ints(torch.stack(T3))


@pytest.mark.parametrize("n", [1, 31, 33, 130])
def test_miller_pairs_equal_plain(lib, n):
    """miller_loop_pairs' launch over n pairs at four warps a block (a
    partial last block for 1, 31, 33 and 130), its blocks and warps in
    turn, against miller_loop_pairs_plain: canonical words, exact."""
    rpk, msg, inf, tile = miller_rows(n, n)
    want = TP.miller_loop_pairs_plain(*(torch.from_numpy(a)
                                        for a in (rpk, msg, inf)))
    rpk, msg, inf = (np.ascontiguousarray(a[tile]) for a in (rpk, msg, inf))
    out = np.zeros((n, 2, 3, 2, 12), np.uint32)
    lib.tail_miller(_ptr(out), _ptr(rpk), _ptr(msg), _ptr(inf), n, 4, _ptr(K))
    assert np.array_equal(out.view(np.int32), want.numpy()[tile])
    if n > 3:  # the pair_inf row: Fp12 one
        assert _ints(out[3].reshape(-1)) == [1] + [0] * 11


def test_cyclotomic_square_inversion_and_final_exponentiation(lib):
    rng = np.random.default_rng(0xF3)
    f = _rand(rng, 12)
    ft = _limbs(f, (2, 3, 2, 12))
    # the Fp12 inverse's chain through the easy part
    n6, w = _run(lib, "INV_N6", f, [0] * 6)[1], [0] * 10
    w = _run(lib, "INV_N2", n6, w)[1]
    inv = np.zeros(12, np.uint32)
    lib.tail_inv(_ptr(inv), _ptr(_words([w[8]])), _ptr(K))
    assert _ints(inv)[0] == pow(w[8], P - 2, P)
    w[9] = _ints(inv)[0]
    m = _run(lib, "INV_EASY", f, w, [0] * 12)[2]
    t = F.fp12_mul(F.fp12_conj(ft), F.fp12_inv(ft))
    mt = F.fp12_mul(F.fp12_frobenius_n(t, 2), t)
    assert m == _plain_ints(mt)
    # the cyclotomic square and square-times-m on m
    assert _run(lib, "CYC_SQ", m, m, [0] * 12)[2] == _plain_ints(
        F.fp12_mul(mt, mt))
    assert _run(lib, "CYC_SQ_MUL", m, m, [0] * 12)[2] == _plain_ints(
        F.fp12_mul(F.fp12_mul(mt, mt), mt))
    # the Euclid inversion at 0, 1 and p - 1
    for v in (0, 1, P - 1):
        lib.tail_inv(_ptr(inv), _ptr(_words([v])), _ptr(K))
        assert _ints(inv)[0] == (pow(v, P - 2, P) if v else 0)


# --- whole launches ---------------------------------------------------------------


def _g1_jac(pt):
    return [pt.x.n, pt.y.n, pt.z.n]


def _g2_jac(pt):
    return [pt.x.c0.n, pt.x.c1.n, pt.y.c0.n, pt.y.c1.n, pt.z.c0.n, pt.z.c1.n]


@pytest.fixture(scope="module")
def launches(lib):
    """Seeded rlc_finish calls: (name, operands, offsets) — at one warp a
    group: valid, forged, an ∞ sum, f terms only, signature terms only,
    an agg_inf, a sig_ok and a sig_sub flag, a dead group; at two warps
    (span 40) and past one term a thread (span 131)."""
    rng = np.random.default_rng(0xF4)
    n = 4
    sk = [int(x) for x in rng.integers(1, 1 << 62, size=n)]
    hk = [int(x) for x in rng.integers(1, 1 << 62, size=n)]
    r = [int(x) for x in rng.integers(1, 1 << 62, size=n)]
    H = [G2.mul(h) for h in hk]
    rpk = [G1.mul(s * ri) for s, ri in zip(sk, r)]
    rsig = [Hi.mul(s * ri) for Hi, s, ri in zip(H, sk, r)]
    Pk, Qk = G1.mul(int(rng.integers(1, 1 << 62))), H[0]
    pairs_p = rpk + [Pk, -Pk]
    pairs_q = H + [Qk, Qk]
    msg = np.stack([B.g2_affine_words(q)[0] for q in pairs_q])
    # the f terms by miller_loop_pairs' warp programs compiled as C++ (held
    # against miller_loop_pairs_plain by test_miller_pairs_equal_plain)
    rpk_w = _words([v for p in pairs_p for v in _g1_jac(p)])
    msg_w = np.ascontiguousarray(msg.astype(np.uint32))
    ml = np.zeros((len(pairs_p), 2, 3, 2, 12), np.uint32)
    no_inf = np.zeros(len(pairs_p), bool)
    lib.tail_miller(_ptr(ml), _ptr(rpk_w), _ptr(msg_w), _ptr(no_inf),
                    len(pairs_p), 2, _ptr(K))
    ml = torch.from_numpy(ml.astype(np.int32))
    fv, kzg = ml[:n], ml[n:]
    sig = [_g2_jac(s) for s in rsig]
    forged = _g2_jac(rsig[0] + G2)
    s_pt = G2.mul(int(rng.integers(1, 1 << 62)))
    groups = [  # (f rows, signature rows, agg_inf, sig_ok, sig_sub)
        (fv, sig, None, None, None),                       # valid
        (fv, [forged] + sig[1:], None, None, None),        # forged
        (fv[:2], [_g2_jac(s_pt), _g2_jac(-s_pt)], None, None, None),  # ∞ sum
        (kzg, [], None, None, None),                       # f terms only
        (fv[:0], [_g2_jac(s_pt), sig[1]], None, None, None),  # signatures only
        (fv[:1], [sig[0], sig[0]], None, None, None),      # a doubled sum
        (fv, sig, 1, None, None),                          # an agg_inf
        (fv, sig, None, 2, None),                          # a sig_ok
        (fv, sig, None, None, 0),                          # a sig_sub
        (fv[:0], [], None, None, None),                    # dead
    ]

    def call(groups):
        fs, ss, ai, ok, sub, fo, so = [], [], [], [], [], [0], [0]
        for f_rows, s_rows, bad_ai, bad_ok, bad_sub in groups:
            a = np.zeros(len(f_rows), bool)
            o = np.ones(len(s_rows), bool)
            u = np.ones(len(s_rows), bool)
            if bad_ai is not None:
                a[bad_ai] = True
            if bad_ok is not None:
                o[bad_ok] = False
            if bad_sub is not None:
                u[bad_sub] = False
            fs.append(f_rows)
            ss += s_rows
            ai.append(a)
            ok.append(o)
            sub.append(u)
            fo.append(fo[-1] + len(f_rows))
            so.append(so[-1] + len(s_rows))
        ops = (torch.cat(fs),
               torch.from_numpy(L.ints_to_words([v for s in ss for v in s])
                                .astype(np.int32).reshape(-1, 3, 2, 12)),
               torch.from_numpy(np.concatenate(ai)),
               torch.from_numpy(np.concatenate(ok)),
               torch.from_numpy(np.concatenate(sub)))
        return ops, np.array(fo), np.array(so)

    def wide(m, seed):
        g = np.random.default_rng(seed)
        f_rows = torch.from_numpy(L.ints_to_words(_rand(g, 12 * m)).astype(
            np.int32).reshape(m, 2, 3, 2, 12))
        base, acc, s_rows = G2.mul(int(g.integers(1, 1 << 62))), None, []
        for _ in range(m):  # multiples of one point: cheap host additions
            acc = base if acc is None else acc + base
            s_rows.append(_g2_jac(acc))
        return f_rows, s_rows, None, None, None

    return [("one warp a group", *call(groups)),
            ("two warps, span 40", *call([wide(40, 1)])),
            ("four warps, span 131", *call([wide(131, 2)]))]


def _launch(lib, ops, fo, so):
    f, rsig, ai, ok, sub = ops
    fo_, so_, live, threads = B.finish_groups(f, rsig, fo, so)
    nf_max, ns_max = B.finish_widths(fo_, so_, live)
    verdict = np.ones(fo_.size - 1, np.uint8)
    fe = np.zeros((max(1, live.size), 144), np.uint32)
    arrays = [np.ascontiguousarray(a.numpy()).astype(np.uint32 if i < 2 else bool)
              for i, a in enumerate((f, rsig, ai, ok, sub))]
    fo32, so32, live32 = (np.ascontiguousarray(x, np.int32) for x in (fo_, so_, live))
    lib.tail_finish(*(_ptr(a) for a in arrays), _ptr(fo32), _ptr(so32),
                    _ptr(live32), live.size, threads, nf_max, ns_max,
                    _ptr(verdict), _ptr(fe), _ptr(K))
    return verdict, fe[:live.size], live, threads


def test_tail_values_equal_final_exponentiation(lib, launches):
    """A live group's Fp12 value before the is-one test equals the plain
    final exponentiation of (product of its f terms) × (Miller loop of −g1
    and its signature sum), word for word — the one-warp launch's valid,
    forged, ∞-sum, f-only, signature-only and doubled-sum groups and the
    wide launches — and a
    wide launch's verdict is that value's is-one test (its flags all
    clear); the sums and products per launch, one plain Miller batch and
    one plain final exponentiation over all."""
    values, prods, sums, verdicts = [], [], [], []
    for name, ops, fo, so in launches:
        verdict, fe, live, threads = _launch(lib, ops, fo, so)
        assert threads == {"one warp a group": 32, "two warps, span 40": 64,
                           "four warps, span 131": 128}[name]
        if name == "one warp a group":
            pick = [0, 1, 2, 3, 4, 5]  # of the live groups
            fe, live = fe[pick], live[pick]
        f_rows = torch.cat([ops[0][fo[g]:fo[g + 1]] for g in live])
        s_rows = torch.cat([ops[1][so[g]:so[g + 1]] for g in live])
        lf = np.cumsum([0] + [fo[g + 1] - fo[g] for g in live])
        ls = np.cumsum([0] + [so[g + 1] - so[g] for g in live])
        prods.append(TP.fp12_product_tree_grouped(L.from_words(f_rows), lf,
                                                  threads))
        sums.append(msm.sum_points_contiguous(C.jac_from_words(s_rows, 2),
                                              ls, C.FP2_OPS, threads))
        values += [_ints(row) for row in fe]
        if name != "one warp a group":
            verdicts.append((verdict.tolist(), fe))
    sig = tuple(torch.cat(c) for c in zip(*sums))
    m = sig[0].shape[0]
    neg = (-G1).to_affine()
    ng = (L.const_fp(neg[0].n, (m,)), L.const_fp(neg[1].n, (m,)),
          L.one_fp((m,)))
    miller = TP.miller_loop(ng, TP.jacobian_to_homogeneous(sig),
                            F.fp2_is_zero(sig[2]))
    want = TP.final_exponentiation(F.fp12_mul(torch.cat(prods), miller))
    assert values == [_plain_ints(row) for row in want]
    one = _plain_ints(F.fp12_one(()))
    for verdict, fe in verdicts:
        assert verdict == [int(_ints(row) == one) for row in fe]


def test_tail_verdicts_equal_rlc_finish_plain(lib, launches):
    """The verdicts of the one-warp launch — valid, forged, ∞ sum, f terms
    only, signature terms only, a doubled sum, the three flags, a dead
    group — against
    `rlc_finish_plain`."""
    _, ops, fo, so = launches[0]
    got = _launch(lib, ops, fo, so)[0].tolist()
    assert got == B.rlc_finish_plain(*ops, fo, so).tolist()
    assert got == [1, 0, 0, 1, 0, 0, 0, 0, 0, 1]
