"""The lane-split ladders on the CPU: csrc/sign.cu (`batch_sign`,
`batch_pubkey`), csrc/kzg.cu (`g1_scalar_mul`), csrc/aggregate.cu
(`aggregate_rlc_scale`), csrc/ed25519.cu (`ed25519_verify`),
csrc/multi.cu (`multi_rlc_scale`, `g1_group_sum`, `g2_group_sum`),
csrc/pairing.cu (`rlc_partial`), csrc/decompress.cu
(`g2_decompress_subgroup`, `g2_subgroup_check`) and csrc/msm.cu
(`msm_horner`) compiled as plain C++, a row's lanes (or a
block's threads and warps) run in turn and the warp's shuffles emulated,
against the port's plain versions, exact (canonical words).

- `batch_sign` at one, two and four lanes a signature: sk = 1, |x| − 1, |x|,
  |x|², |x|³, r − 2, r − 1, keys with zero digits, a seeded key and an ∞
  message row, against `batch_sign_plain` at the same geometry.
- `g1_scalar_mul` (signed 5-bit windows) on three row sets, each with an
  ∞ base: the edges k = 0, 1, x² − 1, x², x² + 1, r − 1, k0 = 0 (3·x²);
  halves whose windows take the table's extreme digits ±16 and ±15; and
  seeded scalars — against `g1_scalar_mul_plain`.
- The lane's long division k = k1·x² + k0 against Python's divmod.
- `aggregate_rlc_scale` (the strided sum and tree, the G1 halves on two
  lanes, the G2 halves as warp programs and their join) on its edges:
  r0 = 0, r1 = 0, r = 1, halves 0xFFFFFFFF, an aggregate summing to ∞,
  the same key twice, one member, 130 members, masked signatures, and
  seeded rows — against `aggregate_rlc_scale_plain`.
- `multi_rlc_scale` (the G1 halves on two lanes, the G2 halves as warp
  programs or on two lanes, each set's join) on its edges: r0 = 0, r1 =
  0, r = 1, r = 0, halves 0xFFFFFFFF, a masked signature, the same key in
  three sets; and on seeded sets — against `multi_rlc_scale_plain`.
- `g1_group_sum` and `g2_group_sum` (a plan's passes, each tile's units
  and fold) on empty groups, an all-∞ group, one row, exactly
  GROUP_CHUNK rows and one more, a group spanning tiles (two passes), P
  and −P, the same point twice, ∞ then P, and six groups of 4 — against
  the plain versions (G1 on lanes, G2 as warp programs).
- `batch_pubkey`'s comb at its two lanes a key: sk = 1, r − 1, r − 2;
  seeded keys; a zero half (a lane's sum ∞), halves below 2⁶⁴, halves of
  all-15 digits, halves (λ, 1) with equal signs (the join doubles) and
  opposite signs (the join gives ∞) — against `batch_pubkey_plain`.
- `ed25519_verify`'s four-lane unified addition (a doubling, a general
  addition, an addition of a row's base) against the plain `ed_add`, and
  a bucket's ladders, tree and cofactor on chip_smoke's edge rows and on
  seeded rows against `ed25519_verify_plain`.
- `rlc_partial`'s plan (each tile's MUL warp programs, the last pass's
  flag bytes) on empty groups, spans 1, 2, 8, 9, 16, 17, a group
  spanning two passes and 64 mixed groups, with ∞ and refused flags —
  against `rlc_partial_plain`; pairing.cu's and decompress.cu's
  compile-time constants against their Python mirrors.
- `g2_decompress_subgroup`'s warp (the roots on lane pairs, the ψ check
  as warp programs) on the edge corpus of testing/decompress_rows.py —
  against `g2_decompress_subgroup_plain`.
- `g2_subgroup_check`'s warp a row on the rows of testing/subgroup_rows.py
  (G2 points, ∞, cofactor torsion, points outside G2, the decompression
  corpus's points) — against `g2_subgroup_check_plain` and the host.
- `msm_horner`'s G1 lane on fpc and G2 warp on the groups of
  testing/horner_rows.py (∞ totals, a group with no entry, equal and
  opposite points meeting in an addition, a sum to ∞) — against
  `msm_horner_plain` and the host anchor; and (1, 1, 0) doubling to itself
  under point_double and G2DBL, which lets both leave out the doublings
  of ∞.

The harness builds with g++ into the git-ignored csrc/build/; without g++
the tests skip (decided in the fixture).
"""

import ctypes
import hashlib
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from grandine_tpu_torch.crypto import ed25519 as HE
from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, R, X
from grandine_tpu_torch.crypto.curves import B1, B2, G1, Point, g1_infinity
from grandine_tpu_torch.crypto.fields import Fq, Fq2
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
from grandine_tpu_torch.gpu import _build
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import ed25519 as E
from grandine_tpu_torch.gpu import kzg as GK
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm as M
from grandine_tpu_torch.testing import decompress_rows as DR
from grandine_tpu_torch.testing import group_rows as GR
from grandine_tpu_torch.testing import horner_rows as HR
from grandine_tpu_torch.testing import pubkey_rows as PKR
from grandine_tpu_torch.testing import subgroup_rows as SR
from grandine_tpu_torch.testing.pairing_rows import (
    AGGREGATE_EDGES, aggregate_rows)

HARNESS = r"""
#include <string.h>
#include <vector>
#include "sign.cu"
#include "kzg.cu"
#include "aggregate.cu"
#include "ed25519.cu"
#include "multi.cu"
#include "pairing.cu"
#include "decompress.cu"
#include "msm.cu"
extern "C" {
// one pass of an rlc_partial plan over n_tiles tiles, each block's warps
// and threads in turn; the last pass with the flag operands, the others
// with nulls
void ladders_partial(const uint32_t* in, const int32_t* tiles, int n_tiles,
                     uint32_t* out, const bool* agg_inf, const bool* sig_ok,
                     const bool* sig_sub, const int32_t* f_off,
                     const int32_t* s_off, uint8_t* flags, const uint32_t* K) {
  std::vector<uint32_t> sm(PT_WORDS);
  for (int t = 0; t < n_tiles; t++)
    partial_tile(sm.data(), in, tiles, t, out, agg_inf, sig_ok, sig_sub,
                 f_off, s_off, flags, K);
}

// g2_decompress_subgroup over n rows, each row's warp in turn
void ladders_g2_decompress(const uint8_t* rows, int n, uint32_t* xs,
                           uint32_t* ys, bool* flags, const uint32_t* K) {
  std::vector<uint32_t> sm(12 * G2_DEC_WS);
  for (int r = 0; r < n; r++)
    g2_decompress_warp(sm.data(), rows, r, n, xs, ys, flags, K, nullptr);
}

// g2_subgroup_check over n rows, each row's warp in turn
void ladders_g2_subgroup(const uint32_t* sx, const uint32_t* sy,
                         const bool* s_inf, int n, bool* in_sub,
                         const uint32_t* K) {
  std::vector<uint32_t> sm(12 * PSI_WS);
  for (int r = 0; r < n; r++)
    g2_subgroup_warp(sm.data(), sx, sy, s_inf, in_sub, r, K);
}

// msm_horner over G groups of W windows: G1 (k = 1) a lane a group on
// fpc, G2 a warp a group (its lanes in turn)
void ladders_horner(int k, const uint32_t* totals, int G, int W, int w,
                    uint32_t* out, const uint32_t* K) {
  std::vector<uint32_t> sm(12 * HORNER_WS);
  for (int g = 0; g < G; g++) {
    if (k == 1)
      msm_store(out, (size_t)g, msm_horner_lane(totals, W, w, g, K));
    else
      msm_horner_warp(sm.data(), totals, W, w, g, out, K);
  }
}

// one doubling of (1, 1, 0) as canonical words: point_double on fpc
// (3 x 12 words), point_double on fp2 and the G2DBL program (6 x 12 each)
void ladders_double_inf(uint32_t* out, const uint32_t* K) {
  jac<fpc> a = point_double(jac_inf<fpc>(K));
  msm_store(out, 0, a);
  jac<fp2> b = point_double(jac_inf<fp2>(K));
  msm_store(out + 36, 0, b);
  std::vector<uint32_t> sm(12 * (6 + AGG_SCRATCH));
  jac<fp2> inf = jac_inf<fp2>(K);
  memcpy(sm.data(), &inf, sizeof inf);
  tail::run(tail::PROG_G2DBL, sm.data(), sm.data(), nullptr, nullptr,
            sm.data() + 72);
  for (int c = 0; c < 6; c++)
    mont_out(out + 108 + 12 * c, fp_load(sm.data() + 12 * c));
}

// the compile-time constants of pairing.cu: PARTIAL_WARPS, GROUP_CHUNK
void ladders_warp_constants(int* out) {
  out[0] = PARTIAL_WARPS;
  out[1] = GROUP_CHUNK;
}

// multi_rlc_scale over n sets: each block's lanes and warps in turn
void ladders_multi(const uint32_t* src_x, const uint32_t* src_y,
                   const int32_t* idx, int n, int g2_lanes,
                   const uint32_t* sig_x, const uint32_t* sig_y,
                   const bool* sig_mask, const uint32_t* r01, uint32_t* rpk,
                   uint32_t* rsig, const uint32_t* K) {
  std::vector<uint32_t> sm(4 * 12 * AGG_WS);
  for (int b = 0; b < multi_blocks(n, g2_lanes); b++)
    multi_block(sm.data(), b, n, g2_lanes, src_x, src_y, idx, sig_x, sig_y,
                sig_mask, r01, rpk, rsig, K);
}

// one pass of a group-sum plan over n_tiles tiles: G1 lanes (g2 = 0) or
// G2 warp programs, G2_GROUP_WARPS a tile
void ladders_group_sum(int g2, const uint32_t* in, const int32_t* tiles,
                       int n_tiles, uint32_t* out, const uint32_t* K) {
  std::vector<uint32_t> sm(12 * GS_WS * G2_GROUP_WARPS);
  for (int t = 0; t < n_tiles; t++) {
    if (!g2)
      gs_lanes_tile<fpc>(in, tiles, t, out, K);
    else
      gs_warps_tile(sm.data(), in, tiles, t, out, K);
  }
}

// multi.cu's compile-time group-sum constants: GROUP_CHUNK, G2_GROUP_WARPS
void ladders_group_constants(int* out) {
  out[0] = GROUP_CHUNK;
  out[1] = G2_GROUP_WARPS;
}

// batch_pubkey over n keys: each key's lanes in turn, then the shuffle tree
void ladders_pubkey(const uint32_t* k, const bool* neg, int n, uint32_t* out,
                    const uint32_t* T, const uint32_t* K) {
  for (int row = 0; row < n; row++) {
    jac<fpc> p[PUBKEY_LANES];
    for (int l = 0; l < PUBKEY_LANES; l++)
      p[l] = pubkey_lane(k + 8 * row, neg + 2 * row, l, T, K);
    for (int m = 1; m < PUBKEY_LANES; m <<= 1)
      for (int l = 0; l < PUBKEY_LANES; l += 2 * m)
        p[l] = point_add_ct(p[l], p[l + m], K);
    pubkey_store(out + 36 * row, p[0]);
  }
}

// one four-lane unified addition p + q (4 x 8 words each); with base, q is
// a row's base (x, y, 1, t) and its t is multiplied by 2d first, as
// ladder_row does
void ladders_ed_add(const uint32_t* p, const uint32_t* q, int base,
                    uint32_t* out) {
  ed::SerialLanes lanes;
  ed::point a, b;
  memcpy(&a, p, sizeof a);
  memcpy(&b, q, sizeof b);
  if (base) {
    const ed::fe k2d = {ED_K2D};
    b.t = ed::fe_mul(b.t, k2d);
    ed::ed_add_lanes<true>(a, b, lanes);
  } else {
    ed::ed_add_lanes<false>(a, b, lanes);
  }
  memcpy(out, &a, sizeof a);
}

// ed25519_verify over a bucket of n rows: each row's ladder (its group's
// four lanes in turn), then the tree kernel's levels and group 0's
// cofactor and identity test
void ladders_ed25519(const uint32_t* px, const uint32_t* py,
                     const uint32_t* pt, const uint32_t* k, int n,
                     bool* verdict, uint32_t* rows, uint32_t* total) {
  ed::SerialLanes lanes;
  std::vector<ed::point> sh(n);
  for (int i = 0; i < n; i++) {
    sh[i] = ed::ladder_row(px + 8 * i, py + 8 * i, pt + 8 * i, k + 8 * i,
                           lanes);
    memcpy(rows + 32 * i, &sh[i], sizeof sh[i]);
  }
  for (int s = n >> 1; s > 0; s >>= 1)
    for (int g = 0; g < s; g++)
      ed::ed_add_lanes<false>(sh[g], sh[g + s], lanes);
  verdict[0] = ed::cofactor_identity(sh[0], lanes);
  memcpy(total, &sh[0], sizeof sh[0]);
}

// aggregate_rlc_scale over m aggregates: each block's threads, lanes and
// warps in turn
void ladders_aggregate(const uint32_t* src_x, const uint32_t* src_y,
                       const int32_t* idx, const int32_t* cnt, int m, int k,
                       const uint32_t* sig_x, const uint32_t* sig_y,
                       const bool* sig_mask, const uint32_t* r01,
                       uint32_t* rpk, bool* agg_inf, uint32_t* rsig,
                       const uint32_t* K) {
  std::vector<uint32_t> sm(AGG_SMEM_WORDS);
  for (int i = 0; i < m; i++)
    aggregate_block(sm.data(), i, src_x, src_y, idx, cnt, k, sig_x, sig_y,
                    sig_mask, r01, rpk, agg_inf, rsig, K, nullptr);
}

// batch_sign over n rows: each row's lanes in turn, then the shuffle tree
// (lane l adds lane l + m at level m, as __shfl_xor_sync gives it)
void ladders_sign(const uint32_t* msg, const bool* inf, const uint32_t* d,
                  int n, int lanes, uint32_t* out, const uint32_t* K) {
  for (int row = 0; row < n; row++) {
    jac<fp2> p[4];
    for (int l = 0; l < lanes; l++)
      p[l] = lanes == 4 ? sign_lane<4>(msg + 48 * row, d + 8 * row, l, K)
           : lanes == 2 ? sign_lane<2>(msg + 48 * row, d + 8 * row, l, K)
                        : sign_lane<1>(msg + 48 * row, d + 8 * row, l, K);
    for (int m = 1; m < lanes; m <<= 1)
      for (int l = 0; l < lanes; l += 2 * m)
        p[l] = point_add_ct(p[l], p[l + m], K);
    sign_store(out + 72 * row, p[0], inf[row], K);
  }
}

// g1_scalar_mul over n rows: lane 0, lane 1, the complete sum
void ladders_kzg(const uint32_t* px, const uint32_t* py, const bool* inf,
                 const uint32_t* k, int n, uint32_t* out, const uint32_t* K) {
  uint32_t tab[(1 << (KZG_W - 1)) * 36];
  for (int row = 0; row < n; row++) {
    jac<fpc> h[2];
    for (int half = 0; half < 2; half++)
      h[half] = kzg_lane(px + 12 * row, py + 12 * row, k + 8 * row, half,
                         tab, 1, K);
    kzg_store(out + 36 * row, h[0], h[1], inf[row], K);
  }
}

// the halves of n scalars: (k0, k1) as 4 + 4 words a row
void ladders_split(const uint32_t* k, int n, uint32_t* out) {
  for (int row = 0; row < n; row++)
    for (int half = 0; half < 2; half++)
      kzg_split(k + 8 * row, half, out + 8 * row + 4 * half);
}
}
"""

FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-I", _build.CSRC]
SOURCES = ("sign.cu", "kzg.cu", "aggregate.cu", "ed25519.cu", "multi.cu",
           "pairing.cu", "decompress.cu", "msm.cu")
ABS_X = -X
X2 = X * X
rng = random.Random(0x1AD)


@pytest.fixture(scope="module")
def lib():
    """The harness, built with g++ into csrc/build/ (hash-stamped, a
    per-process temporary name), loaded."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the ladders' host harness cannot be built")
    h = hashlib.sha256(HARNESS.encode() + " ".join(FLAGS).encode())
    for name in (*SOURCES, *_build.HEADERS):
        with open(os.path.join(_build.CSRC, name), "rb") as fh:
            h.update(fh.read())
    path = os.path.join(_build.BUILD_DIR,
                        f"libladders_{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        src = f"{path}.{os.getpid()}.cpp"
        with open(src, "w") as fh:
            fh.write(HARNESS)
        try:
            subprocess.run(["g++", *FLAGS, "-o", f"{path}.{os.getpid()}",
                            src], check=True, capture_output=True,
                           timeout=300)
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


SIGN_KEYS = [1, ABS_X - 1, ABS_X, ABS_X ** 2, ABS_X ** 3, R - 2, R - 1,
             5 + 9 * ABS_X ** 3,        # two zero middle digits
             7 + 3 * ABS_X ** 2,        # zero digits 1 and 3
             rng.randrange(R)]


@pytest.fixture(scope="module")
def sign_rows():
    """The edge keys' digits and H(m) words over three messages; row 2's
    message marked ∞."""
    d = B.sign_digits_host(SIGN_KEYS)
    msgs = [B.g2_affine_words(hash_to_g2(b"ladder-%d" % i, DST_SIGNATURE))[0]
            for i in range(3)]
    msg = np.stack([msgs[i % 3] for i in range(len(SIGN_KEYS))])
    inf = np.zeros(len(SIGN_KEYS), bool)
    inf[2] = True
    return msg, inf, d


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_sign_lanes_equal_plain(lib, sign_rows, lanes):
    msg, inf, d = sign_rows
    n = len(SIGN_KEYS)
    out = np.zeros((n, 3, 2, 12), np.uint32)
    lib.ladders_sign(_ptr(msg), _ptr(inf), _ptr(d), n, lanes, _ptr(out),
                     _ptr(K))
    want = B.batch_sign_plain(torch.from_numpy(msg), torch.from_numpy(inf),
                              torch.from_numpy(d), lanes)
    assert np.array_equal(out.view(np.int32), want.numpy())
    assert not out[2, 2].any()  # ∞ message: Z = 0


def _alternating(par):
    """A 125-bit half whose signed 5-bit windows alternate +16 and −16
    from window 1 on."""
    return sum((0b1111 << 5 * i) if i % 2 == par else (1 << (5 * i + 4))
               for i in range(25))


ALT0, ALT1 = _alternating(0), _alternating(1)
NEG16 = sum(1 << (5 * i + 4) for i in range(25))  # windows of −15
POS15 = sum(1 << b for b in range(125) if b % 5 != 4)  # windows of +15
KZG_SCALARS = {
    "edges": [0, 1, X2 - 1, X2, X2 + 1, R - 1, 3 * X2, rng.randrange(R), 5],
    "digits": [ALT1 * X2 + ALT0, ALT0 * X2 + ALT1, NEG16 * X2 + POS15,
               POS15 * X2 + NEG16, (R - 1) // X2 * X2, 1 << 127, 16,
               (1 << 127) * X2, 7],
    "seeded": [rng.randrange(R) for _ in range(9)],
}


def _kzg_rows(rows):
    """Eight seeded multiples of G1 and an ∞ base, the scalars of
    `rows`."""
    pts = [G1.mul(rng.randrange(1, R)) for _ in range(8)] + [g1_infinity()]
    inf = np.array([p.is_infinity() for p in pts], bool)
    px = np.zeros((len(pts), 12), np.int32)
    py = np.zeros_like(px)
    px[~inf], py[~inf] = B.g1_affine_words([p for p in pts
                                            if not p.is_infinity()])
    return px, py, inf, GK.scalar_words(KZG_SCALARS[rows])


@pytest.mark.parametrize("rows", sorted(KZG_SCALARS))
def test_kzg_lanes_equal_plain(lib, rows):
    px, py, inf, k = args = _kzg_rows(rows)
    n = inf.shape[0]
    out = np.zeros((n, 3, 12), np.uint32)
    lib.ladders_kzg(_ptr(px), _ptr(py), _ptr(inf), _ptr(k), n, _ptr(out),
                    _ptr(K))
    want = GK.g1_scalar_mul_plain(*(torch.from_numpy(a) for a in args))
    assert np.array_equal(out.view(np.int32), want.numpy())
    assert not out[8, 2].any()  # the ∞ base
    assert out[1:8, 2].any(-1).all()  # live rows with k ≠ 0
    if rows == "edges":
        assert not out[0, 2].any()  # k = 0


def test_kzg_split_equals_divmod(lib):
    ks = [0, 1, X2 - 1, X2, X2 + 1, R - 1, 3 * X2, (1 << 255) - 1,
          (1 << 128) - 1] + [rng.randrange(1 << 255) for _ in range(23)]
    k = GK.scalar_words(ks)
    out = np.zeros((len(ks), 2, 4), np.uint32)
    lib.ladders_split(_ptr(k), len(ks), _ptr(out))
    got = [(int.from_bytes(r[0].tobytes(), "little"),
            int.from_bytes(r[1].tobytes(), "little")) for r in out]
    assert got == [divmod(v, X2)[::-1] for v in ks]
    halves = GK.scalar_halves(torch.from_numpy(k)).numpy().astype(np.uint32)
    assert np.array_equal(halves, out)


AGG_CASES = {
    "edges": AGGREGATE_EDGES,
    "seeded": [(sorted(rng.sample(range(141), rng.randint(1, 130))),
                (rng.getrandbits(32), rng.getrandbits(32)), i % 4 == 3)
               for i in range(8)],
}


@pytest.mark.parametrize("rows", sorted(AGG_CASES))
def test_aggregate_lanes_equal_plain(lib, rows):
    args = aggregate_rows(AGG_CASES[rows], len(rows))
    m, k = args[2].shape
    rpk = np.zeros((m, 3, 12), np.uint32)
    agg_inf = np.zeros(m, bool)
    rsig = np.zeros((m, 3, 2, 12), np.uint32)
    lib.ladders_aggregate(*(_ptr(a) for a in args[:4]), m, k,
                          *(_ptr(a) for a in args[4:]), _ptr(rpk),
                          _ptr(agg_inf), _ptr(rsig), _ptr(K))
    want = B.aggregate_rlc_scale_plain(*(torch.from_numpy(a) for a in args))
    assert np.array_equal(rpk.view(np.int32), want[0].numpy())
    assert np.array_equal(agg_inf, want[1].numpy())
    assert np.array_equal(rsig.view(np.int32), want[2].numpy())
    if rows == "edges":
        assert agg_inf.tolist() == [i in (4, 8) for i in range(m)]
        assert not rsig[7, 2].any() and not rsig[8, 2].any()  # masked


# --- batch_pubkey: the comb --------------------------------------------------


def _pubkey_rows(kind):
    """The ends sk = 1, r − 1, r − 2; four seeded keys; or the comb's
    edge halves (testing/pubkey_rows.py, row COMB_INF_ROW sums to ∞)."""
    if kind == "edges":
        return PKR.halves_operands(PKR.COMB_EDGES)
    seeded = random.Random(0x9B)
    return B.sign_scalars_host(
        [1, R - 1, R - 2] if kind == "ends"
        else [seeded.randrange(1, R) for _ in range(4)])


@pytest.mark.parametrize("kind", ["ends", "seeded", "edges"])
def test_pubkey_comb_lanes_equal_plain(lib, kind):
    k, neg = _pubkey_rows(kind)
    n = k.shape[0]
    table = np.ascontiguousarray(_build.comb_table("cpu").numpy())
    out = np.zeros((n, 3, 12), np.uint32)
    lib.ladders_pubkey(_ptr(k), _ptr(neg), n, _ptr(out), _ptr(table),
                       _ptr(K))
    want = B.batch_pubkey_plain(torch.from_numpy(k), torch.from_numpy(neg))
    assert np.array_equal(out.view(np.int32), want.numpy())
    # only the edge row λ·g1 − λ·g1 is ∞
    inf = np.arange(n) == (PKR.COMB_INF_ROW if kind == "edges" else -1)
    assert not out[inf, 2].any()
    assert out[~inf, 2].any(-1).all()


# --- ed25519_verify: four lanes a row ----------------------------------------


def _ed_affine(p):
    zinv = pow(p[2], HE.P - 2, HE.P)
    return p[0] * zinv % HE.P, p[1] * zinv % HE.P


def _ed_rows(kind):
    """A bucket of 8 rows: chip_smoke's edge rows (zero scalars, k = 1,
    2²⁵³ − 1, L − 1, 8; the identity, the order-2 point, x = 0 negated,
    the base point, a torsion-carrying R) or seeded ones."""
    if kind == "edges":
        r_t = HE.point_add(HE.point_mul(rng.randrange(1, HE.L), HE.BASE),
                           HE.ORDER2)
        pts = [(0, 1), _ed_affine(HE.ORDER2), _ed_affine(HE.BASE),
               (0, HE.P - 1), _ed_affine(r_t), _ed_affine(HE.BASE),
               _ed_affine(HE.point_neg(r_t)), (0, 1)]
        ks = [0, 1, (1 << 253) - 1, HE.L - 1, rng.getrandbits(128),
              HE.L - 1, 8, 0]
    else:
        pts = [_ed_affine(HE.point_mul(rng.randrange(1, HE.L), HE.BASE))
               for _ in range(8)]
        ks = [rng.getrandbits(253) for _ in range(8)]
    return tuple(E.ints_to_words(v) for v in (
        [x for x, _ in pts], [y for _, y in pts],
        [x * y % HE.P for x, y in pts], ks))


def test_ed25519_add_lanes_equal_plain(lib):
    """A doubling, a general addition and an addition of a base (Z = 1)
    on four lanes, against the plain `ed_add`, word for word."""
    pts = [HE.point_mul(rng.randrange(1, HE.L), HE.BASE) for _ in range(2)]
    a = [tuple(c) for c in pts]
    base = _ed_affine(HE.point_mul(rng.randrange(1, HE.L), HE.BASE))
    b = (base[0], base[1], 1, base[0] * base[1] % HE.P)
    for p, q, is_base in ((a[0], a[0], 0), (a[0], a[1], 0), (a[1], b, 1)):
        pw, qw = E.ints_to_words(p), E.ints_to_words(q)
        out = np.zeros((4, 8), np.int32)
        lib.ladders_ed_add(_ptr(pw), _ptr(qw), is_base, _ptr(out))
        want = E.ed_add(E.words_to_limbs(torch.from_numpy(pw)),
                        E.words_to_limbs(torch.from_numpy(qw)))
        assert np.array_equal(out, E.limbs_to_words(want).numpy())


@pytest.mark.parametrize("kind", ["edges", "seeded"])
def test_ed25519_lanes_equal_plain(lib, kind):
    args = _ed_rows(kind)
    verdict = np.zeros(1, bool)
    rows = np.zeros((8, 4, 8), np.int32)
    total = np.zeros((4, 8), np.int32)
    lib.ladders_ed25519(*(_ptr(a) for a in args), 8, _ptr(verdict),
                         _ptr(rows), _ptr(total))
    want = E.ed25519_verify_plain(*(torch.from_numpy(a) for a in args))
    assert verdict.tolist() == want[0].tolist()
    assert np.array_equal(rows, want[1].numpy())
    assert np.array_equal(total, want[2].numpy())


# --- multi_rlc_scale: the GLV halves apart ----------------------------------

MULTI_CASES = {"edges": GR.MULTI_EDGES,
               "seeded": GR.seeded_multi_cases(0x3C, 10)}


@pytest.mark.parametrize("g2_lanes", [0, 1])
@pytest.mark.parametrize("rows", sorted(MULTI_CASES))
def test_multi_lanes_equal_plain(lib, rows, g2_lanes):
    """Both G2 forms give the plain version's words."""
    args = GR.multi_rows(MULTI_CASES[rows], len(rows))
    n = args[2].shape[0]
    rpk = np.zeros((n, 3, 12), np.uint32)
    rsig = np.zeros((n, 3, 2, 12), np.uint32)
    lib.ladders_multi(*(_ptr(a) for a in args[:3]), n, g2_lanes,
                      *(_ptr(a) for a in args[3:]), _ptr(rpk), _ptr(rsig),
                      _ptr(K))
    want = B.multi_rlc_scale_plain(*(torch.from_numpy(a) for a in args))
    assert np.array_equal(rpk.view(np.int32), want[0].numpy())
    assert np.array_equal(rsig.view(np.int32), want[1].numpy())
    masked = args[5]
    assert not rsig[masked, 2].any()
    assert (rsig[masked][:, :2, 0, 0] == 1).all()
    if rows == "edges":
        assert not rpk[8, 2].any() and not rsig[8, 2].any()  # r = 0


# --- g1_group_sum, g2_group_sum: a plan's passes -------------------------------

#: k of each form: G1 lanes, G2 warp programs
GROUP_FORMS = {"g1 lanes": 1, "g2 warps": 2}


def group_sum_host(lib, rows, offsets, k):
    """The plan's passes through the harness, each tile in turn."""
    src = np.ascontiguousarray(rows)
    for tiles in B.group_sum_plan(offsets, B.group_tile(k)):
        out = np.zeros((tiles.shape[0],) + rows.shape[1:], np.int32)
        lib.ladders_group_sum(k - 1, _ptr(src), _ptr(tiles), tiles.shape[0],
                              _ptr(out), _ptr(K))
        src = out
    return src


def test_group_sum_constants_mirror_the_kernel(lib):
    """gpu/bls.py's GROUP_CHUNK and G2_GROUP_WARPS are multi.cu's: the
    plan's tiles are the kernel's (a wider kernel tile would drop none,
    a narrower one would leave units out)."""
    got = np.zeros(2, np.int32)
    lib.ladders_group_constants(_ptr(got))
    assert got.tolist() == [B.GROUP_CHUNK, B.G2_GROUP_WARPS]
    assert B.group_tile(2) == B.G2_GROUP_WARPS
    assert B.group_tile(1) == B.GROUP_LANES == 32


@pytest.mark.parametrize("form", sorted(GROUP_FORMS))
def test_group_sum_tiles_equal_plain(lib, form):
    k = GROUP_FORMS[form]
    tile = B.group_tile(k)
    rows, offsets, names = GR.group_rows(k, 0x6E + k, tile)
    got = group_sum_host(lib, rows, offsets, k)
    plain = B.g1_group_sum_plain if k == 1 else B.g2_group_sum_plain
    want = plain(torch.from_numpy(rows), offsets).numpy()
    assert np.array_equal(got, want)
    z = got[:, 2].reshape(len(names), -1)
    for name, zero, row in zip(names, ~z.any(-1), got):
        assert zero == (name in ("empty", "all ∞", "P and −P")), name
        if zero:  # ∞ as (1, 1, 0)
            assert row.reshape(3, -1)[:2, 0].tolist() == [1, 1]
            assert not row.reshape(3, -1)[:2, 1:].any()
    assert len(B.group_sum_plan(offsets, tile)) == 2  # the spanning group


# --- rlc_partial: a plan's tiles on MUL warp programs -------------------------

#: each case's groups' f spans (the signature spans are the same rotated by
#: one group)
PARTIAL_SPANS = {
    "empty groups and spans 1, 2, 8, 9": [0, 1, 2, 0, 8, 9, 0],
    "spans 16 and 17 (a tile, a tile and one)": [16, 17],
    "a group spanning two passes": [3, 40],
    "64 mixed groups": [(0, 1, 2, 8, 9, 3)[i % 6] for i in range(64)],
}


def partial_host(lib, f, agg_inf, sig_ok, sig_sub, fo, so):
    """The plan's passes through the harness, each tile in turn; the last
    pass reduces the flag bytes."""
    plan = B.group_sum_plan(fo, B.PARTIAL_WARPS)
    fo32, so32 = fo.astype(np.int32), so.astype(np.int32)
    flags = np.zeros(fo.size - 1, np.uint8)
    last = (_ptr(agg_inf), _ptr(sig_ok), _ptr(sig_sub), _ptr(fo32),
            _ptr(so32), _ptr(flags))
    src = np.ascontiguousarray(f)
    for i, tiles in enumerate(plan):
        out = np.zeros((tiles.shape[0], 2, 3, 2, 12), np.int32)
        lib.ladders_partial(_ptr(src), _ptr(tiles), tiles.shape[0],
                            _ptr(out), *(last if i == len(plan) - 1
                                         else (None,) * 6), _ptr(K))
        src = out
    return src, flags, len(plan)


@pytest.mark.parametrize("case", sorted(PARTIAL_SPANS))
def test_partial_tiles_equal_plain(lib, case):
    """Seeded Fp12 terms (canonical words below p) with ∞ aggregates and
    refused signature rows among them: each group's product and flag byte
    equal `rlc_partial_plain`'s; an empty group gives one."""
    spans = PARTIAL_SPANS[case]
    seeded = np.random.default_rng(len(spans) * 31 + sum(spans))
    nf = sum(spans)
    vals = [int.from_bytes(seeded.bytes(48), "little") % L.P
            for _ in range(nf * 12)]
    f = L.ints_to_words(vals).reshape(nf, 2, 3, 2, 12).copy()
    fo = np.concatenate([[0], np.cumsum(spans)]).astype(np.int64)
    so = np.concatenate([[0], np.cumsum(spans[1:] + spans[:1])])
    agg_inf = seeded.random(nf) < 0.08
    sig_ok = seeded.random(so[-1]) < 0.95
    sig_sub = seeded.random(so[-1]) < 0.95
    got, flags, passes = partial_host(lib, f, agg_inf, sig_ok, sig_sub, fo,
                                      so)
    want = B.rlc_partial_plain(*(torch.from_numpy(a) for a in (
        f, agg_inf, sig_ok, sig_sub)), fo, so)
    assert np.array_equal(got, want[0].numpy())
    assert flags.tolist() == want[1].tolist()
    one = np.zeros((2, 3, 2, 12), np.int32)
    one[0, 0, 0, 0] = 1
    for g, span in enumerate(spans):
        if span == 0:
            assert np.array_equal(got[g], one)
    assert passes == (2 if max(spans) > B.PARTIAL_WARPS * B.GROUP_CHUNK
                      else 1)
    assert {v & 1 for v in flags.tolist()} == {0, 1} or nf < 20
    assert {v & 2 for v in flags.tolist()} == {0, 2} or nf < 20


def test_warp_constants_mirror_the_kernels(lib):
    """gpu/bls.py's PARTIAL_WARPS and GROUP_CHUNK are pairing.cu's (the
    plan's tiles are the kernel's)."""
    got = np.zeros(2, np.int32)
    lib.ladders_warp_constants(_ptr(got))
    assert got.tolist() == [B.PARTIAL_WARPS, B.GROUP_CHUNK]


# --- g2_decompress_subgroup: one warp a row -----------------------------------


def test_g2_decompress_warp_equals_plain(lib):
    """The edge corpus of testing/decompress_rows.py, a warp a row (lanes
    in turn): x, y and the six flag rows equal
    `g2_decompress_subgroup_plain`'s, and the flags are the corpus's."""
    rows, names = DR.edge_rows()
    n = rows.shape[0]
    x = np.zeros((n, 2, 12), np.int32)
    y = np.zeros((n, 2, 12), np.int32)
    flags = np.zeros((6, n), bool)
    lib.ladders_g2_decompress(_ptr(rows), n, _ptr(x), _ptr(y), _ptr(flags),
                              _ptr(K))
    want = C.g2_decompress_subgroup_plain(torch.from_numpy(rows))
    assert np.array_equal(x, want[0].numpy())
    assert np.array_equal(y, want[1].numpy())
    assert np.array_equal(flags, torch.stack(want[2:]).numpy())
    assert [(bool(ok), bool(sub)) for ok, sub in zip(flags[1], flags[5])] \
        == [DR.EXPECTED[name] for name in names]
    for i, name in enumerate(names):  # the c1 = 0 branch's two roots
        if name.endswith("√c0"):
            assert not y[i, 1].any() and y[i, 0].any()
        elif name.endswith("√−c0"):
            assert not y[i, 0].any() and y[i, 1].any()


# --- g2_subgroup_check: one warp a row --------------------------------------


def test_g2_subgroup_warp_equals_plain(lib):
    """The rows of testing/subgroup_rows.py, a warp a row (lanes in turn):
    G2 points, ∞, points of E2 outside G2 (a point off the cofactor's
    torsion, [r]Q in it, a G2 point plus [r]Q) and the points the
    decompression corpus decodes to — the flags equal
    `g2_subgroup_check_plain`'s and the host's [r]P = ∞."""
    sx, sy, inf, names, want = SR.edge_rows()
    sx, sy = np.ascontiguousarray(sx), np.ascontiguousarray(sy)
    n = len(names)
    got = np.zeros(n, bool)
    lib.ladders_g2_subgroup(_ptr(sx), _ptr(sy), _ptr(inf), n, _ptr(got),
                            _ptr(K))
    plain = C.g2_subgroup_check_plain(
        *(torch.from_numpy(a) for a in (sx, sy, inf)))
    assert got.tolist() == plain.tolist() == want
    assert set(want) == {True, False}


# --- msm_horner: G1 on fpc, G2 on warp programs -----------------------------


def _host_point(words, k):
    """(3, [2,] 12) Jacobian canonical words → a host point."""
    v = L.words_to_ints(np.asarray(words).reshape(-1, 12))
    if k == 1:
        return Point(*(Fq(c) for c in v), B1)
    return Point(*(Fq2.from_ints(v[2 * i], v[2 * i + 1]) for i in range(3)),
                 B2)


@pytest.mark.parametrize("k,w", [(1, 4), (2, 8)])
def test_horner_group_equals_plain(lib, k, w):
    """The groups of testing/horner_rows.py at the grouped route's window
    (G1: w = 4, one lane a group on fpc; G2: w = 8, one warp a group):
    no entry, ∞ totals at the top, in the middle and as a live point's
    X, Y with Z = 0, a sum that meets itself (the doubling case) and its
    negation (∞, then the doublings left out), a sum to ∞, one live
    total — the words equal `msm_horner_plain`'s and each sum is the host
    anchor's."""
    totals, names, sums = HR.horner_totals(k, w, 0x4E + k)
    g = len(names)
    out = np.zeros((g,) + totals.shape[1:], np.int32)
    lib.ladders_horner(k, _ptr(totals), g, totals.shape[0] // g, w,
                       _ptr(out), _ptr(K))
    want = M.msm_horner_plain(torch.from_numpy(totals), g, w).numpy()
    assert np.array_equal(out, want)
    for name, row, s in zip(names, out, sums):
        assert _host_point(row, k) == s, name
    inf = np.zeros_like(out[0])
    inf[0].reshape(-1)[0] = inf[1].reshape(-1)[0] = 1
    assert np.array_equal(out[names.index("no entry")], inf)


def test_infinity_doubles_to_itself(lib):
    """(1, 1, 0) doubles to (1, 1, 0) word for word under point_double (G1
    on fpc, G2 on fp2) and the G2DBL program: warp_g2_ladder leaves out
    ∞'s doublings, and msm_horner starts at the top window's total, where
    the plain version doubles (1, 1, 0) and then adds that total to it."""
    out = np.zeros(36 + 72 + 72, np.uint32)
    lib.ladders_double_inf(_ptr(out), _ptr(K))
    g1 = np.zeros((3, 12), np.uint32)
    g1[0, 0] = g1[1, 0] = 1
    g2 = np.zeros((3, 2, 12), np.uint32)
    g2[0, 0, 0] = g2[1, 0, 0] = 1
    assert np.array_equal(out[:36], g1.ravel())
    assert np.array_equal(out[36:108], g2.ravel())
    assert np.array_equal(out[108:], g2.ravel())
