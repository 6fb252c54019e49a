"""Differential tests: the port's plain curve layer
(grandine_tpu_torch/gpu/curve.py) against the JAX package's
(grandine_tpu/tpu/curve.py, tpu/bls.py ψ check) on the same seeded inputs:
decompression with all its outputs, the ψ subgroup check, the grouped
tree sum and both GLV ladders — compared as canonical integers and affine
points, exactly."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import P, R
from grandine_tpu.crypto.curves import G1, G2, LAMBDA, endo_constants
from grandine_tpu.crypto.fields import Fq2
from grandine_tpu.crypto.hash_to_curve import (
    hash_to_field_fq2, hash_to_g2, map_to_curve_g2)
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import curve as JC
from grandine_tpu.tpu import limbs as JL
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.testing import decompress_rows as DR

rng = random.Random(0x70C)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _g1_corpus():
    """The edge cases of tests/test_tpu_decompress.py, rebuilt here."""
    blobs = [JA.g1_to_bytes(G1.mul(k)) for k in (1, 2, 3, 1234567)]
    flip = bytearray(blobs[0])
    flip[0] ^= 0x20  # the other square root
    blobs.append(bytes(flip))
    blobs.append(bytes([0xC0]) + bytes(47))  # infinity
    b = bytearray(blobs[0])
    b[0] &= 0x7F  # compression flag missing
    blobs.append(bytes(b))
    enc = bytearray((P + 1).to_bytes(48, "big"))
    enc[0] |= 0x80  # x ≥ p
    blobs.append(bytes(enc))
    x = 1
    while pow((x**3 + 4) % P, (P - 1) // 2, P) == 1:
        x += 1
    nr = bytearray(x.to_bytes(48, "big"))
    nr[0] |= 0x80  # x³ + 4 a non-residue
    blobs.append(bytes(nr))
    ip = bytearray(blobs[0])
    ip[0] |= 0x40  # infinity flag with a payload
    blobs.append(bytes(ip))
    isf = bytearray(48)
    isf[0] = 0xE0  # infinity with the sign bit
    blobs.append(bytes(isf))
    return blobs


def _non_subgroup_g2(i):
    return map_to_curve_g2(hash_to_field_fq2(b"ng-%d" % i, b"SGT", 1)[0])


def _g2_corpus():
    blobs = [JA.g2_to_bytes(hash_to_g2(b"corpus-%d" % i)) for i in range(3)]
    flip = bytearray(blobs[0])
    flip[0] ^= 0x20
    blobs.append(bytes(flip))
    blobs.append(bytes([0xC0]) + bytes(95))
    blobs += [JA.g2_to_bytes(_non_subgroup_g2(i)) for i in range(2)]
    b = bytearray(blobs[0])
    b[0] &= 0x7F
    blobs.append(bytes(b))
    c1_ge = bytearray(96)
    c1_ge[:48] = (P + 2).to_bytes(48, "big")
    c1_ge[0] |= 0x80
    blobs.append(bytes(c1_ge))
    c0_ge = bytearray(96)
    c0_ge[48:] = (P + 2).to_bytes(48, "big")
    c0_ge[0] |= 0x80
    blobs.append(bytes(c0_ge))
    c0v = 0
    while True:
        c0v += 1
        xx = Fq2.from_ints(c0v, 3)
        if (xx * xx * xx + Fq2.from_ints(4, 4)).sqrt() is None:
            break
    nr = bytearray(xx.c1.n.to_bytes(48, "big") + xx.c0.n.to_bytes(48, "big"))
    nr[0] |= 0x80
    blobs.append(bytes(nr))
    ip = bytearray(blobs[0])
    ip[0] |= 0x40
    blobs.append(bytes(ip))
    # the edge corpus the kernel's tests share: c1 = 0 rows, ∞ forms, the
    # all-zero row
    edges, _ = DR.edge_rows()
    return blobs + [bytes(r) for r in edges]


def _rows(blobs, width):
    return np.frombuffer(b"".join(blobs), np.uint8).reshape(-1, width).copy()


def _jax_ints(limb_list):
    return [JL.from_mont(r) % P for r in JL.merge_np(limb_list)]


def test_g1_decompress_matches_jax_on_edge_corpus():
    rows = _rows(_g1_corpus(), 48)
    got = C.g1_decompress_plain(torch.from_numpy(rows))
    ref = jax.jit(JC.g1_decompress_dev)(rows)
    assert L.words_to_ints(got[0]) == _jax_ints(ref[0])
    assert L.words_to_ints(got[1]) == _jax_ints(ref[1])
    for g, r in zip(got[2:], ref[2:]):
        assert g.tolist() == np.asarray(r).tolist()
    ok, bad_enc, bad_curve, bad_inf = (got[i] for i in (3, 4, 5, 6))
    assert bad_enc.sum() >= 2 and bad_curve.sum() >= 1 and bad_inf.sum() >= 2
    assert not (ok & (bad_enc | bad_curve | bad_inf)).any()


def test_g2_decompress_and_psi_check_match_jax():
    blobs = _g2_corpus()
    rows = _rows(blobs, 96)
    got = C.g2_decompress_subgroup_plain(torch.from_numpy(rows))

    def ref_fn(r):
        x, y, inf, ok, be, bc, bi = JC.g2_decompress_dev(r)
        return x, y, inf, ok, be, bc, bi, JB._fused_subgroup_mask(
            (x, y), inf | ~ok)

    ref = jax.jit(ref_fn)(rows)
    for k in (0, 1):
        want = [v for pair in zip(_jax_ints(ref[k][0]), _jax_ints(ref[k][1]))
                for v in pair]
        assert L.words_to_ints(got[k]) == want
    for g, r in zip(got[2:], ref[2:]):
        assert g.tolist() == np.asarray(r).tolist()
    in_sub = got[7].tolist()
    assert in_sub[5:7] == [False, False]  # on E2, outside G2
    assert all(in_sub[:5])                # G2 points and ∞ pass
    _, names = DR.edge_rows()
    n = len(names)
    assert list(zip(got[3].tolist()[-n:], in_sub[-n:])) == [
        DR.EXPECTED[name] for name in names]


# --- group law -----------------------------------------------------------------


def _port_g1(points):
    """Host G1 points (not ∞) → port (X, Y, Z) with Z = 1."""
    aff = [p.to_affine() for p in points]
    w = torch.from_numpy(L.ints_to_words(
        [a[0].n for a in aff] + [a[1].n for a in aff]).copy())
    m = L.from_words(w)
    n = len(points)
    return m[:n], m[n:], L.one_fp((n,))


def _affine_g1(X, Y, Z):
    out = []
    for x, y, z in zip(*(L.words_to_ints(L.to_words(c)) for c in (X, Y, Z))):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, P - 2, P)
        out.append((x * zi * zi % P, y * zi * zi * zi % P))
    return out


def _fq2_ints(t):
    v = L.words_to_ints(L.to_words(t))
    return [(v[2 * i], v[2 * i + 1]) for i in range(len(v) // 2)]


def _affine_g2(X, Y, Z):
    out = []
    for x, y, z in zip(_fq2_ints(X), _fq2_ints(Y), _fq2_ints(Z)):
        zf = Fq2.from_ints(*z)
        if zf.is_zero():
            out.append(None)
            continue
        zi = zf.inv()
        ax = Fq2.from_ints(*x) * zi * zi
        ay = Fq2.from_ints(*y) * zi * zi * zi
        out.append(((ax.c0.n, ax.c1.n), (ay.c0.n, ay.c1.n)))
    return out


def _host_affine(p):
    a = p.to_affine()
    if a is None:
        return None
    if hasattr(a[0], "c0"):
        return ((a[0].c0.n, a[0].c1.n), (a[1].c0.n, a[1].c1.n))
    return (a[0].n, a[1].n)


def test_sum_points_grouped_matches_jax():
    m, k = 2, 4
    base = [G1.mul(rng.randrange(1, R)) for _ in range(3)]
    # group 0: P, Q, P, −P (a doubling and a cancellation); group 1: R, ∞…
    members = [[base[0], base[1], base[0], -base[0]],
               [base[2], None, None, None]]
    live = torch.tensor([[True] * 4, [True, False, False, False]])
    flat = [p if p is not None else base[0] for row in members for p in row]
    X, Y, Z = (c.reshape(m, k, L.NLIMBS) for c in _port_g1(flat))
    Z = L.select(~live, torch.zeros_like(Z), Z)
    X = L.select(~live, L.one_fp((m, k)), X)
    Y = L.select(~live, L.one_fp((m, k)), Y)
    got = _affine_g1(*C.sum_points_grouped((X, Y, Z), C.FP_OPS))
    # JAX: k-major flat batch of M·K Jacobian points
    km = [members[mm][j] for j in range(k) for mm in range(m)]
    devs = [JC.g1_point_to_dev(p if p is not None else base[0]) for p in km]
    inf = np.array([p is None for p in km])
    one = JL.to_mont(1)
    jx = JL.split(jnp.asarray(np.stack([one if i else d[0]
                                        for d, i in zip(devs, inf)])))
    jy = JL.split(jnp.asarray(np.stack([one if i else d[1]
                                        for d, i in zip(devs, inf)])))
    jz = JL.split(jnp.asarray(np.stack([np.zeros_like(one) if i else one
                                        for i in inf])))
    s = jax.jit(lambda p: JC.sum_points_grouped(p, k, JC.FP_OPS))((jx, jy, jz))
    ref = [_host_affine(JC.dev_to_g1_point(JL.merge_np(s[0])[i],
                                           JL.merge_np(s[1])[i],
                                           JL.merge_np(s[2])[i]))
           for i in range(m)]
    assert got == ref
    assert got[1] == _host_affine(base[2])


def _jax_endo(n, group):
    a, b = endo_constants()[group]
    fa = JL.const_fp([int(d) for d in JL.to_mont(a)], (n,))
    fb = JL.const_fp([int(d) for d in JL.to_mont(b)], (n,))
    if group == "g1":
        return fa, fb
    z = JL.zeros_fp((n,))
    return (fa, z), (fb, z)


def _rlc(n):
    r0 = [rng.randrange(1 << 32) for _ in range(n)]
    r1 = [rng.randrange(1 << 32) for _ in range(n)]
    r0[-1], r1[-1] = 0, 5  # a zero low half
    return r0, r1


def test_scalar_mul_jac_glv_g1_matches_jax():
    n = 4
    pts = [G1.mul(rng.randrange(1, R)) for _ in range(n)]
    inf = torch.tensor([False, False, True, False])
    r0, r1 = _rlc(n)
    X, Y, Z = _port_g1(pts)
    Z = L.select(inf, torch.zeros_like(Z), Z)
    got = _affine_g1(*C.scalar_mul_jac_glv(
        (X, Y, Z), inf, torch.tensor(r0), torch.tensor(r1),
        C.g1_endo("cpu"), C.FP_OPS))
    devs = [JC.g1_point_to_dev(p) for p in pts]
    one = JL.to_mont(1)
    q = (JL.split(jnp.asarray(np.stack([d[0] for d in devs]))),
         JL.split(jnp.asarray(np.stack([d[1] for d in devs]))),
         JL.split(jnp.asarray(np.stack(
             [np.zeros_like(one) if i else one for i in inf.tolist()]))))
    lo = jnp.asarray(JC.scalars_to_bits_msb(r0, 32)).T
    hi = jnp.asarray(JC.scalars_to_bits_msb(r1, 32)).T
    s = jax.jit(lambda q, qi, a, b: JC.scalar_mul_jac_glv(
        q, qi, a, b, _jax_endo(n, "g1"), JC.FP_OPS))(
            q, jnp.asarray(inf.numpy()), lo, hi)
    ref = [_host_affine(JC.dev_to_g1_point(JL.merge_np(s[0])[i],
                                           JL.merge_np(s[1])[i],
                                           JL.merge_np(s[2])[i]))
           for i in range(n)]
    assert got == ref
    assert got[0] == _host_affine(pts[0].mul((r0[0] + r1[0] * LAMBDA) % R))
    assert got[2] is None


def test_scalar_mul_glv_g2_matches_jax():
    n = 4
    pts = [G2.mul(rng.randrange(1, R)) for _ in range(n)]
    inf = torch.tensor([False, True, False, False])
    r0, r1 = _rlc(n)
    v = []
    for p in pts:
        (x, y) = p.to_affine()
        v += [x.c0.n, x.c1.n, y.c0.n, y.c1.n]
    m = L.from_words(torch.from_numpy(L.ints_to_words(v).copy()))
    m = m.reshape(n, 2, 2, L.NLIMBS)
    got = _affine_g2(*C.scalar_mul_glv(
        m[:, 0], m[:, 1], inf, torch.tensor(r0), torch.tensor(r1),
        C.g2_endo("cpu"), C.FP2_OPS))
    devs = [JC.g2_point_to_dev(p) for p in pts]
    sx = np.stack([d[0] for d in devs])
    sy = np.stack([d[1] for d in devs])
    lo = jnp.asarray(JC.scalars_to_bits_msb(r0, 32)).T
    hi = jnp.asarray(JC.scalars_to_bits_msb(r1, 32)).T
    s = jax.jit(lambda x, y, qi, a, b: JC.scalar_mul_glv(
        JB._g2_in(x, y)[0], JB._g2_in(x, y)[1], qi, a, b,
        _jax_endo(n, "g2"), JC.FP2_OPS))(
            sx, sy, jnp.asarray(inf.numpy()), lo, hi)
    ref = []
    for i in range(n):
        X, Y, Z = (np.stack([JL.merge_np(c[0])[i], JL.merge_np(c[1])[i]])
                   for c in s)
        ref.append(_host_affine(JC.dev_to_g2_point(X, Y, Z)))
    assert got == ref
    assert got[0] == _host_affine(pts[0].mul((r0[0] + r1[0] * LAMBDA) % R))
    assert got[1] is None


def test_aggregate_rlc_scale_plain_matches_jax():
    """The plain `aggregate_rlc_scale` (its halves' ladders apart, joined
    by a complete addition) against the JAX package's steps on seeded
    inputs: the registry gather (tpu/bls.py:851-854, k-major), the member
    tree sum_points_grouped (tpu/curve.py:361), scalar_mul_jac_glv (G1,
    :645) and scalar_mul_glv (G2, :591) — affine points equal. Aggregates:
    five members, one member, a key and its negation (∞), eight members
    with a masked signature; the last RLC pair has r0 = 0."""
    from grandine_tpu_torch.gpu import bls as TB

    m, k = 4, 8
    keys = [G1.mul(rng.randrange(1, R)) for _ in range(10)]
    keys.append(-keys[0])
    members = [[0, 1, 2, 3, 4], [5], [0, 10], [6, 7, 8, 9, 1, 2, 3, 4]]
    idx = np.zeros((m, k), np.int32)
    for i, mm in enumerate(members):
        idx[i, :len(mm)] = mm
    cnt = np.array([len(mm) for mm in members], np.int32)
    live = np.arange(k)[None, :] < cnt[:, None]
    sigs = [G2.mul(rng.randrange(1, R)) for _ in range(m)]
    mask = np.array([False, False, False, True])
    r0, r1 = _rlc(m)
    # the port
    aff = [p.to_affine() for p in keys]
    sx = L.ints_to_words([a[0].n for a in aff])
    sy = L.ints_to_words([a[1].n for a in aff])
    v = []
    for p in sigs:
        (x, y) = p.to_affine()
        v += [x.c0.n, x.c1.n, y.c0.n, y.c1.n]
    g = L.ints_to_words(v).reshape(m, 2, 2, 12)
    r01 = TB.rlc_pairs_words(list(zip(r0, r1)))
    rpk, agg_inf, rsig = TB.aggregate_rlc_scale_plain(*(
        torch.from_numpy(np.array(a)) for a in
        (sx, sy, idx, cnt, g[:, 0], g[:, 1], mask, r01)))
    got_g1 = _affine_g1(*C.jac_from_words(rpk, 1))
    got_g2 = _affine_g2(*C.jac_from_words(rsig, 2))
    # the JAX package
    devs = [JC.g1_point_to_dev(p) for p in keys]
    reg_x = np.stack([d[0] for d in devs])
    reg_y = np.stack([d[1] for d in devs])
    sdev = [JC.g2_point_to_dev(p) for p in sigs]
    gx = np.stack([d[0] for d in sdev])
    gy = np.stack([d[1] for d in sdev])
    lo = jnp.asarray(JC.scalars_to_bits_msb(r0, 32)).T
    hi = jnp.asarray(JC.scalars_to_bits_msb(r1, 32)).T

    def jax_steps(reg_x, reg_y, idx, mem_inf, gx, gy, sig_inf, lo, hi):
        mem = JB._g1_in(jnp.take(reg_x, JB._flat_km(idx, m, k), axis=0),
                        jnp.take(reg_y, JB._flat_km(idx, m, k), axis=0))
        inf_f = JB._flat_km(mem_inf, m, k)
        one, zero = JC.FP_OPS.one_like(mem[0]), JC.FP_OPS.zeros_like(mem[0])
        mem_jac = (JC.FP_OPS.select(inf_f, one, mem[0]),
                   JC.FP_OPS.select(inf_f, one, mem[1]),
                   JC.FP_OPS.select(inf_f, zero, one))
        apk = JC.sum_points_grouped(mem_jac, k, JC.FP_OPS)
        apk_inf = JL.is_zero_val(apk[2])
        rpk = JC.scalar_mul_jac_glv(apk, apk_inf, lo, hi, _jax_endo(m, "g1"),
                                    JC.FP_OPS)
        sx, sy = JB._g2_in(gx, gy)
        rsig = JC.scalar_mul_glv(sx, sy, sig_inf, lo, hi, _jax_endo(m, "g2"),
                                 JC.FP2_OPS)
        return rpk, apk_inf, rsig

    j_rpk, j_inf, j_rsig = jax.jit(jax_steps)(
        reg_x, reg_y, idx, ~live, gx, gy, jnp.asarray(mask), lo, hi)
    ref_g1 = [_host_affine(JC.dev_to_g1_point(JL.merge_np(j_rpk[0])[i],
                                              JL.merge_np(j_rpk[1])[i],
                                              JL.merge_np(j_rpk[2])[i]))
              for i in range(m)]
    ref_g2 = []
    for i in range(m):
        X, Y, Z = (np.stack([JL.merge_np(c[0])[i], JL.merge_np(c[1])[i]])
                   for c in j_rsig)
        ref_g2.append(_host_affine(JC.dev_to_g2_point(X, Y, Z)))
    assert agg_inf.tolist() == np.asarray(j_inf).tolist() == [
        False, False, True, False]
    assert got_g1 == ref_g1
    assert got_g2 == ref_g2
    lam = [(a + b * LAMBDA) % R for a, b in zip(r0, r1)]
    assert got_g1[1] == _host_affine(keys[5].mul(lam[1]))
    assert got_g2[0] == _host_affine(sigs[0].mul(lam[0]))
    assert got_g1[2] is None and got_g2[3] is None
