"""Differential tests: the port's plain Miller loop, Fp12 product and
final exponentiation (grandine_tpu_torch/gpu/pairing.py) against the JAX
package's (grandine_tpu/tpu/pairing.py) on the same inputs — the same line
scaling and x-chain, so the Fp12 values agree as canonical integers — and
bilinearity through the port alone."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto.constants import P, R
from grandine_tpu.crypto.curves import G1, G2, g1_infinity
from grandine_tpu.tpu import curve as JC
from grandine_tpu.tpu import field as JF
from grandine_tpu.tpu import limbs as JL
from grandine_tpu.tpu import pairing as JP
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import pairing as TP

rng = random.Random(0x9A1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_pairs(ps, qs, zs):
    """JAX limb-list inputs: P Jacobian with Z = zs[i] (∞ → Z = 0), Q
    affine on the twist as homogeneous (x, y, 1)."""
    one = JL.to_mont(1)
    xs, ys, zz = [], [], []
    for p, z in zip(ps, zs):
        x, y, inf = JC.g1_point_to_dev(p)
        if bool(inf):
            xs.append(one), ys.append(one), zz.append(np.zeros_like(one))
            continue
        xv, yv = JL.from_mont(x), JL.from_mont(y)
        xs.append(JL.to_mont(xv * z * z % P))
        ys.append(JL.to_mont(yv * z * z * z % P))
        zz.append(JL.to_mont(z))
    g2d = [JC.g2_point_to_dev(q) for q in qs]
    one2 = np.stack([one, JL.ZERO])
    P_jac = tuple(JL.split(jnp.asarray(np.stack(c))) for c in (xs, ys, zz))
    Q = (JF.fp2_split(jnp.asarray(np.stack([d[0] for d in g2d]))),
         JF.fp2_split(jnp.asarray(np.stack([d[1] for d in g2d]))),
         JF.fp2_split(jnp.asarray(np.stack([one2] * len(qs)))))
    inf = jnp.asarray(np.array([p.is_infinity() for p in ps]))
    return P_jac, Q, inf


def _port_pairs(ps, qs, zs):
    """The same inputs as port words: rpk (n, 3, 12), msg (n, 2, 2, 12)."""
    rv, mv = [], []
    for p, q, z in zip(ps, qs, zs):
        if p.is_infinity():
            rv += [1, 1, 0]
        else:
            x, y = p.to_affine()
            rv += [x.n * z * z % P, y.n * z * z * z % P, z]
        x, y = q.to_affine()
        mv += [x.c0.n, x.c1.n, y.c0.n, y.c1.n]
    n = len(ps)
    rpk = torch.from_numpy(L.ints_to_words(rv).copy()).reshape(n, 3, 12)
    msg = torch.from_numpy(L.ints_to_words(mv).copy()).reshape(n, 2, 2, 12)
    inf = torch.tensor([p.is_infinity() for p in ps])
    return rpk, msg, inf


def _jax_fp12_ints(f):
    arr = JF.fp12_merge_np(f)
    return [JL.from_mont(r) % P for r in arr.reshape(-1, arr.shape[-1])]


@pytest.fixture(scope="module")
def pairs():
    a = rng.randrange(1, 2**32)
    ps = [G1.mul(a), G1, G1.mul(3), g1_infinity()]
    qs = [G2, G2.mul(a), G2.mul(5), G2]
    zs = [rng.randrange(1, P) for _ in ps]
    f = TP.miller_loop_pairs_plain(*_port_pairs(ps, qs, zs))
    return ps, qs, zs, f


def test_miller_loop_matches_jax(pairs):
    ps, qs, zs, f = pairs
    ref = jax.jit(JP.miller_loop)(*_jax_pairs(ps, qs, zs))
    assert L.words_to_ints(f) == _jax_fp12_ints(ref)
    assert F.fp12_is_one(L.from_words(f[3]))  # ∞ pair → 1


def test_product_and_final_exponentiation_match_jax(pairs):
    ps, qs, zs, f = pairs
    fm = L.from_words(f)
    prod = TP.fp12_product(fm)
    jf = JF.fp12_split(jnp.asarray(np.stack([
        np.stack([JL.to_mont(v) for v in L.words_to_ints(f[i])]).reshape(
            2, 3, 2, -1) for i in range(4)])))
    jprod = jax.jit(JP.fp12_product_tree)(jf)
    assert L.words_to_ints(L.to_words(prod)) == _jax_fp12_ints(
        tuple(tuple(tuple(c[:, None] for c in c2) for c2 in c6)
              for c6 in jprod))
    e = TP.final_exponentiation(fm)
    je = jax.jit(JP.final_exponentiation)(jf)
    assert L.words_to_ints(L.to_words(e)) == _jax_fp12_ints(je)


def test_bilinearity_through_the_port(pairs):
    ps, qs, zs, f = pairs
    e = L.words_to_ints(L.to_words(
        TP.final_exponentiation(L.from_words(f[:2]))))
    assert e[:12] == e[12:]  # e(aP, Q) == e(P, aQ)
    # e(aP, Q)·e(−P, aQ) == 1: the pair check the verify kernels end in
    a_f = L.from_words(f[0:1])
    rpk, msg, inf = _port_pairs([-G1], [qs[1]], [1])
    g = L.from_words(TP.miller_loop_pairs_plain(rpk, msg, inf))
    one = F.fp12_is_one(TP.final_exponentiation(F.fp12_mul(a_f, g)))
    assert bool(one.item())
    bad = F.fp12_is_one(TP.final_exponentiation(F.fp12_mul(a_f, a_f)))
    assert not bool(bad.item())
