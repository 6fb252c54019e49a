"""Differential tests: the port's plain Fp/Fp2/Fp12 arithmetic
(grandine_tpu_torch/gpu/{limbs,field}.py) against the JAX package's
(grandine_tpu/tpu/{limbs,field}.py) on the same seeded inputs, compared as
canonical integers — exact, no tolerance."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto.constants import P
from grandine_tpu.tpu import field as JF
from grandine_tpu.tpu import limbs as JL
from grandine_tpu_torch.gpu import field as F
from grandine_tpu_torch.gpu import limbs as L

N = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ints(seed, n, k=1):
    r = np.random.default_rng(seed)
    vals = [int.from_bytes(r.bytes(48), "little") % P for _ in range(n * k)]
    vals[-1] = P - 1
    return vals


def port(vals, shape):
    """ints → port Montgomery limbs of shape `shape` + (24,)."""
    w = torch.from_numpy(L.ints_to_words(vals).copy())
    return L.from_words(w).reshape(*shape, L.NLIMBS)


def port_ints(t):
    return L.words_to_ints(L.to_words(t))


def jax_fp(vals):
    return JL.split(jnp.asarray(np.stack([JL.to_mont(v) for v in vals])))


def jax_ints(fp):
    return [JL.from_mont(r) % P for r in JL.merge_np(fp)]


def test_fp_ops_match_jax():
    xs, ys = _ints(1, N), _ints(2, N)
    X, Y = port(xs, (N,)), port(ys, (N,))
    JX, JY = jax_fp(xs), jax_fp(ys)
    assert port_ints(L.montmul(X, Y)) == jax_ints(jax.jit(JL.montmul)(JX, JY))
    assert port_ints(L.montsq(X)) == jax_ints(JL.montsq(JX))
    assert port_ints(L.add_mod(X, Y)) == jax_ints(JL.add_mod(JX, JY))
    assert port_ints(L.sub_mod(X, Y)) == jax_ints(JL.sub_mod(JX, JY))
    assert port_ints(L.neg_mod(X)) == jax_ints(JL.neg_mod(JX))
    e = 0xD201000000010000
    assert port_ints(L.pow_fixed(X, e)) == jax_ints(
        jax.jit(lambda a: JL.pow_fixed(a, e))(JX))


def test_fp_inverse_matches_jax():
    xs = _ints(3, N)
    xs[0] = 0  # inv(0) = 0 on both sides
    assert port_ints(L.inv_mod(port(xs, (N,)))) == jax_ints(
        jax.jit(JL.inv_mod)(jax_fp(xs)))


def _jax_fp2(vals):
    return (jax_fp(vals[0::2]), jax_fp(vals[1::2]))


def _jax_fp2_ints(a):
    c0, c1 = jax_ints(a[0]), jax_ints(a[1])
    return [v for pair in zip(c0, c1) for v in pair]


def test_fp2_ops_match_jax():
    a, b = _ints(4, N, 2), _ints(5, N, 2)
    A, B = port(a, (N, 2)), port(b, (N, 2))
    JA, JB = _jax_fp2(a), _jax_fp2(b)
    assert port_ints(F.fp2_mul(A, B)) == _jax_fp2_ints(JF.fp2_mul(JA, JB))
    assert port_ints(F.fp2_sq(A)) == _jax_fp2_ints(JF.fp2_sq(JA))
    assert port_ints(F.fp2_inv(A)) == _jax_fp2_ints(jax.jit(JF.fp2_inv)(JA))
    assert port_ints(F.fp2_mul_by_xi(A)) == _jax_fp2_ints(JF.fp2_mul_by_xi(JA))


def _jax_fp12(vals, n):
    arr = np.stack([JL.to_mont(v) for v in vals]).reshape(n, 2, 3, 2, -1)
    return JF.fp12_split(jnp.asarray(arr))


def _jax_fp12_ints(a):
    arr = np.stack([np.stack([np.stack([np.stack(
        [JL.merge_np(c) for c in c2], -2) for c2 in c6], -3) for c6 in a],
        -4)])[0]
    return [JL.from_mont(r) % P for r in arr.reshape(-1, arr.shape[-1])]


def test_fp12_ops_match_jax():
    n = N
    a, b = _ints(6, n, 12), _ints(7, n, 12)
    A, B = port(a, (n, 2, 3, 2)), port(b, (n, 2, 3, 2))
    JA, JB = _jax_fp12(a, n), _jax_fp12(b, n)
    assert port_ints(F.fp12_mul(A, B)) == _jax_fp12_ints(
        jax.jit(JF.fp12_mul)(JA, JB))
    assert port_ints(F.fp12_sq(A)) == _jax_fp12_ints(jax.jit(JF.fp12_sq)(JA))
    assert port_ints(F.fp12_frobenius(A)) == _jax_fp12_ints(
        jax.jit(JF.fp12_frobenius)(JA))
    assert port_ints(F.fp12_conj(A)) == _jax_fp12_ints(JF.fp12_conj(JA))
    assert port_ints(F.fp12_inv(A)) == _jax_fp12_ints(
        jax.jit(JF.fp12_inv)(JA))


def _residues_and_not(seed, n):
    vals = _ints(seed, n)
    vals[0] = 0
    vals[1] = 4
    return vals


def test_fq_sqrt_matches_jax():
    xs = _residues_and_not(8, N)
    s, ok = F.fq_sqrt(port(xs, (N,)))
    js, jok = jax.jit(JF.fq_sqrt)(jax_fp(xs))
    assert port_ints(s) == jax_ints(js)
    assert ok.tolist() == np.asarray(jok).tolist()
    assert ok.tolist() == [pow(x, (P - 1) // 2, P) in (0, 1) for x in xs]
    assert 0 < sum(ok.tolist()) < N  # both residues and non-residues


def test_fq2_sqrt_matches_jax():
    vals = _ints(9, N, 2)
    vals[0:2] = [0, 0]          # zero
    vals[2:4] = [9, 0]          # b = 0, a a residue
    vals[4:6] = [P - 9, 0]      # b = 0, −a a residue
    s, ok = F.fq2_sqrt(port(vals, (N, 2)))
    js, jok = jax.jit(JF.fq2_sqrt)(_jax_fp2(vals))
    assert ok.tolist() == np.asarray(jok).tolist()
    got, ref = port_ints(s), _jax_fp2_ints(js)
    for i in range(N):
        if ok[i]:
            assert got[2 * i : 2 * i + 2] == ref[2 * i : 2 * i + 2], i
    assert 0 < sum(ok.tolist()) < N
