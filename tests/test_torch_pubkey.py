"""The port's key-derivation kernel on the CPU, against the JAX package:
`batch_pubkey_plain` over `sign_scalars_host`'s GLV halves, then
`g1_normalize_plain`, compressed, equals the JAX host anchor's
`SecretKey.public_key()` byte for byte on the edge scalars (1, 2, r − 1,
r − 2, λ and its neighbours, seeded ones, both sign masks on each half);
the comb (`batch_pubkey_plain`) against the dual GLV ladder it replaced
(`batch_pubkey_glv_plain`), the same affine points and both the host
anchor's keys; and — marked kernel and slow — the plain version against
the JAX program
batch_pubkey_kernel jitted on the CPU with the same halves. Every
comparison is exact (bytes, canonical ints)."""

import random

import jax
import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import R
from grandine_tpu.crypto.curves import LAMBDA
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import curve as JC
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.crypto.curves import B1, Point
from grandine_tpu_torch.crypto.fields import Fq
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import limbs as L

rng = random.Random(0x9B1C)
SCALARS = ([1, 2, R - 1, R - 2, LAMBDA, LAMBDA - 1, LAMBDA + 1]
           + [rng.randrange(1, R) for _ in range(5)])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _compressed(xy, inf):
    """Affine words (N, 2, 12) with the ∞ mask → 48-byte keys."""
    ints = L.words_to_ints(xy)
    return [PA.g1_to_bytes(PA.PublicKey.aggregate([]).point if flag else
                           Point.from_affine(Fq(ints[2 * i]),
                                             Fq(ints[2 * i + 1]), B1))
            for i, flag in enumerate(inf.tolist())]


def test_batch_pubkey_plain_matches_jax_public_keys():
    k, neg = B.sign_scalars_host(SCALARS)
    assert neg.any(0).all() and (~neg).any(0).all()  # both masks, each half
    words = B.batch_pubkey(torch.from_numpy(k), torch.from_numpy(neg))
    assert words.shape == (len(SCALARS), 3, 12)
    xy, inf = B.g1_normalize_plain(words)
    assert not inf.any()
    assert _compressed(xy, inf) == [JA.SecretKey(s).public_key().to_bytes()
                                    for s in SCALARS]


def test_comb_equals_the_glv_ladder_and_the_anchor():
    k, neg = (torch.from_numpy(a) for a in B.sign_scalars_host(SCALARS))
    comb = B.g1_normalize_plain(B.batch_pubkey_plain(k, neg))
    ladder = B.g1_normalize_plain(B.batch_pubkey_glv_plain(k, neg))
    assert torch.equal(comb[0], ladder[0])
    assert not comb[1].any() and not ladder[1].any()
    want = [JA.SecretKey(s).public_key().to_bytes() for s in SCALARS]
    assert _compressed(*comb) == _compressed(*ladder) == want
    assert [PA.SecretKey(s).public_key().to_bytes() for s in SCALARS] == want


def test_batch_pubkey_rejects_wrong_operands():
    k, neg = B.sign_scalars_host([5])
    with pytest.raises(ValueError, match="batch_pubkey"):
        B.batch_pubkey(torch.from_numpy(k).to(torch.int64),
                       torch.from_numpy(neg))
    with pytest.raises(ValueError, match="batch_pubkey"):
        B.batch_pubkey(torch.from_numpy(k), torch.from_numpy(neg)[:, :1])


# --- against the JAX program itself ------------------------------------------


@pytest.mark.kernel
@pytest.mark.slow
def test_batch_pubkey_plain_matches_jax_kernel():
    """batch_pubkey_kernel jitted on the CPU at N = 4 (scalars 1, r − 1,
    r − 2 and a seeded one, sign_bits_host's halves) and the port's plain
    version on the same halves (sign_scalars_host): the same points."""
    scalars = [1, R - 1, R - 2, SCALARS[-1]]
    bits, jneg = JB.sign_bits_host(scalars, 4)
    X, Y, Z = jax.jit(JB.batch_pubkey_kernel)(bits, jneg)
    want = [JA.g1_to_bytes(JC.dev_to_g1_point(np.asarray(X)[i],
                                               np.asarray(Y)[i],
                                               np.asarray(Z)[i]))
            for i in range(4)]
    k, neg = B.sign_scalars_host(scalars)
    got = B.batch_pubkey_plain(torch.from_numpy(k), torch.from_numpy(neg))
    assert [PA.g1_to_bytes(p) for p in B.g1_points_from_words(
        got.numpy())] == want
