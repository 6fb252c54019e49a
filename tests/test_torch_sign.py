"""The port's signing path and aggregate construction on the CPU, against
the JAX package: `sign_scalars_host` against `sign_bits_host` (the same
halves and signs, `batch_pubkey`'s operands), `sign_digits_host`'s
base-|x| digits on seeded and edge keys, `batch_sign_plain` at one, two
and four lanes a signature against the JAX host anchor's points,
`TorchBlsBackend(device="cpu").batch_sign` byte for byte against the JAX
host anchor `SecretKey.sign` on the edge corpus, the aggregate seams
against `Signature.aggregate` / `PublicKey.aggregate`, and — marked
kernel and slow, as the JAX package marks its own — the plain versions
against the JAX programs batch_sign_kernel and g2/g1_aggregate_kernel
jitted on the CPU with the same secrets and points."""

import random

import jax
import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import DST_SIGNATURE, R, X
from grandine_tpu.crypto.curves import LAMBDA
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import curve as JC
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.validator.duties import (
    device_aggregator, host_aggregator)

rng = random.Random(0x51C)
SKS = [0x7E57_0001 + 0x1357 * i for i in range(8)]
ABS_X = -X
#: the digit edges: 1, |x| − 1, |x|, |x|², |x|³, r − 2, r − 1, zero
#: middle digits
DIGIT_EDGES = [1, ABS_X - 1, ABS_X, ABS_X ** 2, ABS_X ** 3, R - 2, R - 1,
               5 + 9 * ABS_X ** 3, 7 + 3 * ABS_X ** 2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scalars_of_words(k):
    """(N, 2, 4) int32 words → [(k0, k1), …] ints."""
    u = np.asarray(k).view(np.uint32).astype(object)
    return [tuple(sum(int(row[h, w]) << (32 * w) for w in range(4))
                  for h in range(2)) for row in u]


def _scalars_of_bits(bits):
    """(N, 256) MSB-first bits → [(k0, k1), …] ints."""
    return [(int("".join(map(str, row[:128])), 2),
             int("".join(map(str, row[128:])), 2)) for row in bits]


def test_sign_scalars_host_matches_jax():
    scalars = ([rng.randrange(1, R) for _ in range(12)]
               + [1, R - 1, R - 2, LAMBDA, LAMBDA - 1, LAMBDA + 1])
    k, neg = B.sign_scalars_host(scalars, pad_to=len(scalars) + 3)
    bits, jneg = JB.sign_bits_host(scalars, len(scalars) + 3)
    assert _scalars_of_words(k) == _scalars_of_bits(bits)
    assert np.array_equal(neg, jneg)
    assert _scalars_of_words(k)[-3:] == [(1, 0)] * 3
    assert neg[:len(scalars)].any(0).all()  # both signs occur
    for s, (a, b), (na, nb) in zip(scalars, _scalars_of_words(k), neg):
        assert ((-a if na else a) + (-b if nb else b) * LAMBDA - s) % R == 0
        assert a < 1 << 128 and b < 1 << 128


def _digits_of_words(d):
    """(N, 4, 2) int32 words → [[d0, d1, d2, d3], …] ints."""
    u = np.asarray(d).view(np.uint32).astype(object)
    return [[int(row[i, 0]) + (int(row[i, 1]) << 32) for i in range(4)]
            for row in u]


def test_sign_digits_host_edges_and_seeded_keys():
    scalars = DIGIT_EDGES + [rng.randrange(1, R) for _ in range(24)]
    d = B.sign_digits_host(scalars, pad_to=len(scalars) + 2)
    assert d.shape == (len(scalars) + 2, 4, 2) and d.dtype == np.int32
    digits = _digits_of_words(d)
    for s, ds in zip(scalars, digits):
        assert sum(v * ABS_X ** i for i, v in enumerate(ds)) == s
        assert all(0 <= v < ABS_X for v in ds)
    assert digits[-2:] == [[1, 0, 0, 0]] * 2  # padding
    assert digits[:5] == [[1, 0, 0, 0], [ABS_X - 1, 0, 0, 0], [0, 1, 0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]]
    assert digits[6] == [0, 0, ABS_X - 1, ABS_X - 1]  # r − 1
    assert digits[7] == [5, 0, 0, 9] and digits[8] == [7, 0, 3, 0]


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_batch_sign_plain_at_each_geometry_matches_jax_anchor(lanes):
    """The plain version at one, two and four lanes a signature: the digit
    edges and a seeded key over three messages, an ∞ message row, equal
    as points to [sk]·H(m) of the JAX package's host crypto."""
    scalars = DIGIT_EDGES + [rng.randrange(1, R)]
    msgs = [b"geometry-%d" % (i % 3) for i in range(len(scalars))]
    be = B.TorchBlsBackend(device="cpu")
    msg = torch.from_numpy(np.stack(
        [be._hash_to_g2_words(m, DST_SIGNATURE)[0] for m in msgs]))
    inf = torch.zeros(len(scalars), dtype=torch.bool)
    inf[4] = True
    got = B.batch_sign_plain(msg, inf, torch.from_numpy(
        B.sign_digits_host(scalars)), lanes)
    want = [JA.g2_to_bytes(JA.hash_to_g2(m, DST_SIGNATURE).mul(k))
            for k, m in zip(scalars, msgs)]
    want[4] = JA.g2_to_bytes(JA.g2_infinity())
    assert _port_affine_g2(got.numpy()) == want


def _corpus():
    return [
        (1, b"scalar-one"),
        (R - 1, b"near-order-minus-1"),
        (R - 2, b"near-order-minus-2"),
        (SKS[0], b""),                      # empty message
        (SKS[1], b"\xab" * 100_000),        # a 100 kB message
        (SKS[2], b"duplicate-key"),
        (SKS[2], b"duplicate-key"),         # a duplicate (sk, msg) pair
        (SKS[2], b"duplicate-key-other"),   # a duplicate key, a new message
    ]


def test_batch_sign_matches_jax_host_anchor():
    corpus = _corpus()
    got = B.TorchBlsBackend(device="cpu").batch_sign(
        [m for _, m in corpus], [PA.SecretKey(k) for k, _ in corpus])
    assert [s.to_bytes() for s in got] == [
        JA.SecretKey(k).sign(m).to_bytes() for k, m in corpus]


def test_batch_sign_chunks_and_empty(monkeypatch):
    monkeypatch.setattr(B, "MAX_BUCKET", 2)
    be = B.TorchBlsBackend(device="cpu")
    assert be.batch_sign([], []) == []
    rows = []
    kernel = B.batch_sign

    def counted(msg, msg_inf, d):
        rows.append(msg.shape[0])
        return kernel(msg, msg_inf, d)

    monkeypatch.setattr(B, "batch_sign", counted)
    keys = [PA.SecretKey(k) for k in SKS[:5]]
    msgs = [bytes([i]) * 32 for i in range(5)]
    got = be.batch_sign(msgs, keys)
    assert rows == [2, 2, 1]
    assert [s.to_bytes() for s in got] == [
        JA.SecretKey(k).sign(m).to_bytes() for k, m in zip(SKS, msgs)]


def _sig(k, m):
    return PA.SecretKey(k).sign(m)


AGG_CASES = {
    "full": [[(SKS[i], b"full") for i in range(8)]],
    "single_and_empty": [[(SKS[0], b"solo")], []],
    "mixed_widths": [[(SKS[i], b"mixed-%d" % i) for i in range(3)],
                     [(SKS[5], b"pair"), (SKS[6], b"pair")],
                     [(SKS[7], b"one")]],
    # MAX_BUCKET = 8 below: groups of width bucket 4 go 2 a chunk
    "past_one_chunk": [[(SKS[i % 8], b"c%d" % g) for i in range(g % 3 + 2)]
                       for g in range(5)],
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_groups_match_jax_anchor(case, monkeypatch):
    if case == "past_one_chunk":
        monkeypatch.setattr(B, "MAX_BUCKET", 8)
    groups = AGG_CASES[case]
    sigs = [[_sig(k, m) for k, m in grp] for grp in groups]
    got = B.g2_aggregate_groups(sigs, device="cpu")
    want = [JA.Signature.aggregate(
        [JA.SecretKey(k).sign(m) for k, m in grp]).to_bytes()
        for grp in groups]
    assert [a.to_bytes() for a in got] == want
    keys = [[PA.SecretKey(k).public_key() for k, _ in grp] for grp in groups]
    got_pk = B.g1_aggregate_groups(keys, device="cpu")
    assert [a.to_bytes() for a in got_pk] == [
        JA.PublicKey.aggregate([JA.SecretKey(k).public_key()
                                for k, _ in grp]).to_bytes()
        for grp in groups]


def test_device_aggregator_on_cpu_equals_host_aggregator():
    groups = [[_sig(SKS[i], b"agg") for i in range(4)], [_sig(SKS[4], b"x")],
              []]
    assert B.g2_aggregate_groups([]) == []
    got = device_aggregator(device="cpu")(groups)
    assert [a.to_bytes() for a in got] == [
        a.to_bytes() for a in host_aggregator(groups)]
    assert device_aggregator(device="cpu")([]) == []


def test_readback_round_trips_points():
    pts = [PA.SecretKey(k).sign(b"rt").point for k in SKS[:3]]
    pts.append(PA.Signature.aggregate([]).point)  # ∞
    rows = B.jacobian_rows(pts, 2)
    back = B.g2_points_from_words(rows)
    assert [PA.g2_to_bytes(p) for p in back] == [PA.g2_to_bytes(p)
                                                 for p in pts]
    g1 = [PA.SecretKey(k).public_key().point for k in SKS[:3]]
    g1.append(PA.PublicKey.aggregate([]).point)
    back1 = B.g1_points_from_words(B.jacobian_rows(g1, 1))
    assert [PA.g1_to_bytes(p) for p in back1] == [PA.g1_to_bytes(p)
                                                  for p in g1]


# --- against the JAX programs themselves -------------------------------------


def _jax_affine_g2(X, Y, Z):
    return [JA.g2_to_bytes(JC.dev_to_g2_point(X[i], Y[i], Z[i]))
            for i in range(X.shape[0])]


def _port_affine_g2(words):
    return [PA.g2_to_bytes(p) for p in B.g2_points_from_words(words)]


@pytest.mark.kernel
@pytest.mark.slow
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_batch_sign_plain_matches_jax_kernel(lanes):
    """batch_sign_kernel jitted on the CPU at N = 4 (an ∞ message row,
    scalars 1, r − 1 and a seeded one) and the port's plain version on the
    same secrets and messages, at each geometry: the same points."""
    msgs = [b"k1", b"k2", b"k3", b"k4"]
    scalars = [1, R - 1, rng.randrange(1, R), R - 2]
    jx = [JC.g2_point_to_dev(JA.hash_to_g2(m, DST_SIGNATURE)) for m in msgs]
    mx = np.stack([d[0] for d in jx])
    my = np.stack([d[1] for d in jx])
    minf = np.array([False, False, True, False])
    bits, neg = JB.sign_bits_host(scalars, 4)
    X, Y, Z = jax.jit(JB.batch_sign_kernel)(mx, my, minf, bits, neg)
    want = _jax_affine_g2(np.asarray(X), np.asarray(Y), np.asarray(Z))
    be = B.TorchBlsBackend(device="cpu")
    msg = torch.from_numpy(np.stack(
        [be._hash_to_g2_words(m, DST_SIGNATURE)[0] for m in msgs]))
    got = B.batch_sign_plain(msg, torch.from_numpy(minf), torch.from_numpy(
        B.sign_digits_host(scalars)), lanes)
    assert _port_affine_g2(got.numpy()) == want


@pytest.mark.kernel
@pytest.mark.slow
def test_aggregate_plain_matches_jax_kernels():
    """g2_aggregate_kernel and g1_aggregate_kernel jitted on the CPU at
    N = 8, G = 2 (a full group of 4, a group of 1 padded with ∞) and the
    port's plain group sums on the same rows."""
    sks = [JA.SecretKey(k) for k in SKS[:5]]
    sigs = [sk.sign(b"agg-%d" % (i // 4)).point for i, sk in enumerate(sks)]
    pks = [sk.public_key().point for sk in sks]
    layout = [0, 1, 2, 3, 4, None, None, None]
    sx, sy, sinf = JC.g2_points_to_dev([sigs[i] if i is not None
                                        else JA.g2_infinity() for i in layout])
    X, Y, Z = jax.jit(JB.g2_aggregate_kernel)(
        sx, sy, np.asarray(sinf) | np.array([i is None for i in layout]),
        np.zeros((2,), np.int32))
    want = _jax_affine_g2(np.asarray(X), np.asarray(Y), np.asarray(Z))
    rows = B.jacobian_rows([PA.g2_from_bytes(JA.g2_to_bytes(sigs[i]), False)
                            if i is not None else PA.Signature.empty().point
                            for i in layout], 2)
    got = B.g2_group_sum_plain(torch.from_numpy(rows), [0, 4, 8])
    assert _port_affine_g2(got.numpy()) == want
    px, py, pinf = JC.g1_points_to_dev([pks[i] if i is not None
                                        else JA.g1_infinity() for i in layout])
    X, Y, Z = jax.jit(JB.g1_aggregate_kernel)(
        px, py, np.asarray(pinf) | np.array([i is None for i in layout]),
        np.zeros((2,), np.int32))
    want1 = [JA.g1_to_bytes(JC.dev_to_g1_point(X[i], Y[i], Z[i]))
             for i in range(2)]
    rows1 = B.jacobian_rows([PA.g1_from_bytes(JA.g1_to_bytes(pks[i]))
                             if i is not None else PA.PublicKey.aggregate(
                                 []).point for i in layout], 1)
    got1 = B.g1_group_sum_plain(torch.from_numpy(rows1), [0, 4, 8])
    assert [PA.g1_to_bytes(p) for p in B.g1_points_from_words(
        got1.numpy())] == want1
    assert L.words_to_ints(got1[1, 2]) != [0]
