"""The port's slice as a whole on the CPU: coalesced `VerifyItem`s through
`gpu.schemes.dispatch_bls_compressed` with the port's registry and
backend (plain versions of every kernel), each verdict held against the
JAX package's host anchor (grandine_tpu.crypto.bls
Signature.fast_aggregate_verify); the registry carried across from a JAX
DevicePubkeyRegistry; and, in the slow tier, verdict parity with the JAX
device backend under the same seeded RLC draws."""

import functools
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import DST_SIGNATURE, P, R
from grandine_tpu.crypto.curves import G1
from grandine_tpu.crypto.hash_to_curve import (
    hash_to_field_fq2, hash_to_g2, map_to_curve_g2)
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu.bls import TorchBlsBackend
from grandine_tpu_torch.gpu.registry import (
    DevicePubkeyRegistry, registry_from_jax_arrays)
from grandine_tpu_torch.gpu.schemes import dispatch_bls_compressed
from grandine_tpu_torch.runtime.verify_scheduler import VerifyItem

N_KEYS = 16
#: M = 4 aggregates of K ≤ 4 members; key 15 is −key 0 (sk₁₅ = r − sk₀)
COMMITTEES = [[0, 1, 2], [3], [4, 5, 6, 7], [9, 10]]


def _bits(seed):
    """random.Random behind the `randbits` of `secrets`, which both
    backends' RLC draws take (rng=)."""
    return SimpleNamespace(randbits=random.Random(seed).getrandbits)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world():
    rng = random.Random(0xB15)
    sks = [rng.randrange(1, R) for _ in range(N_KEYS - 1)]
    sks.append(R - sks[0])
    pkb = tuple(JA.g1_to_bytes(G1.mul(k)) for k in sks)
    msgs = [bytes([0x40 + i]) * 32 for i in range(len(COMMITTEES))]
    sigs = [
        JA.g2_to_bytes(hash_to_g2(m, DST_SIGNATURE).mul(
            sum(sks[j] for j in c) % R))
        for m, c in zip(msgs, COMMITTEES)
    ]
    reg = DevicePubkeyRegistry(device="cpu")
    assert reg.ensure(pkb) and reg.count == N_KEYS and reg.capacity == 16
    return sks, pkb, msgs, sigs, reg, TorchBlsBackend(device="cpu")


def _items(world, msgs=None, sigs=None, committees=None):
    _, pkb, m0, s0, _, _ = world
    return [VerifyItem(m, s, member_indices=c, pubkey_columns=pkb)
            for m, s, c in zip(msgs or m0, sigs or s0,
                               committees or COMMITTEES)]


@functools.lru_cache(maxsize=None)
def _anchor_item(msg, sig, members, pkb):
    try:
        s = JA.Signature.from_bytes(sig)
        keys = [JA.PublicKey.from_bytes(pkb[i]) for i in members]
    except (JA.BlsError, IndexError):
        return False
    return s.fast_aggregate_verify(msg, keys)


def _anchor(items):
    return all(_anchor_item(it.message, it.signature, it.member_indices,
                            it.pubkey_columns) for it in items)


def _verdict(world, items):
    _, _, _, _, reg, backend = world
    return dispatch_bls_compressed(items, backend, reg)()


def _with(seq, i, value):
    out = list(seq)
    out[i] = value
    return out


def _x_row(x1: int, flags=0x80) -> bytes:
    row = bytearray(x1.to_bytes(48, "big") + bytes(48))
    row[0] |= flags
    return bytes(row)


def _case(world, name):
    sks, pkb, msgs, sigs, _, _ = world
    if name == "forged_signature":
        return _items(world, sigs=_with(sigs, 1, sigs[0]))
    if name == "wrong_message":
        return _items(world, msgs=_with(msgs, 2, b"\x99" * 32))
    if name == "non_canonical_x":
        return _items(world, sigs=_with(sigs, 0, _x_row(P + 2)))
    if name == "off_curve_x":
        c1 = 1
        while True:  # x = c1·u with no curve point over it
            from grandine_tpu.crypto.fields import Fq2
            xx = Fq2.from_ints(0, c1)
            if (xx * xx * xx + Fq2.from_ints(4, 4)).sqrt() is None:
                break
            c1 += 1
        return _items(world, sigs=_with(sigs, 3, _x_row(c1)))
    if name == "outside_g2":
        pt = map_to_curve_g2(hash_to_field_fq2(b"ng-0", b"SGT", 1)[0])
        return _items(world, sigs=_with(sigs, 1, JA.g2_to_bytes(pt)))
    if name == "identity_committee":
        return _items(world, committees=_with(COMMITTEES, 1, [0, 15]))
    if name == "index_out_of_range":
        return _items(world, committees=_with(COMMITTEES, 0, [0, N_KEYS]))
    if name == "empty_member_list":
        return _items(world, committees=_with(COMMITTEES, 3, []))
    if name == "short_signature":
        return _items(world, sigs=_with(sigs, 2, sigs[2][:95]))
    if name == "infinity_flag":
        return _items(world, sigs=_with(sigs, 0, bytes([0xC0]) + bytes(95)))
    raise KeyError(name)


def test_valid_batch_verifies(world):
    items = _items(world)
    assert _anchor(items) is True
    assert _verdict(world, items) is True


@pytest.mark.parametrize("name", [
    "forged_signature", "wrong_message", "non_canonical_x", "off_curve_x",
    "outside_g2", "identity_committee", "index_out_of_range",
    "empty_member_list", "short_signature", "infinity_flag",
])
def test_bad_batch_fails(world, name):
    items = _case(world, name)
    assert _anchor(items) is False
    assert _verdict(world, items) is False


def test_identity_committee_with_infinity_signature_fails_on_device(world):
    """[P, −P] sums to ∞ and signs as ∞: the pairing product alone would
    pass; the device's rule (a real aggregate whose key sum is ∞ fails)
    catches it, as in the JAX kernels."""
    sks, pkb, msgs, sigs, reg, backend = world
    inf_sig = bytes([0xC0]) + bytes(95)
    assert backend.fast_aggregate_verify_batch_indexed_compressed(
        [msgs[0]], [inf_sig], [[0, 15]], reg) is False
    assert _anchor_item(msgs[0], inf_sig, (0, 15), pkb) is False


def test_seam_edge_semantics(world):
    _, _, msgs, sigs, reg, backend = world
    seam = backend.fast_aggregate_verify_batch_indexed_compressed
    assert seam([], [], [], reg) is True
    assert seam(msgs[:2], sigs[:1], COMMITTEES[:2], reg) is False


def test_mixed_indexed_and_keyed_items_verify(world):
    """Items with materialized keys take the keyed seam (member coords
    uploaded as the gather source), the rest the indexed seam; both
    settle into one verdict."""
    from grandine_tpu_torch.crypto import bls as PA

    sks, pkb, msgs, sigs, reg, backend = world
    items = _items(world)
    for i in (1, 3):
        keys = [PA.PublicKey.from_bytes(pkb[j]) for j in COMMITTEES[i]]
        items[i] = VerifyItem(msgs[i], sigs[i], public_keys=keys)
    assert _verdict(world, items) is True
    items[3] = VerifyItem(msgs[3], sigs[0], public_keys=items[3].public_keys)
    assert _verdict(world, items) is False


def test_registry_carried_across_from_jax(world):
    from grandine_tpu.tpu.registry import DevicePubkeyRegistry as JaxRegistry

    sks, pkb, msgs, sigs, port_reg, backend = world
    jreg = JaxRegistry()
    assert jreg.ensure(pkb)
    jx, jy, n = jreg.arrays()
    carried = registry_from_jax_arrays(np.asarray(jx), np.asarray(jy), n,
                                       jreg._hraw, device="cpu")
    assert carried.count == N_KEYS and carried.capacity == jreg.capacity
    cx, cy, _ = carried.arrays()
    px, py, _ = port_reg.arrays()
    assert torch.equal(cx, px) and torch.equal(cy, py)
    aff = [G1.mul(k).to_affine() for k in sks]
    assert L.words_to_ints(cx[:N_KEYS]) == [a[0].n for a in aff]
    assert L.words_to_ints(cy[:N_KEYS]) == [a[1].n for a in aff]
    # the same keys under the state's tuple: adopted without an upload,
    # then an identity hit
    assert carried.ensure(pkb) and carried.ensure(pkb)
    assert carried.stats["hits"] == 1
    assert carried.stats["uploaded_bytes"] == 0
    items = _items(world)
    assert dispatch_bls_compressed(items, backend, carried)() is True
    bad = _items(world, sigs=_with(sigs, 1, sigs[0]))
    assert dispatch_bls_compressed(bad, backend, carried)() is _anchor(bad)


@pytest.mark.kernel
@pytest.mark.slow
def test_verdicts_match_jax_device_backend(world):
    from grandine_tpu.tpu.bls import TpuBlsBackend
    from grandine_tpu.tpu.registry import DevicePubkeyRegistry as JaxRegistry

    sks, pkb, msgs, sigs, reg, backend = world
    jreg = JaxRegistry()
    jreg.ensure(pkb)
    jb = TpuBlsBackend()
    for s in (sigs, _with(sigs, 1, sigs[0])):
        want = jb.fast_aggregate_verify_batch_indexed_compressed(
            msgs, s, COMMITTEES, jreg, rng=_bits(5))
        got = backend.fast_aggregate_verify_batch_indexed_compressed(
            msgs, s, COMMITTEES, reg, rng=_bits(5))
        assert got == want


def test_registry_lifecycle(world):
    sks, pkb, *_ = world
    reg = DevicePubkeyRegistry(device="cpu")
    assert reg.ensure(pkb[:10]) and reg.capacity == 16
    assert reg.ensure(pkb)  # prefix growth: an in-place append
    assert reg.stats["refreshes"] == 1 and reg.stats["appends"] == 1
    x, y, n = reg.arrays()
    aff = G1.mul(sks[12]).to_affine()
    assert n == N_KEYS and L.words_to_ints(x[12]) == [aff[0].n]
    assert L.words_to_ints(y[12]) == [aff[1].n]
    uploaded = reg.stats["uploaded_bytes"]
    reg.mark_stale()
    assert reg.ensure(pkb) and reg.stats["uploaded_bytes"] == uploaded
    reg.invalidate()
    assert reg.count == 0 and reg.arrays()[0] is None
    from grandine_tpu_torch.crypto.bls import BlsError

    with pytest.raises(BlsError):  # the identity never enters
        reg.ensure(pkb[:3] + (bytes([0xC0]) + bytes(47),))


def test_rlc_bits_layout_matches_jax():
    from grandine_tpu.tpu.bls import rlc_bits_host as jax_bits
    from grandine_tpu_torch.gpu.bls import rlc_bits_host, rlc_pairs_words

    pairs = [(1, 0), (0xFFFFFFFF, 7), (5, 0x80000000)]
    assert (rlc_bits_host(pairs) == np.asarray(jax_bits(pairs, 4))[:3]).all()
    words = rlc_pairs_words(pairs).view(np.uint32)
    assert [tuple(map(int, w)) for w in words] == pairs
