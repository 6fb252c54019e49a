"""Each CUDA kernel of grandine_tpu_torch against its plain version on the
card, exactly, plus the slice end to end on the card. Needs an NVIDIA GPU
and nvcc: every test takes the `cuda_device` fixture, which skips when no
card is present (decided when the test runs, never at import). Run on a
card with `python -m pytest -m cuda --noconftest tests/test_torch_cuda.py`
(tests/conftest.py imports JAX, which the card machine need not have)."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from grandine_tpu_torch.crypto import bls as A
from grandine_tpu_torch.crypto.constants import DST_SIGNATURE, R
from grandine_tpu_torch.crypto.curves import G1, g2_infinity
from grandine_tpu_torch.crypto.hash_to_curve import (
    hash_to_field_fq2, hash_to_g2, map_to_curve_g2)
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import pairing as TP
from grandine_tpu_torch.gpu.registry import DevicePubkeyRegistry
from grandine_tpu_torch.gpu.schemes import dispatch_bls_compressed
from grandine_tpu_torch.runtime.verify_scheduler import VerifyItem

pytestmark = pytest.mark.cuda

COMMITTEES = [[0, 1, 2], [3], [4, 5, 6, 7], [9, 10], [11, 12, 13], [14]]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world(cuda_device):
    # the RLC draw (rng=) takes the `randbits` of `secrets`
    rng = SimpleNamespace(randbits=random.Random(0xC0DA).getrandbits)
    host = random.Random(0xC0DB)
    sks = [host.randrange(1, R) for _ in range(15)] + [0]
    sks[15] = R - sks[0]
    pkb = tuple(A.g1_to_bytes(G1.mul(k)) for k in sks)
    msgs = [bytes([0x50 + i]) * 32 for i in range(len(COMMITTEES))]
    sigs = [A.g2_to_bytes(hash_to_g2(m, DST_SIGNATURE).mul(
        sum(sks[j] for j in c) % R)) for m, c in zip(msgs, COMMITTEES)]
    reg = DevicePubkeyRegistry(device=cuda_device)
    reg.ensure(pkb)
    return rng, pkb, msgs, sigs, reg


def _equal(got, ref):
    for g, r in zip(got, ref, strict=True):
        assert torch.equal(g.cpu(), r.cpu())


def _sig_rows(sigs, dev):
    extra = [A.g2_to_bytes(map_to_curve_g2(
        hash_to_field_fq2(b"ng-0", b"SGT", 1)[0])),
        bytes([0x80]) + b"\x11" * 95, bytes([0xC0]) + bytes(95)]
    raw = np.frombuffer(b"".join(list(sigs) + extra), np.uint8).reshape(-1, 96)
    return torch.from_numpy(raw.copy()).to(dev)


def test_g1_decompress_matches_plain(world, cuda_device):
    _, pkb, *_ = world
    raw = np.frombuffer(b"".join(pkb) + bytes([0xC0]) + bytes(47)
                        + bytes([0x80]) + b"\xff" * 47, np.uint8)
    rows = torch.from_numpy(raw.reshape(-1, 48).copy()).to(cuda_device)
    before = C.g1_decompress.launches
    _equal(C.g1_decompress(rows), C.g1_decompress_plain(rows))
    assert C.g1_decompress.launches == before + 1


def test_g2_decompress_subgroup_matches_plain(world, cuda_device):
    rows = _sig_rows(world[3], cuda_device)
    out = C.g2_decompress_subgroup(rows)
    _equal(out, C.g2_decompress_subgroup_plain(rows))
    assert out[7].tolist() == [True] * len(COMMITTEES) + [False, True, True]


def _scale_args(world, dev):
    rng, _, _, sigs, reg = world
    rx, ry, _ = reg.arrays()
    dec = C.g2_decompress_subgroup(_sig_rows(sigs, dev)[: len(COMMITTEES)])
    m = len(COMMITTEES)
    idx = np.zeros((m, 4), np.int32)
    cnt = np.array([len(c) for c in COMMITTEES], np.int32)
    for i, c in enumerate(COMMITTEES):
        idx[i, : len(c)] = c
    idx[5, :2], cnt[5] = [0, 15], 2  # [P, −P]: the sum is ∞
    pairs = [B.TorchBlsBackend._rlc_pair(rng) for _ in range(m)]
    r01 = torch.from_numpy(B.rlc_pairs_words(pairs)).to(dev)
    return (rx, ry, torch.from_numpy(idx).to(dev),
            torch.from_numpy(cnt).to(dev), dec[0], dec[1],
            dec[2] | ~dec[3], r01), dec


def test_aggregate_rlc_scale_matches_plain(world, cuda_device):
    args, _ = _scale_args(world, cuda_device)
    got = B.aggregate_rlc_scale(*args)
    _equal(got, B.aggregate_rlc_scale_plain(*args))
    assert got[1].tolist() == [False] * 5 + [True]


def test_miller_and_finish_match_plain(world, cuda_device):
    args, dec = _scale_args(world, cuda_device)
    rpk, agg_inf, rsig = B.aggregate_rlc_scale(*args)
    msg = torch.from_numpy(np.stack([B.g2_affine_words(hash_to_g2(
        m, DST_SIGNATURE))[0] for m in world[2]])).to(cuda_device)
    f = TP.miller_loop_pairs(rpk, msg, agg_inf)
    _equal((f,), (TP.miller_loop_pairs_plain(rpk, msg, agg_inf),))
    fin = (f, rsig, agg_inf, dec[3], dec[7])
    v = B.rlc_finish(*fin)
    _equal((v,), (B.rlc_finish_plain(*fin),))
    assert v.item() == 0  # aggregate 5 sums to ∞
    keep = slice(0, 5)
    fin = (f[keep].contiguous(), rsig[keep].contiguous(),
           agg_inf[keep].contiguous(), dec[3][keep].contiguous(),
           dec[7][keep].contiguous())
    assert B.rlc_finish(*fin).item() == 1


def test_strided_passes_match_plain(world, cuda_device):
    """Aggregates of 130 members and a 130-term finish: wider than the
    kernels' 128-thread blocks, so each thread's strided loop takes a
    second pass before the tree."""
    args, dec = _scale_args(world, cuda_device)
    rx, ry, _, _, sx, sy, mask, r01 = args
    wide = torch.arange(130, dtype=torch.int32, device=cuda_device) % 15
    idx = wide.repeat(2, 1).contiguous()
    cnt = torch.tensor([130, 129], dtype=torch.int32, device=cuda_device)
    scale = (rx, ry, idx, cnt, sx[:2].contiguous(), sy[:2].contiguous(),
             mask[:2].contiguous(), r01[:2].contiguous())
    _equal(B.aggregate_rlc_scale(*scale), B.aggregate_rlc_scale_plain(*scale))
    rpk, agg_inf, rsig = B.aggregate_rlc_scale(*args)
    msg = torch.from_numpy(np.stack([B.g2_affine_words(hash_to_g2(
        m, DST_SIGNATURE))[0] for m in world[2]])).to(cuda_device)
    f = TP.miller_loop_pairs(rpk, msg, agg_inf)
    # the five valid aggregates 26 times over: still a valid RLC batch
    tile = torch.arange(130, device=cuda_device) % 5
    fin = tuple(t[tile].contiguous()
                for t in (f, rsig, agg_inf, dec[3], dec[7]))
    v = B.rlc_finish(*fin)
    _equal((v,), (B.rlc_finish_plain(*fin),))
    assert v.item() == 1


def test_slice_end_to_end_on_the_card(world, cuda_device):
    _, pkb, msgs, sigs, reg = world
    backend = B.TorchBlsBackend(device=cuda_device)
    m = len(COMMITTEES) - 1

    def items(s):
        return [VerifyItem(a, b, member_indices=c, pubkey_columns=pkb)
                for a, b, c in zip(msgs[:m], s[:m], COMMITTEES[:m])]

    assert dispatch_bls_compressed(items(sigs), backend, reg)() is True
    forged = [sigs[1]] + sigs[1:]
    assert dispatch_bls_compressed(items(forged), backend, reg)() is False


def _points_rows(world, dev):
    """Affine words of the world's signatures, an ∞ row and a point of E2
    outside G2, as (sx, sy, inf) on `dev`."""
    pts = [A.Signature.from_bytes(s).point for s in world[3]]
    pts += [g2_infinity(), map_to_curve_g2(
        hash_to_field_fq2(b"ng-1", b"SGT", 1)[0])]
    sx, sy, inf = B.g2_affine_words_many(pts)
    return tuple(torch.from_numpy(a.copy()).to(dev) for a in (sx, sy, inf))


def test_g2_subgroup_check_matches_plain(world, cuda_device):
    sx, sy, inf = _points_rows(world, cuda_device)
    before = C.g2_subgroup_check.launches
    got = C.g2_subgroup_check(sx, sy, inf)
    _equal((got,), (C.g2_subgroup_check_plain(sx, sy, inf),))
    assert C.g2_subgroup_check.launches == before + 1
    assert got.tolist() == [True] * len(COMMITTEES) + [True, False]


@pytest.mark.parametrize("n", [1, 40])
def test_multi_rlc_scale_matches_plain(world, cuda_device, n):
    """Registry rows 0 and 15 (the last), ∞ and non-G2 signature rows; at
    n = 40 two G1 warps and two G2 warps, the second of each ragged."""
    rng, *_, reg = world
    rx, ry, _ = reg.arrays()
    sx, sy, inf = _points_rows(world, cuda_device)
    rows = torch.arange(n, device=cuda_device) % sx.shape[0]
    idx = (torch.arange(n, device=cuda_device) * 7 % 16).to(torch.int32)
    idx[-1] = 15
    pairs = [B.TorchBlsBackend._rlc_pair(rng) for _ in range(n)]
    r01 = torch.from_numpy(B.rlc_pairs_words(pairs)).to(cuda_device)
    args = (rx, ry, idx.contiguous(), sx[rows].contiguous(),
            sy[rows].contiguous(), inf[rows].contiguous(), r01)
    before = B.multi_rlc_scale.launches
    _equal(B.multi_rlc_scale(*args), B.multi_rlc_scale_plain(*args))
    assert B.multi_rlc_scale.launches == before + 1


def test_rlc_finish_wide_product_matches_plain(world, cuda_device):
    """1,100 terms: past 128 × 8, so the strided product takes nine passes
    and the tree folds 128 partial products."""
    args, dec = _scale_args(world, cuda_device)
    rpk, agg_inf, rsig = B.aggregate_rlc_scale(*args)
    msg = torch.from_numpy(np.stack([B.g2_affine_words(hash_to_g2(
        m, DST_SIGNATURE))[0] for m in world[2]])).to(cuda_device)
    f = TP.miller_loop_pairs(rpk, msg, agg_inf)
    tile = torch.arange(1100, device=cuda_device) % 5
    fin = tuple(t[tile].contiguous()
                for t in (f, rsig, agg_inf, dec[3], dec[7]))
    v = B.rlc_finish(*fin)
    _equal((v,), (B.rlc_finish_plain(*fin),))
    assert v.item() == 1
    bad = (fin[0], fin[1], fin[2], fin[3], fin[4].clone())
    bad[4][1099] = False  # one row outside G2
    assert B.rlc_finish(*bad).item() == 0


def test_flat_seams_end_to_end_on_the_card(world, cuda_device):
    from grandine_tpu_torch.consensus.verifier import (
        SignatureInvalid, TorchVerifier)
    from grandine_tpu_torch.gpu.schemes import dispatch_bls_host_decompress

    _, pkb, msgs, sigs, reg = world
    backend = B.TorchBlsBackend(device=cuda_device)
    m = len(COMMITTEES) - 1
    keys = [A.PublicKey.aggregate([A.PublicKey.from_bytes(pkb[j])
                                   for j in c]) for c in COMMITTEES[:m]]
    sig_objs = [A.Signature.from_bytes(s) for s in sigs[:m]]
    v = TorchVerifier(backend)
    for a, b, c in zip(msgs, sigs, COMMITTEES[:m]):
        v.verify_aggregate(a, b, [A.PublicKey.from_bytes(pkb[j]) for j in c])
    v.finish()
    v = TorchVerifier(backend)
    v.verify_singular(msgs[0], sigs[1], keys[0])
    with pytest.raises(SignatureInvalid):
        v.finish()
    assert backend.multi_verify_compressed(msgs[:m], sigs[:m], keys) is True
    outside = A.g2_to_bytes(map_to_curve_g2(
        hash_to_field_fq2(b"ng-0", b"SGT", 1)[0]))
    assert backend.multi_verify_compressed(
        msgs[:m], [outside] + sigs[1:m], keys) is False
    assert backend.multi_verify(msgs[:m], sig_objs, keys) is True
    # committees 1 and 5 have one signer each: registry rows 3 and 14
    assert backend.multi_verify_indexed(
        [msgs[1], msgs[5]], [sig_objs[1], A.Signature.from_bytes(sigs[5])],
        [3, 14], reg) is True
    items = [VerifyItem(a, b, member_indices=c, pubkey_columns=pkb)
             for a, b, c in zip(msgs[:m], sigs[:m], COMMITTEES[:m])]
    assert dispatch_bls_host_decompress(items, backend, reg)() is True
    items[2] = VerifyItem(msgs[2], outside, member_indices=COMMITTEES[2],
                          pubkey_columns=pkb)
    assert dispatch_bls_host_decompress(items, backend, reg)() is False
