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
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm as M
from grandine_tpu_torch.gpu import pairing as TP
from grandine_tpu_torch.gpu.registry import DevicePubkeyRegistry
from grandine_tpu_torch.gpu.schemes import dispatch_bls_compressed
from grandine_tpu_torch.runtime.verify_scheduler import VerifyItem
from grandine_tpu_torch.testing import decompress_rows as DR
from grandine_tpu_torch.testing import group_rows as GR
from grandine_tpu_torch.testing.pairing_rows import (
    AGGREGATE_EDGES, aggregate_rows, miller_rows)

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
    """The slot's signatures, three bad rows and the edge corpus of
    testing/decompress_rows.py (c1 = 0 rows, x ≥ p, flags, ∞ forms, the
    all-zero row), one launch, equal to the plain version."""
    edges, names = DR.edge_rows()
    rows = torch.cat([_sig_rows(world[3], cuda_device),
                      torch.from_numpy(edges).to(cuda_device)])
    before = C.g2_decompress_subgroup.launches
    out = C.g2_decompress_subgroup(rows)
    assert C.g2_decompress_subgroup.launches == before + 1
    _equal(out, C.g2_decompress_subgroup_plain(rows))
    n = len(COMMITTEES) + 3
    assert out[7].tolist()[:n] == [True] * len(COMMITTEES) + [False, True,
                                                              True]
    assert list(zip(out[3].tolist()[n:], out[7].tolist()[n:])) == [
        DR.EXPECTED[name] for name in names]


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


@pytest.mark.parametrize("n", [1, 31, 33, 130, 1048])
def test_miller_loop_pairs_matches_plain_on_edge_rows(cuda_device, n):
    """One warp a pair at 1–4 warps a block (`miller_warps`): P with
    Z = 1 and Z ≠ 1, −g1, Q the generator and hashed messages, pair_inf
    rows; partial blocks at 1, 31, 33, 130; 1,048 pairs past one pair an
    SM."""
    rpk, msg, inf, tile = miller_rows(n, n)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a[tile])).to(
        cuda_device) for a in (rpk, msg, inf))
    before = TP.miller_loop_pairs.launches
    got = TP.miller_loop_pairs(*args)
    assert TP.miller_loop_pairs.launches == before + 1
    _equal((got,), (TP.miller_loop_pairs_plain(*args),))


@pytest.mark.parametrize("seeded", [False, True])
def test_aggregate_rlc_scale_matches_plain_on_edge_rows(cuda_device, seeded):
    """r0 = 0, r1 = 0, r = 1, halves 0xFFFFFFFF, an aggregate summing to
    ∞, the same key twice, one member, 130 members, masked signatures; or
    64 seeded aggregates of 1–130 members."""
    g = random.Random(0xA66)
    cases = [(sorted(g.sample(range(141), g.randint(1, 130))),
              (g.getrandbits(32), g.getrandbits(32)), i % 5 == 4)
             for i in range(64)] if seeded else AGGREGATE_EDGES
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in aggregate_rows(cases, 7))
    got = B.aggregate_rlc_scale(*args)
    _equal(got, B.aggregate_rlc_scale_plain(*args))
    if not seeded:
        assert got[1].tolist() == [i in (4, 8) for i in range(len(cases))]


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


def _valid_terms(world, dev):
    """f, rsig and flags of the world's 5 valid aggregates and the 6th,
    whose members sum to ∞, as the gossip path gives them to rlc_finish."""
    args, dec = _scale_args(world, dev)
    rpk, agg_inf, rsig = B.aggregate_rlc_scale(*args)
    msg = torch.from_numpy(np.stack([B.g2_affine_words(hash_to_g2(
        m, DST_SIGNATURE))[0] for m in world[2]])).to(dev)
    f = TP.miller_loop_pairs(rpk, msg, agg_inf)
    return rpk, (f, rsig, agg_inf, dec[3], dec[7])


def test_rlc_finish_groups_match_plain(world, cuda_device):
    """The group-indexed finish: one warp a group (span 1, dead groups
    between, the ∞ aggregate's group False; then spans of 2 and 4), 3-warp
    blocks (a fold that is not a power of two), 128-thread blocks taking
    several terms a thread, and a call whose groups are all dead (no
    launch); one block a live group."""
    _, fin = _valid_terms(world, cuda_device)
    before = B.rlc_finish.launches
    for off, want, live in (([0, 1, 1, 2, 3, 3, 4, 5, 6],
                             [1, 1, 1, 1, 1, 1, 1, 0], 6),
                            ([0, 4, 4, 6], [1, 1, 0], 2)):
        v = B.rlc_finish(*fin, off, off)
        _equal((v,), (B.rlc_finish_plain(*fin, off, off),))
        assert v.tolist() == want
        geo = B.rlc_finish_geometry(*fin[:2], off, off)
        assert geo[:2] == (live, 32) and geo[2] > 0 and geo[3] >= 1
    for width, threads in ((96, 96), (260, 128)):
        tile = torch.arange(2 * width, device=cuda_device) % 5
        wide = tuple(t[tile].contiguous() for t in fin)
        off = [0, width, width, 2 * width]
        v = B.rlc_finish(*wide, off, off)
        _equal((v,), (B.rlc_finish_plain(*wide, off, off),))
        assert v.tolist() == [1, 1, 1]
        geo = B.rlc_finish_geometry(*wide[:2], off, off)
        assert geo[:2] == (2, threads) and geo[2] > 0 and geo[3] >= 1
    assert B.rlc_finish.launches == before + 4
    dead = B.rlc_finish(*fin, [0, 0, 0], [0, 0, 0])
    assert dead.tolist() == [1, 1] and B.rlc_finish.launches == before + 4
    assert B.rlc_finish_geometry(*fin[:2], [0, 0, 0], [0, 0, 0]) == (0,) * 4


def test_g1_group_sum_matches_plain(world, cuda_device):
    """Offsets with empty groups, a group past 128 rows and a group of
    one row."""
    rpk, _ = _valid_terms(world, cuda_device)
    rows = rpk[torch.arange(300, device=cuda_device) % 6].contiguous()
    off = [0, 0, 150, 151, 151, 300]
    before = B.g1_group_sum.launches
    got = B.g1_group_sum(rows, off)
    _equal((got,), (B.g1_group_sum_plain(rows, off),))
    assert B.g1_group_sum.launches == before + 1
    assert got[0].tolist() == got[3].tolist()  # ∞ (1, 1, 0) words


@pytest.fixture(scope="module")
def signer_sets():
    """8 single-signer sets over 2 messages."""
    host = random.Random(0xC0DC)
    sks = [host.randrange(1, R) for _ in range(8)]
    msgs = [bytes([0x70 + i % 2]) * 32 for i in range(8)]
    sigs = [A.Signature(hash_to_g2(m, DST_SIGNATURE).mul(k))
            for m, k in zip(msgs, sks)]
    return msgs, sigs, [A.PublicKey(G1.mul(k)) for k in sks]


def test_grouped_and_partition_on_the_card(signer_sets, cuda_device):
    """The grouped route verifies and rejects on the card; a partition
    pass gives the plain route's group verdicts under the same draws; a
    failed batch localizes to the forged set."""
    from grandine_tpu_torch.runtime.isolation import FaultLocalizer

    msgs, sigs, pks = signer_sets
    be = B.TorchBlsBackend(device=cuda_device)
    wrappers = (M.msm_lane_scan, M.msm_bucket_reduce, M.msm_horner,
                B.g1_group_sum, B.multi_rlc_scale)
    before = [fn.launches for fn in wrappers]
    assert be.multi_verify(msgs, sigs, pks) is True
    swapped = [sigs[1], sigs[0]] + sigs[2:]
    assert be.multi_verify(msgs, swapped, pks) is False
    # the bucket MSM once a plane and verify, no ladder and no group sum
    assert [fn.launches - b for fn, b in zip(wrappers, before)] == [
        4, 4, 4, 0, 0]
    keys = [[k] for k in pks]
    keys[6] = []
    for groups in (4, 8):
        got = be.rlc_partition_verify(
            msgs, swapped, keys, groups,
            rng=SimpleNamespace(randbits=random.Random(3).getrandbits))
        want = B.TorchBlsBackend(device="cpu").rlc_partition_verify(
            msgs, swapped, keys, groups,
            rng=SimpleNamespace(randbits=random.Random(3).getrandbits))
        assert got.tolist() == want.tolist()
    items = [VerifyItem(m, s.to_bytes(), public_keys=[k])
             for m, s, k in zip(msgs, swapped, pks)]
    loc = FaultLocalizer()
    assert loc.localize(be, items) == [False, False] + [True] * 6
    assert loc.passes["host"] == 0


@pytest.mark.parametrize("spans", [[192], [9, 0], [0, 1, 8, 9], [0, 0],
                                   [17, 16],
                                   [(0, 1, 8, 9)[i % 4] for i in range(63)]
                                   + [192]])
def test_rlc_partial_matches_plain(world, cuda_device, spans):
    """1, 2, 4 and 64 groups of spans 0, 1, 8, 9, 16, 17 and 192 (one
    pass up to a tile's PARTIAL_WARPS · GROUP_CHUNK terms, two past it),
    the ∞ aggregate's terms among them and one signature row outside G2;
    a call whose groups are all empty writes Fp12 one."""
    _, fin = _valid_terms(world, cuda_device)
    f, _, agg_inf, ok, sub = fin
    total = sum(spans)
    tile = torch.arange(total, device=cuda_device) % 6
    args = [t[tile].contiguous() for t in (f, agg_inf, ok, sub)]
    if total > 3:
        args[3][3] = False
    off = np.concatenate([[0], np.cumsum(spans)])
    before = B.rlc_partial.launches
    got = B.rlc_partial(*args, off, off)
    _equal(got, B.rlc_partial_plain(*args, off, off))
    assert B.rlc_partial.launches == before + 1
    assert got[0].shape == (len(spans), 2, 3, 2, 12)


@pytest.fixture(scope="module")
def flat_sets():
    """13 single-signer sets over distinct messages (bucket 16)."""
    host = random.Random(0xC0DD)
    sks = [host.randrange(1, R) for _ in range(13)]
    msgs = [bytes([0x90 + i]) * 32 for i in range(13)]
    sigs = [A.Signature(hash_to_g2(m, DST_SIGNATURE).mul(k))
            for m, k in zip(msgs, sks)]
    return msgs, sigs, [A.PublicKey(G1.mul(k)) for k in sks]


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_routes_on_the_card(flat_sets, signer_sets, cuda_device, d):
    """The flat (13 sets: shard 3 of 4 holds one real row) and grouped (8
    sets over 2 messages) routes over D virtual shards of the card give
    the single-device route's verdicts, valid, forged and swapped, with
    one rlc_partial launch a shard, each equal to its plain version."""
    from grandine_tpu_torch.gpu.mesh import VerifyMesh

    mesh = VerifyMesh([cuda_device] * d)
    single = B.TorchBlsBackend(device=cuda_device)
    sharded = B.TorchBlsBackend(mesh=mesh)
    partial = B.rlc_partial

    class Recording:  # the wrapper counts through its module global
        calls = []
        launches = property(lambda self: partial.launches,
                            lambda self, n: setattr(partial, "launches", n))

        def __call__(self, *a):
            out = partial(*a)
            self.calls.append((a, out))
            return out

    for msgs, sigs, pks in (flat_sets, signer_sets):
        forged = list(sigs)
        forged[1] = sigs[2]
        swapped = [sigs[3], sigs[0], sigs[2], sigs[1]] + list(sigs[4:])
        for variant in (sigs, forged, swapped):
            want = single.multi_verify(msgs, variant, pks)
            B.rlc_partial = Recording()
            try:
                before = partial.launches
                got = sharded.multi_verify(msgs, variant, pks)
            finally:
                B.rlc_partial = partial
            assert got is want is (variant is sigs)
            assert partial.launches == before + d
    for a, out in Recording.calls:
        _equal(out, B.rlc_partial_plain(*a))


# --- the signing path ----------------------------------------------------------


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_batch_sign_matches_plain(cuda_device, lanes):
    """Edge rows at one, two and four lanes a signature: ∞ message rows,
    keys 1, |x| − 1, |x|³, r − 1, r − 2, zero digits and seeded ones, 40
    rows (two to five one-warp blocks)."""
    from grandine_tpu_torch.crypto.constants import X

    host = random.Random(0xC0DD)
    scalars = [1, -X - 1, (-X) ** 3, R - 1, R - 2, 5 + 9 * (-X) ** 3] + [
        host.randrange(1, R) for _ in range(34)]
    be = B.TorchBlsBackend(device=cuda_device)
    msg, msg_inf = be._messages([bytes([i % 5]) * 32 for i in range(40)],
                                DST_SIGNATURE)
    msg_inf = msg_inf.clone()
    msg_inf[[1, 17]] = True
    args = (msg, msg_inf,
            torch.from_numpy(B.sign_digits_host(scalars)).to(cuda_device))
    before = B.batch_sign.launches
    got = B.batch_sign(*args, lanes=lanes)
    _equal((got,), (B.batch_sign_plain(*args, lanes),))
    assert B.batch_sign.launches == before + 1
    assert got[1, 2].abs().sum().item() == 0  # ∞: Z = 0


def test_batch_sign_backend_on_the_card(cuda_device):
    keys = [A.SecretKey(k) for k in (1, R - 1, R - 2, 0x7E570001)]
    msgs = [b"a", b"", b"\xab" * 1000, b"a"]
    got = B.TorchBlsBackend(device=cuda_device).batch_sign(msgs, keys)
    assert [s.to_bytes() for s in got] == [k.sign(m).to_bytes()
                                           for k, m in zip(keys, msgs)]


@pytest.mark.parametrize("k", [1, 2])
def test_group_sums_match_plain(cuda_device, k):
    """group_sum<F> for G1 and G2: empty groups, an all-∞ group, single
    members, a group past 128 rows, ∞ rows inside groups."""
    host = random.Random(0xC0DE + k)
    pts = [(G1 if k == 1 else hash_to_g2(b"g", DST_SIGNATURE)).mul(
        host.randrange(1, R)) for _ in range(12)]
    pts += [G1.mul(0) if k == 1 else g2_infinity()] * 2
    rows = B.jacobian_rows([pts[i % 14] for i in range(300)], k)
    rows_t = torch.from_numpy(rows).to(cuda_device)
    off = [0, 0, 12, 14, 15, 150, 151, 300]  # 12:14 holds ∞ rows only
    fn, plain = ((B.g1_group_sum, B.g1_group_sum_plain) if k == 1
                 else (B.g2_group_sum, B.g2_group_sum_plain))
    before = fn.launches
    got = fn(rows_t, off)
    _equal((got,), (plain(rows_t, off),))
    assert fn.launches == before + 1
    assert got[0].tolist() == got[2].tolist()  # ∞ (1, 1, 0) words


@pytest.mark.parametrize("k", [1, 2])
def test_group_sum_edges_match_plain(cuda_device, k):
    """group_sum<F>'s plan edges (testing/group_rows.py) at the kernel's
    tile: empty groups, an all-∞ group, one row, GROUP_CHUNK rows and one
    more, a group spanning tiles (two passes), P and −P, the same point
    twice, ∞ then P, six groups of 4; each launched twice alike."""
    rows, off, names = GR.group_rows(k, 0xC0E0 + k, B.group_tile(k))
    rows_t = torch.from_numpy(rows).to(cuda_device)
    fn, plain = ((B.g1_group_sum, B.g1_group_sum_plain) if k == 1
                 else (B.g2_group_sum, B.g2_group_sum_plain))
    before = fn.launches
    got = fn(rows_t, off)
    _equal((got,), (plain(rows_t, off),))
    _equal((fn(rows_t, off),), (got,))
    assert fn.launches == before + 2
    inf = ~got[:, 2].reshape(len(names), -1).any(-1).cpu()
    assert inf.tolist() == [n in ("empty", "all ∞", "P and −P")
                            for n in names]


@pytest.mark.parametrize("g2_lanes", [False, True])
@pytest.mark.parametrize("kind", ["edges", "seeded"])
def test_multi_rlc_scale_edges_match_plain(cuda_device, kind, g2_lanes):
    """multi_rlc_scale's edges (r0 = 0, r1 = 0, r = 1, r = 0, halves
    0xFFFFFFFF, a masked signature, the same key in three sets) and 70
    seeded sets (two G1 blocks, the second ragged), in both G2 forms: the
    rule's through the wrapper, the other through the C entry."""
    cases = (GR.MULTI_EDGES if kind == "edges"
             else GR.seeded_multi_cases(0xC0E5, 70))
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in GR.multi_rows(cases, 0xC0E6))
    want = B.multi_rlc_scale_plain(*args)
    if B.multi_g2_lanes(len(cases)) == g2_lanes:
        before = B.multi_rlc_scale.launches
        _equal(B.multi_rlc_scale(*args), want)
        assert B.multi_rlc_scale.launches == before + 1
    else:
        _equal(GR.multi_launch(args, g2_lanes), want)


def test_aggregate_seams_and_plane_on_the_card(cuda_device):
    """g2/g1_aggregate_groups and the device aggregator against the host
    aggregates; one signing-plane round on the card through the release
    gate, released byte for byte as SecretKey.sign."""
    from grandine_tpu_torch.runtime.sign_plane import (
        SignLaneConfig, SigningPlane)
    from grandine_tpu_torch.runtime.thread_pool import Priority
    from grandine_tpu_torch.validator.duties import device_aggregator

    sks = [A.SecretKey(0x7E570001 + 0x1357 * i) for i in range(8)]
    roots = [bytes([i + 1]) * 32 for i in range(8)]
    sigs = [sk.sign(r) for sk, r in zip(sks, roots)]
    groups = [sigs[:5], sigs[5:6], [], sigs[6:]]
    assert [a.to_bytes() for a in device_aggregator()(groups)] == [
        A.Signature.aggregate(g).to_bytes() for g in groups]
    pk_groups = [[sk.public_key() for sk in sks[:3]], [sks[3].public_key()]]
    assert [a.to_bytes() for a in B.g1_aggregate_groups(pk_groups)] == [
        A.PublicKey.aggregate(g).to_bytes() for g in pk_groups]
    lanes = (SignLaneConfig("attestation", Priority.HIGH, 8, 0.05, 64,
                            shed=False),)
    plane = SigningPlane(lanes=lanes, settle_timeout_s=120.0)
    try:
        tickets = [plane.submit(r, sk, duty_kind="attestation",
                                public_key=sk.public_key())
                   for sk, r in zip(sks, roots)]
        assert [t.result(120.0) for t in tickets] == [s.to_bytes()
                                                      for s in sigs]
        st = plane.stats()["attestation"]
        assert st["device_batches"] == st["batches"] >= 1
        assert st["degraded"] == st["gate_failures"] == 0
    finally:
        plane.stop()


# --- the blob-KZG plane ---------------------------------------------------------


def _kzg_rows(points, scalars, dev):
    from grandine_tpu_torch.gpu import kzg as GK

    inf = np.array([p.is_infinity() for p in points], bool)
    px = np.zeros((len(points), 12), np.int32)
    py = np.zeros((len(points), 12), np.int32)
    px[~inf], py[~inf] = B.g1_affine_words(
        [p for p, i in zip(points, inf) if not i])
    return tuple(torch.from_numpy(a).to(dev) for a in (
        px, py, inf, GK.scalar_words(scalars)))


def test_g1_scalar_mul_matches_plain_on_edge_rows(cuda_device):
    """k = 0, 1, r − 1, x² − 1, x², 3·x² (k0 = 0), an ∞ base, the generator
    and random rows: the kernel equals its plain version word for word and
    the host ladder as points."""
    from grandine_tpu_torch.crypto.curves import g1_infinity
    from grandine_tpu_torch.gpu import kzg as GK

    rng = random.Random(0x4844)
    points = [G1.mul(rng.randrange(1, R)) for _ in range(8)]
    points += [g1_infinity(), G1, G1, G1]
    scalars = [0, 1, R - 1, GK.X2 - 1, GK.X2, 3 * GK.X2, rng.randrange(R),
               2, rng.randrange(R), 1, R - 1, rng.randrange(R)]
    args = _kzg_rows(points, scalars, cuda_device)
    before = GK.g1_scalar_mul.launches
    got = GK.g1_scalar_mul(*args)
    assert GK.g1_scalar_mul.launches == before + 1
    _equal((got,), (GK.g1_scalar_mul_plain(*args),))
    back = B.g1_points_from_words(got.cpu().numpy())
    assert [a == p.mul(k) for a, p, k in zip(back, points, scalars)] == \
        [True] * len(points)


def test_g1_scalar_mul_and_lincomb_at_setup_width(cuda_device):
    """4,096 rows: the official setup's Lagrange points with random scalars
    (the MSM shape); the ladder and the whole setup MSM equal the plain
    versions on the same operands."""
    from grandine_tpu_torch.gpu import kzg as GK
    from grandine_tpu_torch.kzg.setup import official_setup

    setup = official_setup()
    rng = np.random.default_rng(7)
    scalars = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(4096)]
    px, py, inf = setup.device_g1(cuda_device)
    k = torch.from_numpy(GK.scalar_words(scalars)).to(cuda_device)
    rows = GK.g1_scalar_mul(px, py, inf, k)
    _equal((rows,), (GK.g1_scalar_mul_plain(px, py, inf, k),))
    _equal((GK.lincomb(px, py, inf, k),),
           (B.g1_group_sum_plain(rows, [0, 4096]),))


def test_blob_plane_on_the_card(cuda_device):
    """Width 8: commitments and proofs on the card equal the plain
    versions' bytes; the row-15 pass (ladder, four group sums, width-4
    Miller loop, finish) equals its plain composition, and batch verdicts
    (valid, forged, ∞ proof) equal the host tail."""
    from grandine_tpu_torch.gpu import kzg as GK
    from grandine_tpu_torch.kzg import eip4844 as K
    from grandine_tpu_torch.kzg.setup import dev_setup

    setup = dev_setup(8)
    rng = np.random.default_rng(0x4844)
    blobs = [b"".join((int.from_bytes(rng.bytes(31), "big")).to_bytes(
        32, "big") for _ in range(8)) for _ in range(3)] + [bytes(256)]
    comms = [K.blob_to_kzg_commitment(b, setup) for b in blobs]
    assert comms == [K.blob_to_kzg_commitment(b, setup, device="cpu")
                     for b in blobs]
    proofs = [K.compute_blob_kzg_proof(b, c, setup)
              for b, c in zip(blobs, comms)]
    assert proofs[0] == K.compute_blob_kzg_proof(blobs[0], comms[0], setup,
                                                 device="cpu")
    backend = K.KzgDeviceBackend()
    batches = {"valid": (blobs[:3], comms[:3], proofs[:3], True),
               "forged": (blobs[:3], comms[:3],
                          [proofs[0], proofs[2], proofs[2]], False),
               "infinity": (blobs[1:], comms[1:], proofs[1:], True)}
    for name, (bl, cm, pr, want) in batches.items():
        assert K.verify_blob_kzg_proof_batch(bl, cm, pr, setup) is want, name
        assert K._batch_pairing_host(setup, *K._batch_inputs(
            bl, cm, pr, setup)) is want, name
        _, prep = backend.prepare_raw(bl, cm, pr, setup)
        px, py, pinf, k, _, _ = prep
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (px, py, pinf, k)]
        q2 = setup.device_g2(cuda_device)
        rows = GK.g1_scalar_mul_plain(*args)
        sums = B.g1_group_sum_plain(rows, [0, 4, 8, 12, 16])
        sum_inf = (sums[:, 2] == 0).all(-1)
        f = TP.miller_loop_pairs_plain(sums, q2, sum_inf)
        none = torch.zeros((0,), dtype=torch.bool, device=cuda_device)
        plain = B.rlc_finish_plain(
            f, torch.zeros((0, 3, 2, 12), dtype=torch.int32,
                           device=cuda_device),
            torch.zeros_like(sum_inf), none, none, [0, 4], [0, 0])
        got = GK.blob_verify(*args, q2, 4)
        _equal((got,), (plain,))
        assert bool(got.item()) is want, name


# --- ed25519_verify ----------------------------------------------------------------


def _ed_rows(B, seed):
    from grandine_tpu_torch.crypto import ed25519 as HE
    from grandine_tpu_torch.gpu import ed25519 as E

    rng = random.Random(seed)

    def affine(p):
        zinv = pow(p[2], HE.P - 2, HE.P)
        return p[0] * zinv % HE.P, p[1] * zinv % HE.P

    pts = [(0, 1), (0, HE.P - 1), affine(HE.BASE), affine(HE.point_add(
        HE.point_mul(99, HE.BASE), HE.ORDER2))]
    ks = [0, 1, (1 << 253) - 1, HE.L - 1]
    pts += [affine(HE.point_mul(rng.randrange(1, HE.L), HE.BASE))
            for _ in range(B - 4)]
    ks += [rng.randrange(1 << 253) for _ in range(B - 4)]
    return [E.ints_to_words(v) for v in (
        [x for x, _ in pts], [y for _, y in pts],
        [x * y % HE.P for x, y in pts], ks)]


@pytest.mark.parametrize("B", [8, 32, 128])
def test_ed25519_verify_matches_plain(cuda_device, B):
    from grandine_tpu_torch.gpu import ed25519 as E

    args = [torch.from_numpy(a).to(cuda_device) for a in _ed_rows(B, B)]
    before = E.ed25519_verify.launches
    got = E.ed25519_verify(*args)
    assert E.ed25519_verify.launches == before + 1
    _equal(got, E.ed25519_verify_plain(*args))


def test_ed25519_lane_on_the_card(cuda_device):
    from grandine_tpu_torch.crypto import ed25519 as HE
    from grandine_tpu_torch.gpu import ed25519 as E
    from grandine_tpu_torch.runtime.verify_scheduler import VerifyScheduler

    rng = random.Random(0xED)
    items = []
    for i in range(5):
        sk = rng.randbytes(32)
        msg = rng.randbytes(8)
        items.append(VerifyItem(msg + (b"!" if i == 3 else b""),
                                HE.sign(sk, msg),
                                public_keys=(HE.secret_to_public(sk),)))
    sched = VerifyScheduler(device=cuda_device)
    try:
        before = E.ed25519_verify.launches
        tickets = [sched.submit("ed25519", [it]) for it in items]
        assert [t.result(60.0) for t in tickets] == [
            HE.check_item(it) for it in items]
        st = sched.stats["ed25519"]
        assert st["device_faults"] == st["retries"] == 0
        assert E.ed25519_verify.launches > before
    finally:
        sched.stop()


# --- span_update_grid ----------------------------------------------------------


@pytest.mark.parametrize("n,base", [(1, 0), (255, (1 << 30) - 64), (256, 48),
                                    (257, 0), (16_385, (1 << 30) - 64),
                                    (50_000, 48), (300, (1 << 31) - 64)])
def test_span_update_grid_matches_plain(cuda_device, n, base):
    from grandine_tpu_torch.gpu import spans as S
    from grandine_tpu_torch.testing.slasher import span_edge_rows

    args = [torch.from_numpy(a).to(cuda_device)
            for a in span_edge_rows(n, base, seed=n)]
    before = S.span_update_grid.launches
    got = S.span_update_grid(*args, base)
    assert S.span_update_grid.launches == before + 1
    _equal(got, S.span_update_grid_plain(*args, base))


def _dump(db):
    return [(bytes(k), bytes(v)) for k, v in db.iterate_prefix(b"sl:")]


def _hits(lists):
    return [[(h.kind, h.validator_index, h.evidence) for h in hits]
            for hits in lists]


def test_slasher_on_the_card(cuda_device):
    """A device Slasher() against Slasher(device="cpu") on a
    4,096-validator two-window stream, the second poisoned with a double
    vote (the collision path) and a surround (a grid row): identical hits
    and `sl:` dumps, one launch a window."""
    from grandine_tpu_torch.gpu import spans as S
    from grandine_tpu_torch.slasher import Slasher
    from grandine_tpu_torch.testing.slasher import epoch_window

    windows = [epoch_window(4096, t, seed=t) for t in (96, 97)]
    second = windows[1]
    second.append((second[0][0][:3], 96, 97, b"\xee" * 32))
    ids, s, t, root = second[5]
    second[5] = (ids[1:], s, t, root)
    second.append(([ids[0]], 90, 97, root))
    card, host = Slasher(), Slasher(device="cpu")
    before = S.span_update_grid.launches
    outs = [(card.on_attestations_bulk(w), host.on_attestations_bulk(w))
            for w in windows]
    assert S.span_update_grid.launches == before + len(windows)
    for got, want in outs:
        assert _hits(got) == _hits(want)
    kinds = sorted(h.kind for hits in outs[1][0] for h in hits)
    assert kinds == ["double_vote"] * 3 + ["surround_vote"]
    assert _dump(card.db) == _dump(host.db)


# --- the reference-only programs and their kernels ------------------------------


def test_batch_pubkey_matches_plain(cuda_device):
    """Scalars 1, r − 1, r − 2 and seeded ones, both sign masks on each
    half, 40 rows (two one-warp blocks)."""
    host = random.Random(0xC0E1)
    scalars = [1, R - 1, R - 2] + [host.randrange(1, R) for _ in range(37)]
    k, neg = B.sign_scalars_host(scalars)
    assert neg.any(0).all() and (~neg).any(0).all()
    args = (torch.from_numpy(k).to(cuda_device),
            torch.from_numpy(neg).to(cuda_device))
    before = B.batch_pubkey.launches
    got = B.batch_pubkey(*args)
    _equal((got,), (B.batch_pubkey_plain(*args),))
    assert B.batch_pubkey.launches == before + 1


def test_batch_pubkey_comb_edges_match_plain(cuda_device):
    """The comb's edge halves (testing/pubkey_rows.py: a zero half, a
    lane summing to ∞, a join that doubles and one that gives ∞, all-15
    digits)."""
    from grandine_tpu_torch.testing import pubkey_rows as PKR

    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in PKR.halves_operands(PKR.COMB_EDGES))
    got = B.batch_pubkey(*args)
    _equal((got,), (B.batch_pubkey_plain(*args),))
    assert got[PKR.COMB_INF_ROW, 2].abs().sum().item() == 0  # λ·g1 − λ·g1


def _normalize_rows(k, dev):
    """Jacobian rows with Z ≠ 1 (ladder outputs), an ∞ row, Z = 1 and
    Z = −1 (X, −Y, −1) of one point."""
    host = random.Random(0xC0E2 + k)
    scalars = [host.randrange(1, R) for _ in range(37)]
    ks, neg = B.sign_scalars_host(scalars)
    if k == 1:
        rows = B.batch_pubkey_plain(torch.from_numpy(ks),
                                    torch.from_numpy(neg)).numpy()
        x, y = G1.to_affine()
        ints = [x.n, y.n, 1, x.n, (C.P - y.n) % C.P, C.P - 1]
    else:
        h = hash_to_g2(b"norm", DST_SIGNATURE)
        msg = torch.from_numpy(np.stack([B.g2_affine_words(h)[0]] * 37))
        rows = B.batch_sign_plain(
            msg, torch.zeros((37,), dtype=torch.bool),
            torch.from_numpy(B.sign_digits_host(scalars))).numpy()
        x, y = h.to_affine()
        ints = [x.c0.n, x.c1.n, y.c0.n, y.c1.n, 1, 0,
                x.c0.n, x.c1.n, (C.P - y.c0.n) % C.P, (C.P - y.c1.n) % C.P,
                C.P - 1, 0]
    edge = np.asarray(L.ints_to_words(ints)).reshape((2,) + rows.shape[1:])
    rows = np.concatenate([rows, np.zeros((1,) + rows.shape[1:], np.int32),
                           edge])
    return torch.from_numpy(rows).to(dev)


@pytest.mark.parametrize("k", [1, 2])
def test_normalize_matches_plain(cuda_device, k):
    """g1_normalize / g2_normalize on 40 rows: exact, the ∞ row zero
    words under its mask, Z = 1 and Z = −1 the same affine point."""
    rows = _normalize_rows(k, cuda_device)
    fn, plain = ((B.g1_normalize, B.g1_normalize_plain) if k == 1
                 else (B.g2_normalize, B.g2_normalize_plain))
    before = fn.launches
    xy, inf = fn(rows)
    _equal((xy, inf), plain(rows))
    assert fn.launches == before + 1
    assert inf.tolist() == [False] * 37 + [True, False, False]
    assert xy[37].abs().sum().item() == 0
    assert torch.equal(xy[38], xy[39])


def test_unpack_words_matches_plain(cuda_device):
    """0, p − 1, p, 2³⁸⁴ − 1, 2³⁹⁰ − 1 and rows with bits above 390 set."""
    values = [0, C.P - 1, C.P, (1 << 384) - 1, (1 << 390) - 1,
              (1 << 416) - 1, ((1 << 26) - 1) << 390, (123 << 395) | 5]
    w = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(13)]
                  for v in values], np.uint32).view(np.int32)
    t = torch.from_numpy(w).to(cuda_device)
    before = B.unpack_words.launches
    got = B.unpack_words(t)
    _equal((got,), (B.unpack_words_plain(t),))
    assert B.unpack_words.launches == before + 1
    assert L.words_to_ints(got) == [(v % (1 << 390)) % C.P for v in values]


def test_pubkey_normalize_round_trip_on_the_card(cuda_device):
    """512 keys: batch_pubkey, g1_normalize, compression — byte for byte
    `SecretKey.public_key()`."""
    from grandine_tpu_torch.crypto.curves import B1, Point
    from grandine_tpu_torch.crypto.fields import Fq

    host = random.Random(0xC0E3)
    scalars = [host.randrange(1, R) for _ in range(512)]
    k, neg = B.sign_scalars_host(scalars)
    xy, inf = B.g1_normalize(B.batch_pubkey(
        torch.from_numpy(k).to(cuda_device),
        torch.from_numpy(neg).to(cuda_device)))
    ints = L.words_to_ints(xy)
    got = [A.g1_to_bytes(Point.from_affine(Fq(ints[2 * i]),
                                           Fq(ints[2 * i + 1]), B1))
           for i in range(512)]
    assert not inf.any()
    assert got == [A.SecretKey(s).public_key().to_bytes() for s in scalars]


def test_reference_programs_on_the_card(cuda_device):
    """entry() verifies; each program on a small batch: valid True, the
    firehose's [P, −P] slot False when real and neutral as padding, the
    packed program with check_subgroup False on a signature outside G2;
    only the packed program with check_subgroup launches
    g2_subgroup_check; dryrun_multichip(2) over virtual shards."""
    from grandine_tpu_torch import entry as E

    fn, args = E.entry()
    before = C.g2_subgroup_check.launches
    assert fn(*args).item() == 1
    host = random.Random(0xC0E4)
    sks = [A.SecretKey(host.randrange(1, R)) for _ in range(5)]
    roots = [b"r0", b"r1"]
    hs = [hash_to_g2(m, DST_SIGNATURE) for m in roots]
    owner = [0, 0, 0, 1, 1]
    sig = [sk.sign(roots[o]).point for sk, o in zip(sks, owner)]
    pk = [sk.public_key().point for sk in sks]
    pairs = [(host.getrandbits(32), host.getrandbits(32)) for _ in range(5)]
    members = [[(pk[i], sig[i]) for i in range(3)],
               [(pk[i], sig[i]) for i in range(3, 5)]]
    grp = E.grouped_batch(members, hs, [pairs[:3], pairs[3:]], 2, 4)

    def up(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                for a in arrays]

    assert B.grouped_multi_verify_kernel(*up(grp)).item() == 1
    agg = [A.Signature.aggregate([A.Signature(sig[i]) for i in range(3)]),
           A.Signature.aggregate([A.Signature(sig[i]) for i in range(3, 5)])]
    pair = [pk[0], -pk[0]]
    fh = list(E.firehose_batch([pk[:3], pk[3:], pair],
                               [a.point for a in agg] + [g2_infinity()],
                               hs + [hs[0]], pairs[:3], 4, 4))
    assert B.aggregate_fast_verify_kernel(*up(fh)).item() == 0
    fh[3] = np.array([False, False, True, True])  # the pair's slot padding
    assert B.aggregate_fast_verify_kernel(*up(fh)).item() == 1
    assert C.g2_subgroup_check.launches == before
    plans, kw = E.grouped_plans(grp)
    assert B.grouped_multi_verify_msm_kernel(
        *up(list(grp[:8]) + list(plans)), **kw).item() == 1
    packed = list(grp[:8])
    packed[3:5] = [E.packed_signatures(grp[3], grp[4])]
    assert B.grouped_multi_verify_msm_packed_kernel(
        *up(packed + list(plans)), **kw, check_subgroup=1).item() == 1
    assert C.g2_subgroup_check.launches == before + 1
    nonsub = map_to_curve_g2(hash_to_field_fq2(b"ng-0", b"SGT", 1)[0])
    bad = list(members)
    bad[1] = [members[1][0], (pk[4], nonsub)]
    bgrp = E.grouped_batch(bad, hs, [pairs[:3], pairs[3:]], 2, 4)
    bpacked = list(bgrp[:8])
    bpacked[3:5] = [E.packed_signatures(bgrp[3], bgrp[4])]
    bplans, bkw = E.grouped_plans(bgrp)
    assert B.grouped_multi_verify_msm_packed_kernel(
        *up(bpacked + list(bplans)), **bkw, check_subgroup=1).item() == 0
    E.dryrun_multichip(2)


# --- the bucket MSM ----------------------------------------------------------


def _msm_case(k, n, n_groups, w, seed, lanes):
    """Points (four distinct bases, so duplicates share buckets), one ∞, a
    point and its negation under the same scalar and group, a zero scalar
    and a zero low half, the last group empty, one live row masked off on
    the device; the plan of their scalars. Numpy arrays and the plan."""
    from grandine_tpu_torch.crypto.curves import G2, g1_infinity

    rng = random.Random(seed)
    gen = G1 if k == 1 else G2
    base = [gen.mul(rng.randrange(1, 1 << 64)) for _ in range(4)]
    pts = [base[rng.randrange(4)] for _ in range(n)]
    pts[1] = g1_infinity() if k == 1 else g2_infinity()
    pts[2] = -pts[4]
    lo = [rng.randrange(0, 1 << 32) for _ in range(n)]
    hi = [rng.randrange(0, 1 << 32) for _ in range(n)]
    lo[2], hi[2] = lo[4], hi[4]
    lo[5] = hi[5] = 0
    lo[6] = 0
    groups = [rng.randrange(0, max(1, n_groups - 1)) for _ in range(n)]
    groups[2] = groups[4]
    inf = np.array([p.is_infinity() for p in pts])
    plan = M.plan_msm(lo, hi, inf, groups, n_groups, window_bits=w,
                      lanes=lanes)
    if k == 1:
        x = np.zeros((n, 12), np.int32)
        y = np.zeros((n, 12), np.int32)
        x[~inf], y[~inf] = B.g1_affine_words([p for p in pts
                                             if not p.is_infinity()])
    else:
        x, y, _ = B.g2_affine_words_many(pts)
    live = ~inf
    live[8] = False
    return x, y, live, plan


@pytest.mark.parametrize("k,n,groups,w,lanes", [
    (1, 37, 5, 4, 64), (1, 30, 3, 8, 40), (2, 17, 1, 5, 64),
    (2, 40, 2, 8, 64), (1, 1562, 16, 4, None), (2, 1562, 1, 6, None),
    (2, 512, 1, 8, None)])
def test_msm_kernels_match_plain(cuda_device, k, n, groups, w, lanes):
    """msm_lane_scan, msm_bucket_reduce and msm_horner, G1 (k = 1) and G2,
    each against its plain version on the same operands, word for word: a
    lane count not a multiple of 32, B = 256 digits (72 KiB of shared
    memory a G2 block), the grouped route's shapes; one launch each."""
    x, y, live, plan = _msm_case(k, n, groups, w, 0xC0F0 + n, lanes)
    px, py, lv = (torch.from_numpy(a.copy()).to(cuda_device)
                  for a in (x, y, live))
    a = M.upload_plan(plan, cuda_device).arrays
    before = [fn.launches for fn in (M.msm_lane_scan, M.msm_bucket_reduce,
                                     M.msm_horner)]
    emit = M.msm_lane_scan(px, py, lv, *a[:3])
    _equal((emit,), (M.msm_lane_scan_plain(px, py, lv, *a[:3]),))
    totals = M.msm_bucket_reduce(emit, *a[3:])
    _equal((totals,), (M.msm_bucket_reduce_plain(emit, *a[3:]),))
    out = M.msm_horner(totals, groups, w)
    _equal((out,), (M.msm_horner_plain(totals, groups, w),))
    assert [fn.launches for fn in (M.msm_lane_scan, M.msm_bucket_reduce,
                                   M.msm_horner)] == [b + 1 for b in before]
    if groups > 1:  # the last group holds no point: ∞
        assert out[-1, 2].abs().sum().item() == 0
