"""The port's block-verify slice on the CPU: the standalone ψ subgroup
check, the flat RLC ladders and the finish product held against the JAX
package's programs (exact canonical integers and verdicts), and the slice
end to end — `consensus.verifier.TorchVerifier`, every new backend seam,
`gpu.schemes.dispatch_bls_host_decompress` and the replay window's
composition — against the JAX package's host anchors
(grandine_tpu.crypto.bls multi_verify / fast_aggregate_verify) on the
same seeded inputs, bad variants and edge semantics included; in the slow
tier, verdict parity with the JAX device backend under the same RLC
draws."""

import functools
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import DST_SIGNATURE, P, R
from grandine_tpu.crypto.curves import G1, G2, LAMBDA, endo_constants
from grandine_tpu.crypto import pairing as JPH
from grandine_tpu.crypto.fields import Fq2, Fq6, Fq12
from grandine_tpu.crypto.hash_to_curve import (
    hash_to_field_fq2, hash_to_g2, map_to_curve_g2)
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import curve as JC
from grandine_tpu.tpu import field as JF
from grandine_tpu.tpu import limbs as JL
from grandine_tpu.tpu import pairing as JP
from grandine_tpu_torch.consensus.verifier import (
    SignatureInvalid, TorchVerifier)
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.crypto.curves import g2_infinity
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2 as port_h2c
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import pairing as TP
from grandine_tpu_torch.gpu.registry import DevicePubkeyRegistry
from grandine_tpu_torch.gpu.schemes import dispatch_bls_host_decompress
from grandine_tpu_torch.runtime.replay import dispatch_window
from grandine_tpu_torch.runtime.verify_scheduler import VerifyItem

N_KEYS = 16
#: a small block: (message byte, signers); key 15 is −key 0
SETS = [(0x60, [0, 1, 2]), (0x61, [3]), (0x62, [4, 5, 6, 7]), (0x63, [9])]

rng = random.Random(0x7E5)


def _bits(seed):
    """random.Random behind the `randbits` of `secrets`, which the RLC
    draws of both packages take (rng=)."""
    return SimpleNamespace(randbits=random.Random(seed).getrandbits)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _non_subgroup_g2(i):
    return map_to_curve_g2(hash_to_field_fq2(b"ng-%d" % i, b"SGT", 1)[0])


def _jax_ints(rows):
    return [JL.from_mont(r) % P for r in rows]


# --- the kernels' plain versions against the JAX programs ---------------------


def test_g2_subgroup_check_matches_jax():
    pts = [hash_to_g2(b"sub-%d" % i) for i in range(5)]
    pts += [G2.mul(0), _non_subgroup_g2(0), _non_subgroup_g2(1)]
    sx, sy, inf = B.g2_affine_words_many(pts)
    jx, jy, jinf = JC.g2_points_to_dev(pts)
    for w, j in ((sx, jx), (sy, jy)):  # the same affine points
        assert L.words_to_ints(w) == _jax_ints(j.reshape(-1, j.shape[-1]))
    got = C.g2_subgroup_check(torch.from_numpy(sx), torch.from_numpy(sy),
                              torch.from_numpy(inf))
    x_bits = np.ascontiguousarray(
        JC.scalars_to_bits_msb([JB._ABS_X] * len(pts), 64).T)
    ref = jax.jit(JB.g2_subgroup_check_kernel)(jx, jy, jinf, x_bits)
    assert got.tolist() == np.asarray(ref).tolist()
    assert got.tolist() == [True] * 6 + [False, False]


def _jax_endo(n, group):
    a, b = endo_constants()[group]
    fa = JL.const_fp([int(d) for d in JL.to_mont(a)], (n,))
    fb = JL.const_fp([int(d) for d in JL.to_mont(b)], (n,))
    if group == "g1":
        return fa, fb
    z = JL.zeros_fp((n,))
    return (fa, z), (fb, z)


def _affine(words, k):
    """(N, 3, [2,] 12) Jacobian canonical words → host affine ints."""
    v = L.words_to_ints(words)
    per = 3 * k
    out = []
    for i in range(len(v) // per):
        c = v[per * i: per * (i + 1)]
        if k == 1:
            x, y, z = c
            if z == 0:
                out.append(None)
                continue
            zi = pow(z, P - 2, P)
            out.append((x * zi * zi % P, y * zi ** 3 % P))
            continue
        x, y, z = (Fq2.from_ints(c[2 * j], c[2 * j + 1]) for j in range(3))
        if z.is_zero():
            out.append(None)
            continue
        zi = z.inv()
        ax, ay = x * zi * zi, y * zi * zi * zi
        out.append(((ax.c0.n, ax.c1.n), (ay.c0.n, ay.c1.n)))
    return out


def _jax_affine(s, n, k):
    to_pt = JC.dev_to_g1_point if k == 1 else JC.dev_to_g2_point
    out = []
    for i in range(n):
        if k == 1:
            X, Y, Z = (JL.merge_np(c)[i] for c in s)
        else:
            X, Y, Z = (np.stack([JL.merge_np(c[0])[i], JL.merge_np(c[1])[i]])
                       for c in s)
        a = to_pt(X, Y, Z).to_affine()
        out.append(None if a is None else (
            (a[0].n, a[1].n) if k == 1 else
            ((a[0].c0.n, a[0].c1.n), (a[1].c0.n, a[1].c1.n))))
    return out


def test_multi_rlc_scale_plain_matches_jax():
    """rᵢ·pkᵢ (keys gathered by a permuted index) and rᵢ·sigᵢ (an ∞ row
    masked) against the JAX package's scalar_mul_glv on FP_OPS and
    FP2_OPS, as affine canonical integers."""
    n = 6
    keys = [G1.mul(rng.randrange(1, R)) for _ in range(n)]
    sigs = [G2.mul(rng.randrange(1, R)) for _ in range(n)]
    sigs[3] = G2.mul(0)
    order = [5, 0, 3, 1, 4, 2]
    r0 = [rng.randrange(1 << 32) for _ in range(n)]
    r1 = [rng.randrange(1 << 32) for _ in range(n)]
    r0[1] = 0  # a zero low half
    fx, fy = B.g1_affine_words(keys)
    sx, sy, sinf = B.g2_affine_words_many(sigs)
    rpk, rsig = B.multi_rlc_scale(
        torch.from_numpy(fx.copy()), torch.from_numpy(fy.copy()),
        torch.tensor(order, dtype=torch.int32), torch.from_numpy(sx),
        torch.from_numpy(sy), torch.from_numpy(sinf),
        torch.from_numpy(B.rlc_pairs_words(list(zip(r0, r1)))))
    lo = jnp.asarray(JC.scalars_to_bits_msb(r0, 32)).T
    hi = jnp.asarray(JC.scalars_to_bits_msb(r1, 32)).T
    gx, gy, ginf = JC.g1_points_to_dev([keys[i] for i in order])
    j1 = jax.jit(lambda x, y, qi, a, b: JC.scalar_mul_glv(
        JL.split(x), JL.split(y), qi, a, b, _jax_endo(n, "g1"),
        JC.FP_OPS))(gx, gy, ginf, lo, hi)
    jx, jy, jinf = JC.g2_points_to_dev(sigs)
    j2 = jax.jit(lambda x, y, qi, a, b: JC.scalar_mul_glv(
        JB._g2_in(x, y)[0], JB._g2_in(x, y)[1], qi, a, b,
        _jax_endo(n, "g2"), JC.FP2_OPS))(jx, jy, jinf, lo, hi)
    assert _affine(rpk, 1) == _jax_affine(j1, n, 1)
    assert _affine(rsig, 2) == _jax_affine(j2, n, 2)
    s = [(a + b * LAMBDA) % R for a, b in zip(r0, r1)]
    want = keys[order[2]].mul(s[2]).to_affine()
    assert _affine(rpk, 1)[2] == (want[0].n, want[1].n)
    assert _affine(rsig, 2)[3] is None


def _port_fp12(f_ints):
    return L.from_words(torch.from_numpy(
        L.ints_to_words(f_ints).copy()).reshape(-1, 2, 3, 2, 12))


def _jax_fp12(f_ints, pad_to=None):
    """Canonical Fp12 ints → a JAX batch, padded with ones to `pad_to`."""
    n = len(f_ints) // 12
    if pad_to:
        f_ints = list(f_ints) + ([1] + [0] * 11) * (pad_to - n)
        n = pad_to
    rows = np.stack([JL.to_mont(v) for v in f_ints]).reshape(n, 2, 3, 2, -1)
    return JF.fp12_split(jnp.asarray(rows))


def _jax_fp12_ints(f):
    arr = JF.fp12_merge_np(f)
    return [JL.from_mont(r) % P for r in arr.reshape(-1, arr.shape[-1])]


def _batched(prod):
    return tuple(tuple(tuple(c[:, None] for c in c2) for c2 in c6)
                 for c6 in prod)


def test_strided_tree_product_matches_jax_product_tree():
    """130 terms: past the kernel's 128 threads, so the strided loop takes
    a second pass before the tree."""
    vals = [rng.randrange(P) for _ in range(130 * 12)]
    got = TP.strided_tree_product(_port_fp12(vals))
    jf = _jax_fp12(vals, pad_to=256)
    ref = jax.jit(JP.fp12_product_tree)(jf)
    assert L.words_to_ints(L.to_words(got)) == _jax_fp12_ints(_batched(ref))


@pytest.fixture(scope="module")
def keys():
    sks = [rng.randrange(1, R) for _ in range(N_KEYS - 1)]
    sks.append(R - sks[0])
    pkb = tuple(JA.g1_to_bytes(G1.mul(k)) for k in sks)
    reg = DevicePubkeyRegistry(device="cpu")
    assert reg.ensure(pkb)
    return sks, pkb, reg


def _sign(sks, msg, signers):
    return JA.g2_to_bytes(hash_to_g2(msg, DST_SIGNATURE).mul(
        sum(sks[j] for j in signers) % R))


@pytest.fixture(scope="module")
def block(keys):
    sks, pkb, _ = keys
    return [(bytes([b]) * 32, mem, _sign(sks, bytes([b]) * 32, mem))
            for b, mem in SETS]


def _host_fp12(ints):
    """12 canonical ints in the port's (2, 3, 2) order → a host Fq12."""
    c = [Fq2.from_ints(ints[2 * k], ints[2 * k + 1]) for k in range(6)]
    return Fq12(Fq6(*c[:3]), Fq6(*c[3:]))


def test_rlc_finish_plain_matches_jax(keys, block):
    """The finish of a valid block and of one with two messages swapped:
    the strided-tree product of the fᵢ and f(−g1, Σ rᵢ·sigᵢ) against the
    JAX product tree, the verdict against the JAX final_exp_is_one, and
    the port's final exponentiation (which computes FE(f)³, as the JAX
    package's does) against the cube of the host anchor's FE."""
    sks, pkb, _ = keys
    n = len(block)
    pks = [PA.PublicKey.aggregate([PA.PublicKey.from_bytes(pkb[j])
                                   for j in mem]) for _, mem, _ in block]
    fx, fy = B.g1_affine_words([pk.point for pk in pks])
    sx, sy, sinf = B.g2_affine_words_many(
        [PA.Signature.from_bytes(s).point for _, _, s in block])
    pairs = [B.TorchBlsBackend._rlc_pair(_bits(3)) for _ in range(n)]
    rpk, rsig = B.multi_rlc_scale(
        torch.from_numpy(fx.copy()), torch.from_numpy(fy.copy()),
        torch.arange(n, dtype=torch.int32), torch.from_numpy(sx),
        torch.from_numpy(sy), torch.from_numpy(sinf),
        torch.from_numpy(B.rlc_pairs_words(pairs)))
    no = torch.zeros((n,), dtype=torch.bool)
    jfn = jax.jit(lambda f: (JP.fp12_product_tree(f),
                             JP.final_exp_is_one(JP.fp12_product_tree(f))))
    f_sig = B.rlc_sig_miller_plain(rsig)
    for order, want in ((range(n), True), ([1, 0, 2, 3], False)):
        msg = torch.from_numpy(np.stack([B.g2_affine_words(port_h2c(
            block[i][0], DST_SIGNATURE))[0] for i in order]))
        f = TP.miller_loop_pairs_plain(rpk, msg, no)
        f_all = torch.cat([L.from_words(f), f_sig], 0)
        prod = TP.strided_tree_product(f_all)
        jprod, jone = jfn(_jax_fp12(L.words_to_ints(L.to_words(f_all)),
                                    pad_to=8))
        prod_ints = L.words_to_ints(L.to_words(prod))
        assert prod_ints == _jax_fp12_ints(_batched(jprod))
        assert bool(jone) == want
        if want:  # the verdict of rlc_finish_plain itself
            assert B.rlc_finish(f, rsig, no, ~no, ~no).item() == 1
            continue
        fe = L.words_to_ints(L.to_words(TP.final_exponentiation(prod)))
        host = JPH.final_exponentiation(_host_fp12(prod_ints))
        cube = host * host * host
        assert fe == [v.n for f6 in (cube.c0, cube.c1)
                      for f2 in (f6.c0, f6.c1, f6.c2) for v in (f2.c0, f2.c1)]
        assert fe != [1] + [0] * 11


# --- the slice end to end against the host anchors ------------------------------


@functools.lru_cache(maxsize=None)
def _anchor(sets, pkb):
    """JAX host anchor: one RLC multi_verify over aggregated keys (False
    on an undecodable signature or an ∞ key, as the backends)."""
    try:
        sigs = [JA.Signature.from_bytes(s) for _, _, s in sets]
        pks = [JA.PublicKey.aggregate([JA.PublicKey.from_bytes(pkb[j])
                                       for j in mem]) for _, mem, _ in sets]
    except JA.BlsError:
        return False
    return JA.multi_verify([m for m, _, _ in sets], sigs, pks,
                           rng=_bits(11))


def _with(sets, i, msg=None, mem=None, sig=None):
    out = list(sets)
    m0, k0, s0 = out[i]
    out[i] = (msg or m0, tuple(mem or k0), sig or s0)
    return tuple(out)


def _variant(block, name):
    base = tuple((m, tuple(k), s) for m, k, s in block)
    if name == "valid":
        return base
    if name == "forged_set":
        return _with(base, 2, sig=base[0][2])
    if name == "swapped_message":
        return _with(_with(base, 0, msg=base[1][0]), 1, msg=base[0][0])
    if name == "infinity_key":
        return _with(base, 0, mem=(0, N_KEYS - 1))
    if name == "outside_g2":
        return _with(base, 3, sig=JA.g2_to_bytes(_non_subgroup_g2(0)))
    raise KeyError(name)


def _port_keys(pkb, mem):
    return [PA.PublicKey.from_bytes(pkb[j]) for j in mem]


@pytest.mark.parametrize("name", ["valid", "forged_set", "swapped_message",
                                  "infinity_key", "outside_g2"])
def test_torch_verifier_matches_anchor(keys, block, name):
    _, pkb, _ = keys
    sets = _variant(block, name)
    v = TorchVerifier(B.TorchBlsBackend(device="cpu"))
    for msg, mem, sig in sets:
        if len(mem) == 1:
            v.verify_singular(msg, sig, _port_keys(pkb, mem)[0])
        else:
            v.verify_aggregate(msg, sig, _port_keys(pkb, mem))
    try:
        settle = v.finish_async()
    except SignatureInvalid:
        # host decompression keeps the subgroup check, as in the JAX
        # package's TpuVerifier
        assert name == "outside_g2"
        got = False
    else:
        try:
            settle()
            got = True
        except SignatureInvalid:
            got = False
    assert got == _anchor(sets, pkb) == (name == "valid")


def _agg_keys(pkb, sets):
    return [PA.PublicKey.aggregate(_port_keys(pkb, mem)) for _, mem, _ in sets]


@pytest.mark.parametrize("name", ["valid", "outside_g2"])
def test_multi_verify_compressed_matches_anchor(keys, block, name):
    _, pkb, _ = keys
    sets = _variant(block, name)
    be = B.TorchBlsBackend(device="cpu")
    got = be.multi_verify_compressed([m for m, _, _ in sets],
                                     [s for _, _, s in sets],
                                     _agg_keys(pkb, sets), rng=_bits(5))
    assert got is _anchor(sets, pkb)


def test_multi_verify_indexed_matches_anchor(keys):
    sks, pkb, reg = keys
    sets = tuple((bytes([0x70 + j]) * 32, (j,),
                  _sign(sks, bytes([0x70 + j]) * 32, [j])) for j in (0, 8, 15))
    be = B.TorchBlsBackend(device="cpu")
    sigs = [PA.Signature.from_bytes(s) for _, _, s in sets]
    msgs = [m for m, _, _ in sets]
    assert be.multi_verify_indexed(msgs, sigs, [0, 8, 15], reg) is True
    assert _anchor(sets, pkb) is True
    assert be.multi_verify_indexed(msgs, sigs, [0, 8, N_KEYS], reg) is False


def test_fast_aggregate_verify_batch_matches_anchor(keys, block):
    _, pkb, _ = keys
    be = B.TorchBlsBackend(device="cpu")
    sets = _variant(block, "valid")
    got = be.fast_aggregate_verify_batch(
        [m for m, _, _ in sets],
        [PA.Signature.from_bytes(s) for _, _, s in sets],
        [_port_keys(pkb, mem) for _, mem, _ in sets], rng=_bits(6))
    assert got is _anchor(sets, pkb) is True


def _items(sets, pkb):
    return [VerifyItem(m, s, member_indices=mem, pubkey_columns=pkb)
            for m, mem, s in sets]


@pytest.mark.parametrize("name", ["valid", "forged_set", "outside_g2"])
def test_host_decompress_dispatch_matches_anchor(keys, block, name):
    """The uncompressed gossip seams (fast_aggregate_verify_batch_indexed
    with the ψ check fused) behind dispatch_bls_host_decompress."""
    _, pkb, reg = keys
    sets = _variant(block, name)
    be = B.TorchBlsBackend(device="cpu")
    got = dispatch_bls_host_decompress(_items(sets, pkb), be, reg)()
    assert got is _anchor(sets, pkb)


@pytest.mark.parametrize("name", ["valid", "outside_g2"])
def test_replay_window_matches_anchor(keys, block, name):
    """The replay composition: g2_subgroup_check_batch_async stacked ahead
    of multi_verify_async over the window's sets."""
    _, pkb, _ = keys
    sets = _variant(block, name)
    be = B.TorchBlsBackend(device="cpu")
    items = [VerifyItem(m, s, public_keys=_port_keys(pkb, mem))
             for m, mem, s in sets]
    assert dispatch_window(items, be)() is _anchor(sets, pkb)


def test_seam_edge_semantics(keys, block):
    """What every seam answers before any kernel runs: empty → True; a
    length mismatch, an ∞ key, an out-of-range index, an empty member
    list, a short or infinity signature → False."""
    sks, pkb, reg = keys
    be = B.TorchBlsBackend(device="cpu")
    msgs = [m for m, _, _ in block]
    raw = [s for _, _, s in block]
    sigs = [PA.Signature.from_bytes(s) for s in raw]
    pks = _agg_keys(pkb, block)
    inf_pk = PA.PublicKey.aggregate(_port_keys(pkb, [0, N_KEYS - 1]))
    members = [list(mem) for _, mem, _ in block]
    for seam, s in ((be.multi_verify, sigs),
                    (be.multi_verify_compressed, raw)):
        assert seam([], [], []) is True
        assert seam(msgs, s[:2], pks) is False
        assert seam(msgs, s, [inf_pk] + pks[1:]) is False
    assert be.multi_verify_compressed(msgs, [raw[0][:95]] + raw[1:],
                                      pks) is False
    assert be.multi_verify_indexed([], [], [], reg) is True
    assert be.multi_verify_indexed(msgs, sigs, [0, 1, 2], reg) is False
    assert be.multi_verify_indexed(msgs, sigs, [0, 1, 2, -1], reg) is False
    keyed = [_port_keys(pkb, mem) for mem in members]
    assert be.fast_aggregate_verify_batch([], [], []) is True
    assert be.fast_aggregate_verify_batch(msgs, sigs, keyed[:3]) is False
    assert be.fast_aggregate_verify_batch(
        msgs, sigs, [keyed[0] + [inf_pk]] + keyed[1:]) is False
    assert be.fast_aggregate_verify_batch(msgs, sigs,
                                          [[]] + keyed[1:]) is False
    idx = be.fast_aggregate_verify_batch_indexed
    assert idx([], [], [], reg) is True
    assert idx(msgs, sigs, [[0, N_KEYS]] + members[1:], reg) is False
    assert idx(msgs, sigs, [[]] + members[1:], reg) is False
    assert be.g2_subgroup_check_batch([]).shape == (0,)
    assert be.g2_subgroup_check_batch([g2_infinity()]).tolist() == [True]
    inf_sig = bytes([0xC0]) + bytes(95)
    items = _items(_with(_variant(block, "valid"), 1, sig=inf_sig), pkb)
    assert dispatch_bls_host_decompress(items, be, reg)() is False
    items = [VerifyItem(m, inf_sig, public_keys=_port_keys(pkb, mem))
             for m, mem, _ in block]
    assert dispatch_window(items, be)() is False
    assert dispatch_window([], be)() is True


@pytest.mark.kernel
@pytest.mark.slow
def test_verdicts_match_jax_device_backend(keys, block):
    """multi_verify and g2_subgroup_check_batch against TpuBlsBackend's
    under the same RLC draws (compiles the JAX programs on the CPU)."""
    from grandine_tpu.tpu.bls import TpuBlsBackend

    _, pkb, _ = keys
    jb = TpuBlsBackend()
    be = B.TorchBlsBackend(device="cpu")
    for name in ("valid", "forged_set"):
        sets = _variant(block, name)
        msgs = [m for m, _, _ in sets]
        want = jb.multi_verify(
            msgs, [JA.Signature.from_bytes(s) for _, _, s in sets],
            [JA.PublicKey.aggregate([JA.PublicKey.from_bytes(pkb[j])
                                     for j in mem]) for _, mem, _ in sets],
            rng=_bits(9))
        got = be.multi_verify(
            msgs, [PA.Signature.from_bytes(s) for _, _, s in sets],
            _agg_keys(pkb, sets), rng=_bits(9))
        assert got == want == (name == "valid")
    pts = [hash_to_g2(b"sub-%d" % i) for i in range(3)] + [_non_subgroup_g2(0)]
    want = jb.g2_subgroup_check_batch(pts)
    got = be.g2_subgroup_check_batch(pts)
    assert got.tolist() == np.asarray(want).tolist() == [True] * 3 + [False]
