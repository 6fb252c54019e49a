"""The port's fault localization on the CPU against the JAX package,
exact: `rlc_partition_verify` (the port's plain route) against the JAX
backend's group verdicts and host anchors; `runtime.isolation`'s ladder
and `FaultLocalizer.localize` against the JAX FaultLocalizer on the same
truth-table fakes (per-item verdicts, device passes, host leaves, pass
counts) — except that a device fault raises instead of sweeping on the
host; one localization end to end on the port's backend; the key cache
and `host_check_item` against their JAX counterparts."""

import random
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from grandine_tpu.consensus import keys as JK
from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import DST_SIGNATURE, R
from grandine_tpu.crypto.curves import G1, B1, Point
from grandine_tpu.crypto.fields import Fq
from grandine_tpu.crypto.hash_to_curve import hash_to_g2
from grandine_tpu.metrics import Metrics
from grandine_tpu.runtime import isolation as jiso
from grandine_tpu.runtime import verify_scheduler as jvs
from grandine_tpu.testing.chaos import KnownAnswerBackend
from grandine_tpu_torch.consensus import keys as PK
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.runtime import isolation as iso
from grandine_tpu_torch.runtime import verify_scheduler as pvs

rng = random.Random(0x10C)


def _bits(seed):
    """random.Random behind the `randbits` of `secrets` (rng=)."""
    return SimpleNamespace(randbits=random.Random(seed).getrandbits)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- ladder and pass bound --------------------------------------------------


@pytest.mark.parametrize("fanout", [2, 8])
def test_ladder_and_pass_bound_match_jax(fanout):
    for bucket in (4, 8, 16, 64, 256, 2048, 16384):
        assert iso.ladder(bucket, fanout) == jiso.ladder(bucket, fanout)
    for n in (1, 2, 4, 5, 100, 192, 1562, 16384):
        assert iso.max_device_passes(n, fanout) == \
            jiso.max_device_passes(n, fanout)
    assert iso.ladder(2048) == [8, 64, 512, 2048]
    assert iso.max_device_passes(192) == 4


# --- localize against the JAX FaultLocalizer on truth-table fakes -------------

_SK = 0x5EED
_SIG = JA.g2_to_bytes(hash_to_g2(b"isolation", DST_SIGNATURE).mul(_SK))
_JPK = JA.PublicKey(G1.mul(_SK))
_PPK = PA.PublicKey.from_bytes(_JPK.to_bytes())


def _items(n, sig=None):
    """The same n items for both packages: messages keyed in the truth
    table, one real signature (the pre-pass decompresses it)."""
    msgs = [b"iso-%04d" % i + bytes(24) for i in range(n)]
    sigs = [(sig or {}).get(i, _SIG) for i in range(n)]
    return (msgs,
            [jvs.VerifyItem(m, s, public_keys=(_JPK,))
             for m, s in zip(msgs, sigs)],
            [pvs.VerifyItem(m, s, public_keys=(_PPK,))
             for m, s in zip(msgs, sigs)])


def _run_both(n, forged, backend_cls=KnownAnswerBackend, sig=None,
              deadline=None):
    msgs, jitems, pitems = _items(n, sig)
    truth = {m: i not in forged for i, m in enumerate(msgs)}
    calls = {"jax": 0, "port": 0}

    def check(who):
        def host_check(item):
            calls[who] += 1
            return truth.get(bytes(item.message), False)
        return host_check

    metrics = Metrics()
    jkab, pkab = backend_cls(truth), backend_cls(truth)
    jloc = jiso.FaultLocalizer(metrics=metrics, host_check=check("jax"))
    ploc = iso.FaultLocalizer(host_check=check("port"))
    want = jloc.localize(jkab, jitems, deadline=deadline)
    got = ploc.localize(pkab, pitems, deadline=deadline)
    return (got, want, pkab, jkab, calls, ploc.passes,
            {k: metrics.verify_isolation_passes.value(k)
             for k in ("g2_subgroup", "rlc_partition", "host")}, truth,
            msgs)


#: forged positions: first, last, adjacent pairs across a group boundary,
#: all bad, scattered
_PATTERNS = [(5, {0}), (5, {4}), (8, {3, 4}), (13, {0, 1}),
             (13, set(range(13))), (16, {0, 15}), (32, {7, 8, 30, 31}),
             (64, {9}), (192, {5, 100, 180}), (192, set())]


@pytest.mark.parametrize("n,forged", _PATTERNS)
def test_localize_matches_jax(n, forged):
    """Per-item verdicts, the partition dispatches (items, groups), the
    host leaves and the pass counts are the JAX FaultLocalizer's; the
    host checks only the forged items, within the pass bound."""
    (got, want, pkab, jkab, calls, passes, jpasses, truth,
     msgs) = _run_both(n, forged)
    assert got == want == [truth[m] for m in msgs]
    assert pkab.partitions == jkab.partitions
    assert calls["port"] == calls["jax"] == len(forged)
    assert 1 + len(pkab.partitions) <= iso.max_device_passes(n)
    assert {k: passes[k] for k in jpasses} == jpasses


def test_localize_host_leaves_match_jax():
    """An undecodable signature is a host leaf and never reaches the
    device; a subgroup-flagged item is a host leaf (the host verdict
    wins) and the descent runs over the rest."""
    got, want, pkab, jkab, calls, *_ = _run_both(
        6, {2, 4}, sig={4: b"\xff" * 96})  # the host says no to item 4
    assert got == want == [True, True, False, True, False, True]
    assert pkab.partitions == jkab.partitions
    assert all(n_items <= 5 for n_items, _ in pkab.partitions)

    class SubgroupFlagged(KnownAnswerBackend):
        def g2_subgroup_check_batch_async(self, points):
            flags = np.ones((len(points),), dtype=bool)
            flags[1] = False
            return lambda: flags

    got, want, pkab, jkab, calls, *_ = _run_both(8, set(), SubgroupFlagged)
    assert got == want == [True] * 8
    assert calls["port"] == calls["jax"] == 1
    assert pkab.partitions == jkab.partitions == [(7, 8)]


@pytest.mark.parametrize("where", ["dispatch", "settle", "subgroup"])
def test_device_fault_raises_not_swept(where):
    """A device fault propagates: the port does not sweep on the host
    (the reference does), so a failing kernel cannot hide."""

    class Faulting(KnownAnswerBackend):
        def rlc_partition_verify_async(self, *a, **kw):
            if where == "dispatch":
                raise RuntimeError("injected partition fault")
            super().rlc_partition_verify_async(*a, **kw)

            def settle():
                raise RuntimeError("injected settle fault")
            return settle

        def g2_subgroup_check_batch_async(self, points):
            if where == "subgroup":
                raise ValueError("injected subgroup fault")
            return super().g2_subgroup_check_batch_async(points)

    msgs, jitems, pitems = _items(12)
    truth = {m: i != 9 for i, m in enumerate(msgs)}
    calls = [0]

    def host_check(item):
        calls[0] += 1
        return truth[bytes(item.message)]

    loc = iso.FaultLocalizer(host_check=host_check)
    with pytest.raises((RuntimeError, ValueError), match="injected"):
        loc.localize(Faulting(truth), pitems)
    assert calls[0] == 0 and loc.passes["host"] == 0
    # the reference sweeps the same fault on the host
    assert jiso.FaultLocalizer(host_check=host_check).localize(
        Faulting(truth), jitems) == [truth[m] for m in msgs]


def test_expired_deadline_sweeps_and_is_counted():
    got, want, pkab, jkab, calls, passes, jpasses, truth, msgs = _run_both(
        8, {6}, deadline=time.monotonic() - 1.0)
    assert got == want == [truth[m] for m in msgs]
    assert pkab.partitions == jkab.partitions == []
    assert passes["host"] == jpasses["host"] == 1
    assert calls["port"] == calls["jax"] == 8


# --- rlc_partition_verify ---------------------------------------------------


@pytest.fixture(scope="module")
def partition_world():
    """8 signers; item i signs message i with key i."""
    sks = [rng.randrange(1, R) for _ in range(8)]
    msgs = [b"part-%02d" % i + bytes(24) for i in range(8)]
    sig_bytes = [JA.g2_to_bytes(hash_to_g2(m, DST_SIGNATURE).mul(k))
                 for m, k in zip(msgs, sks)]
    pkb = [JA.g1_to_bytes(G1.mul(k)) for k in sks]
    return msgs, sig_bytes, pkb


def _partition_inputs(world, n, forged, keyless):
    msgs, sb, pkb = world
    sigs = list(sb[:n])
    for i in forged:
        sigs[i] = sb[(i + 1) % n]
    keys = [[] if i in keyless else [i] for i in range(n)]
    port = (msgs[:n], [PA.Signature.from_bytes(s) for s in sigs],
            [[PA.PublicKey.from_bytes(pkb[j]) for j in ks] for ks in keys])
    jax = (msgs[:n], [JA.Signature.from_bytes(s) for s in sigs],
           [[JA.PublicKey.from_bytes(pkb[j]) for j in ks] for ks in keys])
    return port, jax


def _host_group_verdicts(jax_inputs, groups):
    """The JAX package's geometry (pow-2 bucket and group count, lo=4) and
    host verdicts: a group is True when each of its items verifies on the
    JAX host anchor; padding is True; a keyless item is False."""
    msgs, sigs, keys = jax_inputs
    n = len(msgs)
    b = max(4, 1 << (n - 1).bit_length())
    g = min(max(4, 1 << (groups - 1).bit_length()), b)
    ok = [bool(ks) and sigs[i].fast_aggregate_verify(msgs[i], ks)
          for i, ks in enumerate(keys)] + [True] * (b - n)
    span = b // g
    return [all(ok[j * span:(j + 1) * span]) for j in range(g)]


@pytest.mark.parametrize("n,groups,forged,keyless", [
    (8, 4, {3}, {6}),       # groups of 2: one forged, one keyless
    (8, 8, {1}, {5}),       # the per-item rung
    (6, 4, {0}, set()),     # bucket 8: the last group is all padding
])
def test_rlc_partition_verify_matches_jax_host(partition_world, n, groups,
                                               forged, keyless):
    port, jax = _partition_inputs(partition_world, n, forged, keyless)
    be = B.TorchBlsBackend(device="cpu")
    got = be.rlc_partition_verify(*port, groups, rng=_bits(8))
    assert got.dtype == bool
    assert got.tolist() == _host_group_verdicts(jax, groups)


def test_rlc_partition_edges():
    be = B.TorchBlsBackend(device="cpu")
    assert be.rlc_partition_verify([], [], [], 8).shape == (0,)
    assert be.rlc_partition_verify([b"x"], [], [[]], 8).shape == (0,)
    with pytest.raises(ValueError):
        be.rlc_partition_verify([b"x"], [PA.Signature.empty()], [[_PPK]],
                                B.MAX_BUCKET * 2)
    # every item keyless: nothing reaches the device, their group is False
    got = be.rlc_partition_verify([b"a", b"b"], [PA.Signature.empty()] * 2,
                                  [[], []], 4)
    assert got.tolist() == [False, False, True, True]


@pytest.mark.kernel
def test_rlc_partition_verify_matches_jax_backend(partition_world):
    """The port's plain route against TpuBlsBackend.rlc_partition_verify
    (the JAX program, compiled on the CPU at the smallest bucket) under
    the same RLC draws: N = 4 = G, a forged item and a keyless one."""
    from grandine_tpu.tpu.bls import TpuBlsBackend

    port, jax = _partition_inputs(partition_world, 4, {1}, {2})
    want = TpuBlsBackend().rlc_partition_verify(*jax, 4, rng=_bits(9))
    got = B.TorchBlsBackend(device="cpu").rlc_partition_verify(
        *port, 4, rng=_bits(9))
    assert got.tolist() == np.asarray(want).tolist() == \
        [True, False, False, True]


def test_localize_end_to_end_on_the_port_backend(partition_world):
    """One failed batch of 4 items localized through the port's own
    seams (the ψ check and one partition pass, plain versions): the
    forged item named, no host sweep, two device passes."""
    msgs, sb, pkb = partition_world
    sigs = list(sb[:4])
    sigs[2] = sb[3]
    items = [pvs.VerifyItem(msgs[i], sigs[i],
                            public_keys=[PA.PublicKey.from_bytes(pkb[i])])
             for i in range(4)]
    loc = iso.FaultLocalizer()
    got = loc.localize(B.TorchBlsBackend(device="cpu"), items)
    assert got == [True, True, False, True]
    assert loc.passes == {"g2_subgroup": 1, "rlc_partition": 1}


# --- the key cache and the leaf check -----------------------------------------


def _off_subgroup_g1_bytes():
    """A point of E1 outside G1, compressed."""
    x = 1
    while True:
        y = (Fq(x) * Fq(x) * Fq(x) + Fq(4)).sqrt()
        if y is not None:
            pt = Point.from_affine(Fq(x), y, B1)
            if not pt.in_subgroup():
                return JA.g1_to_bytes(pt)
        x += 1


def test_key_cache_matches_jax():
    pkb = JA.g1_to_bytes(G1.mul(rng.randrange(1, R)))
    got, want = PK.decompress_pubkey(pkb), JK.decompress_pubkey(pkb)
    assert got.to_bytes() == want.to_bytes() == pkb
    assert PK.decompress_pubkey(pkb) is got  # a hit, not a decompression
    for bad in (bytes([0xC0]) + bytes(47), b"\x80" + b"\xff" * 47):
        with pytest.raises(PA.BlsError):
            PK.decompress_pubkey(bad, trusted=True)
        with pytest.raises(JA.BlsError):
            JK.decompress_pubkey(bad, trusted=True)
    off = _off_subgroup_g1_bytes()
    assert PK.decompress_pubkey(off, trusted=True).to_bytes() == \
        JK.decompress_pubkey(off, trusted=True).to_bytes()
    with pytest.raises(PA.BlsError):  # a trusted entry is checked again
        PK.decompress_pubkey(off)
    with pytest.raises(JA.BlsError):
        JK.decompress_pubkey(off)


def test_resolve_keys_and_host_check_match_jax(partition_world):
    msgs, sb, pkb = partition_world
    cols = tuple(pkb)
    cases = [(msgs[0], sb[0], [0]), (msgs[1], sb[0], [1]),
             (msgs[2], sb[2], []), (msgs[3], sb[3], [3, 9])]
    for m, s, mem in cases:
        p_item = pvs.VerifyItem(m, s, member_indices=mem,
                                pubkey_columns=cols)
        j_item = jvs.VerifyItem(m, s, member_indices=mem,
                                pubkey_columns=cols)
        assert pvs.host_check_item(p_item) is jvs.host_check_item(j_item)
    item = pvs.VerifyItem(msgs[0], sb[0], member_indices=[0, 1],
                          pubkey_columns=cols)
    first, again = item.resolve_keys(), item.resolve_keys()
    assert all(a is b for a, b in zip(first, again))  # the process cache
    assert [k.to_bytes() for k in first] == [pkb[0], pkb[1]]
