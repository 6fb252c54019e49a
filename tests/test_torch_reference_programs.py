"""The port's counterparts of the JAX package's reference-only verify
programs (grandine_tpu/tpu/bls.py:251 multi_verify_kernel, :322
grouped_multi_verify_kernel, :636 aggregate_fast_verify_kernel, :527
grouped_multi_verify_msm_packed_kernel) on the CPU, against the JAX
package:

- each program's plain verdict on one seeded batch against the JAX host
  anchor's (`multi_verify`, `Signature.fast_aggregate_verify`), with the
  launches of every kernel wrapper counted by monkeypatched stand-ins that
  forward to the real ones;
- what the reference does and the port must too, pinned by cheap
  stand-ins (shape-only kernels that record their operands): no
  membership check in the first three programs (no `g2_subgroup_check`,
  every row in G2 at the finish) and one in the packed program with
  check_subgroup; the firehose's `slot_pad` against an ∞ aggregate; the
  grouped programs' member ↔ RLC row mapping beside the reference's
  k-major `_flat_km`;
- marked slow: forged and swapped variants against the anchor; marked
  kernel and slow: the JAX programs jitted on the CPU at N ≤ 8 beside the
  plain versions on the same operands (a signature outside G2 included:
  the algebra's verdict on both).

Every comparison is exact (verdicts, canonical words, bits). The batches
are built once a module (`world`); a plain verdict costs ~12 s of one
core, so the tier-1 cases are the five valid-or-pinned verdicts below."""

import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from grandine_tpu.crypto import bls as JA
from grandine_tpu.crypto.constants import R
from grandine_tpu.crypto.hash_to_curve import (
    hash_to_field_fq2, map_to_curve_g2)
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import limbs as JL
from grandine_tpu.tpu import msm as JM
from grandine_tpu_torch import entry as E
from grandine_tpu_torch.crypto import bls as PA
from grandine_tpu_torch.crypto.hash_to_curve import hash_to_g2
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import curve as C
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import msm as M
from grandine_tpu_torch.gpu import pairing as TP

rng = random.Random(0x4EF0)
ROOTS = [b"ref-root-0", b"ref-root-1"]
OWNER = [0, 0, 0, 1, 1]  # message of each signer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world():
    """Five JAX-signed sets over two messages, as host points of both
    packages, their RLC pairs, a point of E2 outside G2 and the [P, −P]
    committee; the batches of the four programs laid out by entry.py."""
    jsk = [JA.SecretKey(rng.randrange(1, R)) for _ in OWNER]
    jsig = [sk.sign(ROOTS[o]) for sk, o in zip(jsk, OWNER)]
    jpk = [sk.public_key() for sk in jsk]
    pk = [PA.g1_from_bytes(k.to_bytes()) for k in jpk]
    sig = [PA.g2_from_bytes(s.to_bytes()) for s in jsig]
    hs = [hash_to_g2(m) for m in ROOTS]
    pairs = [(rng.getrandbits(32), rng.getrandbits(32)) for _ in OWNER]
    members = [[(pk[i], sig[i]) for i in range(3)],
               [(pk[i], sig[i]) for i in range(3, 5)]]
    gpairs = [pairs[:3], pairs[3:]]
    nonsub = map_to_curve_g2(hash_to_field_fq2(b"ng-0", b"SGT", 1)[0])
    jagg = [JA.Signature.aggregate(jsig[:3]), JA.Signature.aggregate(jsig[3:])]
    agg = [PA.g2_from_bytes(a.to_bytes()) for a in jagg]
    w = SimpleNamespace(
        jsk=jsk, jsig=jsig, jpk=jpk, pk=pk, sig=sig, hs=hs, pairs=pairs,
        members=members, gpairs=gpairs, jagg=jagg, agg=agg,
        nonsub=PA.g2_from_bytes(JA.g2_to_bytes(nonsub), subgroup_check=False),
        flat=E.flat_batch(pk, sig, [hs[o] for o in OWNER], pairs, 8),
        grouped=E.grouped_batch(members, hs, gpairs, 2, 4))
    return w


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _packed(grouped):
    """The packed program's operands and keywords: the batch with its
    signatures packed, then the reference's plans (entry.grouped_plans)."""
    g = list(grouped)
    plans, kw = E.grouped_plans(g)
    return (g[:3] + [E.packed_signatures(g[3], g[4])] + g[5:8] + list(plans),
            kw)


def _msm_program(grouped):
    """`grouped_multi_verify_msm_kernel`'s operands and keywords."""
    plans, kw = E.grouped_plans(grouped)
    return list(grouped[:8]) + list(plans), kw


def _firehose(w, pair_slot_pad: bool, bm=4):
    """The two aggregates and an [P, −P] committee with an ∞ signature in
    slot 2, a padding slot or a real one."""
    pair = [w.pk[0], -w.pk[0]]
    fh = list(E.firehose_batch([w.pk[:3], w.pk[3:], pair],
                               w.agg + [PA.Signature.empty().point],
                               w.hs + [w.hs[0]],
                               [w.pairs[0], w.pairs[3], w.pairs[1]], bm, 4))
    fh[3] = np.arange(bm) >= (2 if pair_slot_pad else 3)
    return fh


class _Counts:
    """Counting stand-ins forwarding to every kernel wrapper a program can
    launch (the plain versions count no launches of their own)."""

    WRAPPERS = ((B, "multi_rlc_scale"), (B, "aggregate_rlc_scale"),
                (B, "g1_group_sum"), (B, "rlc_finish"), (B, "unpack_words"),
                (TP, "miller_loop_pairs"), (C, "g2_subgroup_check"),
                (M, "msm_lane_scan"), (M, "msm_bucket_reduce"),
                (M, "msm_horner"))

    def __init__(self, monkeypatch):
        self.n = {name: 0 for _, name in self.WRAPPERS}
        for mod, name in self.WRAPPERS:
            monkeypatch.setattr(mod, name, self._count(name, getattr(mod,
                                                                     name)))

    def _count(self, name, fn):
        def counted(*args, **kwargs):
            self.n[name] += 1
            return fn(*args, **kwargs)
        return counted

    def launched(self):
        return {k for k, v in self.n.items() if v}


def _anchor_sets(w, sigs=None):
    msgs = [ROOTS[o] for o in OWNER]
    return JA.multi_verify(msgs, sigs or w.jsig, w.jpk)


# --- plain verdicts against the JAX host anchor ---------------------------------


def test_multi_verify_kernel_matches_anchor(world, monkeypatch):
    """Five sets padded with three ∞ rows (bucket 8): True, as the JAX
    anchor; multi_rlc_scale, miller_loop_pairs and rlc_finish once each,
    no g2_subgroup_check."""
    counts = _Counts(monkeypatch)
    got = B.multi_verify_kernel(*_t(world.flat))
    assert got.shape == (1,) and got.dtype == torch.uint8
    assert bool(got.item()) is _anchor_sets(world) is True
    assert counts.n == {"multi_rlc_scale": 1, "aggregate_rlc_scale": 0,
                        "g1_group_sum": 0, "rlc_finish": 1,
                        "unpack_words": 0, "miller_loop_pairs": 1,
                        "g2_subgroup_check": 0, "msm_lane_scan": 0,
                        "msm_bucket_reduce": 0, "msm_horner": 0}


def test_grouped_multi_verify_kernel_matches_anchor(world, monkeypatch):
    """Two messages of 3 and 2 signers in (M, K) = (2, 4) slots: True, as
    the anchor; one launch of each of the grouped route's kernels."""
    counts = _Counts(monkeypatch)
    got = B.grouped_multi_verify_kernel(*_t(world.grouped))
    assert bool(got.item()) is _anchor_sets(world) is True
    assert counts.launched() == {"multi_rlc_scale", "g1_group_sum",
                                 "miller_loop_pairs", "rlc_finish"}
    assert set(counts.n.values()) == {0, 1}


def test_firehose_padding_slot_stays_neutral(world, monkeypatch):
    """The [P, −P] committee with an ∞ signature in a padding slot: the
    two real aggregates verify (as the anchor's fast_aggregate_verify) and
    the padding slot changes nothing."""
    counts = _Counts(monkeypatch)
    got = B.aggregate_fast_verify_kernel(*_t(_firehose(world, True)))
    anchor = all(s.fast_aggregate_verify(m, k) for s, m, k in zip(
        world.jagg, ROOTS, [world.jpk[:3], world.jpk[3:]]))
    assert bool(got.item()) is anchor is True
    assert counts.launched() == {"aggregate_rlc_scale", "miller_loop_pairs",
                                 "rlc_finish"}


def test_firehose_real_identity_slot_fails(world):
    """The same committee in a real slot: the batch is False, as the
    anchor rejects [P, −P] with an ∞ signature."""
    got = B.aggregate_fast_verify_kernel(*_t(_firehose(world, False)))
    pair = [world.jpk[0], JA.PublicKey(-world.jpk[0].point)]
    anchor = JA.Signature.empty().fast_aggregate_verify(ROOTS[0], pair)
    assert bool(got.item()) is anchor is False


def test_packed_program_matches_anchor(world, monkeypatch):
    """The grouped batch with its signatures in the packed transfer format,
    the reference's plans and check_subgroup on: True, as the anchor;
    unpack_words and g2_subgroup_check once each, the bucket MSM's three
    kernels once a plane (G1 and G2), one Miller pass and one finish."""
    counts = _Counts(monkeypatch)
    args, kw = _packed(world.grouped)
    got = B.grouped_multi_verify_msm_packed_kernel(*_t(args), **kw,
                                                   check_subgroup=1)
    assert bool(got.item()) is _anchor_sets(world) is True
    assert counts.n == {"multi_rlc_scale": 0, "aggregate_rlc_scale": 0,
                        "g1_group_sum": 0, "rlc_finish": 1,
                        "unpack_words": 1, "miller_loop_pairs": 1,
                        "g2_subgroup_check": 1, "msm_lane_scan": 2,
                        "msm_bucket_reduce": 2, "msm_horner": 2}


def test_grouped_msm_program_matches_anchor(world, monkeypatch):
    """grouped_multi_verify_msm_kernel on the batch and the port's plans
    of its pairs: True, as the anchor; the bucket MSM's three kernels once
    a plane, one Miller pass, one finish, no ladder and no group sum."""
    counts = _Counts(monkeypatch)
    args, kw = _msm_program(world.grouped)
    got = B.grouped_multi_verify_msm_kernel(*_t(args), **kw)
    assert bool(got.item()) is _anchor_sets(world) is True
    assert counts.n == {"multi_rlc_scale": 0, "aggregate_rlc_scale": 0,
                        "g1_group_sum": 0, "rlc_finish": 1,
                        "unpack_words": 0, "miller_loop_pairs": 1,
                        "g2_subgroup_check": 0, "msm_lane_scan": 2,
                        "msm_bucket_reduce": 2, "msm_horner": 2}


# --- the MSM programs on the JAX package's own plans -----------------------------


class _Deferred:
    """Stands in for `miller_loop_pairs` and `rlc_finish` while programs
    run: each call's operands are kept, a placeholder returned (a finish
    returns its case's index), and `verdicts()` evaluates them all at once
    — one plain Miller pass over every pair, one plain finish with one
    group a finish call. The Miller loop is per pair and the finish per
    group, so each case's verdict is its own call's; the cases share one
    batch instead of one final exponentiation each."""

    def __init__(self, monkeypatch):
        self.millers, self.finishes = {}, []

        def miller(gpk, msg, pair_inf):
            out = torch.zeros((gpk.shape[0], 2, 3, 2, 12), dtype=torch.int32)
            self.millers[id(out)] = (out, (gpk, msg, pair_inf))
            return out

        def finish(f, rsig, agg_inf, sig_ok, sig_sub, f_off=None, s_off=None):
            assert f_off is None and s_off is None
            self.finishes.append((self.millers[id(f)][1], rsig, agg_inf,
                                  sig_ok, sig_sub))
            return torch.tensor([len(self.finishes) - 1])

        monkeypatch.setattr(TP, "miller_loop_pairs", miller)
        monkeypatch.setattr(B, "rlc_finish", finish)

    def verdicts(self):
        pairs = [p for p, *_ in self.finishes]
        f = TP.miller_loop_pairs_plain(*(torch.cat(c) for c in zip(*pairs)))
        f_off = np.cumsum([0] + [p[0].shape[0] for p in pairs])
        s_off = np.cumsum([0] + [r.shape[0] for _, r, *_ in self.finishes])
        rest = [torch.cat(c) for c in zip(*(x[1:] for x in self.finishes))]
        return [bool(v) for v in B.rlc_finish_plain(f, *rest, f_off, s_off)]


#: the batch's variants: set 1 forged with set 2's signature; sets 0 and 3
#: swapped across the roots; key 1 at ∞; signature 4 outside G2
_VARIANTS = ("valid", "forged", "swapped", "inf_key", "outside_g2")


def _variant_points(w, variant):
    """(keys, signatures) as host points of the port, and the JAX anchor's
    (keys, signatures) objects, for one variant."""
    from grandine_tpu.crypto.curves import g1_infinity

    pk, sig = list(w.pk), list(w.sig)
    jpk, jsig = list(w.jpk), list(w.jsig)
    if variant == "forged":
        sig[1], jsig[1] = sig[2], jsig[2]
    elif variant == "swapped":
        sig[0], sig[3], jsig[0], jsig[3] = sig[3], sig[0], jsig[3], jsig[0]
    elif variant == "inf_key":
        pk[1] = PA.PublicKey.aggregate([]).point
        jpk[1] = JA.PublicKey(g1_infinity())
    elif variant == "outside_g2":
        sig[4] = w.nonsub
        jsig[4] = JA.Signature(JA.g2_from_bytes(
            PA.g2_to_bytes(w.nonsub), subgroup_check=False))
    return pk, sig, jpk, jsig


@pytest.mark.parametrize("variant", _VARIANTS)
def test_msm_programs_on_the_reference_plans_match_jax(world, monkeypatch,
                                                        variant):
    """grouped_multi_verify_msm_kernel and the packed program fed the plans
    of the JAX package's own planner (grandine_tpu.tpu.msm.plan_msm over
    the k-major pairs and ∞ masks, w = 4; check_subgroup set for the
    signature outside G2) give the JAX host anchor's verdict: True only
    for the valid batch (an ∞ key drops out of the key MSM while its
    signature stays in the signature MSM; the signature outside G2 fails
    the fused check). Both programs' Miller loops and finishes run as one
    deferred batch."""
    deferred = _Deferred(monkeypatch)
    pk, sig, jpk, jsig = _variant_points(world, variant)
    members = [[(pk[i], sig[i]) for i in range(3)],
               [(pk[i], sig[i]) for i in range(3, 5)]]
    grp = E.grouped_batch(members, world.hs, world.gpairs, 2, 4)
    m, k = grp[2].shape
    r = np.asarray(grp[8]).view(np.uint32).astype(np.uint64)
    r = r.transpose(1, 0, 2).reshape(-1, 2)  # k-major
    g1 = JM.plan_msm(r[:, 0], r[:, 1], grp[2].T.reshape(-1),
                     np.arange(m * k) % m, m, window_bits=4, lanes=64)
    g2 = JM.plan_msm(r[:, 0], r[:, 1], grp[5].T.reshape(-1), None, 1,
                     window_bits=4, lanes=64)
    plans = list(g1.arrays) + list(g2.arrays)
    kw = {"g1_windows": g1.windows, "g1_wbits": g1.window_bits,
          "g2_windows": g2.windows, "g2_wbits": g2.window_bits,
          "check_subgroup": int(variant == "outside_g2")}
    cases = [B.grouped_multi_verify_msm_kernel(
                 *_t(list(grp[:8]) + plans), **kw).item(),
             B.grouped_multi_verify_msm_packed_kernel(
                 *_t(_packed(grp)[0][:7] + plans), **kw).item()]
    verdicts = deferred.verdicts()
    anchor = JA.multi_verify([ROOTS[o] for o in OWNER], jsig, jpk)
    assert [verdicts[i] for i in cases] == [anchor] * 2
    assert anchor is (variant == "valid")


# --- what each program must do, pinned with shape-only kernels ----------------


class _Shapes:
    """Shape-only stand-ins for the heavy kernels (verdict 1), recording
    each call's operands; `g2_subgroup_check` stays the real one, counted,
    its masks kept in `sub_masks`."""

    def __init__(self, monkeypatch, rpk_z=1):
        self.calls = {}

        def rec(name, out):
            def fn(*args, **kwargs):
                self.calls.setdefault(name, []).append(args)
                return out(*args)
            return fn

        monkeypatch.setattr(B, "multi_rlc_scale", rec(
            "multi_rlc_scale", lambda sx, sy, idx, *a: (
                torch.full((idx.shape[0], 3, 12), rpk_z, dtype=torch.int32),
                torch.zeros((idx.shape[0], 3, 2, 12), dtype=torch.int32))))
        monkeypatch.setattr(B, "aggregate_rlc_scale", rec(
            "aggregate_rlc_scale", lambda sx, sy, idx, cnt, *a: (
                torch.zeros((idx.shape[0], 3, 12), dtype=torch.int32),
                cnt == 0,
                torch.zeros((idx.shape[0], 3, 2, 12), dtype=torch.int32))))
        monkeypatch.setattr(B, "g1_group_sum", rec(
            "g1_group_sum", lambda rows, off: torch.ones(
                (len(off) - 1, 3, 12), dtype=torch.int32)))
        monkeypatch.setattr(TP, "miller_loop_pairs", rec(
            "miller_loop_pairs", lambda rpk, msg, inf: torch.zeros(
                (rpk.shape[0], 2, 3, 2, 12), dtype=torch.int32)))
        monkeypatch.setattr(B, "rlc_finish", rec(
            "rlc_finish", lambda *a: torch.ones((1,), dtype=torch.uint8)))
        monkeypatch.setattr(M, "msm_bucket_sum", rec(
            "msm_bucket_sum", lambda px, py, live, plan: torch.ones(
                (plan.n_groups, 3) + tuple(px.shape[1:]), dtype=torch.int32)))
        sub = C.g2_subgroup_check
        self.sub_masks = []
        monkeypatch.setattr(C, "g2_subgroup_check", rec(
            "g2_subgroup_check",
            lambda *a: self.sub_masks.append(sub(*a)) or self.sub_masks[-1]))

    def finish(self):
        (args,), = [self.calls["rlc_finish"]]
        return args


@pytest.mark.parametrize("program", ["flat", "grouped", "firehose", "packed",
                                     "packed_checked"])
def test_membership_check_only_where_the_reference_runs_it(
        world, monkeypatch, program):
    """A signature outside G2 (set 4): the first three programs and the
    packed one without check_subgroup launch no g2_subgroup_check and hand
    the finish every row as a member of G2 — their verdict is the
    algebra's; the packed program with check_subgroup runs it once, its
    mask flags exactly that row (member (1, 1), row 1·M + 1 of the plans'
    k-major order) and the finish sees the one folded signature row
    False."""
    shapes = _Shapes(monkeypatch)
    w = world
    sig = list(w.sig)
    sig[4] = w.nonsub
    if program == "flat":
        B.multi_verify_kernel(*_t(E.flat_batch(
            w.pk, sig, [w.hs[o] for o in OWNER], w.pairs, 8)))
        bad_row = 4
    elif program == "firehose":
        fh = list(E.firehose_batch([w.pk[:3], w.pk[3:]],
                                   [w.agg[0], w.nonsub], w.hs,
                                   [w.pairs[0], w.pairs[3]], 4, 4))
        B.aggregate_fast_verify_kernel(*_t(fh))
        bad_row = 1
    else:
        members = [[(w.pk[i], sig[i]) for i in range(3)],
                   [(w.pk[i], sig[i]) for i in range(3, 5)]]
        grp = E.grouped_batch(members, w.hs, w.gpairs, 2, 4)
        bad_row = 1 * 4 + 1  # member (1, 1), row-major
        if program == "grouped":
            B.grouped_multi_verify_kernel(*_t(grp))
        else:
            bad_row = 1 * 2 + 1  # k-major
            args, kw = _packed(grp)
            B.grouped_multi_verify_msm_packed_kernel(
                *_t(args), **kw,
                check_subgroup=int(program == "packed_checked"))
    f, rsig, agg_inf, sig_ok, sig_sub = shapes.finish()[:5]
    assert sig_ok.all()
    if program == "packed_checked":
        (mask,) = shapes.sub_masks
        assert (~mask).nonzero().flatten().tolist() == [bad_row]
        assert sig_sub.tolist() == [False]
    else:
        assert "g2_subgroup_check" not in shapes.calls
        assert sig_sub.all()


def test_grouped_rlc_rows_follow_the_members(world, monkeypatch):
    """Member (m, k) is row m·K + k of the port's ladders, with its key and
    its own RLC pair; the reference's k-major `_flat_km` gives the same
    member the same (M, K, 64) r_bits row. ∞ members reach the group sum
    with Z = 0 (their term is ∞)."""
    shapes = _Shapes(monkeypatch)
    grp = world.grouped
    B.grouped_multi_verify_kernel(*_t(grp))
    (src_x, _sy, idx, _sx, _sy2, _mask, r01), = shapes.calls["multi_rlc_scale"]
    m, k = grp[2].shape
    for mm in range(m):
        for kk in range(k):
            row = int(idx[mm * k + kk])
            assert torch.equal(src_x[row], torch.from_numpy(grp[0][mm, kk]))
            assert r01[mm * k + kk].tolist() == grp[8][mm, kk].tolist()
    bits = np.stack([B.rlc_bits_host([tuple(int(v) & 0xFFFFFFFF
                                            for v in grp[8][mm, kk])])[0]
                     for mm in range(m) for kk in range(k)]).reshape(m, k, 64)
    flat = np.asarray(JB._flat_km(bits, m, k))
    for mm in range(m):
        for kk in range(k):
            assert flat[kk * m + mm].tolist() == bits[mm, kk].tolist()
    (rows, off), = shapes.calls["g1_group_sum"]
    assert list(off) == [0, k, 2 * k]
    z_zero = (rows[:, 2] == 0).all(-1)
    assert z_zero.tolist() == grp[2].reshape(-1).tolist()


def test_firehose_slot_pad_against_infinite_aggregates(world, monkeypatch):
    """A real slot whose members sum to ∞ reaches the finish as a rejecting
    flag, a padding slot's does not; both mask their pairing. Live members
    gather first, in order, whatever the padding pattern."""
    shapes = _Shapes(monkeypatch)
    w = world
    fh = list(E.firehose_batch([w.pk[:3], w.pk[3:], []],
                               w.agg + [PA.Signature.empty().point],
                               w.hs + [w.hs[0]], w.pairs[:3], 4, 4))
    fh[2] = fh[2].copy()
    fh[2][0] = [True, False, False, True]  # a hole before live members
    fh[3] = np.array([False, False, False, True])
    B.aggregate_fast_verify_kernel(*_t(fh))
    (_sx, _sy, idx, cnt, *_), = shapes.calls["aggregate_rlc_scale"]
    assert cnt.tolist() == [2, 2, 0, 0]
    assert idx[0, :2].tolist() == [1, 2] and idx[1, :2].tolist() == [4, 5]
    (_rpk, _msg, pair_inf), = shapes.calls["miller_loop_pairs"]
    assert pair_inf.tolist() == [False, False, True, True]
    agg_flag = shapes.finish()[2]
    assert agg_flag.tolist() == [False, False, True, False]


def test_programs_reject_wrong_shapes(world):
    flat = _t(world.flat)
    with pytest.raises(ValueError, match="multi_verify_kernel"):
        B.multi_verify_kernel(*flat[:-1], flat[-1][:4])
    grp = _t(world.grouped)
    with pytest.raises(ValueError, match="grouped_multi_verify_kernel"):
        B.grouped_multi_verify_kernel(*grp[:6], grp[6][:1], *grp[7:])
    args, kw = _packed(world.grouped)
    pk = _t(args)
    with pytest.raises(ValueError, match="packed"):
        B.grouped_multi_verify_msm_packed_kernel(*pk[:3], pk[3][..., :12],
                                                 *pk[4:], **kw)
    with pytest.raises(ValueError, match="ten plan arrays"):
        B.grouped_multi_verify_msm_packed_kernel(*pk[:-1], **kw)


# --- forged and swapped, against the anchor (slow) -----------------------------


@pytest.mark.slow
@pytest.mark.parametrize("program", ["flat", "grouped", "packed"])
@pytest.mark.parametrize("variant", ["forged", "swapped"])
def test_bad_batches_match_anchor(world, program, variant):
    """Set 1 signed with set 2's signature (forged), or sets 0 and 3
    swapped across messages: False on every program, as the anchor."""
    w = world
    jsig, sig = list(w.jsig), list(w.sig)
    if variant == "forged":
        jsig[1], sig[1] = jsig[2], sig[2]
    else:
        jsig[0], jsig[3] = jsig[3], jsig[0]
        sig[0], sig[3] = sig[3], sig[0]
    if program == "flat":
        got = B.multi_verify_kernel(*_t(E.flat_batch(
            w.pk, sig, [w.hs[o] for o in OWNER], w.pairs, 8)))
    else:
        members = [[(w.pk[i], sig[i]) for i in range(3)],
                   [(w.pk[i], sig[i]) for i in range(3, 5)]]
        grp = E.grouped_batch(members, w.hs, w.gpairs, 2, 4)
        if program == "grouped":
            got = B.grouped_multi_verify_kernel(*_t(grp))
        else:
            args, kw = _packed(grp)
            got = B.grouped_multi_verify_msm_packed_kernel(
                *_t(args), **kw, check_subgroup=1)
    assert bool(got.item()) is _anchor_sets(w, jsig) is False


# --- against the JAX programs themselves --------------------------------------


def _jfp(words):
    """(…, 12) canonical words → (…, 26) JAX Montgomery limbs."""
    a = np.asarray(words)
    ints = L.words_to_ints(a)
    return np.stack([JL.to_mont(v) for v in ints]).reshape(
        a.shape[:-1] + (JL.NLIMBS,)).astype(np.int32)


def _jbits(r01):
    """(…, 2) RLC halves → (…, 64) r_bits rows (rlc_bits_host)."""
    a = np.asarray(r01).view(np.uint32).astype(np.int64)
    flat = [tuple(int(v) for v in p) for p in a.reshape(-1, 2)]
    return JB.rlc_bits_host(flat, len(flat)).reshape(a.shape[:-1] + (64,))


@pytest.mark.kernel
@pytest.mark.slow
def test_flat_program_matches_jax_kernel_outside_g2(world):
    """multi_verify_kernel jitted on the CPU at N = 8 with set 4's signature
    outside G2, and the port's plain program on the same operands: the
    same verdict (the algebra's, no membership check in either)."""
    w = world
    sig = list(w.sig)
    sig[4] = w.nonsub
    fl = E.flat_batch(w.pk, sig, [w.hs[o] for o in OWNER], w.pairs, 8)
    pk_x, pk_y, pk_inf, sx, sy, sinf, msg, minf, r01 = fl
    want = jax.jit(JB.multi_verify_kernel)(
        _jfp(pk_x), _jfp(pk_y), pk_inf, _jfp(sx), _jfp(sy), sinf,
        _jfp(msg[:, 0]), _jfp(msg[:, 1]), minf, _jbits(r01))
    got = B.multi_verify_kernel(*_t(fl))
    assert bool(got.item()) is bool(want) is False


def _jax_grouped(grp):
    pk_x, pk_y, pk_inf, sx, sy, sinf, msg, minf, r01 = grp
    return (_jfp(pk_x), _jfp(pk_y), pk_inf, _jfp(sx), _jfp(sy), sinf,
            _jfp(msg[:, 0]), _jfp(msg[:, 1]), minf)


@pytest.mark.kernel
@pytest.mark.slow
def test_grouped_program_matches_jax_kernel(world):
    """grouped_multi_verify_kernel jitted at (M, K) = (2, 4) with the same
    (M, K, 64) r_bits rows, valid and with one forged member."""
    w = world
    fn = jax.jit(JB.grouped_multi_verify_kernel)
    for forged in (False, True):
        members = [list(g) for g in w.members]
        if forged:
            members[0][1] = (members[0][1][0], members[0][2][1])
        grp = E.grouped_batch(members, w.hs, w.gpairs, 2, 4)
        want = bool(fn(*_jax_grouped(grp), _jbits(grp[8])))
        got = bool(B.grouped_multi_verify_kernel(*_t(grp)).item())
        assert got is want is (not forged)


@pytest.mark.kernel
@pytest.mark.slow
def test_firehose_program_matches_jax_kernel(world):
    """aggregate_fast_verify_kernel jitted at (M, K) = (4, 4) with the
    [P, −P] committee in a padding slot (True) and in a real slot (False)."""
    fn = jax.jit(JB.aggregate_fast_verify_kernel)
    for pad in (True, False):
        fh = _firehose(world, pad)
        mx, my, minf_m, slot_pad, sx, sy, sinf, msg, minf, r01 = fh
        want = bool(fn(_jfp(mx), _jfp(my), minf_m, slot_pad, _jfp(sx),
                       _jfp(sy), sinf, _jfp(msg[:, 0]), _jfp(msg[:, 1]), minf,
                       _jbits(r01)))
        got = bool(B.aggregate_fast_verify_kernel(*_t(fh)).item())
        assert got is want is pad


@pytest.mark.kernel
@pytest.mark.slow
def test_packed_program_matches_jax_kernel(world):
    """grouped_multi_verify_msm_packed_kernel jitted with check_subgroup
    and its MSM plans over the same RLC pairs (k-major: point f = k·M + m
    is member (m, k)), valid and with a signature outside G2; the port's
    packed program on the same words and the same plan arrays."""
    import functools

    w = world
    for outside in (False, True):
        sig = list(w.sig)
        if outside:
            sig[4] = w.nonsub
        members = [[(w.pk[i], sig[i]) for i in range(3)],
                   [(w.pk[i], sig[i]) for i in range(3, 5)]]
        grp = E.grouped_batch(members, w.hs, w.gpairs, 2, 4)
        m, k = grp[2].shape
        r = np.asarray(grp[8]).view(np.uint32).astype(np.uint64)
        r_lo = r[..., 0].T.reshape(-1)  # k-major
        r_hi = r[..., 1].T.reshape(-1)
        g1 = JM.plan_msm(r_lo, r_hi, grp[2].T.reshape(-1),
                         np.arange(m * k) % m, m, window_bits=4, lanes=64)
        g2 = JM.plan_msm(r_lo, r_hi, grp[5].T.reshape(-1), None, 1,
                         window_bits=6, lanes=64)
        words = E.packed_signatures(grp[3], grp[4]).view(np.uint32)
        jg = _jax_grouped(grp)
        fn = jax.jit(functools.partial(
            JB.grouped_multi_verify_msm_packed_kernel,
            g1_windows=g1.windows, g1_wbits=g1.window_bits,
            g2_windows=g2.windows, g2_wbits=g2.window_bits,
            check_subgroup=1))
        want = bool(fn(*jg[:3], words, jg[5], *jg[6:], *g1.arrays,
                       *g2.arrays))
        args = _packed(grp)[0][:7] + list(g1.arrays) + list(g2.arrays)
        got = bool(B.grouped_multi_verify_msm_packed_kernel(
            *_t(args), g1_windows=g1.windows, g1_wbits=g1.window_bits,
            g2_windows=g2.windows, g2_wbits=g2.window_bits,
            check_subgroup=1).item())
        assert got is want is (not outside)
