"""The port's EIP-4844 blob-KZG plane (grandine_tpu_torch/kzg/) against the
JAX package's (grandine_tpu/kzg/) on the CPU: Fr helpers, the trusted
setup, the six public calls at width 8 with device="cpu" (the kernels'
plain versions) and KzgDeviceBackend, with inputs made from a seed with
numpy. The reference runs its host path (USE_DEVICE_MSM / USE_DEVICE_KZG
monkeypatched off, the package itself untouched); bytes and verdicts must
be identical.

The plain device path of one batch verify costs ~12 s on one core (the
plain Miller loop and final exponentiation), so four verdicts run it
(valid, forged, tampered, ∞ proof) and the other cases are held at the
prepare/pack level and on the port's host tail. The `kernel`+`slow` test
holds the plain path against the JAX programs kzg_msm and
kzg_blob_verify (outside tier-1)."""

import hashlib
import os

import numpy as np
import pytest
import torch

from grandine_tpu.kzg import eip4844 as RK
from grandine_tpu.kzg import fr as RF
from grandine_tpu.kzg import setup as RS
from grandine_tpu.tpu import limbs as RL
from grandine_tpu_torch.gpu import kzg as GK
from grandine_tpu_torch.gpu import limbs as L
from grandine_tpu_torch.gpu import schemes
from grandine_tpu_torch.kzg import eip4844 as K
from grandine_tpu_torch.kzg import fr as PF
from grandine_tpu_torch.kzg import setup as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 8
R = PF.BLS_MODULUS


@pytest.fixture(autouse=True)
def reference_host_path(monkeypatch):
    monkeypatch.setattr(RK, "USE_DEVICE_MSM", False)
    monkeypatch.setattr(RK, "USE_DEVICE_KZG", False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # the plain field ops are many tiny tensor ops: threads only add overhead
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def g1_ints(pt):
    aff = pt.to_affine()
    return None if aff is None else (aff[0].n, aff[1].n)


def g2_ints(pt):
    aff = pt.to_affine()
    return None if aff is None else tuple((c.c0.n, c.c1.n) for c in aff)


def blob_of(values) -> bytes:
    return b"".join(int(v % R).to_bytes(32, "big") for v in values)


class Item:
    """Scheduler-geometry item: blob in the message slot, commitment as
    the single public key, proof in the signature slot."""

    def __init__(self, blob, commitment, proof, keys=None):
        self.message = blob
        self.public_keys = (commitment,) if keys is None else keys
        self.signature = proof


@pytest.fixture(scope="module")
def world():
    """Three seeded blobs and the zero blob at width 8, committed and
    proved by the port on the plain versions and by the reference."""
    setup, ref_setup = PS.dev_setup(WIDTH), RS.dev_setup(WIDTH)
    rng = np.random.default_rng(0x4844)
    blobs = [blob_of(int.from_bytes(rng.bytes(31), "big")
                     for _ in range(WIDTH)) for _ in range(3)]
    blobs.append(bytes(32 * WIDTH))
    flags = RK.USE_DEVICE_MSM, RK.USE_DEVICE_KZG
    RK.USE_DEVICE_MSM = RK.USE_DEVICE_KZG = False
    try:
        ref_c = [RK.blob_to_kzg_commitment(b, ref_setup) for b in blobs]
        ref_p = [RK.compute_blob_kzg_proof(b, c, ref_setup)
                 for b, c in zip(blobs, ref_c)]
    finally:
        RK.USE_DEVICE_MSM, RK.USE_DEVICE_KZG = flags
    comms = [K.blob_to_kzg_commitment(b, setup, device="cpu") for b in blobs]
    proofs = [K.compute_blob_kzg_proof(b, c, setup, device="cpu")
              for b, c in zip(blobs, comms)]
    return dict(setup=setup, ref_setup=ref_setup, blobs=blobs, comms=comms,
                proofs=proofs, ref_c=ref_c, ref_p=ref_p)


# --------------------------------------------------------------------- fr


def _fr_case(which, rng):
    if which == "roots":
        return [f.compute_roots_of_unity(n) for f in (PF, RF)
                for n in (1, 2, 8, 64)]
    if which == "bit_reversal":
        vals = [int(v) for v in rng.integers(0, 2**62, 64)]
        return [f.bit_reversal_permutation(vals[:n]) for f in (PF, RF)
                for n in (1, 2, 8, 64)]
    if which == "batch_inverse":
        vals = [int.from_bytes(rng.bytes(31), "big") for _ in range(40)]
        vals[3] = vals[17] = 0
        return [f.batch_inverse(vals) for f in (PF, RF)]
    roots = PF.bit_reversal_permutation(PF.compute_roots_of_unity(64))
    evals = [int.from_bytes(rng.bytes(31), "big") % R for _ in range(64)]
    z = (int.from_bytes(rng.bytes(32), "big") % R if which == "barycentric"
         else roots[11])
    return [f.evaluate_polynomial_in_evaluation_form(evals, z, roots)
            for f in (PF, RF)]


@pytest.mark.parametrize("which", ["roots", "bit_reversal", "batch_inverse",
                                   "barycentric", "z_at_root"])
def test_fr_equals_reference(which):
    out = _fr_case(which, np.random.default_rng(11))
    half = len(out) // 2
    assert out[:half] == out[half:]


# ------------------------------------------------------------------- setup


@pytest.mark.parametrize("n", [8, 16])
def test_dev_setup_equals_reference(n):
    port, ref = PS.dev_setup(n), RS.dev_setup(n)
    assert [g1_ints(p) for p in port.g1_lagrange_brp] == \
        [g1_ints(p) for p in ref.g1_lagrange_brp]
    assert [g2_ints(q) for q in port.g2_monomial] == \
        [g2_ints(q) for q in ref.g2_monomial]
    assert port.roots_brp == ref.roots_brp and port.name == ref.name


def test_ceremony_file_is_a_byte_identical_copy():
    digests = []
    for pkg in ("grandine_tpu", "grandine_tpu_torch"):
        with open(os.path.join(ROOT, pkg, "kzg", "data",
                               "trusted_setup.txt"), "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    assert digests[0] == digests[1]
    assert os.path.dirname(PS._OFFICIAL_TXT) == os.path.join(
        ROOT, "grandine_tpu_torch", "kzg", "data")


def test_official_setup_equals_reference():
    port, ref = PS.official_setup(), RS.official_setup()
    assert port.width == ref.width == 4096
    assert [g1_ints(p) for p in port.g1_lagrange_brp] == \
        [g1_ints(p) for p in ref.g1_lagrange_brp]
    assert [g2_ints(q) for q in port.g2_monomial] == \
        [g2_ints(q) for q in ref.g2_monomial[:2]]
    assert port.roots_brp == ref.roots_brp


def test_from_arrays_round_trips_and_equals_reference():
    """A dev setup's points through the cache layout and back: the same
    setup; the reference's setup from the same arrays: the same points."""
    from grandine_tpu_torch.crypto import bls as A

    dev = PS.dev_setup(16)
    natural = PF.bit_reversal_permutation(dev.g1_lagrange_brp)
    g1_xy = np.array([[np.frombuffer(v.to_bytes(48, "big"), np.uint8)
                       for v in g1_ints(p)] for p in natural])
    g2 = np.stack([np.frombuffer(A.g2_to_bytes(q), np.uint8)
                   for q in dev.g2_monomial])
    same = PS.TrustedSetup.from_arrays(g1_xy, g2, "arrays")
    assert [g1_ints(p) for p in same.g1_lagrange_brp] == \
        [g1_ints(p) for p in dev.g1_lagrange_brp]
    assert [g2_ints(q) for q in same.g2_monomial] == \
        [g2_ints(q) for q in dev.g2_monomial]
    g1_xy[5] = 0  # an ∞ Lagrange point
    port = PS.TrustedSetup.from_arrays(g1_xy, g2, "arrays")
    # the reference's setup built from the same arrays by its own loaders
    ref_pts = [RS._g1_from_affine(int.from_bytes(r[0].tobytes(), "big"),
                                  int.from_bytes(r[1].tobytes(), "big"))
               if r.any() else RS.g1_infinity() for r in g1_xy]
    ref = RS.TrustedSetup(RF.bit_reversal_permutation(ref_pts),
                          [RS._g2_from_bytes_unchecked(b.tobytes())
                           for b in g2], "arrays")
    assert [g1_ints(p) for p in port.g1_lagrange_brp] == \
        [g1_ints(p) for p in ref.g1_lagrange_brp]
    assert g1_ints(port.g1_lagrange_brp[PF.bit_reversal_permutation(
        list(range(16))).index(5)]) is None
    assert [g2_ints(q) for q in port.g2_monomial] == \
        [g2_ints(q) for q in ref.g2_monomial]


# ------------------------------------------------------------ the six calls


def test_commitments_and_blob_proofs_equal_reference(world):
    assert world["comms"] == world["ref_c"]
    assert world["proofs"] == world["ref_p"]
    assert world["comms"][3] == world["proofs"][3] == K.G1_POINT_AT_INFINITY


@pytest.mark.parametrize("at_root", [False, True])
def test_compute_kzg_proof_equals_reference(world, at_root):
    setup = world["setup"]
    z = (setup.roots_brp[5] if at_root
         else int.from_bytes(np.random.default_rng(9).bytes(32), "big") % R)
    zb = z.to_bytes(32, "big")
    got = K.compute_kzg_proof(world["blobs"][0], zb, setup, device="cpu")
    assert got == RK.compute_kzg_proof(world["blobs"][0], zb,
                                       world["ref_setup"])
    if at_root:
        assert got[1] == world["blobs"][0][5 * 32:6 * 32]


def test_constant_blob_commits_to_scaled_generator():
    from grandine_tpu_torch.crypto import bls as A
    from grandine_tpu_torch.crypto.curves import G1

    c = 0x1234_5678
    got = K.blob_to_kzg_commitment(blob_of([c] * WIDTH), PS.dev_setup(WIDTH),
                                   device="cpu")
    assert got == A.g1_to_bytes(G1.mul(c))


def test_verify_kzg_proof_equals_reference(world):
    setup, ref_setup = world["setup"], world["ref_setup"]
    blob, c = world["blobs"][1], world["comms"][1]
    zb = (0xDEADBEEF).to_bytes(32, "big")
    proof, y = RK.compute_kzg_proof(blob, zb, ref_setup)
    bad_y = ((int.from_bytes(y, "big") + 1) % R).to_bytes(32, "big")
    for yy, want in ((y, True), (bad_y, False)):
        assert K.verify_kzg_proof(c, zb, yy, proof, setup) is want
        assert RK.verify_kzg_proof(c, zb, yy, proof, ref_setup) is want


def test_verify_blob_kzg_proof_equals_reference(world):
    blobs, comms, proofs = world["blobs"], world["comms"], world["proofs"]
    for p, want in ((proofs[0], True), (proofs[1], False)):
        assert K.verify_blob_kzg_proof(blobs[0], comms[0], p,
                                       world["setup"]) is want
        assert RK.verify_blob_kzg_proof(blobs[0], comms[0], p,
                                        world["ref_setup"]) is want


ERRORS = {
    "field element out of range": lambda m, s, w: m.blob_to_kzg_commitment(
        (R + 1).to_bytes(32, "big") + w["blobs"][0][32:], s),
    "blob of the wrong length": lambda m, s, w: m.compute_blob_kzg_proof(
        w["blobs"][0][:-32], w["comms"][0], s),
    "commitment not on the curve": lambda m, s, w: m.verify_blob_kzg_proof(
        w["blobs"][0], bytes([0x80]) + b"\x11" * 47, w["proofs"][0], s),
    "z out of range": lambda m, s, w: m.compute_kzg_proof(
        w["blobs"][0], R.to_bytes(32, "big"), s),
    "batch length mismatch": lambda m, s, w: m.verify_blob_kzg_proof_batch(
        w["blobs"][:2], w["comms"][:2], w["proofs"][:1], s),
    "batch with a blob of another width": lambda m, s, w:
        m.verify_blob_kzg_proof_batch(
            [w["blobs"][0], w["blobs"][1] * 2], w["comms"][:2],
            w["proofs"][:2], s),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_equal_reference(world, case):
    for mod, setup in ((K, world["setup"]), (RK, world["ref_setup"])):
        with pytest.raises(mod.KzgError):
            ERRORS[case](mod, setup, world)


# ------------------------------------------------- batches and the backend


def _batch(world, kind):
    """(blobs, commitments, proofs) of a named batch."""
    blobs, comms, proofs = (list(world[k][:3]) for k in
                            ("blobs", "comms", "proofs"))
    if kind == "forged":
        proofs[1] = proofs[2]
    elif kind == "tampered":
        blobs[2] = blobs[2][:40] + bytes([blobs[2][40] ^ 1]) + blobs[2][41:]
    elif kind == "infinity":
        blobs[1], comms[1], proofs[1] = (world[k][3] for k in
                                         ("blobs", "comms", "proofs"))
    elif kind == "n1":
        blobs, comms, proofs = blobs[:1], comms[:1], proofs[:1]
    return blobs, comms, proofs


WANT = {"valid": True, "forged": False, "tampered": False, "infinity": True,
        "n1": True}


@pytest.mark.parametrize("kind", sorted(WANT))
def test_host_batch_tail_equals_reference(world, kind):
    blobs, comms, proofs = _batch(world, kind)
    ref = RK.verify_blob_kzg_proof_batch(blobs, comms, proofs,
                                         world["ref_setup"])
    assert ref is WANT[kind]
    if kind == "n1":  # the single-verify equation, on the host in both
        got = K.verify_blob_kzg_proof_batch(blobs, comms, proofs,
                                            world["setup"], device="cpu")
    else:
        got = K._batch_pairing_host(world["setup"], *K._batch_inputs(
            blobs, comms, proofs, world["setup"]))
    assert got is ref


@pytest.mark.parametrize("kind", ["valid", "tampered"])
def test_batch_call_on_the_plain_versions(world, kind):
    blobs, comms, proofs = _batch(world, kind)
    assert K.verify_blob_kzg_proof_batch(blobs, comms, proofs, world["setup"],
                                         device="cpu") is WANT[kind]


class Tracer:
    def __init__(self):
        self.spans = []

    def span(self, name, attrs):
        import contextlib

        self.spans.append((name, attrs))
        return contextlib.nullcontext()


@pytest.mark.parametrize("kind", ["forged", "infinity"])
def test_backend_through_the_scheme_row(world, kind):
    row = schemes.get("blob_kzg")
    assert row.async_seam == K.KzgDeviceBackend.ASYNC_SEAM
    backend = row.make_backend(device="cpu")
    backend.tracer = Tracer()
    items = [Item(*t) for t in zip(*_batch(world, kind))]
    status, prep = backend.prepare(items)
    assert status == "ok"
    got = getattr(backend, row.async_seam[0])(prep)()
    assert got is WANT[kind]
    assert backend.tracer.spans == [("device_dispatch", {
        "kernel": "kzg_blob_verify", "lane": "blob_kzg"})]


def test_prepare_statuses_equal_reference(world):
    blobs, comms, proofs = (world[k] for k in ("blobs", "comms", "proofs"))
    cases = {
        "ok": [Item(b, c, p) for b, c, p in zip(blobs, comms, proofs)],
        "empty": [],
        "invalid commitment": [Item(blobs[0], b"\x00" * 48, proofs[0])],
        "invalid key count": [Item(blobs[0], None, proofs[0],
                                   keys=(comms[0], comms[1]))],
        "invalid width": [Item(blobs[0][:96], comms[0], proofs[0])] * 2,
        "invalid ragged blob": [Item(blobs[0][:-1], comms[0], proofs[0])],
        "invalid field element": [Item(b"\xff" * 32 + blobs[0][32:],
                                       comms[0], proofs[0])],
        "mixed": [Item(blobs[0], comms[0], proofs[0]),
                  Item(blobs[1] * 2, comms[1], proofs[1])],
        "oversize": [Item(blobs[0], comms[0], proofs[0])] * 9,
    }
    port, ref = K.KzgDeviceBackend(device="cpu"), RK.KzgDeviceBackend()
    for name, items in cases.items():
        got, want = port.prepare(items)[0], ref.prepare(items)[0]
        assert got == want == {"empty": "ok"}.get(name, name.split()[0]), \
            name


@pytest.mark.parametrize("kind", ["valid", "forged", "infinity"])
def test_pack_equals_reference(world, kind):
    blobs, comms, proofs = _batch(world, kind)
    _, prep = K.KzgDeviceBackend(device="cpu").prepare_raw(
        blobs, comms, proofs, world["setup"])
    _, ref = RK.KzgDeviceBackend().prepare_raw(blobs, comms, proofs,
                                               world["ref_setup"])
    px, py, pinf, k, _setup, n = prep
    rpx, rpy, rpinf, rbits, _q2x, _q2y, rn = ref
    assert n == rn and px.shape[0] == rpx.shape[0] == 16
    assert pinf.tolist() == np.asarray(rpinf).tolist()
    got_pts = [(L.words_to_ints(px[i])[0], L.words_to_ints(py[i])[0])
               for i in range(16) if not pinf[i]]
    want_pts = [(RL.from_mont(rpx[i]), RL.from_mont(rpy[i]))
                for i in range(16) if not rpinf[i]]
    assert got_pts == want_pts
    got_k = [int.from_bytes(k[i].tobytes(), "little") for i in range(16)]
    want_k = [int("".join(map(str, row)), 2) for row in np.asarray(rbits)]
    assert got_k == want_k


@pytest.mark.parametrize("kind", ["forged", "valid"])
def test_host_check_item_equals_reference(world, kind):
    blobs, comms, proofs = _batch(world, kind)
    item = Item(blobs[1], comms[1], proofs[1])
    assert K.host_check_item(item) is RK.host_check_item(item) \
        is (kind == "valid")
    assert schemes.get("blob_kzg").host_check(item) is (kind == "valid")


# -------------------------------------------------- no silent fallback


def test_a_kernel_error_raises_and_never_falls_back(world, monkeypatch):
    def broken(*args):
        raise RuntimeError("g1_scalar_mul failed to launch")

    monkeypatch.setattr(GK, "g1_scalar_mul", broken)
    with pytest.raises(RuntimeError, match="g1_scalar_mul"):
        K.blob_to_kzg_commitment(world["blobs"][0], world["setup"],
                                 device="cpu")
    backend = K.KzgDeviceBackend(device="cpu")
    _, prep = backend.prepare_raw(*_batch(world, "valid"), world["setup"])
    with pytest.raises(RuntimeError, match="g1_scalar_mul"):
        backend.verify_blobs_async(prep)


def test_scalars_at_or_above_r_are_refused():
    px = torch.zeros((2, 12), dtype=torch.int32)
    for bad in (R, 2**256 - 1):
        k = torch.from_numpy(GK.scalar_words([1, bad]))
        with pytest.raises(ValueError, match="below r"):
            GK.g1_scalar_mul(px, px, torch.ones(2, dtype=torch.bool), k)


# ------------------------------------- the plain path against the JAX programs


@pytest.mark.kernel
@pytest.mark.slow
def test_plain_path_equals_jax_programs(world, monkeypatch):
    """kzg_msm and kzg_blob_verify (jitted on the CPU) at width 8, bucket 4,
    against the port's plain versions."""
    monkeypatch.setattr(RK, "USE_DEVICE_MSM", True)
    rng = np.random.default_rng(5)
    scalars = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(WIDTH)]
    scalars[2] = 0
    got = K._g1_lincomb(world["setup"], scalars, "cpu")
    want = RK._msm_device(world["ref_setup"], scalars)
    assert g1_ints(got) == g1_ints(want)
    port, ref = K.KzgDeviceBackend(device="cpu"), RK.KzgDeviceBackend()
    for kind in ("valid", "forged"):
        batch = _batch(world, kind)
        v_port = port.verify_blobs_async(
            port.prepare_raw(*batch, world["setup"])[1])()
        v_ref = ref.verify_blobs_async(
            ref.prepare_raw(*batch, world["ref_setup"])[1])()
        assert v_port is v_ref is WANT[kind]
