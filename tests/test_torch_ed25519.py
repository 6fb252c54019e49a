"""The port's Ed25519 plane on the CPU against the JAX package, exact: the
host twin (crypto/ed25519.py) against grandine_tpu.crypto.ed25519 on every
verdict class; the plain field product, add and sub against Python ints
and the JAX plane's montmul/from_mont; the plain unified addition against
the JAX ed_add and the host point_add; `Ed25519Backend.prepare` against
the JAX backend's under one deterministic rng; the plain `ed25519_verify`
at bucket 8 against the host twin's AND; the JAX verify program against
the plain version (marked kernel and slow: the JAX compile is heavy); and
the wrapper's refusals — a bad shape, a scalar ≥ 2²⁵³, a kernel that fails
to launch or build raises, and is never swapped for the plain version.
Inputs are made from seeds; tolerance is exact equality of canonical
values, points and verdicts. The kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py and chip_smoke.py."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.crypto import ed25519 as JE
from grandine_tpu.tpu import ed25519 as DE
from grandine_tpu.tpu.ed25519 import Ed25519Backend as JaxEd25519Backend
from grandine_tpu_torch.crypto import ed25519 as HE
from grandine_tpu_torch.gpu import ed25519 as E

P = HE.P

# RFC 8032 test-vector secret keys (TEST 1 / TEST 3)
SK1 = bytes.fromhex(
    "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
SK3 = bytes.fromhex(
    "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7")
MSG3 = bytes.fromhex("af82")


class Item:
    """Scheduler-geometry item: (message, signature, public_keys)."""

    def __init__(self, pk: bytes, msg: bytes, sig: bytes) -> None:
        self.public_keys = (pk,)
        self.message = msg
        self.signature = sig


class FixedRng:
    """Deterministic stand-in for the backends' RLC-coefficient rng."""

    def __init__(self, seed: int = 7) -> None:
        self._r = np.random.default_rng(seed)

    def randbits(self, n: int) -> int:
        return int.from_bytes(self._r.bytes(n // 8), "little")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _torsion_signature(sk: bytes, msg: bytes):
    """A signature whose R carries a 2-torsion component: accepted by
    cofactored verification, rejected cofactorless."""
    a, prefix = HE.secret_expand(sk)
    pk = HE.secret_to_public(sk)
    r = int.from_bytes(HE.sha512(prefix + msg), "little") % HE.L
    r_enc = HE.point_compress(HE.point_add(HE.point_mul(r, HE.BASE),
                                           HE.ORDER2))
    k = int.from_bytes(HE.sha512(r_enc + pk + msg), "little") % HE.L
    return pk, r_enc + ((r + k * a) % HE.L).to_bytes(32, "little")


def _with_s(sig: bytes, s: int) -> bytes:
    return sig[:32] + s.to_bytes(32, "little")


def _cases():
    """(name, item, expected verdict) over every verdict class."""
    pk1, sig1 = HE.secret_to_public(SK1), HE.sign(SK1, b"")
    pk3, sig3 = HE.secret_to_public(SK3), HE.sign(SK3, MSG3)
    s1 = int.from_bytes(sig1[32:], "little")
    pk_t, sig_t = _torsion_signature(SK1, b"torsion")
    # y = 1 with the sign bit set: x = 0 must have sign 0
    x0_signed = (1 | (1 << 255)).to_bytes(32, "little")
    out = [
        ("rfc8032 test 1", Item(pk1, b"", sig1), True),
        ("rfc8032 test 3", Item(pk3, MSG3, sig3), True),
        ("wrong message", Item(pk3, MSG3 + b"\x00", sig3), False),
        ("wrong key", Item(pk1, b"", sig3), False),
        ("torsion in R", Item(pk_t, b"torsion", sig_t), True),
        ("S + 1", Item(pk1, b"", _with_s(sig1, (s1 + 1) % HE.L)), False),
        ("S >= L", Item(pk1, b"", _with_s(sig1, s1 + HE.L)), False),
        ("x = 0, sign bit set (key)", Item(x0_signed, b"", sig1), False),
        ("x = 0, sign bit set (R)",
         Item(pk1, b"", x0_signed + sig1[32:]), False),
        ("y >= p", Item((P + 1).to_bytes(32, "little"), b"", sig1), False),
        ("short signature", Item(pk1, b"", sig1[:-1]), False),
    ]
    rng = np.random.default_rng(42)
    for i in range(6):
        sk = rng.bytes(32)
        msg = rng.bytes(int(rng.integers(0, 40)))
        sig = HE.sign(sk, msg)
        bad = i % 3 == 2
        out.append((f"seeded {i}", Item(HE.secret_to_public(sk),
                                        msg + b"!" if bad else msg, sig),
                    not bad))
    return out


CASES = _cases()


# --- the host twin -----------------------------------------------------------


@pytest.mark.parametrize("name,item,want", CASES, ids=[c[0] for c in CASES])
def test_host_twin_matches_jax(name, item, want):
    assert HE.check_item(item) is JE.check_item(item) is want
    pk = item.public_keys[0]
    assert HE.verify(pk, item.message, item.signature) is \
        JE.verify(pk, item.message, item.signature)
    assert HE.point_decompress(pk) == JE.point_decompress(pk)


def test_host_twin_signs_the_rfc8032_vectors():
    assert HE.secret_to_public(SK1) == bytes.fromhex(
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
    assert HE.sign(SK1, b"") == JE.sign(SK1, b"") == bytes.fromhex(
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")


# --- the field and the unified addition --------------------------------------


def _limbs(values):
    return E.words_to_limbs(torch.from_numpy(E.ints_to_words(values)))


def _ints(limbs):
    return E.words_to_ints(E.limbs_to_words(limbs))


def test_field_ops_match_ints_and_jax_montmul():
    rng = random.Random(0xED)
    a = [0, 1, P - 1, P - 2, 19, 2**255 - 20, 2**128] + [
        rng.randrange(P) for _ in range(57)]
    b = [P - 1, P - 1, P - 1, 2, 0, 2**255 - 20, 2**128] + [
        rng.randrange(P) for _ in range(57)]
    la, lb = _limbs(a), _limbs(b)
    assert _ints(E.fe_mul(la, lb)) == [x * y % P for x, y in zip(a, b)]
    assert _ints(E.fe_add(la, lb)) == [(x + y) % P for x, y in zip(a, b)]
    assert _ints(E.fe_sub(la, lb)) == [(x - y) % P for x, y in zip(a, b)]
    for x, y in list(zip(a, b))[:8]:
        prod = DE.montmul(jnp.asarray(DE.to_mont(x)),
                          jnp.asarray(DE.to_mont(y)))
        assert DE.from_mont(np.asarray(prod)) == _ints(
            E.fe_mul(_limbs([x]), _limbs([y])))[0]


def _affine(p):
    zinv = pow(p[2], P - 2, P)
    return p[0] * zinv % P, p[1] * zinv % P


def _points():
    rng = random.Random(0xADD)
    pts = [HE.IDENTITY, HE.ORDER2, HE.BASE,
           HE.point_add(HE.point_mul(99, HE.BASE), HE.ORDER2)]
    pts += [HE.point_mul(rng.randrange(1, HE.L), HE.BASE) for _ in range(4)]
    return [(x, y, 1, x * y % P) for x, y in map(_affine, pts)]


def test_ed_add_matches_jax_and_host():
    pts = _points()
    n = len(pts)
    left = [p for p in pts for _ in range(n)]
    right = [q for _ in range(n) for q in pts]

    def stack(side):
        return torch.stack([_limbs([p[c] for p in side]) for c in range(4)],
                           -2)

    got = E.ed_add(stack(left), stack(right))
    coords = [_ints(got[:, c]) for c in range(4)]
    for i, (p, q) in enumerate(zip(left, right)):
        assert tuple(c[i] for c in coords) == HE.point_add(p, q)

    def jax_point(side):
        return tuple(DE.split(DE.ints_to_mont_limbs([p[c] for p in side]))
                     for c in range(4))

    jout = DE.ed_add(jax_point(left), jax_point(right))
    for c in range(4):
        limbs = np.asarray(DE.merge(jout[c]))
        assert [DE.from_mont(row) for row in limbs] == coords[c]


# --- prepare -----------------------------------------------------------------


def _jax_backend():
    return JaxEd25519Backend(rng=FixedRng())


def _port_backend():
    return E.Ed25519Backend(device="cpu", rng=FixedRng())


@pytest.mark.parametrize("n", [0, 1, 3, 15, 63, 64])
def test_prepare_matches_jax(n):
    items = [c[1] for c in CASES if c[2]]
    items = (items * (n // len(items) + 1))[:n]
    jstatus, jprep = _jax_backend().prepare(items)
    status, prep = _port_backend().prepare(items)
    assert status == jstatus == ("oversize" if n > 63 else "ok")
    if n == 0:
        assert prep == jprep == ()
        assert _port_backend().verify_batch_async(prep)() is True
    if n in (0, 64):
        return
    px, py, pt, k, m = prep
    jx, jy, jt, jbits, jm = jprep
    assert m == jm == n and px.shape == (E.ladder_bucket(2 * n + 1), 8)
    for words, jl in ((px, jx), (py, jy), (pt, jt)):
        assert E.words_to_ints(words) == [DE.from_mont(r) for r in jl]
    assert E.words_to_ints(k) == [
        int("".join(map(str, row)), 2) for row in np.asarray(jbits)]


@pytest.mark.parametrize("name", ["S >= L", "x = 0, sign bit set (key)",
                                  "short signature", "y >= p"])
def test_prepare_invalid_matches_jax(name):
    item = next(c[1] for c in CASES if c[0] == name)
    good = CASES[0][1]
    assert _port_backend().prepare([good, item])[0] == \
        _jax_backend().prepare([good, item])[0] == "invalid"


# --- the plain verify --------------------------------------------------------


def test_plain_verify_matches_the_host_twin():
    """Bucket-8 batches (n ≤ 3) over every verdict class: the verdict is
    the AND of the twin's; an invalid prepare never reaches the kernel."""
    be = _port_backend()
    valid = [c[1] for c in CASES if c[2]]
    pk_t, sig_t = _torsion_signature(SK3, b"torsion 2")
    batches = [valid[:3], [valid[0], next(c[1] for c in CASES
                                          if c[0] == "wrong message")],
               [valid[1], next(c[1] for c in CASES if c[0] == "S + 1")],
               [Item(pk_t, b"torsion 2", sig_t), valid[2]],
               [next(c[1] for c in CASES if c[0] == "wrong key")]]
    for items in batches:
        status, prep = be.prepare(items)
        assert status == "ok" and prep[0].shape == (8, 8)
        assert be.verify_batch_async(prep)() is all(
            HE.check_item(it) for it in items)


def test_plain_sum_tree_order_is_the_references():
    """Row i += row i + s for s = n/2 … 1: the same projective words as
    the host formula applied in that order."""
    pts = _points()
    rows = torch.stack([torch.stack([_limbs([p[c]])[0] for c in range(4)])
                        for p in pts])
    host = list(pts)
    s = len(host) // 2
    while s:
        host = [HE.point_add(host[i], host[i + s]) for i in range(s)]
        s //= 2
    got = E.sum_tree_plain(rows)
    assert tuple(_ints(got[c])[0] for c in range(4)) == host[0]


@pytest.mark.kernel
@pytest.mark.slow
def test_jax_verify_kernel_matches_plain():
    """The JAX program (ladder, sum tree, three doublings) and the plain
    version on the same bucket-8 rows: the verdict, and [8]Σ as field
    elements (the JAX coordinates after from_mont)."""

    def total(px, py, pt, bits):
        x, y, t = DE.split(px), DE.split(py), DE.split(pt)
        s = DE._sum_tree(DE._ladder(x, y, t, bits.T))
        for _ in range(3):
            s = DE.ed_add(s, s)
        return s

    run_total = jax.jit(total)
    for items in ([c[1] for c in CASES if c[2]][:3],
                  [CASES[0][1], CASES[2][1]]):
        _, jprep = _jax_backend().prepare(items)
        _, prep = _port_backend().prepare(items)
        verdict, _rows, tot = E.ed25519_verify(
            *(torch.from_numpy(a) for a in prep[:4]))
        jx, jy, jt, jbits, _ = jprep
        assert bool(verdict) is bool(DE.verify_kernel(jx, jy, jt, jbits))
        jtot = run_total(jx, jy, jt, jbits)
        assert [DE.from_mont(np.asarray(c)) for c in jtot] == \
            E.words_to_ints(tot)


# --- refusals: no fallback ---------------------------------------------------


def _rows(n=8, k=0):
    w = torch.from_numpy(E.ints_to_words([0] * n))
    one = torch.from_numpy(E.ints_to_words([1] * n))
    return w, one, w.clone(), torch.from_numpy(E.ints_to_words([k] * n))


def test_wrapper_refuses_bad_shapes_and_scalars():
    px, py, pt, k = _rows()
    with pytest.raises(ValueError, match="B in"):
        E.ed25519_verify(px[:4], py[:4], pt[:4], k[:4])
    with pytest.raises(ValueError, match="int32"):
        E.ed25519_verify(px, py, pt, k.to(torch.int64))
    with pytest.raises(ValueError, match="2\\^253"):
        E.ed25519_verify(*_rows(k=1 << 253)[:4])
    verdict, rows, total = E.ed25519_verify(*_rows(k=(1 << 253) - 1))
    assert bool(verdict) and rows.shape == (8, 4, 8) and total.shape == (4, 8)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes the wrapper's
    kernel branch, which must never fall back to the plain version."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_kernel_launch_error_raises_not_swapped(monkeypatch):
    from grandine_tpu_torch.gpu import _build

    def failing_launch(name, *args):
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error 98")

    def plain(*args):
        raise AssertionError("the plain version stood in for the kernel")

    monkeypatch.setattr(_build, "launch", failing_launch)
    monkeypatch.setattr(E, "ed25519_verify_plain", plain)
    args = [a.as_subclass(_CudaLooking) for a in _rows()]
    before = E.ed25519_verify.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        E.ed25519_verify(*args)
    assert E.ed25519_verify.launches == before


def test_kernel_build_error_raises_in_the_constructor(monkeypatch):
    from grandine_tpu_torch.gpu import _build

    def failing_library():
        raise RuntimeError("nvcc failed for ['ed25519.cu']")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "library", failing_library)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        E.Ed25519Backend(device="cuda")


def test_backend_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        E.Ed25519Backend()
    assert E.Ed25519Backend(device="cpu").device.type == "cpu"
