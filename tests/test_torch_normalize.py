"""The port's normalize and packed-word kernels on the CPU, against the JAX
package, exact: `g1_normalize_plain` / `g2_normalize_plain` against the
JAX host points' affine coordinates (live rows) and infinity masks;
`unpack_words_plain` against the reference's tpu/limbs.py unpack_words
followed by its Montgomery lift and the host reduction mod p, on edge
values (0, p − 1, p, 2³⁸⁴ − 1, 2³⁹⁰ − 1, bits above 390 set); the port's
`pack_fp_words_host` against the JAX one byte for byte; and — marked kernel
and slow, as the JAX package marks its own — the plain normalize against
the JAX programs g1/g2_normalize_kernel jitted on the CPU. Every
comparison is exact (canonical ints, masks, bytes)."""

import random

import jax
import numpy as np
import pytest
import torch

from grandine_tpu.crypto.constants import P, R
from grandine_tpu.crypto.curves import G1 as JG1
from grandine_tpu.crypto.curves import Point as JPoint
from grandine_tpu.crypto.hash_to_curve import hash_to_g2 as j_hash_to_g2
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import field as JF
from grandine_tpu.tpu import limbs as JL
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import limbs as L

rng = random.Random(0x0E11)

EDGE_VALUES = [0, 1, P - 1, P, P + 1, (1 << 384) - 1, (1 << 390) - 1,
               rng.randrange(P), rng.randrange(1 << 390)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jacobian_points(k):
    """JAX host points with Z ≠ 1 (sums of multiples), ∞ at row 2 and an
    affine point (Z = 1) last."""
    base = JG1 if k == 1 else j_hash_to_g2(b"normalize")
    pts = [base.mul(rng.randrange(1, R)) + base.mul(rng.randrange(1, R))
           for _ in range(4)]
    pts.insert(2, base.mul(0))
    x, y = base.mul(7).to_affine()
    pts.append(JPoint.from_affine(x, y, base.b))
    return pts


def _rows(pts, k):
    """Jacobian canonical words of the points' own (X, Y, Z)."""
    if k == 1:
        ints = [v for p in pts for v in (p.x.n, p.y.n, p.z.n)]
        return torch.from_numpy(L.ints_to_words(ints).copy()).reshape(
            len(pts), 3, 12)
    ints = [v for p in pts for c in (p.x, p.y, p.z) for v in (c.c0.n, c.c1.n)]
    return torch.from_numpy(L.ints_to_words(ints).copy()).reshape(
        len(pts), 3, 2, 12)


def _negated_z_row(p, k):
    """(X, −Y, −Z) of an affine point: the same point with Z = −1."""
    if k == 1:
        ints = [p.x.n, (P - p.y.n) % P, P - 1]
        return torch.from_numpy(L.ints_to_words(ints).copy()).reshape(3, 12)
    ints = [p.x.c0.n, p.x.c1.n, (P - p.y.c0.n) % P, (P - p.y.c1.n) % P,
            P - 1, 0]
    return torch.from_numpy(L.ints_to_words(ints).copy()).reshape(3, 2, 12)


def _affine_ints(p, k):
    aff = p.to_affine()
    if aff is None:
        return None
    if k == 1:
        return [aff[0].n, aff[1].n]
    return [aff[0].c0.n, aff[0].c1.n, aff[1].c0.n, aff[1].c1.n]


@pytest.mark.parametrize("k", [1, 2])
def test_normalize_plain_matches_jax_host_points(k):
    """Live rows: the affine coordinates the JAX host anchor gives; ∞ rows:
    mask True and zero words (the reference's are garbage under its mask);
    a row whose Jacobian Z is −1 (X, −Y, −1 is the same point as X, Y, 1)."""
    pts = _jacobian_points(k)
    rows = torch.cat([_rows(pts, k), _negated_z_row(pts[-1], k)[None]])
    pts.append(pts[-1])
    xy, inf = (B.g1_normalize_plain if k == 1 else B.g2_normalize_plain)(rows)
    assert inf.tolist() == [p.to_affine() is None for p in pts]
    for i, p in enumerate(pts):
        want = _affine_ints(p, k)
        got = L.words_to_ints(xy[i])
        assert got == (want if want is not None else [0] * len(got))
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal((B.g1_normalize if k == 1 else B.g2_normalize)(rows)[0],
                       xy)


def test_normalize_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="g1_normalize"):
        B.g1_normalize(torch.zeros((2, 3, 2, 12), dtype=torch.int32))
    with pytest.raises(ValueError, match="g2_normalize"):
        B.g2_normalize(torch.zeros((2, 3, 12), dtype=torch.int32))
    with pytest.raises(ValueError, match="g1_normalize"):
        B.g1_normalize(torch.zeros((2, 3, 12), dtype=torch.int64))


def _packed(values):
    """Any 416-bit ints → (N, 13) uint32 words (not only values below p)."""
    out = np.zeros((len(values), 13), np.uint32)
    for i, v in enumerate(values):
        for j in range(13):
            out[i, j] = (v >> (32 * j)) & 0xFFFFFFFF
    return out


def test_unpack_words_plain_matches_jax_unpack_and_reduction():
    """The reference's unpack_words (bits 0–389 as 26 limbs of 15 bits),
    its to_mont_dev lift and host from_mont against the port on the edge
    values and on rows with bits above 390 set (dropped by both)."""
    values = EDGE_VALUES + [(1 << 416) - 1, ((1 << 26) - 1) << 390,
                            (123 << 395) | 5]
    w = _packed(values)
    got = L.words_to_ints(B.unpack_words_plain(torch.from_numpy(
        w.view(np.int32))))
    canon = np.asarray(jax.jit(JL.unpack_words)(w))  # (26, N)
    mont = np.asarray(jax.jit(JL.to_mont_dev)(canon))
    for i, v in enumerate(values):
        assert JL.limbs_to_int(canon[:, i]) == v & ((1 << 390) - 1)
        assert got[i] == JL.from_mont(mont[:, i]) == (v % (1 << 390)) % P
    # batch axes pass through: (2, 2, 13) → (2, 2, 12)
    w4 = torch.from_numpy(w[:4].view(np.int32)).reshape(2, 2, 13)
    assert B.unpack_words(w4).shape == (2, 2, 12)
    with pytest.raises(ValueError, match="unpack_words"):
        B.unpack_words(torch.zeros((3, 12), dtype=torch.int32))


def test_pack_fp_words_host_matches_jax_byte_for_byte():
    values = [0, 1, P - 1, (1 << 384) - 1] + [rng.randrange(P)
                                              for _ in range(5)]
    got = L.pack_fp_words_host(values)
    want = JL.pack_fp_words_host(values)
    assert got.dtype == want.dtype == np.uint32
    assert got.tobytes() == want.tobytes()
    assert L.pack_fp_words_host([]).shape == (0, 13)
    with pytest.raises(AssertionError):
        L.pack_fp_words_host([1 << 384])
    # below p the packed words are the canonical words and a zero word
    back = B.unpack_words_plain(torch.from_numpy(got.view(np.int32)))
    assert L.words_to_ints(back) == [v % P for v in values]


# --- against the JAX programs themselves -------------------------------------


@pytest.mark.kernel
@pytest.mark.slow
@pytest.mark.parametrize("k", [1, 2])
def test_normalize_plain_matches_jax_kernel(k):
    """g1_normalize_kernel / g2_normalize_kernel jitted on the CPU at N = 6
    (∞ at row 2) and the port's plain version on the same Jacobian points:
    equal affine coordinates on live rows, equal masks."""
    pts = _jacobian_points(k)
    rows = _rows(pts, k)
    if k == 1:
        dev = [np.stack([JL.to_mont(getattr(p, c).n) for p in pts])
               for c in "xyz"]
        x, y, inf = jax.jit(JB.g1_normalize_kernel)(*dev)
        want = [[JL.from_mont(np.asarray(x)[i]), JL.from_mont(np.asarray(y)[i])]
                for i in range(len(pts))]
    else:
        dev = [np.stack([JF.fq2_to_dev(getattr(p, c)) for p in pts])
               for c in "xyz"]
        x, y, inf = jax.jit(JB.g2_normalize_kernel)(*dev)
        want = []
        for i in range(len(pts)):
            fx, fy = JF.dev_to_fq2(np.asarray(x)[i]), JF.dev_to_fq2(
                np.asarray(y)[i])
            want.append([fx.c0.n, fx.c1.n, fy.c0.n, fy.c1.n])
    xy, pinf = (B.g1_normalize_plain if k == 1 else B.g2_normalize_plain)(rows)
    assert pinf.tolist() == np.asarray(inf).tolist()
    for i in range(len(pts)):
        if not pinf[i]:
            assert L.words_to_ints(xy[i]) == want[i]
