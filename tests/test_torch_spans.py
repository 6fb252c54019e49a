"""The port's span-grid merge (gpu/spans.py) on the CPU against the JAX
package, exact: the plain `span_update_grid` against the JAX program's
body `_span_grid_compute` and both `grid_merge_host` copies on edge rows
(a row not valid, s below the grid, t past it, s = t − 1, UNSET and 0
inputs, grid bases 0, 2³⁰ − 64 and the int32 limit 2³¹ − 64); the port's
`SpanPlane(device="cpu")` against the JAX `SpanPlane()` at several row
counts; the JAX device path's 16,384-row cap, which the port does not
have; and the wrapper's refusals. Inputs are made from seeds with numpy;
tolerance is exact equality. The kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grandine_tpu.tpu import spans as JS
from grandine_tpu_torch.gpu import spans as S
from grandine_tpu_torch.testing.slasher import span_edge_rows as edge_rows

E = S.SPAN_GRID_EPOCHS


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_grid(mn, mx, src, tgt, valid, base):
    out = JS._span_grid_compute(
        jnp.asarray(mn), jnp.asarray(mx), jnp.asarray(src), jnp.asarray(tgt),
        jnp.asarray(valid), jnp.asarray(np.full((1,), base, np.int32)))
    return [np.asarray(o) for o in out]


CASES = [(n, base) for n in (1, 255, 256, 257, 1000)
         for base in (0, (1 << 30) - 64)] + [(300, S.MAX_BASE), (64, 48)]


@pytest.mark.parametrize("n,base", CASES)
def test_plain_matches_jax_program_and_host_twins(n, base):
    mn, mx, src, tgt, valid = edge_rows(n, base, seed=n + base % 997)
    got = S.span_update_grid(*_torch(mn, mx, src, tgt, valid), base)
    want = _jax_grid(mn, mx, src, tgt, valid, base)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and g.shape == (n, E)
        np.testing.assert_array_equal(g.numpy(), w)
    # the host twins know no `valid`: hold them on all-valid rows
    ones = np.ones(n, bool)
    got = [g.numpy() for g in S.span_update_grid_plain(
        *_torch(mn, mx, src, tgt, ones), base)]
    for twin in (S.grid_merge_host, JS.grid_merge_host):
        for g, w in zip(got, twin(mn, mx, src, tgt, base), strict=True):
            np.testing.assert_array_equal(g, w)


def test_edge_rows_cover_every_case():
    """The edge rows reach each branch: a row left alone (not valid), a
    min side set below the source, a max side set in (s, t], and both
    sentinels kept where nothing applies."""
    base = 48
    mn, mx, src, tgt, valid = edge_rows(8, base, seed=3)
    mn[:] = S.INT32_UNSET
    mx[:] = 0
    new_min, new_max = (a.numpy() for a in S.span_update_grid(
        *_torch(mn, mx, src, tgt, valid), base))
    e = base + np.arange(E)
    assert (new_min[0] == S.INT32_UNSET).all() and (new_max[0] == 0).all()
    for r in range(1, 8):
        s, t = int(src[r]), int(tgt[r])
        np.testing.assert_array_equal(
            new_min[r], np.where(e < s, t, S.INT32_UNSET))
        np.testing.assert_array_equal(
            new_max[r], np.where((e > s) & (e <= t), t, 0))
    assert (new_min[4] == tgt[4]).all()       # s past the grid: all below
    assert (new_max[5] == 0).all()            # s = t: no max epoch
    assert new_max[2, -1] == tgt[2]           # t past the grid's end


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_span_plane_matches_jax_plane(n):
    base = 96
    mn, mx, src, tgt, _ = edge_rows(n, base, seed=7 * n)
    want = JS.SpanPlane().update(mn, mx, src, tgt, base)
    got = S.SpanPlane(device="cpu").update(mn, mx, src, tgt, base)
    for g, w in zip(got, want, strict=True):
        assert isinstance(g, np.ndarray) and g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_reference_device_path_caps_rows_the_port_does_not():
    """Above 16,384 rows the JAX device path raises (its pow-2 bucket
    stops at MAX_BUCKET, a compiled-shape contract); the grid merge is
    row-wise, so the port launches once at any n and equals the host twin
    and the JAX program's body on the unpadded rows."""
    n, base = 16_385, 48
    mn, mx, src, tgt, _ = edge_rows(n, base, seed=16_385)
    with pytest.raises(ValueError, match="exceeds max bucket"):
        JS.SpanPlane().update(mn, mx, src, tgt, base)
    got = S.SpanPlane(device="cpu").update(mn, mx, src, tgt, base)
    for want in (JS.grid_merge_host(mn, mx, src, tgt, base),
                 _jax_grid(mn, mx, src, tgt, np.ones(n, bool), base)):
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)


class _Counter:
    def __init__(self):
        self.calls = []

    def labels(self, kernel):
        self.calls.append(kernel)
        return self

    def inc(self, n=1):
        pass


def test_span_plane_counts_kernel_calls():
    metrics = type("M", (), {})()
    metrics.device_kernel_calls = _Counter()
    plane = S.SpanPlane(device="cpu", metrics=metrics)
    mn, mx, src, tgt, _ = edge_rows(3, 0, seed=1)
    plane.update(mn, mx, src, tgt, 0)
    plane.update(mn, mx, src, tgt, 16)
    assert metrics.device_kernel_calls.calls == ["span_update_grid"] * 2


def test_cpu_plain_version_counts_no_launch():
    before = S.span_update_grid.launches
    S.span_update_grid(*_torch(*edge_rows(4, 0, seed=2)), 0)
    assert S.span_update_grid.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "valid", "base_low",
                                 "base_high", "base_type", "rank"])
def test_wrapper_refuses_bad_operands(bad):
    mn, mx, src, tgt, valid = _torch(*edge_rows(4, 16, seed=4))
    base = 16
    if bad == "dtype":
        mn = mn.to(torch.int64)
    elif bad == "shape":
        mx = mx[:, :32]
    elif bad == "valid":
        valid = valid.to(torch.int32)
    elif bad == "base_low":
        base = -1
    elif bad == "base_high":
        base = S.MAX_BASE + 1
    elif bad == "base_type":
        base = 16.0
    elif bad == "rank":
        mn = mn.reshape(-1)
    with pytest.raises(ValueError, match="span_update_grid"):
        S.span_update_grid(mn, mx, src, tgt, valid, base)

