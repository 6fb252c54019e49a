"""The port's entry points (grandine_tpu_torch/entry.py) against the
repository's `__graft_entry__.py` for the JAX package: `example_batch`
equal to the reference's `_example_batch(2, 4)` after conversion (the
same keys, messages and RLC pairs, canonical ints and masks, exact);
`entry(device="cpu")`'s program verifying its own batch;
`dryrun_multichip(2, device="cpu")` over two virtual CPU shards (flat and
grouped sharded passes, the factory called again); and — marked kernel
and slow — the reference's flagship multi_verify_kernel jitted on the CPU
on its own example batch beside the port's program on the converted one."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from grandine_tpu.tpu import bls as JB
from grandine_tpu.tpu import limbs as JL
from grandine_tpu_torch import entry as E
from grandine_tpu_torch.gpu import bls as B
from grandine_tpu_torch.gpu import limbs as L


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ints(limbs):
    """(…, 26) JAX Montgomery limbs → canonical ints, row-major."""
    a = np.asarray(limbs)
    return [JL.from_mont(r) for r in a.reshape(-1, a.shape[-1])]


def test_example_batch_matches_reference():
    ref = G._example_batch(2, 4)
    (pk_x, pk_y, pk_inf, sig_x, sig_y, sig_inf, msg_x, msg_y, msg_inf,
     r_bits) = ref
    got = E.example_batch(2, 4, device="cpu")
    assert [tuple(t.shape) for t in got] == [
        (4, 12), (4, 12), (4,), (4, 2, 12), (4, 2, 12), (4,), (4, 2, 2, 12),
        (4,), (4, 2)]
    gpk_x, gpk_y, gpk_inf, gsx, gsy, gsinf, gmsg, gminf, r01 = got
    assert gpk_inf.tolist() == pk_inf.tolist() == [False, False, True, True]
    assert gsinf.tolist() == sig_inf.tolist()
    assert gminf.tolist() == msg_inf.tolist()
    live = ~pk_inf
    for port, jax_limbs in ((gpk_x, pk_x), (gpk_y, pk_y), (gsx, sig_x),
                            (gsy, sig_y), (gmsg[:, 0], msg_x),
                            (gmsg[:, 1], msg_y)):
        assert L.words_to_ints(port[torch.from_numpy(live)]) == _ints(
            jax_limbs[live])
        assert not port[torch.from_numpy(~live)].any()  # ∞ rows: zero words
    # the same RLC scalars: r01 rows as the reference's r_bits rows
    pairs = [tuple(int(v) & 0xFFFFFFFF for v in row) for row in r01.tolist()]
    assert np.array_equal(B.rlc_bits_host(pairs), r_bits)
    assert pairs == [(7 + 13 * i, 5 + 3 * i) for i in range(4)]


def test_entry_verifies_on_cpu():
    fn, args = E.entry(device="cpu")
    assert fn is B.multi_verify_kernel
    assert all(a.device.type == "cpu" for a in args)
    assert fn(*args).tolist() == [1]


def test_dryrun_multichip_on_cpu_shards(capsys):
    assert E.dryrun_multichip(2, device="cpu") is None
    out = capsys.readouterr().out
    assert "sharded batch verify OK" in out
    assert "sharded grouped batch verify OK" in out
    assert "no new library load" in out


@pytest.mark.kernel
@pytest.mark.slow
def test_entry_program_matches_jax_flagship_kernel():
    """The reference's `entry()` program, multi_verify_kernel jitted on the
    CPU on `_example_batch(2, 4)`, and the port's on `example_batch(2, 4)`:
    both True; with signature 1 replaced by signature 0, both False."""
    ref = list(G._example_batch(2, 4))
    fn, args = E.entry(device="cpu")
    jfn = jax.jit(JB.multi_verify_kernel)
    assert bool(jfn(*ref)) is bool(fn(*args).item()) is True
    for i in (3, 4):  # sig_x, sig_y
        ref[i] = ref[i].copy()
        ref[i][1] = ref[i][0]
    args = list(args)
    for i in (3, 4):
        args[i] = args[i].clone()
        args[i][1] = args[i][0]
    assert bool(jfn(*ref)) is bool(fn(*args).item()) is False
