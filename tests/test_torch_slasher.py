"""The port's slasher (grandine_tpu_torch/slasher.py) on the CPU against
the JAX package's, exact. Every test drives a JAX `Slasher()` and the
port's `Slasher(device="cpu")` (whose bulk merge runs the plain version of
`span_update_grid`) over the same seeded input and requires:

* identical detections — kind, validator, evidence dict, in order;
* an identical `sl:` keyspace, byte for byte (span chunks, records, prune
  indexes): a lazier or more eager walk would write other chunks.

Covered: `on_attestation`, `on_attestation_reference`,
`on_attestations_bulk` (collisions, off-grid rows, small history floors,
epochs near the int32 grid contract, the JAX device `SpanPlane`), `prune`,
`on_block`, `drain`, `record_for`, the LRU chunk cache and the metrics
seams, and epoch windows in which every validator votes once (the shape
chip_smoke.py runs at 50,000 validators on the card)."""

import random

import pytest
import torch

import grandine_tpu.slasher as JSL
from grandine_tpu.tpu.spans import SpanPlane as JaxSpanPlane
import grandine_tpu_torch.slasher as PSL
from grandine_tpu_torch.gpu.spans import SpanPlane
from grandine_tpu_torch.testing.slasher import epoch_window


def _dump(db):
    """Full slasher keyspace as sorted (key, value) bytes."""
    return [(bytes(k), bytes(v)) for k, v in db.iterate_prefix(b"sl:")]


def _hits_key(hits):
    return [(h.kind, h.validator_index, h.evidence) for h in hits]


def _random_aggregates(seed, n_aggs, max_validator=1024, max_epoch=200,
                       unique_within=True):
    """The port's copy of tests/test_slasher_batched.py's generator: a few
    data roots (collisions → double votes), random (s, t) spans (nesting →
    surround / surrounded), random index subsets."""
    rng = random.Random(seed)
    roots = [bytes([r]) * 32 for r in (0xAA, 0xBB, 0xCC)]
    aggs = []
    for _ in range(n_aggs):
        k = rng.randint(1, 48)
        if unique_within:
            ids = rng.sample(range(max_validator), k)
        else:
            ids = [rng.randrange(max_validator) for _ in range(k)]
        s = rng.randint(0, max_epoch - 1)
        t = rng.randint(s + 1, min(s + 40, max_epoch))
        aggs.append((ids, s, t, rng.choice(roots)))
    return aggs


def _pair(**kw):
    return JSL.Slasher(**kw), PSL.Slasher(device="cpu", **kw)


def _assert_same(jax_sl, port_sl):
    assert _dump(port_sl.db) == _dump(jax_sl.db)


def _feed(sl, entry, aggs):
    """Per-aggregate hit lists through `entry` (one call a window for the
    bulk feed)."""
    if entry == "on_attestations_bulk":
        return [_hits_key(h) for h in sl.on_attestations_bulk(aggs)]
    return [_hits_key(getattr(sl, entry)(*a)) for a in aggs]


def test_constants_and_key_layout_match():
    assert (PSL.CHUNK_EPOCHS, PSL.VALIDATORS_PER_CHUNK) == (
        JSL.CHUNK_EPOCHS, JSL.VALIDATORS_PER_CHUNK)
    for name in ("_PREFIX_MIN", "_PREFIX_MAX", "_PREFIX_REC",
                 "_PREFIX_BLOCK", "_PREFIX_ECHUNK_IDX", "_PREFIX_TGT_IDX",
                 "_GRID_EPOCH_LIMIT", "_UNSET_MIN"):
        assert getattr(PSL, name) == getattr(JSL, name), name


ENTRIES = [("on_attestation_reference", "on_attestation_reference"),
           ("on_attestation", "on_attestation"),
           ("on_attestation_reference", "on_attestation"),
           ("on_attestation_reference", "on_attestations_bulk")]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("jax_entry,port_entry", ENTRIES)
def test_ingest_matches_jax(seed, jax_entry, port_entry):
    """Each port entry point against the JAX reference loop (and against
    the same JAX entry): hits and the whole keyspace equal, the bulk feed
    included (one window of the whole mix)."""
    aggs = _random_aggregates(seed, 40, unique_within=seed != 3)
    jax_sl, port_sl = _pair()
    want = _feed(jax_sl, jax_entry, aggs)
    got = _feed(port_sl, port_entry, aggs)
    assert got == want
    _assert_same(jax_sl, port_sl)
    assert _hits_key(port_sl.drain()) == _hits_key(jax_sl.drain())
    assert port_sl.drain() == []


def test_directed_kinds_and_evidence():
    jax_sl, port_sl = _pair()
    steps = [
        (list(range(0, 300)), 10, 20, b"\xaa" * 32),  # two vchunks
        ([7, 290], 5, 30, b"\xbb" * 32),    # surround (10, 20)
        ([8], 12, 15, b"\xcc" * 32),        # surrounded by (10, 20)
        ([9, 11], 11, 20, b"\xdd" * 32),    # double vote at 20
        ([500, 501], 10, 20, b"\xaa" * 32),  # clean
    ]
    got = [_hits_key(port_sl.on_attestation(*a)) for a in steps]
    assert got == [_hits_key(jax_sl.on_attestation(*a)) for a in steps]
    assert [[(k, v) for k, v, _ in hits] for hits in got] == [
        [], [("surround_vote", 7), ("surround_vote", 290)],
        [("surrounded_vote", 8)], [("double_vote", 9), ("double_vote", 11)],
        []]
    assert got[1][0][2] == {"existing": [10, 20], "new": [5, 30]}
    assert got[3][0][2]["roots"] == [(b"\xaa" * 32).hex(), (b"\xdd" * 32).hex()]
    _assert_same(jax_sl, port_sl)


@pytest.mark.parametrize("entry", ["on_attestation", "on_attestations_bulk"])
def test_duplicate_indices_take_the_sequential_path(entry):
    aggs = [([3, 4, 3], 1, 5, b"\xaa" * 32), ([4, 4], 2, 5, b"\xbb" * 32),
            ([5, 6], 1, 9, b"\xaa" * 32)]
    jax_sl, port_sl = _pair()
    assert _feed(port_sl, entry, aggs) == _feed(jax_sl, entry, aggs)
    _assert_same(jax_sl, port_sl)


@pytest.mark.parametrize("history", [8, 24, 64])
@pytest.mark.parametrize("entry", ["on_attestation", "on_attestations_bulk"])
def test_small_history_floors(history, entry):
    """Tiny history windows put the floor inside (or above) the walk's
    first chunk, and off the grid for the bulk merge."""
    aggs = _random_aggregates(7, 30, max_epoch=64 if history < 64 else 150,
                              unique_within=False)
    jax_sl, port_sl = _pair(history_epochs=history)
    assert _feed(port_sl, entry, aggs) == _feed(jax_sl, entry, aggs)
    _assert_same(jax_sl, port_sl)


@pytest.mark.parametrize("entry", ["on_attestation", "on_attestations_bulk"])
def test_deep_fresh_history_walk(entry):
    """A fresh slasher at epoch 4,000: the min walk crosses hundreds of
    chunks (below the grid for the bulk feed); one epoch up it stops at
    once."""
    ids = list(range(300))
    jax_sl, port_sl = _pair()
    for s in (4000, 4001):
        aggs = [(ids, s, s + 1, bytes([s % 256]) * 32)]
        assert _feed(port_sl, entry, aggs) == _feed(jax_sl, entry, aggs)
        _assert_same(jax_sl, port_sl)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("jax_merge", ["host twin", "jax device plane"])
def test_bulk_matches_jax_bulk(seed, jax_merge):
    """A window with repeats through `on_attestations_bulk` against the JAX
    bulk feed on its numpy twin and on its own device plane (JAX on the
    CPU)."""
    aggs = _random_aggregates(seed, 25, max_validator=768,
                              unique_within=False)
    jax_sl = JSL.Slasher(span_plane=JaxSpanPlane()
                         if jax_merge == "jax device plane" else None)
    port_sl = PSL.Slasher(device="cpu")
    assert _feed(port_sl, "on_attestations_bulk", aggs) == _feed(
        jax_sl, "on_attestations_bulk", aggs)
    _assert_same(jax_sl, port_sl)


def test_bulk_off_grid_rows():
    """Rows whose update range does not fit the grid (history floor above
    the grid base) take the host walk."""
    aggs = [(list(range(64)), 4000, 4001, b"\xaa" * 32),
            (list(range(64, 96)), 2, 4001, b"\xbb" * 32)]
    jax_sl, port_sl = _pair(history_epochs=64)
    assert _feed(port_sl, "on_attestations_bulk", aggs) == _feed(
        jax_sl, "on_attestations_bulk", aggs)
    _assert_same(jax_sl, port_sl)


@pytest.mark.parametrize("jax_merge", ["host twin", "jax device plane"])
def test_bulk_epochs_at_the_int32_grid_contract(jax_merge):
    """A target at 2³⁰ leaves the grid (the int32 contract) and lifts the
    grid base to 2³⁰ − 48, while rows just below 2³⁰ still ride it: the
    reference computes that base, so the port's kernel takes any base up
    to 2³¹ − 64."""
    top = 1 << 30
    aggs = [([1, 2], top + 1, top + 5, b"\xaa" * 32),
            ([3, 4, 300], top - 10, top - 5, b"\xbb" * 32),
            ([5], top - 40, top - 1, b"\xcc" * 32)]
    jax_sl = JSL.Slasher(history_epochs=64, span_plane=JaxSpanPlane()
                         if jax_merge == "jax device plane" else None)
    port_sl = PSL.Slasher(history_epochs=64, device="cpu")
    grid = []
    real = port_sl.span_plane.update
    port_sl.span_plane.update = lambda *a: grid.append(a[4]) or real(*a)
    assert _feed(port_sl, "on_attestations_bulk", aggs) == _feed(
        jax_sl, "on_attestations_bulk", aggs)
    assert grid == [top - 48]
    _assert_same(jax_sl, port_sl)


@pytest.mark.parametrize("entry", ["on_attestation", "on_attestations_bulk"])
def test_prune_matches_jax(entry):
    """Pruning after ingest drops exactly the reference's rows."""
    aggs = _random_aggregates(31, 20, max_validator=512, max_epoch=150)
    jax_sl, port_sl = _pair(history_epochs=64)
    _feed(jax_sl, entry, aggs)
    _feed(port_sl, entry, aggs)
    dropped = port_sl.prune(150)
    assert dropped == jax_sl.prune(150) and dropped > 0
    _assert_same(jax_sl, port_sl)
    assert len(port_sl._chunks) == len(jax_sl._chunks)


def test_on_block_and_drain():
    jax_sl, port_sl = _pair()
    blocks = [(3, 10, b"\x01" * 32), (4, 10, b"\x02" * 32),
              (3, 10, b"\x01" * 32), (3, 10, b"\x03" * 32),
              (4, 11, b"\x04" * 32), (4, 10, b"\x05" * 32)]
    got = [port_sl.on_block(*b) for b in blocks]
    want = [jax_sl.on_block(*b) for b in blocks]
    assert [h and _hits_key([h]) for h in got] == [
        h and _hits_key([h]) for h in want]
    assert [h.kind if h else None for h in got] == [
        None, None, None, "double_block", None, "double_block"]
    assert got[3].evidence == {"slot": 10, "roots": [(b"\x01" * 32).hex(),
                                                     (b"\x03" * 32).hex()]}
    _assert_same(jax_sl, port_sl)
    assert _hits_key(port_sl.drain()) == _hits_key(jax_sl.drain())


def test_record_for():
    aggs = _random_aggregates(5, 15, max_validator=256)
    jax_sl, port_sl = _pair()
    _feed(jax_sl, "on_attestations_bulk", aggs)
    _feed(port_sl, "on_attestations_bulk", aggs)
    for v in range(0, 256, 7):
        for t in range(0, 200, 13):
            assert port_sl.record_for(v, t) == jax_sl.record_for(v, t)
    ids, s, t, root = aggs[0]
    assert port_sl.record_for(ids[0], t) == (s, root)


class _Metrics:
    """Records every call of the slasher's metrics seams."""

    def __init__(self):
        self.events = []
        self.sizes = []
        self.observed = 0
        self.indices = 0
        metrics = self

        class _Labels:
            def labels(self, event):
                return type("C", (), {"inc": lambda _s, n=1:
                                      metrics.events.append(event)})()

        self.slasher_chunk_cache_events = _Labels()
        self.slasher_chunk_cache_size = type(
            "G", (), {"set": lambda _s, v: metrics.sizes.append(v)})()
        self.slasher_span_update_seconds = type(
            "H", (), {"observe": lambda _s, v: setattr(
                metrics, "observed", metrics.observed + 1)})()
        self.slasher_span_indices = type(
            "N", (), {"inc": lambda _s, n=1: setattr(
                metrics, "indices", metrics.indices + n)})()

    def seen(self):
        return self.events, self.sizes, self.observed, self.indices


@pytest.mark.parametrize("cache_chunks", [4, 4096])
def test_chunk_cache_and_metrics_seams(cache_chunks):
    """The LRU cache (dirty chunks pinned until the flush) evicts and the
    metrics seams fire exactly as the reference's."""
    aggs = _random_aggregates(9, 20, max_validator=1024, max_epoch=120,
                              unique_within=False)
    jm, pm = _Metrics(), _Metrics()
    jax_sl = JSL.Slasher(metrics=jm, cache_chunks=cache_chunks)
    port_sl = PSL.Slasher(metrics=pm, cache_chunks=cache_chunks,
                          span_plane=SpanPlane(device="cpu"))
    for entry in ("on_attestation", "on_attestations_bulk"):
        assert _feed(port_sl, entry, aggs) == _feed(jax_sl, entry, aggs)
    assert pm.seen() == jm.seen()
    assert ("evict" in pm.events) == (cache_chunks == 4)
    _assert_same(jax_sl, port_sl)


def test_spans_persist_across_instances():
    port_sl = PSL.Slasher(device="cpu")
    port_sl.on_attestation([7], 2, 3, b"\xcc" * 32)
    again = PSL.Slasher(port_sl.db, device="cpu")
    hits = again.on_attestation([7], 1, 4, b"\xdd" * 32)
    assert [(h.kind, h.evidence) for h in hits] == [
        ("surround_vote", {"existing": [2, 3], "new": [1, 4]})]


def test_epoch_windows_every_validator_votes_once():
    """The chip_smoke cell at 1,024 validators: consecutive epoch windows
    near genesis (targets 96-99, so the grid base is above 0 and the
    below-grid walk runs), then a poisoned window with a double vote, a
    surround on the grid, a surrounded vote on the collision path and a
    double proposal."""
    n = 1024
    windows = [epoch_window(n, t, seed=t) for t in range(96, 100)]
    last = epoch_window(n, 100, seed=100)
    ids, s, t, root = last[3]
    last[3] = (ids[2:], s, t, root)
    last.append((ids[:2], 80, 100, root))             # surround (grid)
    # (98, 102) is clean; the same validators' honest (99, 100) after it
    # is surrounded (collision path)
    last.insert(0, (last[5][0][:2], 98, 102, root))
    last.append((last[9][0][:3], 99, 100, b"\xee" * 32))  # double vote
    windows.append(last)
    jax_sl, port_sl = _pair()
    kinds = []
    for w in windows:
        got = _feed(port_sl, "on_attestations_bulk", w)
        assert got == _feed(jax_sl, "on_attestations_bulk", w)
        kinds.append(sorted(k for hits in got for k, _, _ in hits))
        _assert_same(jax_sl, port_sl)
    assert kinds[:4] == [[]] * 4
    assert kinds[4] == ["double_vote"] * 3 + ["surround_vote"] * 2 + [
        "surrounded_vote"] * 2
    for b in [(17, 3200, b"\x01" * 32), (17, 3200, b"\x02" * 32)]:
        assert (port_sl.on_block(*b) is None) == (jax_sl.on_block(*b) is None)
    assert port_sl.drain()[-1].kind == jax_sl.drain()[-1].kind == (
        "double_block")
    _assert_same(jax_sl, port_sl)


def test_slasher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PSL.Slasher()
    assert PSL.Slasher(device="cpu").span_plane.device.type == "cpu"
    plane = SpanPlane(device="cpu")
    assert PSL.Slasher(span_plane=plane).span_plane is plane
