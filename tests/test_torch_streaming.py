"""The port's incremental (streaming) profiling against batch and reference.

Random event streams come from the reference's own generator
(``test_profiler_parity._random_recorder``) and cross into the port as
plain dicts (``repro_torch.interop``), as in ``tests/test_torch_profiler.py``.
For any chunking of a stream — cuts inside a multiplicity-collapsed run,
buffers that keep growing between updates — the port's finalized
incremental profile must be byte-identical (``to_json()``) to the port's
batch reduction and to the reference's, on ``NumpyBackend`` and on
``TorchBackend(device="cpu")``; shards merge in any order and tree shape
and survive pickling (the laws of ``tests/test_streaming.py`` and
``tests/test_streaming_property.py``).  All four apps' traces stream
through ``trace_observer`` to the batch profile.
"""

import pickle
import random

import numpy as np
import pytest
import torch

from proptest import given, settings, st
from test_profiler_parity import _random_coll_event, _random_p2p_event, _random_recorder
from test_torch_profiler import _event_dicts

from repro.core.profiler import CommPatternProfiler as RefProfiler
from repro.core.streaming import merge_tree as ref_merge_tree
from repro_torch.apps import amg, beatnik, kripke, laghos
from repro_torch.apps.stencil import Decomp3D
from repro_torch.core.backend import BackendUnavailable, NumpyBackend, TorchBackend
from repro_torch.core.profiler import CommPatternProfiler, CommProfile, trace_observer
from repro_torch.core.regions import RegionRecorder
from repro_torch.core.streaming import (
    ProfileSummary,
    RegionSummary,
    StreamingProfiler,
    merge_tree,
)
from repro_torch.interop import recorder_from_event_dicts

CPU = TorchBackend(device="cpu")
BACKENDS = {"numpy": NumpyBackend(), "torch-cpu": CPU}


def _port(ref_rec) -> RegionRecorder:
    return recorder_from_event_dicts(_event_dicts(ref_rec), ref_rec.instances)


def _recorders(seed) -> tuple:
    ref_rec = _random_recorder(seed)
    return ref_rec, _port(ref_rec)


def _port_event(ref_ev):
    """One reference event carried into the port."""

    class _One:
        events = [ref_ev]

    return recorder_from_event_dicts(_event_dicts(_One), {}).events[0]


def _stream_profile(rec, cuts, backend=CPU, **kw):
    sp = CommPatternProfiler.incremental(rec, backend=backend)
    assert isinstance(sp, StreamingProfiler)
    for c in cuts:
        sp.update(int(c))
    return sp.profile(**kw)


def _shards(rec, rng, backend=CPU, max_cuts=6):
    """Cut the recorder's stream into contiguous watermark deltas."""
    sp = CommPatternProfiler.incremental(rec, backend=backend)
    n = rec.buffer.n_rows
    cuts = sorted(rng.sample(range(n + 1), k=min(rng.randint(0, max_cuts), n + 1)))
    deltas = [sp.update(c) for c in cuts]
    deltas.append(sp.update())
    return [d for d in deltas if d.n_events or d.regions or d.instances]


# ---------------------------------------------------------------------------
# Random streams: incremental == batch == reference, on both backends
# ---------------------------------------------------------------------------

SEEDS = [0, 3, 5, 17, 42, 1234, 20260808, 999_999]


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("seed", SEEDS)
def test_incremental_equals_batch_and_reference(seed, backend):
    ref_rec, rec = _recorders(seed)
    repl = (seed % 3) + 1
    want = RefProfiler.from_recorder(
        ref_rec, name="p", replication=repl, backend="numpy"
    ).to_json()
    batch = CommPatternProfiler.from_recorder(
        rec, name="p", replication=repl, backend=BACKENDS[backend]
    )
    assert batch.to_json() == want
    rng = np.random.default_rng(seed)
    n = rec.buffer.n_rows
    cuts = np.sort(rng.integers(0, n + 1, size=int(rng.integers(0, 6))))
    live = _stream_profile(rec, cuts, BACKENDS[backend], name="p", replication=repl)
    assert live.to_json() == want


@given(st.integers(0, 10**6))
@settings(max_examples=25, deadline=None)
def test_incremental_equals_batch_on_random_streams(seed):
    ref_rec, rec = _recorders(seed)
    repl = (seed % 3) + 1
    want = RefProfiler.from_recorder(
        ref_rec, name="p", replication=repl, backend="numpy"
    ).to_json()
    rng = np.random.default_rng(seed)
    n = rec.buffer.n_rows
    cuts = np.sort(rng.integers(0, n + 1, size=int(rng.integers(0, 6))))
    assert _stream_profile(rec, cuts, name="p", replication=repl).to_json() == want


@pytest.mark.parametrize("seed", [2, 11, 31])
def test_shards_equal_reference_shards(seed):
    """The port's delta summaries hold the reference's vectors exactly."""
    ref_rec, rec = _recorders(seed)
    n = rec.buffer.n_rows
    cuts = [int(c) for c in np.linspace(0, n, 4).astype(int)]
    ref_sp = RefProfiler.incremental(ref_rec, backend="numpy")
    sp = CommPatternProfiler.incremental(rec, backend=CPU)
    for c in cuts + [None]:
        want, got = ref_sp.update(c), sp.update(c)
        assert got.n_events == want.n_events and got.instances == want.instances
        assert list(got.regions) == list(want.regions)
        for name, rs in got.regions.items():
            ws = want.regions[name]
            for field in ("sends", "recvs", "bsent", "brecv", "cbytes", "part", "cpart",
                          "dest_codes", "src_codes"):
                g, w = getattr(rs, field), getattr(ws, field)
                assert isinstance(g, np.ndarray) and g.dtype == w.dtype, field
                assert np.array_equal(g, w), field
            assert (rs.n, rs.first_row, rs.coll, rs.largest, rs.kinds) == (
                ws.n, ws.first_row, ws.coll, ws.largest, ws.kinds
            )
        assert sp.watermark == ref_sp.watermark


def test_empty_recorder():
    rec = RegionRecorder()
    sp = CommPatternProfiler.incremental(rec, backend=CPU)
    delta = sp.update()
    assert delta.n_events == 0 and not delta.regions and not delta.instances
    assert sp.watermark == (0, 0)
    prof = sp.profile(name="profile")
    batch = CommPatternProfiler.from_recorder(rec, backend=CPU)
    assert prof.to_json() == batch.to_json()


def test_instances_only_recorder():
    rec = RegionRecorder()
    rec.enter("setup")
    rec.enter("setup")
    rec.enter("solve")
    live = _stream_profile(rec, [], name="p")
    assert live.to_json() == CommPatternProfiler.from_recorder(
        rec, name="p", backend=CPU
    ).to_json()
    assert live.regions["setup"].instances == 2


# ---------------------------------------------------------------------------
# Watermark semantics: the last row can keep growing
# ---------------------------------------------------------------------------


def test_boundary_row_growth_between_updates():
    rng = random.Random(7)
    rec = RegionRecorder()
    rec.enter("r")
    ev = _port_event(_random_p2p_event(rng, "r", 6))
    for _ in range(4):
        rec.record(ev)
    assert rec.buffer.n_rows == 1 and rec.buffer.n_events == 4

    sp = CommPatternProfiler.incremental(rec, backend=CPU)
    assert sp.update().n_events == 4
    assert sp.watermark == (0, 4) == rec.buffer.watermark()
    for _ in range(3):
        rec.record(ev)
    assert sp.update().n_events == 3
    assert sp.watermark == (0, 7)
    rec.record(_port_event(_random_coll_event(rng, "r", 6)))
    rec.record(ev)
    sp.update(1)
    sp.update()
    assert sp.watermark == rec.buffer.watermark()
    batch = CommPatternProfiler.from_recorder(rec, name="p", backend=CPU)
    assert sp.profile(name="p").to_json() == batch.to_json()


def test_repeated_and_backward_updates_are_noops():
    _, rec = _recorders(11)
    sp = CommPatternProfiler.incremental(rec, backend=CPU)
    sp.update()
    wm, before = sp.watermark, sp.summary.n_events
    for cut in (0, 1, rec.buffer.n_rows):
        d = sp.update(cut)
        assert d.n_events == 0 and not d.regions
    assert sp.watermark == wm and sp.summary.n_events == before


def test_late_instance_entries_ride_the_next_delta():
    _, rec = _recorders(23)
    sp = CommPatternProfiler.incremental(rec, backend=CPU)
    sp.update()
    rec.enter("late_phase")
    rec.enter("quiet")
    d = sp.update()
    assert d.instances.get("late_phase") == 1 and d.instances.get("quiet") == 1
    batch = CommPatternProfiler.from_recorder(rec, name="p", backend=CPU)
    assert sp.profile(name="p").to_json() == batch.to_json()


# ---------------------------------------------------------------------------
# Merge laws (commutative, associative, batch-equal; pickled shards)
# ---------------------------------------------------------------------------


def _random_tree(items, rng):
    if not items:
        return ProfileSummary.empty()
    work = list(items)
    while len(work) > 1:
        i = rng.randrange(len(work) - 1)
        j = rng.randrange(i + 1, len(work))
        b = work.pop(j)
        a = work.pop(i)
        work.insert(rng.randrange(len(work) + 1), a.merge(b))
    return work[0]


def test_deltas_partition_the_stream():
    _, rec = _recorders(5)
    sp = CommPatternProfiler.incremental(rec, backend=CPU)
    deltas = [sp.update(c) for c in np.linspace(0, rec.buffer.n_rows, 7).astype(int)]
    assert sum(d.n_events for d in deltas) == rec.buffer.n_events
    rebuilt = merge_tree(deltas)
    assert rebuilt.n_events == sp.summary.n_events
    assert (
        rebuilt.finalize(name="p").to_json()
        == sp.summary.finalize(name="p").to_json()
        == CommPatternProfiler.from_recorder(rec, name="p", backend=CPU).to_json()
    )


@given(st.integers(0, 10**6))
@settings(max_examples=20, deadline=None)
def test_any_shard_order_and_tree_shape_reduce_identically(seed):
    rng = random.Random(seed)
    ref_rec, rec = _recorders(seed)
    repl = (seed % 3) + 1
    want = RefProfiler.from_recorder(
        ref_rec, name="p", replication=repl, backend="numpy"
    ).to_json()
    shards = _shards(rec, rng)
    variants = []
    for _ in range(3):
        order = list(shards)
        rng.shuffle(order)
        variants.append(_random_tree(order, rng))
    variants += [merge_tree(shards), merge_tree(reversed(shards))]
    acc = ProfileSummary.empty()
    for s in shards:
        acc = acc.merge(s)
    variants.append(acc)
    acc = ProfileSummary.empty()
    for s in reversed(shards):
        acc = s.merge(acc)
    variants.append(acc)
    for v in variants:
        assert v.finalize(name="p", replication=repl).to_json() == want


@given(st.integers(0, 10**6))
@settings(max_examples=20, deadline=None)
def test_merge_commutes_and_associates_pairwise(seed):
    rng = random.Random(seed ^ 0x5EED)
    _, rec = _recorders(seed)
    shards = _shards(rec, rng)
    while len(shards) < 3:
        shards.append(ProfileSummary.empty())
    a, b, c = shards[:3]

    def j(s):
        return s.finalize(name="p").to_json()

    assert j(a.merge(b)) == j(b.merge(a))
    assert j(a.merge(b).merge(c)) == j(a.merge(b.merge(c)))


def test_cross_stream_merge_is_order_independent():
    rng = random.Random(99)
    pool, ref_pool = [], []
    for seed in (1, 2, 3):
        ref_rec, rec = _recorders(seed)
        pool += _shards(rec, random.Random(seed))
        ref_sp = RefProfiler.incremental(ref_rec, backend="numpy")
        ref_pool.append(ref_sp.update())
    want = ref_merge_tree(ref_pool).finalize(name="pool").to_json()
    assert merge_tree(pool).finalize(name="pool").to_json() == want
    for _ in range(5):
        rng.shuffle(pool)
        assert _random_tree(pool, rng).finalize(name="pool").to_json() == want


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("seed", [4, 12, 77])
def test_shard_pickle_roundtrip_preserves_merge(seed, backend):
    rng = random.Random(seed)
    ref_rec, rec = _recorders(seed)
    shards = _shards(rec, rng, backend=BACKENDS[backend])
    blobs = [pickle.dumps(s) for s in shards]
    assert all(b"torch._utils" not in blob for blob in blobs)  # no tensors inside
    rt = [pickle.loads(b) for b in blobs]
    rng.shuffle(rt)
    assert (
        merge_tree(rt).finalize(name="p").to_json()
        == RefProfiler.from_recorder(ref_rec, name="p", backend="numpy").to_json()
    )


def test_region_order_stability_across_merge_orders():
    rng = random.Random(4)
    _, rec = _recorders(12)
    shards = _shards(rec, rng)
    batch = CommPatternProfiler.from_recorder(rec, name="p", backend=CPU)
    event_set = {r for s in shards for r in s.regions}
    want = [r for r in batch.regions if r in event_set]
    for _ in range(4):
        rng.shuffle(shards)
        got = list(merge_tree(shards).finalize(name="p").regions)
        assert [r for r in got if r in event_set] == want


def test_merge_empty_identity_and_types():
    _, rec = _recorders(21)
    sp = CommPatternProfiler.incremental(rec, backend=CPU)
    sp.update()
    s = sp.summary
    for merged in (s.merge(ProfileSummary.empty()), ProfileSummary.empty().merge(s)):
        assert merged.finalize(name="p").to_json() == s.finalize(name="p").to_json()
    assert merge_tree([]).finalize(name="p").to_json() == ProfileSummary().finalize(
        name="p"
    ).to_json()
    merged = merge_tree(_shards(rec, random.Random(8)))
    for rs in merged.regions.values():
        assert rs.sends.dtype == np.int64 and rs.part.dtype == np.bool_
        assert np.all(np.diff(rs.dest_codes) > 0) and np.all(np.diff(rs.src_codes) > 0)
    assert RegionSummary.empty().merge(RegionSummary.empty()).n == 0


# ---------------------------------------------------------------------------
# The four apps streamed live through trace_observer
# ---------------------------------------------------------------------------

APPS = {
    "kripke": (
        kripke.profile,
        kripke.KripkeConfig(
            decomp=Decomp3D(2, 2, 2), nx=4, ny=4, nz=4, n_octants=2, fuse_messages=False
        ),
    ),
    "amg": (amg.profile, amg.AMGConfig(decomp=Decomp3D(2, 2, 2))),
    "laghos": (
        laghos.profile,
        laghos.LaghosConfig(decomp=Decomp3D(2, 2, 1), nx=32, ny=32, n_steps=1),
    ),
    "beatnik": (
        beatnik.profile,
        beatnik.BeatnikConfig(
            decomp=Decomp3D(2, 2, 1), nx=8, ny=8, far_subsample=8, n_steps=3
        ),
    ),
}


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("app", list(APPS))
def test_app_live_parity(app, backend):
    profile_fn, cfg = APPS[app]
    batch = profile_fn(cfg, device="cpu")
    seen = {}

    def observer(rec, *, name, replication, meta):
        sp = CommPatternProfiler.incremental(rec, backend=BACKENDS[backend])
        for c in np.linspace(0, rec.buffer.n_rows, 6).astype(int):
            sp.update(int(c))
        seen["watermark"] = sp.watermark
        return sp.profile(name=name, replication=replication, meta=meta)

    with trace_observer(observer):
        live = profile_fn(cfg, device="cpu")
    assert seen["watermark"][0] >= 0
    assert live.to_json() == batch.to_json()


def test_observer_result_wins_and_scope_restores():
    cfg = kripke.KripkeConfig(decomp=Decomp3D(2, 2, 1), nx=4, ny=4, nz=4)
    sentinel = CommProfile(name="sentinel", n_ranks=0)
    with trace_observer(lambda rec, **kw: None):
        with trace_observer(lambda rec, **kw: sentinel):
            assert kripke.profile(cfg, device="cpu") is sentinel
        prof = kripke.profile(cfg, device="cpu")
        assert prof is not sentinel and prof.regions
    assert kripke.profile(cfg, device="cpu") is not sentinel


def test_default_backend_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, rec = _recorders(3)
    with pytest.raises(BackendUnavailable):
        CommPatternProfiler.incremental(rec)
    with pytest.raises(BackendUnavailable):
        StreamingProfiler(rec)
