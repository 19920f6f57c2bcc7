"""The port's SweepAggregator: atomic shard publish, crash tolerance, live
parity (``tests/test_aggregator.py`` re-pointed at ``repro_torch``).

Covers the aggregator half of the streaming tentpole: O_EXCL + atomic
rename shard publication, ingest of partial shard sets (a lost/withheld
shard degrades the served view, never corrupts it — partial frames carry
the ingest watermark in meta columns), bit-identical convergence once a
late shard arrives, corrupt-file skipping, the finished-profile shard
kind (what cache hits publish), and the end-to-end acceptance criterion:
a process-pool ``run_experiment(live_dir=...)`` sweep over all three apps
produces profiles byte-identical (``to_json()``) to the batch path, both
as returned by the runner and as merged by the aggregator.  Random
streams come from the reference's generator and cross into the port as
plain dicts (``repro_torch.interop``); shards reduce on
``TorchBackend(device="cpu")`` and the sweeps on ``NumpyBackend``, named.
A shard pickled by a process that reduced on torch loads in a process
that never imported the card's backend.
"""

import logging
import os
import pickle
import shutil

import pytest

from test_profiler_parity import _random_recorder
from test_torch_profiler import _event_dicts

from repro_torch.benchpark.aggregator import (
    SweepAggregator,
    publish_shard,
    shard_filename,
)
from repro_torch.benchpark.runner import point_key, run_experiment
from repro_torch.benchpark.spec import ExperimentSpec, ScalePoint
from repro_torch.core.backend import TorchBackend
from repro_torch.core.profiler import CommPatternProfiler
from repro_torch.core.streaming import ProfileSummary
from repro_torch.interop import recorder_from_event_dicts

CPU = TorchBackend(device="cpu")
BACKEND = "numpy"


def _point_shards(seed, n_shards=3):
    """A point's batch profile + its stream cut into n_shards deltas."""
    ref_rec = _random_recorder(seed)
    rec = recorder_from_event_dicts(_event_dicts(ref_rec), ref_rec.instances)
    batch = CommPatternProfiler.from_recorder(rec, name=f"pt{seed}", backend=CPU)
    sp = CommPatternProfiler.incremental(rec, backend=CPU)
    n = rec.buffer.n_rows
    deltas = [sp.update((n * (i + 1)) // n_shards) for i in range(n_shards)]
    tail = sp.update()
    if tail.n_events or tail.regions or tail.instances:
        deltas.append(tail)
    return batch, deltas


def _publish_all(root, point, deltas, name):
    for i, d in enumerate(deltas):
        publish_shard(
            root, point=point, seq=i, total=len(deltas), summary=d, name=name
        )


# ---------------------------------------------------------------------------
# Publish / ingest round-trip
# ---------------------------------------------------------------------------


def test_publish_ingest_roundtrip(tmp_path):
    root = str(tmp_path)
    batch, deltas = _point_shards(7)
    _publish_all(root, "pt7", deltas, batch.name)
    agg = SweepAggregator(root)
    assert agg.ingest() == len(deltas)
    assert agg.ingest() == 0  # idempotent
    assert agg.points() == ["pt7"]
    assert agg.watermark("pt7") == (len(deltas), len(deltas))
    assert agg.complete("pt7") and agg.complete()
    assert agg.profile("pt7").to_json() == batch.to_json()


def test_shard_filename_contract():
    assert shard_filename("kripke-x-00064", 2, 5) == "kripke-x-00064.0002of0005.shard"
    with pytest.raises(ValueError):
        shard_filename("p", 5, 5)
    with pytest.raises(ValueError):
        shard_filename("p", -1, 5)
    with pytest.raises(ValueError):
        publish_shard("/nonexistent", point="p", seq=0, total=1)  # no payload
    with pytest.raises(ValueError):
        publish_shard(
            "/nonexistent",
            point="p",
            seq=0,
            total=2,  # a finished profile must be the only shard
            profile_json="{}",
        )


def test_profile_kind_shard(tmp_path):
    """Cache hits ship finished JSON; the aggregator serves it verbatim."""
    root = str(tmp_path)
    batch, _ = _point_shards(3)
    publish_shard(
        root,
        point="cached-pt",
        seq=0,
        total=1,
        profile_json=batch.to_json(),
        name=batch.name,
        meta=batch.meta,
    )
    agg = SweepAggregator(root)
    assert agg.ingest() == 1
    assert agg.complete("cached-pt")
    assert agg.profile("cached-pt").to_json() == batch.to_json()


# ---------------------------------------------------------------------------
# Shard loss: degrade, never corrupt; converge when the shard arrives
# ---------------------------------------------------------------------------


def test_withheld_shard_partial_then_convergence(tmp_path):
    root = str(tmp_path / "shards")
    hold = str(tmp_path / "held")
    os.makedirs(hold)
    batch, deltas = _point_shards(19, n_shards=4)
    _publish_all(root, "pt19", deltas, batch.name)
    withheld = shard_filename("pt19", 1, len(deltas))
    shutil.move(os.path.join(root, withheld), os.path.join(hold, withheld))

    agg = SweepAggregator(root)
    assert agg.ingest() == len(deltas) - 1
    assert agg.watermark("pt19") == (len(deltas) - 1, len(deltas))
    assert not agg.complete("pt19") and not agg.complete()

    # the partial view is a well-formed profile over the arrived events
    partial = agg.profile("pt19")
    arrived = [d for i, d in enumerate(deltas) if i != 1]
    expect = ProfileSummary.empty()
    for d in arrived:
        expect = expect.merge(d)
    assert partial.to_json() == expect.finalize(name=batch.name).to_json()
    assert sum(d.n_events for d in arrived) < sum(d.n_events for d in deltas)

    # the partial frame is tagged with the ingest watermark
    frame = agg.frame(include_partial=True)
    csv = frame.to_csv()
    header = csv.splitlines()[0].split(",")
    assert "meta_ingest_shards" in header
    assert "meta_ingest_total" in header
    assert "meta_complete" in header
    assert agg.frame(include_partial=False).to_csv().count("\n") <= 1

    # the late shard arrives: bit-identical convergence
    shutil.move(os.path.join(hold, withheld), os.path.join(root, withheld))
    assert agg.ingest() == 1
    assert agg.complete("pt19")
    assert agg.profile("pt19").to_json() == batch.to_json()
    # watermark tags live on frame copies only — profile() stays pristine
    assert "ingest_shards" not in agg.profile("pt19").meta
    assert agg.frame(include_partial=False).to_csv().count("\n") > 1


def test_corrupt_shard_skipped_and_retried(tmp_path):
    root = str(tmp_path)
    batch, deltas = _point_shards(5, n_shards=2)
    for i, d in enumerate(deltas[:-1]):
        publish_shard(
            root, point="pt5", seq=i, total=len(deltas), summary=d, name=batch.name
        )
    bad = os.path.join(root, shard_filename("pt5", len(deltas) - 1, len(deltas)))
    with open(bad, "wb") as f:
        f.write(b"torn write / not a pickle")
    agg = SweepAggregator(root)
    got = agg.ingest()
    assert got == len(deltas) - 1  # the corrupt one is skipped
    assert not agg.complete("pt5")
    # foreign files are ignored entirely
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("hi")
    assert agg.ingest() == 0
    # the writer retries with a good copy (atomic overwrite) -> converges
    publish_shard(
        root,
        point="pt5",
        seq=len(deltas) - 1,
        total=len(deltas),
        summary=deltas[-1],
        name=batch.name,
    )
    assert agg.ingest() == 1
    assert agg.profile("pt5").to_json() == batch.to_json()


def test_unreadable_shard_quarantined_after_bounded_retries(tmp_path, caplog):
    """Satellite: a permanently torn file gets ``max_load_retries`` ingest
    passes to be healed by an atomic overwrite, then is quarantined — it
    can degrade the view but never wedge ingest in a retry-forever loop."""
    root = str(tmp_path)
    bad = os.path.join(root, shard_filename("ptX", 0, 1))
    with open(bad, "wb") as f:
        f.write(b"never a pickle")
    agg = SweepAggregator(root, max_load_retries=2)
    with caplog.at_level(logging.WARNING, logger="repro_torch.benchpark.aggregator"):
        assert agg.ingest() == 0  # failed load 1: retained for retry
        assert os.path.exists(bad)
        assert agg.ingest() == 0  # failed load 2: budget spent -> quarantine
    assert not os.path.exists(bad)
    qdir = os.path.join(root, "quarantine")
    assert len(os.listdir(qdir)) == 1
    assert len(agg.quarantined) == 1 and qdir in agg.quarantined[0]
    assert any("unreadable" in r.getMessage() for r in caplog.records)
    # given up for good: later passes don't resurrect or re-count it
    assert agg.ingest() == 0 and len(agg.quarantined) == 1
    assert "ptX" not in agg.points()
    # a healthy publisher re-publishing the point (under a different
    # sharding — the given-up filename itself stays ignored) converges
    batch, deltas = _point_shards(23, n_shards=2)
    _publish_all(root, "ptX", deltas, batch.name)
    assert agg.ingest() == len(deltas)
    assert agg.complete("ptX")
    assert agg.profile("ptX").to_json() == batch.to_json()


def test_env_bounds_load_retries(tmp_path, monkeypatch):
    from repro_torch.benchpark.aggregator import AGG_MAX_RETRIES_ENV

    monkeypatch.setenv(AGG_MAX_RETRIES_ENV, "7")
    assert SweepAggregator(str(tmp_path)).max_load_retries == 7
    monkeypatch.setenv(AGG_MAX_RETRIES_ENV, "0")  # floor: at least one try
    assert SweepAggregator(str(tmp_path)).max_load_retries == 1


def test_conflicting_publisher_totals_resolved_by_majority(tmp_path, caplog):
    """Satellite: two publishers disagree on a point's ``NNNNofNNNN``
    total (a re-run with a different ``live_shards``, a buggy worker).
    Majority vote over ingested files wins — retroactively: the earlier
    minority shard is evicted and quarantined when the majority flips,
    and the served profile converges to the majority's batch bytes."""
    root = str(tmp_path)
    batch, deltas = _point_shards(11, n_shards=3)  # truth: len(deltas) shards
    _, wrong = _point_shards(11, n_shards=2)  # a conflicting sharding
    # the conflicting publisher lands first and becomes the incumbent
    publish_shard(root, point="pt11", seq=0, total=9, summary=wrong[0],
                  name=batch.name)
    agg = SweepAggregator(root, max_load_retries=3)
    assert agg.ingest() == 1
    assert agg.watermark("pt11") == (1, 9)
    # now the real sweep publishes its full majority set
    _publish_all(root, "pt11", deltas, batch.name)
    with caplog.at_level(logging.WARNING, logger="repro_torch.benchpark.aggregator"):
        agg.ingest()  # majority flips: the total=9 incumbent is evicted
        agg.ingest()  # deferred majority files (pre-flip pass order) land
    assert agg.complete("pt11"), agg.watermark("pt11")
    assert agg.profile("pt11").to_json() == batch.to_json()
    assert len(agg.quarantined) == 1
    assert "0000of0009" in os.path.basename(agg.quarantined[0])
    assert any("minority total" in r.getMessage() for r in caplog.records)
    # the view stays stable afterwards — nothing oscillates back
    assert agg.ingest() == 0
    assert agg.profile("pt11").to_json() == batch.to_json()


def test_minority_total_straggler_is_deferred_then_quarantined(tmp_path):
    """A minority-total shard arriving *after* the majority settled is
    deferred (a later flip could legitimize it), then quarantined once its
    bounded retry budget is spent — the majority view never flinches."""
    root = str(tmp_path)
    batch, deltas = _point_shards(13, n_shards=3)
    _, wrong = _point_shards(13, n_shards=2)
    _publish_all(root, "pt13", deltas, batch.name)
    agg = SweepAggregator(root, max_load_retries=2)
    assert agg.ingest() == len(deltas)
    assert agg.complete("pt13")
    publish_shard(root, point="pt13", seq=0, total=9, summary=wrong[0],
                  name=batch.name)
    assert agg.ingest() == 0  # deferred, not ingested (fail 1)
    straggler = os.path.join(root, shard_filename("pt13", 0, 9))
    assert os.path.exists(straggler)
    assert agg.ingest() == 0  # budget spent (fail 2) -> quarantined
    assert not os.path.exists(straggler)
    assert len(agg.quarantined) == 1
    assert agg.profile("pt13").to_json() == batch.to_json()


def test_publish_is_atomic_no_temp_left(tmp_path):
    root = str(tmp_path)
    _, deltas = _point_shards(2, n_shards=1)
    publish_shard(root, point="p", seq=0, total=1, summary=deltas[0])
    names = os.listdir(root)
    assert names == [shard_filename("p", 0, 1)]
    with open(os.path.join(root, names[0]), "rb") as f:
        payload = pickle.load(f)
    assert payload["kind"] == "summary"


def test_aggregator_restart_rebuilds_from_directory(tmp_path):
    """All state is in the directory: a fresh aggregator (new process
    after a crash) serves the same view."""
    root = str(tmp_path)
    batch, deltas = _point_shards(29)
    _publish_all(root, "pt29", deltas, batch.name)
    a1 = SweepAggregator(root)
    a1.ingest()
    a2 = SweepAggregator(root)  # restart
    a2.ingest()
    assert a1.profile("pt29").to_json() == a2.profile("pt29").to_json()


_LOAD_SHARDS = """
import sys

sys.path.insert(0, sys.argv[1])
import torch

assert not torch.cuda.is_available()
from repro_torch.benchpark.aggregator import SweepAggregator

agg = SweepAggregator(sys.argv[2])
assert agg.ingest() == int(sys.argv[3]) and agg.complete()
print(agg.profile("pt31").to_json())
"""


def test_torch_reduced_shard_holds_no_tensor_and_loads_without_a_card(tmp_path):
    """A shard whose deltas the torch backend reduced pickles NumPy arrays
    only — no tensor anywhere in it — and a process that sees no CUDA
    device merges it to the batch profile."""
    import subprocess
    import sys

    from helpers import REPO_SRC

    import io

    import torch

    class NoTensor(pickle.Pickler):
        def reducer_override(self, obj):
            assert not isinstance(obj, torch.Tensor), type(obj)
            return NotImplemented

    root = str(tmp_path)
    batch, deltas = _point_shards(31)
    for d in deltas:
        NoTensor(io.BytesIO()).dump(d)
    _publish_all(root, "pt31", deltas, batch.name)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_SHARDS, os.path.abspath(REPO_SRC), root,
         str(len(deltas))],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == batch.to_json()


# ---------------------------------------------------------------------------
# End to end: three-app process-pool live sweep == batch, byte for byte
# ---------------------------------------------------------------------------


def _tiny_specs():
    return [
        ExperimentSpec(
            name="agg-kripke",
            app="kripke",
            scaling="weak",
            points=[ScalePoint((2, 2, 1)), ScalePoint((2, 2, 2))],
            app_params={"nx": 4, "ny": 4, "nz": 4, "n_octants": 1},
            system="test",
        ),
        ExperimentSpec(
            name="agg-amg",
            app="amg",
            scaling="weak",
            points=[ScalePoint((2, 2, 1))],
            app_params={"nx": 8, "ny": 8, "nz": 8},
            system="test",
        ),
        ExperimentSpec(
            name="agg-laghos",
            app="laghos",
            scaling="strong",
            points=[ScalePoint((2, 2, 1))],
            app_params={"nx": 32, "ny": 32, "n_steps": 1},
            system="test",
        ),
    ]


def test_live_process_sweep_matches_batch(tmp_path):
    live_root = str(tmp_path / "live")
    batch = {}
    for spec in _tiny_specs():
        profs = run_experiment(
            spec, verbose=False, executor="serial", backend=BACKEND
        )
        for (pt, _), prof in zip(spec.configs(), profs):
            batch[point_key(spec, pt)] = prof

    agg = SweepAggregator(live_root)
    live = {}
    for spec in _tiny_specs():
        profs = run_experiment(
            spec,
            verbose=False,
            executor="process",
            backend=BACKEND,
            max_workers=2,
            live_dir=live_root,
            live_shards=3,
        )
        agg.ingest()  # mid-sweep ingest must never break anything
        for (pt, _), prof in zip(spec.configs(), profs):
            live[point_key(spec, pt)] = prof

    agg.ingest()
    assert agg.complete(), agg.watermark()
    assert sorted(agg.points()) == sorted(batch)
    for key, ref in batch.items():
        assert live[key].to_json() == ref.to_json(), key
        assert agg.profile(key).to_json() == ref.to_json(), key
    frame = agg.frame()
    csv = frame.to_csv()
    assert "meta_complete" in csv.splitlines()[0]
    assert len(csv.splitlines()) > len(batch)  # header + >=1 row per point


def test_live_serial_sweep_with_cache_hits(tmp_path):
    """Cache-hit points publish finished-JSON shards; parity still holds."""
    spec = _tiny_specs()[0]
    cache_dir = str(tmp_path / "cache")
    live_root = str(tmp_path / "live")
    first = run_experiment(
        spec, verbose=False, executor="serial", backend=BACKEND, cache_dir=cache_dir
    )
    second = run_experiment(
        spec,
        verbose=False,
        executor="serial",
        backend=BACKEND,
        cache_dir=cache_dir,
        live_dir=live_root,
    )
    agg = SweepAggregator(live_root)
    agg.ingest()
    assert agg.complete()
    for (pt, _), a, b in zip(spec.configs(), first, second):
        key = point_key(spec, pt)
        assert agg.watermark(key) == (1, 1)  # one finished-profile shard
        assert a.to_json() == b.to_json()
        assert agg.profile(key).to_json() == a.to_json()
