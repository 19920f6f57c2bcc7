"""Chaos acceptance on the port: fault-injected sweeps terminate, heal, and
never lie (``tests/test_chaos.py`` re-pointed at ``repro_torch``).

The contract of ``repro_torch.core.faultinject`` + the supervision
layer in ``repro_torch.benchpark.runner``: under *any* seeded fault schedule a
sweep (a) terminates, (b) returns every point either **byte-identical**
(``to_json()``) to the fault-free serial reference, or as an explicit
degraded placeholder (``meta_degraded`` truthy, nonzero ``meta_retries``,
zero regions — never fabricated data), and (c) a sweep killed mid-flight
resumes from its journal re-tracing only the unfinished points (asserted
through the cache-manifest counters, which account for every trace
exactly).

Runs the property over NumPy and the torch backend on the host
(``TorchBackend(device="cpu")``, where the reference runs jax); the
process-pool leg uses tiny three-app specs so the whole schedule sweep
stays in tier-1 budget.  The other tests name ``NumpyBackend``.
"""

import os
import signal
import subprocess
import sys
import textwrap

import pytest

from repro_torch.benchpark.runner import (
    CacheManifest,
    QUARANTINE_DIRNAME,
    ProfileCache,
    RetryLog,
    point_key,
    run_experiment,
)
from repro_torch.benchpark.spec import ExperimentSpec, ScalePoint
from repro_torch.ckpt.manager import SweepJournal
from repro_torch.core.backend import TorchBackend
from repro_torch.core.faultinject import FaultPlan, install_plan
from repro_torch.core.thicket import Frame

BACKEND = "numpy"
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _mini_spec(app):
    """Smallest meaningful two-point sweep per app."""
    points = {
        "kripke": (ScalePoint((2, 2, 1)), ScalePoint((2, 2, 2))),
        "amg": (ScalePoint((2, 2, 1)), ScalePoint((2, 2, 2))),
        "laghos": (ScalePoint((2, 1, 1)), ScalePoint((2, 2, 1))),  # 2-D decomp
    }[app]
    params = {
        "kripke": dict(nx=4, ny=4, nz=4, n_octants=1),
        "amg": dict(nx=8, ny=8, nz=8),
        "laghos": dict(nx=32, ny=32, n_steps=1),
    }[app]
    return ExperimentSpec(
        name=f"chaos-{app}",
        app=app,
        scaling="strong" if app == "laghos" else "weak",
        points=points,
        app_params=params,
        system="test",
    )


# ---------------------------------------------------------------------------
# The chaos property: >= 20 seeded schedules x {numpy, jax}
# ---------------------------------------------------------------------------

#: One sweep per schedule per backend — 20 fault-injected runs total.
#: Sites span every layer the harness threads through: worker entry
#: (soft + hard crash, latency), cache get/put, and the manifest lock.
#: ``key~#a0`` pins a fault to first attempts so retries can heal it;
#: unpinned ``p`` rules re-draw per attempt (and may legitimately exhaust
#: the retry budget — the property admits that as *flagged* degradation).
_CHAOS_SCHEDULES = [
    "worker_crash@n=1",
    "worker_crash@p=0.5",
    "worker_crash@hard,key~#a0,n=1",
    "slow_worker@p=0.6,s=0.05",
    "cache_corrupt@p=0.8",
    "cache_put@n=1",
    "lock_stale@n=4",
    "worker_crash@p=0.4;cache_corrupt@p=0.5",
    "slow_worker@n=1,s=0.05;worker_crash@n=1",
    "worker_crash@p=0.9",
]


def _ok_or_flagged(prof, ref_json, ctx):
    """The property's per-point disjunction."""
    if prof.meta.get("degraded"):
        assert int(prof.meta.get("retries", 0)) > 0, ctx
        assert not prof.regions, ctx  # a gap, never fabricated zeros
    else:
        assert prof.to_json() == ref_json, ctx


@pytest.mark.parametrize(
    "backend", ["numpy", TorchBackend(device="cpu")], ids=["numpy", "torch-cpu"]
)
def test_chaos_schedules_terminate_byte_identical_or_flagged(tmp_path, backend):
    label = backend if isinstance(backend, str) else "torch-cpu"
    refs = {}  # app -> fault-free serial reference jsons
    for i, fault_spec in enumerate(_CHAOS_SCHEDULES):
        app = ("kripke", "amg", "laghos")[i % 3]
        spec = _mini_spec(app)
        if app not in refs:
            with install_plan(None):
                refs[app] = [
                    p.to_json()
                    for p in run_experiment(
                        spec, verbose=False, executor="serial", backend=backend
                    )
                ]
        plan = FaultPlan.parse(fault_spec, seed=100 + i)
        rlog = RetryLog()
        cache_dir = str(tmp_path / label / f"cache{i}")
        with install_plan(plan):
            # cold pass: supervised process pool under the fault schedule
            profs = run_experiment(
                spec,
                verbose=False,
                executor="process",
                max_workers=2,
                cache_dir=cache_dir,
                backend=backend,
                retries=2,
                backoff_s=0.01,
                retry_log=rlog,
            )
            # warm pass: serial over the same cache — exercises the
            # corrupt-entry (quarantined miss) path against real entries
            warm = run_experiment(
                spec,
                verbose=False,
                executor="serial",
                cache_dir=cache_dir,
                backend=backend,
                retries=2,
                backoff_s=0.01,
                retry_log=rlog,
            )
        assert len(profs) == len(warm) == len(spec.points)
        for j, ref_json in enumerate(refs[app]):
            _ok_or_flagged(profs[j], ref_json, (label, i, fault_spec, "cold"))
            _ok_or_flagged(warm[j], ref_json, (label, i, fault_spec, "warm"))
        # quarantine (when it engaged) is bounded and off to the side —
        # never entries the cache could serve again
        qdir = os.path.join(cache_dir, QUARANTINE_DIRNAME)
        if os.path.isdir(qdir):
            assert len(os.listdir(qdir)) <= 64


# ---------------------------------------------------------------------------
# Exhausted retries: explicit degradation, masked frame rows, JSONL log
# ---------------------------------------------------------------------------


def test_exhausted_retries_degrade_with_masked_frame_rows(tmp_path):
    spec = _mini_spec("kripke")
    plan = FaultPlan.parse("worker_crash@p=1.0", seed=0)
    rlog = RetryLog(path=str(tmp_path / "retries.jsonl"))
    with install_plan(plan):
        profs = run_experiment(
            spec,
            verbose=False,
            executor="serial",
            backend=BACKEND,
            retries=1,
            backoff_s=0.0,
            retry_log=rlog,
        )
    assert len(profs) == len(spec.points)
    for p in profs:
        assert p.meta.get("degraded") is True
        assert p.meta.get("retries") == 2  # retries=1 -> two attempts
        assert not p.regions
        assert "seconds" not in p.meta  # no fabricated roofline estimate
    # the frame carries the gap as a visible row with masked stats
    csv = Frame.from_profiles(profs).to_csv()
    header = csv.splitlines()[0].split(",")
    assert "meta_degraded" in header and "meta_retries" in header
    assert "total_bytes_sent" not in header  # nothing fabricated to report
    # every supervision event is mirrored to the JSONL retry log
    lines = (tmp_path / "retries.jsonl").read_text().splitlines()
    assert len(lines) == len(rlog.events) == 2 * len(spec.points)
    assert all('"kind": "error"' in ln for ln in lines)


# ---------------------------------------------------------------------------
# Satellite: slow_worker + per-point timeout on the thread executor
# ---------------------------------------------------------------------------


def test_slow_worker_timeout_fires_then_retry_matches_serial():
    """A point injected to hang on its first attempt is timed out by the
    supervisor, retried (the fault is pinned to ``#a0``), and the final
    sweep is byte-identical to the fault-free serial run."""
    spec = _mini_spec("amg")
    ref = run_experiment(spec, verbose=False, executor="serial", backend=BACKEND)
    target = point_key(spec, spec.points[1])  # chaos-amg-00008
    plan = FaultPlan.parse(f"slow_worker@key~{target}#a0,s=5", seed=3)
    rlog = RetryLog()
    with install_plan(plan):
        profs = run_experiment(
            spec,
            verbose=False,
            executor="thread",
            backend=BACKEND,
            max_workers=2,
            point_timeout_s=1.0,
            retries=2,
            backoff_s=0.01,
            retry_log=rlog,
        )
    timeouts = [e for e in rlog.events if e["kind"] == "timeout"]
    assert [e["point"] for e in timeouts] == [target]
    assert timeouts[0]["attempt"] == 0
    for got, want in zip(profs, ref):
        assert got.to_json() == want.to_json()
        assert "degraded" not in got.meta and "retries" not in got.meta


# ---------------------------------------------------------------------------
# Satellite: kill a sweep mid-flight, resume only the unfinished points
# ---------------------------------------------------------------------------

_KILLED_DRIVER = """\
import os
import signal
import sys

sys.path.insert(0, {src!r})

from repro_torch.benchpark.runner import run_experiment
from repro_torch.benchpark.spec import ExperimentSpec, ScalePoint
from repro_torch.ckpt.manager import SweepJournal


class KillingJournal(SweepJournal):
    '''SIGKILL the sweep the instant the second point is journaled.'''

    def record(self, key, payload):
        super().record(key, payload)
        if len(self.completed()) >= 2:
            os.kill(os.getpid(), signal.SIGKILL)


spec = ExperimentSpec(
    name="chaos-resume",
    app="kripke",
    scaling="weak",
    points=(ScalePoint((1, 1, 2)), ScalePoint((1, 2, 2)), ScalePoint((2, 2, 2))),
    app_params=dict(nx=4, ny=4, nz=4, n_octants=1),
    system="test",
)
run_experiment(
    spec,
    verbose=False,
    executor="serial",
    backend="numpy",
    cache_dir=sys.argv[1],
    journal=KillingJournal(sys.argv[2]),
)
raise SystemExit("unreachable: the journal must have killed this process")
"""


def test_killed_sweep_resumes_only_unfinished_points(tmp_path):
    spec = ExperimentSpec(
        name="chaos-resume",
        app="kripke",
        scaling="weak",
        points=(ScalePoint((1, 1, 2)), ScalePoint((1, 2, 2)), ScalePoint((2, 2, 2))),
        app_params=dict(nx=4, ny=4, nz=4, n_octants=1),
        system="test",
    )
    cache_root = str(tmp_path / "cache")
    journal_dir = str(tmp_path / "journal")
    driver = tmp_path / "driver.py"
    driver.write_text(_KILLED_DRIVER.format(src=SRC))
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, str(driver), cache_root, journal_dir],
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stderr

    # the dead run journaled exactly two points, each traced exactly once
    keys = [point_key(spec, pt) for pt, _ in spec.configs()]
    assert set(SweepJournal(journal_dir).completed()) == set(keys[:2])
    before = CacheManifest(cache_root).read()
    assert before["misses"] == 2 and before["puts"] == 2 and before["hits"] == 0

    # resume: journal-resumed points touch neither tracer nor cache,
    # so the manifest advances by exactly the one unfinished point
    profs = run_experiment(
        spec,
        verbose=False,
        executor="serial",
        backend=BACKEND,
        cache_dir=cache_root,
        journal=journal_dir,
    )
    after = CacheManifest(cache_root).read()
    assert after["misses"] == 3 and after["puts"] == 3 and after["hits"] == 0
    assert set(SweepJournal(journal_dir).completed()) == set(keys)

    # and the stitched sweep is byte-identical to a fault-free serial run
    ref = run_experiment(spec, verbose=False, executor="serial", backend=BACKEND)
    for got, want in zip(profs, ref):
        assert got.to_json() == want.to_json()

    # a second resume is a pure journal replay: zero new cache traffic
    again = run_experiment(
        spec,
        verbose=False,
        executor="serial",
        backend=BACKEND,
        cache_dir=cache_root,
        journal=journal_dir,
    )
    final = CacheManifest(cache_root).read()
    assert {k: final[k] for k in ("hits", "misses", "puts")} == {
        k: after[k] for k in ("hits", "misses", "puts")
    }
    for got, want in zip(again, ref):
        assert got.to_json() == want.to_json()


# ---------------------------------------------------------------------------
# Degraded points flow through run_experiment outputs without poisoning
# ---------------------------------------------------------------------------


def test_degraded_point_rides_frame_csv_and_out_dir(tmp_path):
    """A sweep with one degraded point still writes its artifacts: the
    healthy points' rows are full, the degraded one is a masked row."""
    spec = _mini_spec("kripke")
    target = point_key(spec, spec.points[0])
    plan = FaultPlan.parse(f"worker_crash@key~{target},p=1.0", seed=1)
    csv_path = tmp_path / "frame.csv"
    with install_plan(plan):
        profs = run_experiment(
            spec,
            out_dir=str(tmp_path / "out"),
            verbose=False,
            executor="serial",
            backend=BACKEND,
            retries=0,
            backoff_s=0.0,
            frame_csv=str(csv_path),
        )
    assert profs[0].meta.get("degraded") and not profs[0].regions
    assert not profs[1].meta.get("degraded") and profs[1].regions
    lines = csv_path.read_text().splitlines()
    header = lines[0].split(",")
    assert "meta_degraded" in header and "total_bytes_sent" in header
    # one masked row for the degraded point + one row per healthy region
    assert len(lines) == 1 + 1 + len(profs[1].regions)
    saved = sorted(os.listdir(tmp_path / "out"))
    assert saved == [f"{spec.name}-{pt.n_ranks:05d}.json" for pt in spec.points]
