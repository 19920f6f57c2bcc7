"""The port's Benchpark sweeps against the JAX package's.

For each of the paper's five experiments, cut to its points of at most 64
ranks, ``run_experiment(..., executor="serial", backend="numpy")`` of both
packages gives byte-equal ``to_json()`` once ``meta["seconds"]`` and
``meta["system"]`` are masked: the port's system model is an H100's
datasheet, the reference's a TPU v5e's.  With the reference's constants
and system name patched into the port, the whole sweep frame CSV is
byte-equal too, ``meta_seconds`` included, which holds the roofline
formula itself.  Without a CUDA device the default backend raises
``BackendUnavailable`` under every executor, before any point runs.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace

import pytest
import torch

from helpers import REPO_SRC
from repro.benchpark import runner as ref_runner
from repro.benchpark.spec import PAPER_EXPERIMENTS as REF_EXPERIMENTS
from repro.core.thicket import Frame as RefFrame
from repro_torch.apps.kripke import KripkeConfig
from repro_torch.apps.stencil import Decomp3D
from repro_torch.benchpark import runner
from repro_torch.benchpark.runner import RetryLog, run_experiment
from repro_torch.benchpark.spec import PAPER_EXPERIMENTS, ExperimentSpec, ScalePoint
from repro_torch.core.backend import BackendUnavailable, NumpyBackend
from repro_torch.core.profiler import CommProfile
from repro_torch.core.thicket import Frame

MAX_RANKS = 64


def _cut(spec):
    return replace(spec, points=tuple(p for p in spec.points if p.n_ranks <= MAX_RANKS))


def _masked(prof) -> str:
    prof = CommProfile.from_json(prof.to_json())
    prof.meta = {k: v for k, v in prof.meta.items() if k not in ("seconds", "system")}
    return prof.to_json()


@pytest.fixture(scope="module")
def ref_sweeps() -> dict:
    return {
        name: ref_runner.run_experiment(
            _cut(spec), verbose=False, executor="serial", backend="numpy"
        )
        for name, spec in REF_EXPERIMENTS.items()
    }


def test_specs_match_the_reference():
    assert list(PAPER_EXPERIMENTS) == list(REF_EXPERIMENTS)
    for name, spec in PAPER_EXPERIMENTS.items():
        ref = REF_EXPERIMENTS[name]
        assert (spec.name, spec.app, spec.scaling) == (ref.name, ref.app, ref.scaling)
        assert [p.decomp for p in spec.points] == [p.decomp for p in ref.points]
        assert spec.app_params == ref.app_params
        assert spec.system == "dgx-h100" != ref.system


@pytest.mark.parametrize("name", list(REF_EXPERIMENTS))
def test_sweep_profiles_byte_equal_to_reference(name, ref_sweeps):
    got = run_experiment(
        _cut(PAPER_EXPERIMENTS[name]), verbose=False, executor="serial",
        backend="numpy",
    )
    want = ref_sweeps[name]
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.meta["system"] == "dgx-h100"
        assert g.meta["seconds"] > 0
        assert _masked(g) == _masked(w), g.name


def test_sweep_frame_csv_byte_equal_with_reference_system_model(
    ref_sweeps, monkeypatch
):
    for const in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(runner, const, getattr(ref_runner, const))
    got, want = [], []
    for name, spec in PAPER_EXPERIMENTS.items():
        spec = replace(_cut(spec), system=REF_EXPERIMENTS[name].system)
        got += run_experiment(spec, verbose=False, executor="serial", backend="numpy")
        want += ref_sweeps[name]
    csv = Frame.from_profiles(got).to_csv()
    assert "meta_seconds" in csv.splitlines()[0]
    assert csv == RefFrame.from_profiles(want).to_csv()


def test_roofline_seconds_with_h100_datasheet_constants():
    assert (runner.PEAK_FLOPS, runner.HBM_BW, runner.LINK_BW) == (989e12, 3.35e12, 50e9)
    cfg = KripkeConfig(decomp=Decomp3D(2, 2, 1), nx=4, ny=4, nz=4, n_octants=1)
    # 12 flops a zone, direction and group: 64 zones, the default angles
    ang = cfg.n_dirsets * cfg.n_groupsets * cfg.dirs_per_set * cfg.groups_per_set
    flops = 12.0 * 64 * ang
    # no traffic: the memory term (2 bytes a flop) bounds the step
    empty = CommProfile(name="empty", n_ranks=4)
    assert runner._roofline_seconds("kripke", cfg, empty) == 2.0 * flops / 3.35e12
    # the busiest region's per-rank bytes over one NDR port
    prof = run_experiment(
        ExperimentSpec(name="h100", app="kripke", scaling="weak",
                       points=(ScalePoint((2, 2, 1)),),
                       app_params=dict(nx=4, ny=4, nz=4, n_octants=1)),
        verbose=False, executor="serial", backend="numpy",
    )[0]
    wire = max(s.bytes_sent[1] + s.coll_bytes[1] for s in prof.regions.values())
    assert wire > 0
    want = max(flops / 989e12, 2.0 * flops / 3.35e12, wire / 50e9)
    assert prof.meta["seconds"] == want
    assert runner._roofline_seconds("kripke", cfg, prof) == want


@pytest.mark.parametrize("executor", ["serial", "thread", "process"])
def test_default_backend_without_a_card_raises_before_any_point(
    executor, tmp_path, monkeypatch
):
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    spec = ExperimentSpec(
        name="no-card", app="kripke", scaling="weak",
        points=(ScalePoint((1, 1, 2)), ScalePoint((1, 2, 2))),
        app_params=dict(nx=4, ny=4, nz=4, n_octants=1),
    )
    rlog = RetryLog()
    with pytest.raises(BackendUnavailable):
        run_experiment(
            spec, verbose=False, executor=executor, max_workers=2,
            cache_dir=str(tmp_path / "cache"), out_dir=str(tmp_path / "out"),
            journal=str(tmp_path / "journal"), retry_log=rlog,
        )
    # no point ran: no retry, no cache traffic, nothing written or journaled
    assert rlog.events == []
    assert not os.path.exists(tmp_path / "out")
    assert not os.path.exists(tmp_path / "cache" / "manifest.json")
    journal = tmp_path / "journal"
    assert not journal.exists() or os.listdir(journal) == []


_SYS_PATH_SWEEP = """
import json, os, sys

sys.path.insert(0, sys.argv[1])
from repro_torch.benchpark.runner import run_experiment
from repro_torch.benchpark.spec import ExperimentSpec, ScalePoint


def main():
    spec = ExperimentSpec(
        name="sys-path", app="kripke", scaling="weak",
        points=(ScalePoint((1, 1, 2)), ScalePoint((1, 2, 2))),
        app_params=dict(nx=4, ny=4, nz=4, n_octants=1),
    )
    out = {}
    for method in ("forkserver", "spawn"):
        os.environ["REPRO_POOL_START_METHOD"] = method
        profs = run_experiment(spec, verbose=False, executor="process",
                               max_workers=2, backend="numpy", retries=0)
        out[method] = [p.to_json() for p in profs]
    serial = run_experiment(spec, verbose=False, executor="serial", backend="numpy")
    out["serial"] = [p.to_json() for p in serial]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
"""


def test_pool_workers_find_the_port_on_a_run_time_sys_path(tmp_path):
    """A script that puts ``src`` on ``sys.path`` itself (as ``chip_smoke.py``
    does) hands that path to forkserver and spawn workers."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = tmp_path / "sweep.py"
    script.write_text(_SYS_PATH_SWEEP)
    proc = subprocess.run(
        [sys.executable, str(script), os.path.abspath(REPO_SRC)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forkserver"] == out["serial"] == out["spawn"]
    assert all('"degraded"' not in p for p in out["forkserver"] + out["spawn"])


def test_numpy_and_torch_cpu_sweeps_byte_equal():
    from repro_torch.core.backend import TorchBackend

    spec = _cut(PAPER_EXPERIMENTS["amg-weak-tioga"])
    a = run_experiment(spec, verbose=False, executor="serial", backend=NumpyBackend())
    b = run_experiment(spec, verbose=False, executor="thread",
                       backend=TorchBackend(device="cpu"))
    assert [p.to_json() for p in a] == [p.to_json() for p in b]
