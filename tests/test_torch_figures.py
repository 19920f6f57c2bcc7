"""The port's figure drivers against the JAX package's ``benchmarks/``.

Table IV and figs 1–8 run from both packages over the paper's
experiments cut to their points of at most 64 ranks, both on NumPy and
with the reference's system model (TPU v5e constants and system name)
patched into the port, so ``meta_seconds`` agrees.  Every file a driver
writes (markdown and fig 8's heatmap CSVs) and every row it returns must be
byte-equal.  The reference's drivers use flat imports, so ``benchmarks/``
goes on ``sys.path``; results and the profile cache go to ``tmp_path``.
"""

import importlib
import os
from dataclasses import replace

import pytest

from helpers import REPO_SRC
from repro.benchpark import runner as ref_runner
from repro.benchpark.spec import PAPER_EXPERIMENTS as REF_EXPERIMENTS
from repro_torch.benchpark import runner
from repro_torch.benchpark.spec import PAPER_EXPERIMENTS
from repro_torch.figures import paper_data

BENCHMARKS = os.path.abspath(os.path.join(REPO_SRC, "..", "benchmarks"))
MAX_RANKS = 64
DRIVERS = [
    "table4_metrics",
    "fig1_kripke_scaling",
    "fig2_amg_levels",
    "fig3_amg_ranks",
    "fig4_laghos_strong",
    "fig56_bw_msgrate",
    "fig7_hlo_vs_traced",
    "fig8_halo_heatmap",
]


def _cut(spec, system):
    pts = tuple(p for p in spec.points if p.n_ranks <= MAX_RANKS)
    return replace(spec, points=pts, system=system)


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """(reference paper_data, port paper_data, their results dirs)."""
    tmp = tmp_path_factory.mktemp("figures")
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(BENCHMARKS)
        mp.setenv("REPRO_BACKEND", "numpy")
        mp.setenv("REPRO_PROFILE_CACHE_DIR", str(tmp / "cache"))
        for const in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
            mp.setattr(runner, const, getattr(ref_runner, const))
        ref_data = importlib.import_module("paper_data")
        assert os.path.dirname(os.path.abspath(ref_data.__file__)) == BENCHMARKS
        dirs = {"ref": str(tmp / "ref"), "port": str(tmp / "port")}
        for data, key, table in (
            (ref_data, "ref", REF_EXPERIMENTS),
            (paper_data, "port", PAPER_EXPERIMENTS),
        ):
            cut = {
                name: _cut(spec, REF_EXPERIMENTS[name].system)
                for name, spec in table.items()
            }
            mp.setattr(data, "PAPER_EXPERIMENTS", cut)
            mp.setattr(data, "RESULTS", dirs[key])
            data.profiles.cache_clear()
        yield ref_data, dirs
        ref_data.profiles.cache_clear()
        paper_data.profiles.cache_clear()


def _files(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        if os.path.basename(dirpath) == "profiles":
            continue  # the sweeps' JSONs: system and seconds differ by design
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("driver", DRIVERS)
def test_figure_driver_byte_equal_to_reference(driver, packages):
    _ref_data, dirs = packages
    ref_mod = importlib.import_module(driver)
    port_mod = importlib.import_module(f"repro_torch.figures.{driver}")
    before = {k: set(_files(d)) for k, d in dirs.items()}
    ref_rows = ref_mod.run()
    port_rows = port_mod.run()
    assert port_rows == ref_rows
    ref_files, port_files = _files(dirs["ref"]), _files(dirs["port"])
    new = set(port_files) - before["port"]
    assert new == set(ref_files) - before["ref"]
    assert any(name.endswith(".md") for name in new), new
    for name in sorted(new):
        assert port_files[name] == ref_files[name], name


def test_figure_sweeps_cover_the_cut_points(packages):
    """Every cut experiment ran, with no degraded point and no retry."""
    total = 0
    for name, spec in paper_data.PAPER_EXPERIMENTS.items():
        profs = paper_data.profiles(name)
        assert [p.n_ranks for p in profs] == [p.n_ranks for p in spec.points]
        assert not any(p.meta.get("degraded") for p in profs)
        total += len(profs)
    assert total == 13
    assert paper_data.RETRY_LOG.events == []


def test_run_figures_without_a_card_raises_before_any_driver(tmp_path, monkeypatch):
    import torch

    from repro_torch.core.backend import BackendUnavailable
    from repro_torch.figures import run

    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    monkeypatch.setattr(paper_data, "RESULTS", paper_data.RESULTS)
    with pytest.raises(BackendUnavailable):
        run.run_figures(results=str(tmp_path / "results"))
    assert not (tmp_path / "results").exists()


def test_run_figures_fails_when_any_driver_fails(tmp_path, monkeypatch, capsys):
    """Every driver runs, but one failure makes the whole run raise."""
    import functools

    from repro_torch.figures import run

    ran = []
    for name in DRIVERS:
        mod = importlib.import_module(f"repro_torch.figures.{name}")

        def fake(name=name):
            ran.append(name)
            if name == "fig2_amg_levels":
                raise ValueError("broken table")
            return [(f"{name}/row", 1.0, "x")]

        monkeypatch.setattr(mod, "run", fake)
    monkeypatch.setattr(paper_data, "profiles", functools.lru_cache(lambda e: ()))
    monkeypatch.setattr(paper_data, "PAPER_EXPERIMENTS", {})
    monkeypatch.setattr(paper_data, "RESULTS", paper_data.RESULTS)
    with pytest.raises(RuntimeError, match="fig2: ValueError: broken table"):
        run.run_figures(backend="numpy", results=str(tmp_path))
    assert ran == DRIVERS
    assert "fig2/ERROR,0,ValueError:broken table" in capsys.readouterr().out
