"""The four apps' distributed drivers run for real over ``torch.distributed``.

kripke's ``distributed_sweep``, amg's ``solve`` and laghos's and beatnik's
``run_steps`` run on 8 gloo ranks (one spawn for the file) at the configs
of ``tests/test_apps.py``'s 8-rank parity tests, and are held at those
tests' tolerances to the port's single-domain oracles and to ``repro``'s
distributed outputs on 8 forced host devices (one subprocess).  The
profile recorded during the real run must equal, byte for byte, the meta
trace's and ``repro``'s.  The single-rank tests run in this process on a
gloo group of one rank; one test runs two drivers under ``torchrun``.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import REPO_SRC, run_with_devices
from repro.apps import amg as ref_amg
from repro.apps import beatnik as ref_beatnik
from repro.apps import kripke as ref_kripke
from repro.apps import laghos as ref_laghos
from repro.apps.stencil import Decomp3D as RefDecomp3D
from repro_torch.apps import amg, laghos, multirank
from repro_torch.apps.stencil import Decomp3D
from repro_torch.core.ranks import run_ranks

APPS = list(multirank.PARITY_PARAMS)

#: (rtol, atol) per output in ``multirank.flat_outputs`` order, from
#: tests/test_apps.py (kripke :69, amg :122, laghos :162, beatnik :239)
TOLERANCES = {
    "kripke": [(2e-5, 2e-5)],
    "amg": [(2e-4, 2e-5), (1e-4, 0.0)],
    "laghos": [(5e-5, 5e-6)] * 4 + [(1e-5, 0.0)],
    "beatnik": [(5e-5, 5e-6)] * 2 + [(1e-4, 0.0)],
}

_JAX = """
import json, numpy as np, jax
from repro.apps import amg, beatnik, kripke, laghos
from repro.apps.stencil import Decomp3D
params = json.load(open({params!r}))
def flat(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in flat(v)]
    return [out]
runs = {{
    "kripke": (kripke.KripkeConfig, kripke.distributed_sweep,
               lambda c: kripke.make_source(c, global_shape=True)),
    "amg": (amg.AMGConfig, amg.solve, amg.make_rhs),
    "laghos": (laghos.LaghosConfig, laghos.run_steps, laghos.make_state),
    "beatnik": (beatnik.BeatnikConfig, beatnik.run_steps, beatnik.make_state),
}}
out = {{}}
for app, (cls, driver, inputs) in runs.items():
    p = dict(params[app])
    c = cls(decomp=Decomp3D(*p.pop("decomp")), **p)
    # jit: eager shard_map takes minutes here
    got = jax.jit(driver(c, c.decomp.make_mesh()))(inputs(c))
    for i, t in enumerate(flat(got)):
        out[f"{{app}}.{{i}}"] = np.asarray(t)
np.savez({out!r}, **out)
print("OK")
"""

_REF = {
    "kripke": (ref_kripke, ref_kripke.KripkeConfig),
    "amg": (ref_amg, ref_amg.AMGConfig),
    "laghos": (ref_laghos, ref_laghos.LaghosConfig),
    "beatnik": (ref_beatnik, ref_beatnik.BeatnikConfig),
}


@pytest.fixture(scope="module")
def runs():
    """(the port's 8-rank results, repro's 8-device outputs)."""
    port = run_ranks(multirank.run_apps, 8, backend="gloo",
                     args=(multirank.PARITY_PARAMS, "cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"params": os.path.join(tmp, "params.json"),
                 "out": os.path.join(tmp, "out.npz")}
        with open(paths["params"], "w") as f:
            json.dump(multirank.PARITY_PARAMS, f)
        run_with_devices(_JAX.format(**paths))
        with np.load(paths["out"]) as data:
            ref = {app: [data[f"{app}.{i}"] for i in range(len(TOLERANCES[app]))]
                   for app in APPS}
    return port, ref


def _close(got: list, want: list, app: str) -> None:
    assert len(got) == len(want) == len(TOLERANCES[app])
    for g, w, (rtol, atol) in zip(got, want, TOLERANCES[app]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("app", APPS)
def test_driver_on_8_ranks_matches_the_oracle(app, runs):
    port, _ref = runs
    _close(port[app]["out"], port[app]["oracle"], app)


@pytest.mark.parametrize("app", APPS)
def test_driver_on_8_ranks_matches_repro_on_8_devices(app, runs):
    port, ref = runs
    _close(port[app]["out"], ref[app], app)


@pytest.mark.parametrize("app", APPS)
def test_recorded_profile_equals_the_meta_trace_and_repro(app, runs):
    port, _ref = runs
    p = dict(multirank.PARITY_PARAMS[app])
    mod, cls = _REF[app]
    ref_cfg = cls(decomp=RefDecomp3D(*p.pop("decomp")), **p)
    want = mod.profile(ref_cfg, name=f"{app}-8").to_json()
    assert port[app]["profile"] == port[app]["trace_profile"]
    assert port[app]["profile"] == want


def test_every_rank_joined_and_reported(runs):
    port, _ref = runs
    stats = port["ranks"]
    assert [s["rank"] for s in stats] == list(range(8))
    assert all(s["t_exit"] >= s["t_enter"] and s["peak_rss_mb"] > 0 for s in stats)


@pytest.fixture
def one_rank(tmp_path):
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_amg_vcycle_converges_on_one_rank(one_rank):
    """tests/test_apps.py:111 on a world of one rank."""
    cfg = amg.AMGConfig(decomp=Decomp3D(1, 1, 1), nx=16, ny=16, nz=16, n_cycles=1)
    mesh = cfg.decomp.make_mesh()
    f = amg.make_rhs(cfg, device="cpu")
    _, r1 = amg.solve(cfg, mesh)(f)
    cfg4 = amg.AMGConfig(decomp=Decomp3D(1, 1, 1), nx=16, ny=16, nz=16, n_cycles=4)
    _, r4 = amg.solve(cfg4, mesh)(f)
    assert float(r4) < float(r1) < float(torch.sqrt((f * f).sum()))


def test_laghos_energy_stays_finite_on_one_rank(one_rank):
    """tests/test_apps.py:183 on a world of one rank."""
    cfg = laghos.LaghosConfig(decomp=Decomp3D(1, 1, 1), nx=64, ny=64, n_steps=5)
    out, dts = laghos.run_steps(cfg, cfg.decomp.make_mesh())(
        laghos.make_state(cfg, device="cpu"))
    assert bool(torch.isfinite(out["e"]).all())
    assert bool((dts > 0).all())


def test_run_apps_defaults_to_the_card(one_rank, monkeypatch):
    """Without ``device`` the drivers run on the card: with none, the call
    raises rather than running on the CPU."""
    from repro_torch.core.backend import BackendUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable, match="CUDA"):
        multirank.run_apps({"beatnik": multirank.ONE_RANK_PARAMS["beatnik"]})


def test_check_holds_a_run_to_its_oracle_and_trace(runs):
    """``multirank.check`` passes the oracle's own outputs and flags a
    perturbed output or a different profile."""
    port, _ref = runs
    row = port["laghos"]
    good = multirank.check("laghos", row)
    assert good["within_tolerance"] and good["profile_equal"]
    bad_out = [o.copy() for o in row["out"]]
    bad_out[0][0, 0] += 1.0
    assert not multirank.check("laghos", dict(row, out=bad_out))["within_tolerance"]
    assert not multirank.check("laghos", dict(row, profile="{}"))["profile_equal"]


def test_torchrun_runs_the_drivers():
    """The drivers need only a default process group: under ``torchrun``
    each rank joins its env:// group (``python -m
    repro_torch.apps.multirank``)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO_SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.apps.multirank",
         "--device", "cpu", "--apps", "laghos,beatnik"],
        env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert [r["app"] for r in rows] == ["laghos", "beatnik"]
    assert all(r["within_tolerance"] and r["profile_equal"] for r in rows)
