"""The port's amg, laghos and beatnik against the JAX package's.

Profiles are traced by each package (meta tensors here, ``jax.eval_shape``
there) and must serialize byte for byte alike, reduced on the port's
``TorchBackend(device="cpu")`` and on its ``NumpyBackend``.  The
configurations are those of ``tests/test_backend_parity.py`` (the
reference's backend-parity cases), the paper findings of
``tests/test_apps.py`` and one paper Dane point of amg (64 ranks, 32×32×16
a rank).  The seeded states and the single-domain oracles are compared
within rtol 5e-5 / atol 5e-6 (float32 sums round in another order); the
reference oracles run under ``jax.jit``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.apps import amg as ref_amg
from repro.apps import beatnik as ref_beatnik
from repro.apps import laghos as ref_laghos
from repro.apps import stencil as ref_stencil
from repro.apps.stencil import Decomp3D as RefDecomp
from repro_torch.apps import amg, beatnik, laghos, stencil
from repro_torch.core import compat
from repro_torch.core.backend import BackendUnavailable, NumpyBackend, use_backend
from repro_torch.interop import (
    amg_config_from_dict,
    beatnik_config_from_dict,
    laghos_config_from_dict,
)

TOL = dict(rtol=5e-5, atol=5e-6)
APPS = {
    "amg": (ref_amg, amg, ref_amg.AMGConfig, amg_config_from_dict),
    "laghos": (ref_laghos, laghos, ref_laghos.LaghosConfig, laghos_config_from_dict),
    "beatnik": (
        ref_beatnik,
        beatnik,
        ref_beatnik.BeatnikConfig,
        beatnik_config_from_dict,
    ),
}
CASES = {
    "amg-parity-2x2x2": ("amg", (2, 2, 2), {}),
    "amg-dane-64": ("amg", (4, 4, 4), dict(nx=32, ny=32, nz=16)),
    "amg-small-4x2x2": ("amg", (4, 2, 2), dict(nx=4, ny=4, nz=4, n_cycles=2)),
    "laghos-parity-2x2x1": ("laghos", (2, 2, 1), dict(nx=32, ny=32, n_steps=1)),
    "laghos-strong-4x4x1": ("laghos", (4, 4, 1), dict(nx=64, ny=64, n_steps=2)),
    "beatnik-parity-2x2x1": (
        "beatnik",
        (2, 2, 1),
        dict(nx=8, ny=8, far_subsample=8, n_steps=3),
    ),
    "beatnik-4x4x1": ("beatnik", (4, 4, 1), dict(nx=8, ny=8, far_subsample=8)),
    "beatnik-4x1x1": (
        "beatnik",
        (4, 1, 1),
        dict(nx=8, ny=8, far_subsample=8, n_steps=4),
    ),
}


def _configs(app, shape, params):
    ref_mod, mod, ref_cls, from_dict = APPS[app]
    ref_cfg = ref_cls(decomp=RefDecomp(*shape), **params)
    return ref_mod, mod, ref_cfg, from_dict(dataclasses.asdict(ref_cfg))


def _profile(app, shape, params, **kw):
    _, mod, _, cfg = _configs(app, shape, params)
    return mod.profile(cfg, device="cpu", **kw)


@pytest.mark.parametrize("backend", ["torch-cpu", "numpy"])
@pytest.mark.parametrize("case", list(CASES))
def test_profile_byte_identical(case, backend):
    app, shape, params = CASES[case]
    ref_mod, mod, ref_cfg, cfg = _configs(app, shape, params)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    want = ref_mod.profile(ref_cfg, name=case, meta={"case": case}).to_json()
    if backend == "numpy":
        with use_backend(NumpyBackend()):
            got = mod.profile(cfg, name=case, meta={"case": case})
    else:
        got = mod.profile(cfg, name=case, meta={"case": case}, device="cpu")
    assert got.to_json() == want


# ---------------------------------------------------------------------------
# The paper's trace-level findings (tests/test_apps.py), in the port
# ---------------------------------------------------------------------------


def test_amg_bytes_decrease_with_level():
    p = _profile("amg", (2, 2, 2), {})
    b0 = p.regions["mg_level_0"].bytes_sent[1]
    b1 = p.regions["mg_level_1"].bytes_sent[1]
    assert b0 > b1 > 0


def test_amg_coarse_level_involves_everyone():
    p = _profile("amg", (2, 2, 2), {})
    assert p.regions["mg_level_0"].dest_ranks[1] <= 6
    coarse = p.regions["coarse_solve"]
    assert coarse.coll >= 1 and coarse.coll_bytes[1] > 0


def test_amg_levels_deepen_with_ranks():
    """Weak scaling: more ranks, a deeper distributed hierarchy (paper)."""
    _, _, _, small = _configs("amg", (2, 2, 2), {})
    _, _, _, big = _configs("amg", (8, 8, 8), {})
    assert big.n_dist_levels() > small.n_dist_levels()
    regions = _profile("amg", (4, 4, 4), dict(nx=32, ny=32, nz=16)).regions
    levels = [r for r in regions if r.startswith("mg_level_")]
    dane = amg.AMGConfig(decomp=stencil.Decomp3D(4, 4, 4))
    assert len(levels) == dane.n_dist_levels()


def test_laghos_strong_scaling_bytes_per_rank_decrease():
    b = {}
    for px in (4, 8, 16):
        p = _profile("laghos", (px, px, 1), dict(nx=64, ny=64, n_steps=1))
        b[px] = p.regions["halo_exchange"].bytes_sent[1]
    assert b[4] > b[8] > b[16]


def test_laghos_timestep_has_reduce_and_broadcast():
    p = _profile("laghos", (2, 2, 1), dict(nx=32, ny=32, n_steps=1))
    ts = p.regions["timestep"]
    assert ts.coll == 2
    assert set(ts.kinds) == {"pmin", "broadcast"}


def test_beatnik_far_field_couples_all_ranks():
    params = dict(nx=8, ny=8, far_subsample=8, n_steps=2)
    ff = _profile("beatnik", (4, 4, 1), params).regions["far_field"]
    assert ff.coll == 2
    assert set(ff.kinds) == {"all_gather"}
    assert all(b > 0 for b in ff.coll_bytes)


def test_beatnik_migration_mutates_structure_per_step():
    params = dict(nx=8, ny=8, far_subsample=8, n_steps=6)
    _, _, _, cfg = _configs("beatnik", (4, 4, 1), params)
    seen = [beatnik._migration(cfg, s) for s in range(cfg.n_steps)]
    assert len(set(seen)) == len(seen)
    assert {axis for axis, _ in seen} == {0, 1}
    mig = _profile("beatnik", (4, 4, 1), params).regions["migrate"]
    assert mig.total_sends == 2 * cfg.n_steps * cfg.decomp.n_ranks


def test_beatnik_single_rank_axis_skips_migration():
    params = dict(nx=8, ny=8, far_subsample=8, n_steps=4)
    _, _, _, cfg = _configs("beatnik", (4, 1, 1), params)
    assert beatnik._migration(cfg, 1) == (1, 0)
    mig = _profile("beatnik", (4, 1, 1), params).regions["migrate"]
    assert mig.total_sends == 2 * (cfg.n_steps // 2) * cfg.decomp.n_ranks


# ---------------------------------------------------------------------------
# Seeded states and single-domain oracles against the JAX functions
# ---------------------------------------------------------------------------

ORACLES = {
    "amg": ((2, 2, 2), dict(nx=8, ny=8, nz=8)),
    "amg-2cycles": ((2, 1, 1), dict(nx=8, ny=16, nz=16, n_cycles=2)),
    "laghos": ((4, 2, 1), dict(nx=32, ny=32, n_steps=3)),
    "beatnik": ((4, 2, 1), dict(nx=8, ny=8, far_subsample=8, n_steps=3)),
    "beatnik-k4": ((2, 2, 1), dict(nx=8, ny=16, far_subsample=4, n_steps=4)),
}


def _leaves(tree) -> list:
    """NumPy leaves of a tree of arrays or tensors, dict keys sorted."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    return [np.asarray(tree)]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _state(app, ref_cfg, cfg):
    if app == "amg":
        return ref_amg.make_rhs(ref_cfg), amg.make_rhs(cfg, device="cpu")
    ref_mod, mod = APPS[app][0], APPS[app][1]
    return ref_mod.make_state(ref_cfg), mod.make_state(cfg, device="cpu")


@pytest.mark.parametrize("case", list(ORACLES))
def test_initial_state_matches_jax(case):
    app = case.split("-")[0]
    _, _, ref_cfg, cfg = _configs(app, *ORACLES[case])
    want, got = _state(app, ref_cfg, cfg)
    want, got = _leaves(want), _leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("case", list(ORACLES))
def test_reference_oracle_matches_jax(case):
    app = case.split("-")[0]
    _, _, ref_cfg, cfg = _configs(app, *ORACLES[case])
    ref_state, _ = _state(app, ref_cfg, cfg)
    if app == "amg":
        ref_run, ref_single = ref_amg.reference_solve(ref_cfg)
        run, single = amg.reference_solve(cfg)
        assert single.n_dist_levels() == ref_single.n_dist_levels()
    else:
        ref_run = APPS[app][0].reference_steps(ref_cfg)
        run = APPS[app][1].reference_steps(cfg)
    want = _leaves(jax.jit(ref_run)(ref_state))
    got = _leaves(run(_torch_tree(ref_state)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_amg_vcycle_converges():
    cfg = amg.AMGConfig(decomp=stencil.Decomp3D(1, 1, 1), nx=16, ny=16, nz=16)
    f = amg.make_rhs(cfg, device="cpu")
    _, r1 = amg.reference_solve(cfg)[0](f)
    _, r4 = amg.reference_solve(dataclasses.replace(cfg, n_cycles=4))[0](f)
    assert float(r4) < float(r1) < float(torch.sqrt((f * f).sum()))


def test_laghos_energy_stays_finite():
    cfg = laghos.LaghosConfig(decomp=stencil.Decomp3D(1, 1, 1), nx=64, ny=64, n_steps=5)
    out, dts = laghos.reference_steps(cfg)(laghos.make_state(cfg, device="cpu"))
    assert bool(torch.isfinite(out["e"]).all())
    assert bool((dts > 0).all())


# ---------------------------------------------------------------------------
# Entry points on the card by default; the halo helpers; the shim's trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app", list(APPS))
def test_default_backend_needs_the_card(app):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    case = next(c for c in CASES if c.startswith(f"{app}-parity"))
    _, mod, _, cfg = _configs(*CASES[case])
    with pytest.raises(BackendUnavailable):
        mod.profile(cfg)
    make = amg.make_rhs if app == "amg" else mod.make_state
    with pytest.raises(BackendUnavailable):
        make(cfg)


@pytest.mark.parametrize("dims", [(0, 1, 2), (0, 1), (2,)])
def test_pad_with_halo_matches_jax(dims):
    rng = np.random.default_rng(len(dims))
    u = rng.standard_normal((3, 4, 5)).astype(np.float32)
    ghosts = {}
    for d in dims:
        shape = list(u.shape)
        shape[d] = 1
        lo = rng.standard_normal(shape).astype(np.float32)
        hi = rng.standard_normal(shape).astype(np.float32)
        ghosts[d] = (lo, hi)
    want = np.asarray(ref_stencil.pad_with_halo(u, ghosts, dims=dims))
    tg = {d: tuple(torch.from_numpy(g) for g in pair) for d, pair in ghosts.items()}
    got = stencil.pad_with_halo(torch.from_numpy(u), tg, dims=dims).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        stencil.zero_pad(torch.from_numpy(u)).numpy(), np.pad(u, 1)
    )


def test_shard_map_takes_trees_of_specs():
    mesh = compat.make_mesh((2, 4), ("x", "y"))
    spec = compat.PartitionSpec("x", "y")
    seen = {}

    def body(state, pair):
        seen["state"] = {k: tuple(v.shape) for k, v in state.items()}
        seen["pair"] = [tuple(t.shape) for t in pair]
        return (state, pair[0].sum())

    t = torch.empty((8, 16), device="meta")
    out_state, total = compat.shard_map(
        body,
        mesh=mesh,
        in_specs=({"a": spec, "b": spec}, (spec, compat.PartitionSpec("x", None))),
        out_specs=({"a": spec, "b": spec}, compat.PartitionSpec()),
    )({"a": t, "b": t}, (t, t))
    assert seen == {"state": {"a": (4, 4), "b": (4, 4)}, "pair": [(4, 4), (4, 16)]}
    assert {k: tuple(v.shape) for k, v in out_state.items()} == {
        "a": (8, 16),
        "b": (8, 16),
    }
    assert total.shape == () and total.device.type == "meta"


def test_oracles_take_real_tensors_and_the_traced_steps_refuse_them():
    """The oracles run on real tensors without a collective; the traced
    steps, which go through the instrumented collectives, refuse them
    until real execution is ported."""
    cfg = laghos.LaghosConfig(decomp=stencil.Decomp3D(2, 1, 1), nx=8, ny=8, n_steps=1)
    state = laghos.make_state(cfg, device="cpu")
    laghos.reference_steps(cfg)(state)
    with pytest.raises(NotImplementedError, match="item 6"):
        laghos.run_steps(cfg, cfg.decomp.make_mesh())(state)
