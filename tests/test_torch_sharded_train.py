"""Sharded training over a DeviceMesh, on 8 gloo CPU ranks.

The port of ``tests/test_dryrun_small.py::test_real_sharded_train_step_runs``
and ``tests/test_substrate.py::test_ckpt_elastic_restore_across_meshes``.
The ranks are spawned once for the file (``run_ranks``, the target in
``sharded_ranks.py``): the reduced olmo-1b with four query and four KV
heads, in f32, trains 3 steps through ``launch.train``'s mesh path on a
(data 2, model 4) mesh with the plan override ``heads = kv_heads = model``,
``seq = None`` (``repro``'s test's), each rank holding its shards of the
parameters and the AdamW state as DTensors.  Held here:

* each step against the port's single-device f32 step from the same
  weights, AdamW state and batch (the sharded run's state before the step,
  gathered whole), by ``tests/train_parity.py``'s rule with that f32 step
  standing in for repro's: each number's tolerance is the base rule (rtol
  1e-5 for the loss and the gradient norm, 1e-4 x a gradient leaf's max)
  or ten times how far the single-device f32 step lies from the exact
  (f64) step from the same state, whichever is looser.  The reduced
  model's f32 gradients are ill-conditioned (its attention is nearly
  one-hot): the single-device f32 gradients lie up to ~2e-3 x a leaf's
  max from the exact ones, and the sharded ones, whose sums split over
  the shards, up to ~5e-4 from the single-device ones.  Held: the loss,
  the gradient norm, and every parameter where the gradient lies beyond
  its rule from 0 and the two updates share a sign (the updates agree to
  1e-4 x the leaf's largest update plus one f32 ulp of the new parameter,
  plus on the first step what the rules let ``g / (|g| + eps)`` move);
  clear sign flips stay under 0.1 % of the elements;
* each step's loss and gradient norm against ``repro``'s sharded step of
  the same config on the same (2, 4) mesh and plan (8 forced host
  devices), from the same parameters (the sharded run's before the step,
  gathered whole and laid out as ``repro``'s tree) and batch, by
  ``tests/train_parity.py``'s rule: rtol 1e-5, or ten times how far
  ``repro``'s f32 step lies from its exact (f64) step, whichever is looser;
* the compiled layer captured from one sharded step attributes every
  collective DTensor inserts to a model region, among them
  ``tests/test_dryrun_small.py``'s ``{"mlp", "attn", "grad", "lm_head",
  "fwd", "optimizer", "embed"}``;
* the elastic restore: an (8, 8) array saved sharded by rows over an (8,)
  mesh restores onto the (2, 4) mesh with rows on ``model`` and columns on
  ``data``, every rank holding its block;
* one f32 step of the hybrid (zamba2: the SSD kernel and the shared block
  under ``local_map``), the mLSTM, MLA and MoE families on the launcher's
  (2, 4) plan: the loss and the gradient norm against the single-device
  step by the same rule;
* on one rank in this process: the launcher's mesh path at (1, 1) gives
  the one-process path's first loss bit for bit and its next within rtol
  1e-5, and the mesh constructors' contracts.
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import sharded_ranks
import train_parity as P
from helpers import run_with_devices
from repro.configs import registry as jax_registry
from repro.train import steps as jax_steps
from repro_torch import interop
from repro_torch.core.ranks import run_ranks
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch
from repro_torch.models.lm import layer_plan
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train import steps

REGIONS = {"mlp", "attn", "grad", "lm_head", "fwd", "optimizer", "embed"}


@pytest.fixture(scope="module")
def sharded():
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        return run_ranks(sharded_ranks.sharded_train, 8, backend="gloo",
                         args=(a, b), timeout_s=240)


def _run() -> launch.RunConfig:
    return launch.RunConfig(**sharded_ranks.RUN)


def _model(run, state: dict, dtype) -> torch.nn.Module:
    model = build_model(sharded_ranks.run_config(run), device="cpu").to(dtype)
    model.load_state_dict({n: torch.as_tensor(a).to(dtype)
                           for n, a in state["params"].items()})
    return model


def _loss_and_grads(run, state: dict, k: int, exact: bool = False) -> tuple:
    cfg = sharded_ranks.run_config(run)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=run.seq_len,
                                global_batch=run.global_batch))
    model = _model(run, state, torch.float64 if exact else torch.float32)
    with sharded_ranks.exact_f64(exact):
        loss, _ = steps.make_loss_fn(cfg)(model.requires_grad_(True), ds.batch(k))
        loss.backward()
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def _single_step(run, state: dict, k: int) -> dict:
    """The port's single-device f32 step ``k`` of ``run`` from ``state``
    (the parameters, m, v and step count before it), its gradients, and
    the rules: each number's tolerance is the base rule or ``YARDSTICK`` x
    how far this f32 step lies from the exact (f64) step from the same
    state, whichever is looser (``train_parity._rules``)."""
    cfg = sharded_ranks.run_config(run)
    loss, grads = _loss_and_grads(run, state, k)
    loss64, grads64 = _loss_and_grads(run, state, k, exact=True)
    model = _model(run, state, torch.float32)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = {"m": _tensors(state["m"]), "v": _tensors(state["v"]),
           "step": torch.tensor(state["step"], dtype=torch.int32)}
    opt_cfg = adamw.OptConfig(lr=3e-4, warmup_steps=run.warmup_steps,
                              total_steps=run.steps)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=run.seq_len,
                                global_batch=run.global_batch))
    opt, metrics = steps.make_train_step(cfg, opt_cfg)(model, opt, ds.batch(k))
    new = {n: p.detach().clone() for n, p in model.named_parameters()}
    gn, gn64 = (float(sum((g ** 2).sum() for g in gs.values()) ** 0.5)
                for gs in (grads, grads64))
    rules = {"loss": max(P.SCALAR_RTOL, P.YARDSTICK * abs(loss / loss64 - 1)),
             "grad_norm": max(P.SCALAR_RTOL, P.YARDSTICK * abs(gn / gn64 - 1)),
             "grads": {n: max(P.LEAF_TOL, P.YARDSTICK * P._distance(g, grads64[n]))
                       for n, g in grads.items()}}
    assert float(metrics["loss"]) == loss
    return {"grads": grads, "old": old, "params": new, "rules": rules, "state": state,
            "loss": loss, "grad_norm": float(metrics["grad_norm"]),
            "lr": float(metrics["lr"])}


def _tensors(arrays: dict) -> dict:
    return {n: torch.as_tensor(a).clone() for n, a in arrays.items()}


def _initial_state(run) -> dict:
    model = build_model(sharded_ranks.run_config(run), device="cpu").float()
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    zeros = {n: np.zeros_like(p) for n, p in params.items()}
    return {"params": params, "m": zeros, "v": dict(zeros), "step": 0}


def _direction(cfg, m, v, g, t: int):
    """AdamW's direction at step ``t`` for a clipped gradient ``g`` after
    moments ``m``, ``v``."""
    b1, b2 = cfg.betas
    m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
    return (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + cfg.eps)


def _updates_agree(got: dict, want: dict, k: int) -> tuple:
    """train_parity's update rule (``check_parameters_where_gradients_agree``)
    with this step's rules; (worst excess over the tolerance, clear flips,
    elements)."""
    cfg = adamw.OptConfig()
    rules = want["rules"]
    worst, flips, total = -np.inf, 0, 0
    clip = min(1.0, cfg.clip_norm / (want["grad_norm"] + 1e-9))
    for name, g in want["grads"].items():
        dg = rules["grads"][name] * float(g.abs().max())
        clear = g.abs() > dg
        du = torch.as_tensor(got[name]).double() - want["old"][name].double()
        u = want["params"][name].double() - want["old"][name].double()
        held = clear & (torch.sign(du) == torch.sign(u))
        flips += int((clear & ~held).sum())
        total += held.numel()
        ulp = torch.finfo(torch.float32).eps * want["params"][name].double().abs()
        # what a clipped gradient off by the rules moves AdamW's direction
        # (train_parity's first-step term, here from this step's moments)
        gc, dgc = clip * g, clip * (dg + rules["grad_norm"] * g.abs())
        m, v = (torch.as_tensor(want["state"][x][name]).double() for x in "mv")
        u0 = _direction(cfg, m, v, gc, k + 1)
        moved = want["lr"] * torch.maximum(
            (_direction(cfg, m, v, gc + dgc, k + 1) - u0).abs(),
            (_direction(cfg, m, v, gc - dgc, k + 1) - u0).abs())
        excess = (du - u).abs() - ulp - moved
        err = float(torch.where(held, excess, -1.0).max())
        worst = max(worst, err - P.LEAF_TOL * float(u.abs().max()))
    return worst, flips, total


def test_sharded_steps_match_the_single_device_steps(sharded):
    run = _run()
    got = sharded["steps"]
    assert len(got) == run.steps == 3
    assert [s["loss"] for s in got] == sharded["losses"]
    state = _initial_state(run)
    for k, step in enumerate(got):
        want = _single_step(run, state, k)
        assert step["step"] == k + 1
        rules = want["rules"]
        assert step["loss"] == pytest.approx(want["loss"], rel=rules["loss"]), k
        assert step["grad_norm"] == pytest.approx(want["grad_norm"],
                                                  rel=rules["grad_norm"]), k
        worst, flips, total = _updates_agree(step["params"], want, k)
        assert worst <= 0, (k, worst)
        assert flips < P.MAX_FLIPS * total, (k, flips, total)
        state = step  # the next step starts from the sharded run's state


#: repro's sharded step of the same run (``repro``'s
#: ``test_real_sharded_train_step_runs``'s config and plan with the
#: launcher's FFN and vocab on ``model``, remat "full"), in f32 and exact
#: (f64, repro's f32 islands lifted as ``train_parity._exact`` does) from
#: each step's parameters and batch: (dtype, step, loss, gradient norm)
_JAX = """
import contextlib, json
from unittest import mock
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.launch.mesh import make_debug_mesh, mesh_shape_dict
from repro.models.params import param_shardings
from repro.optim import adamw
from repro.parallel.context import parallel_context
from repro.parallel.sharding import default_plan
from repro.train import steps as S

mesh = make_debug_mesh(2, 4)
rows = []
for dtype in ("float32", "float64"):
    with contextlib.ExitStack() as stack:
        if dtype == "float64":
            stack.enter_context(jax.enable_x64(True))
            stack.enter_context(mock.patch.object(jnp, "float32", jnp.float64))
        cfg = registry.get("olmo-1b").reduced(n_heads=4, n_kv_heads=4, remat="full",
                                              dtype=dtype)
        plan = default_plan(cfg, mesh_shape_dict(mesh)).override(
            seq=None, heads="model", kv_heads="model", mlp="model", vocab="model")
        step, model = S.make_train_step(
            cfg, adamw.OptConfig(lr=3e-4, warmup_steps=1, total_steps={steps}))
        jstep = jax.jit(step)
        with parallel_context(mesh, plan), np.load({inputs!r}) as f:
            treedef = jax.tree.structure(model.init(jax.random.PRNGKey(0)))
            shards = param_shardings(model.defs, mesh, plan)
            on_batch = plan.sharding(mesh, "batch", "seq")
            for k in range({steps}):
                leaves = [jnp.asarray(f[f"p{{k}}_{{i}}"].astype(dtype))
                          for i in range(treedef.num_leaves)]
                params = jax.tree.map(jax.device_put,
                                      jax.tree.unflatten(treedef, leaves), shards)
                batch = {{n: jax.device_put(jnp.asarray(f[f"{{n}}{{k}}"]), on_batch)
                         for n in ("tokens", "labels")}}
                _, _, m = jstep(params, adamw.init_state(params), batch)
                rows.append((dtype, k, float(m["loss"]), float(m["grad_norm"])))
print(json.dumps(rows))
"""


def _reference_leaves(cfg, state: dict) -> list:
    """The port's LM state dict (NumPy) as the leaves of ``repro``'s
    parameter tree of ``cfg``, in its flattening order: the inverse of
    ``interop.lm_params_from_numpy`` (each group's layers stacked)."""
    jcfg = jax_registry.get(cfg.name.removesuffix("-smoke")).reduced(**sharded_ranks.CONFIG)
    template = jax_steps.make_loss_fn(jcfg)[1].init(jax.random.PRNGKey(0))
    assert set(template) == {"embed", "groups"}, set(template)

    def fill(sub, leaf, path=()):
        return {k: fill(v, leaf, path + (k,)) if isinstance(v, dict)
                else leaf(".".join(path + (k,))) for k, v in sub.items()}

    tree = {"embed": fill(template["embed"], lambda p: state[f"embed.{p}"]),
            "groups": tuple(
                fill(stacked, lambda p, g=g, n=n: np.stack(
                    [state[f"groups.{g}.{i}.{p}"] for i in range(n)]))
                for g, ((_, n), stacked) in enumerate(zip(layer_plan(cfg),
                                                          template["groups"])))}
    back = interop.lm_params_from_numpy(cfg, tree)
    assert back.keys() == state.keys()
    assert all(np.array_equal(back[n].numpy(), a) for n, a in state.items())
    return jax.tree.leaves(tree)


@pytest.fixture(scope="module")
def reference(sharded):
    """repro's sharded steps (8 forced host devices) from the parameters
    each of the port's sharded steps started from, and the same batches."""
    run = _run()
    cfg = sharded_ranks.run_config(run)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=run.seq_len,
                                global_batch=run.global_batch))
    starts = [_initial_state(run)["params"]] + [s["params"] for s in sharded["steps"][:-1]]
    arrays = {}
    for k, params in enumerate(starts):
        arrays.update({f"p{k}_{i}": a for i, a in enumerate(_reference_leaves(cfg, params))})
        arrays.update({f"{n}{k}": t.numpy().astype(np.int32)
                       for n, t in ds.batch(k).items()})
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "in.npz")
        np.savez(inputs, **arrays)
        stdout = run_with_devices(_JAX.format(inputs=inputs, steps=run.steps))
    rows = json.loads(stdout.strip().splitlines()[-1])
    return {(dtype, k): (loss, gn) for dtype, k, loss, gn in rows}


def test_sharded_steps_match_repro_sharded_steps(sharded, reference):
    for k, step in enumerate(sharded["steps"]):
        r32, r64 = reference[("float32", k)], reference[("float64", k)]
        for got, want, exact in zip((step["loss"], step["grad_norm"]), r32, r64):
            rule = max(P.SCALAR_RTOL, P.YARDSTICK * abs(want / exact - 1))
            assert got == pytest.approx(want, rel=rule), (k, got, want, exact)


def test_sharded_step_collectives_land_in_model_regions(sharded):
    rows = sharded["collectives"]
    regions = {r[0] for r in rows}
    kinds = {r[1] for r in rows}
    assert rows and regions <= REGIONS, regions
    assert {"mlp", "grad", "optimizer", "embed"} <= regions, regions
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= kinds, kinds
    # every collective runs along one mesh axis of the (2, 4) mesh
    assert {(r[3], r[4]) for r in rows} <= {(2, 4), (4, 2)}
    assert all(r[2] > 0 for r in rows)


def test_elastic_restore_from_8_to_2x4(sharded):
    e = sharded["elastic"]
    assert e["step"] == 5
    assert e["mesh"] == ["data", "model"]
    assert e["placements"] == ["Shard(dim=1)", "Shard(dim=0)"]
    np.testing.assert_array_equal(e["whole"], np.arange(64.0).reshape(8, 8))
    assert e["local_ok"] == [True] * 8


def _family_step(cfg, exact: bool) -> tuple:
    """(loss, gradient norm) of the single-device f32 (or exact f64) step
    of a family from its seeded parameters and ``_family_batch``."""
    dtype = torch.float64 if exact else torch.float32
    model = build_model(cfg, device="cpu").to(dtype).requires_grad_(True)
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in sharded_ranks._family_batch(cfg).items()}
    with sharded_ranks.exact_f64(exact):
        loss, _ = steps.make_loss_fn(cfg)(model, batch)
        loss.backward()
    gn = float(sum((p.grad.double() ** 2).sum() for p in model.parameters()) ** 0.5)
    return float(loss.detach()), gn


@pytest.mark.parametrize("arch", sharded_ranks.FAMILIES)
def test_other_families_train_a_sharded_step(sharded, arch):
    got = sharded["families"][arch]
    assert got[0] != "failed", got
    cfg = launch.run_config(launch.RunConfig(arch=arch))
    want, exact = _family_step(cfg, False), _family_step(cfg, True)
    for g, w, x in zip(got, want, exact):
        rule = max(P.SCALAR_RTOL, P.YARDSTICK * abs(w / x - 1))
        assert g == pytest.approx(w, rel=rule), (g, w, x)


@pytest.fixture
def one_rank(tmp_path):
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_one_rank_mesh_path_equals_the_one_process_path(tmp_path):
    run = dataclasses.replace(_run(), data_mesh=(1, 1), steps=2, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "one"))
    with sharded_ranks.as_tested():
        plain, _ = launch.train(run, verbose=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        seen = []
        with sharded_ranks.as_tested(lambda model, *_: seen.append(type(model.embed["tok"]))):
            meshed, _ = launch.train(dataclasses.replace(run, ckpt_dir=str(tmp_path / "m")),
                                     verbose=False)
    finally:
        dist.destroy_process_group()
    # the first step bit for bit; later ones within the scalar rule (the
    # DTensor path's ops round a few ulps apart)
    assert meshed[0] == plain[0]
    assert meshed == pytest.approx(plain, rel=P.SCALAR_RTOL)
    assert [t.__name__ for t in seen] == ["DTensor", "DTensor"]


def test_debug_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        M.make_debug_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="without a process group"):
        launch.train(dataclasses.replace(_run(), steps=1), verbose=False)


def test_debug_mesh_on_one_rank(one_rank):
    mesh = M.make_debug_mesh(1, 1, device="cpu")
    assert mesh.device_type == "cpu"
    assert M.mesh_shape_dict(mesh) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 8 ranks"):
        M.make_debug_mesh(2, 4, device="cpu")
    run = dataclasses.replace(_run(), data_mesh=(1, 1))
    _, plan = launch.mesh_and_plan(run, launch.run_config(run))
    # the reference's launcher plan: no head or sequence sharding
    assert plan.get("heads") is None and plan.get("seq") is None
    with sharded_ranks.as_tested():
        _, plan = launch.mesh_and_plan(run, sharded_ranks.run_config(run))
    # the reference's launcher plan, then the run's rules
    assert plan.get("mlp") is None and plan.get("vocab") is None
    assert plan.get("heads") == "model" and plan.get("seq") is None


def test_production_mesh_touches_no_device():
    m = M.make_production_mesh()
    assert M.mesh_shape_dict(m) == {"data": 16, "model": 16}
    m2 = M.make_production_mesh(multi_pod=True)
    assert M.mesh_shape_dict(m2) == {"pod": 2, "data": 16, "model": 16}
    assert not dist.is_initialized()
