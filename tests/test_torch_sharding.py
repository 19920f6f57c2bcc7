"""Sharding plans and the activation context, against ``repro``'s.

The port of ``tests/test_substrate.py``'s plan tests.  For every
architecture and both production meshes (16 x 16 and 2 x 16 x 16, from
``launch.mesh.make_production_mesh``): the port's ``default_plan`` rules
equal ``repro``'s, and so does the spec of every parameter of the model's
definitions and of the activations' logical axes, compared as tuples.
Then the port's twins of ``test_spec_dedupes_mesh_axes``,
``test_default_plans_all_archs`` and ``test_unknown_logical_axis_rejected``,
the specs as DTensor placements, ``tree_specs`` / ``tree_shardings``,
``param_shardings`` (a stacked group's sharding is one layer's) and
``shard_act`` / ``replicate`` with and without a context.
"""

import threading
import types

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import registry as jax_registry
from repro.models.model import build_model as jax_build
from repro.parallel import sharding as jax_sharding
from repro_torch.configs import registry
from repro_torch.launch import mesh as M
from repro_torch.models import params as PM
from repro_torch.parallel import context as C
from repro_torch.parallel.sharding import (
    LOGICAL_AXES,
    NamedSharding,
    ShardingPlan,
    default_plan,
    tree_shardings,
    tree_specs,
)

#: activations' logical axes, as the models constrain them
ACTIVATIONS = [("batch", "seq", "act_embed"), ("batch", "heads", "seq", None),
               ("batch", "seq", "mlp"), ("batch", None, "vocab"),
               ("moe_groups", None, "act_embed"),
               ("experts", "moe_groups", "moe_cap", "expert_mlp"),
               ("batch", "seq"), ("batch", "kv_heads", "kv_seq", None)]


def _leaves(defs, path=()):
    if isinstance(defs, dict):
        for k in sorted(defs):
            yield from _leaves(defs[k], path + (k,))
    elif isinstance(defs, (tuple, list)):
        for i, d in enumerate(defs):
            yield from _leaves(d, path + (i,))
    else:
        yield path, defs


def _as_tuple(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list(jax_registry.ARCH_IDS))
def test_default_plan_and_specs_equal_repro(arch, multi_pod):
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    shape = M.mesh_shape_dict(mesh)
    jcfg = jax_registry.get(arch)
    want = jax_sharding.default_plan(jcfg, shape)
    got = default_plan(registry.get(arch), shape)
    assert got.rules == want.rules
    assert got.mesh_axes == want.mesh_axes == tuple(shape)
    assert got.describe() == want.describe()
    jleaves = list(_leaves(jax_build(jcfg).defs))
    pleaves = list(_leaves(_defs(arch)))
    assert [p for p, _ in pleaves] == [p for p, _ in jleaves]
    for (path, d), (_, jd) in zip(pleaves, jleaves):
        assert d.axes == jd.axes, path
        assert _as_tuple(got.spec(*d.axes)) == _as_tuple(want.spec(*jd.axes)), path
    for axes in ACTIVATIONS:
        assert _as_tuple(got.spec(*axes)) == _as_tuple(want.spec(*axes)), axes


def _defs(arch):
    from repro_torch.models import encdec, lm

    cfg = registry.get(arch)
    if cfg.family in ("encdec", "audio"):
        return encdec.model_defs(cfg)
    return lm.model_defs(cfg)


def test_spec_dedupes_mesh_axes():
    plan = ShardingPlan(rules={"batch": ("pod", "data"), "seq": "model",
                               "vocab": "model"})
    spec = plan.spec("batch", "seq", "vocab")
    assert spec == (("pod", "data"), "model", None)
    assert _as_tuple(spec) == _as_tuple(jax_sharding.ShardingPlan(
        rules=dict(plan.rules)).spec("batch", "seq", "vocab"))


def test_default_plans_all_archs():
    for mesh_shape in ({"data": 16, "model": 16},
                       {"pod": 2, "data": 16, "model": 16}):
        for arch in registry.ARCH_IDS:
            cfg = registry.get(arch)
            plan = default_plan(cfg, mesh_shape)
            assert plan.get("mlp") == "model"
            heads_div = cfg.n_heads % 16 == 0
            assert (plan.get("heads") == "model") == heads_div
            if cfg.param_count() >= 7e9:
                assert plan.get("embed") is not None


def test_unknown_logical_axis_rejected():
    with pytest.raises(KeyError):
        ShardingPlan().spec("nonsense")
    assert set(LOGICAL_AXES) == set(jax_sharding.LOGICAL_AXES)


def _mesh(*names):
    """Stands in for a DeviceMesh where only its axis names are read."""
    return types.SimpleNamespace(mesh_dim_names=names)


def test_placements_follow_the_spec():
    plan = ShardingPlan(rules={"batch": ("pod", "data"), "seq": "model",
                               "vocab": "model", "heads": "model"})
    mesh = _mesh("pod", "data", "model")
    # a dim over (pod, data) is sharded on both, the major axis first
    assert plan.placements(mesh, "batch", "seq", "vocab") == (
        Shard(0), Shard(0), Shard(1))
    assert plan.placements(mesh, None, "heads") == (
        Replicate(), Replicate(), Shard(1))
    assert plan.placements(mesh) == (Replicate(),) * 3
    sh = plan.sharding(mesh, "batch")
    assert isinstance(sh, NamedSharding) and sh.mesh is mesh
    with pytest.raises(ValueError, match="does not have"):
        plan.placements(_mesh("data", "model"), "batch")


def test_tree_specs_and_shardings():
    plan = default_plan(registry.get("olmo-1b"), {"data": 16, "model": 16})
    jplan = jax_sharding.default_plan(jax_registry.get("olmo-1b"),
                                      {"data": 16, "model": 16})
    tree = {"x": ("batch", "seq", "act_embed"), "w": [("embed", "mlp"), ("vocab", None)]}
    got, want = tree_specs(tree, plan), jax_sharding.tree_specs(tree, jplan)
    assert _as_tuple(got["x"]) == _as_tuple(want["x"])
    assert [_as_tuple(s) for s in got["w"]] == [_as_tuple(s) for s in want["w"]]
    mesh = _mesh("data", "model")
    sh = tree_shardings(mesh, tree, plan)
    assert sh["w"][0].placements == (Replicate(), Shard(1))
    assert sh["x"].placements == (Shard(0), Shard(1))  # seq -> model


def test_param_shardings_drop_the_stacked_layers_axis():
    cfg = registry.get("zamba2-1.2b")
    plan = default_plan(cfg, {"data": 16, "model": 16})
    defs = _defs("zamba2-1.2b")
    sh = PM.param_shardings(defs, _mesh("data", "model"), plan)
    # a stacked Mamba group's def: its sharding is one layer's
    stacked = next(d for _, d in _leaves(defs["groups"][0]))
    assert isinstance(stacked, PM.StackedDef) and stacked.axes[0] == "layers"
    # the shared block's down projections keep their leading axis: the port
    # holds them as one tensor
    down = defs["shared"]["down"]
    assert not isinstance(down, PM.StackedDef)
    assert sh["shared"]["down"].placements == plan.placements(
        _mesh("data", "model"), *down.axes)
    assert defs["shared"]["ffn"]["w_gate"].axes == ("embed", "mlp")
    assert sh["shared"]["ffn"]["w_gate"].placements == (Replicate(), Shard(1))
    for path, d in _leaves(defs["groups"]):
        got = sh["groups"]
        for k in path:
            got = got[k]
        assert got.placements == plan.placements(_mesh("data", "model"), *d.axes[1:])


def test_shard_act_is_the_identity_without_a_mesh():
    x = torch.ones(2, 3)
    assert C.shard_act(x, ("batch", "seq")) is x
    assert C.replicate(x) is x
    with C.parallel_context(object(), ShardingPlan()):
        assert C.shard_act(x, ("batch", "seq")) is x  # a plain tensor
    assert C.current_plan() is None


def test_the_context_is_seen_from_other_threads():
    """The autograd engine recomputes checkpointed layers on its own threads
    on the card: they must see the plan."""
    plan, seen = ShardingPlan(), []
    with C.parallel_context("mesh", plan):
        t = threading.Thread(target=lambda: seen.append((C._CTX.mesh,
                                                         C.current_plan())))
        t.start()
        t.join()
    assert seen == [("mesh", plan)]


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_shard_act_and_replicate_under_a_mesh(one_rank):
    mesh = M.make_debug_mesh(1, 1, device="cpu")
    plan = ShardingPlan(rules={"batch": "data", "mlp": "model"})
    x = torch.arange(12.0).reshape(2, 6)
    with C.parallel_context(mesh, plan):
        r = C.replicate(x)
        assert isinstance(r, DTensor) and r.placements == (Replicate(), Replicate())
        y = C.shard_act(r, ("batch", "mlp"))
        assert y.placements == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x)
        assert C.replicate(y) is y
