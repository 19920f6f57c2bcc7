"""The serving steps and the dry run's abstract inputs, against ``repro``'s.

The port of ``repro/train/steps.py``'s ``make_prefill_step``,
``make_decode_step``, ``batch_specs``, ``cache_specs``,
``decode_token_specs`` and ``abstract_opt_state``.  Every spec helper gives
``repro``'s global shapes and dtypes for every arch x shape of ``SHAPES``
(the port keeps a stacked group's caches and moments as one tensor a
layer, so a leading ``layers`` axis becomes a list); on a fake (16, 16)
mesh the specs are DTensors with the plan's placements and shard shapes.
The serving steps give the models' own outputs inside their regions.
"""

import math

import jax
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro.configs import registry as jax_registry
from repro.configs.base import SHAPES as RS_SHAPES
from repro.models.model import build_model as jax_build
from repro.train import steps as RS
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import fake_mesh
from repro_torch.models import encdec, lm
from repro_torch.models.model import build_model
from repro_torch.models.params import StackedDef, param_def
from repro_torch.parallel.sharding import default_plan
from repro_torch.train import steps as S

CELLS = [(a, s) for a in registry.ARCH_IDS for s in SHAPES]


def _sig(t) -> tuple:
    """(shape, dtype name) of a spec: a meta tensor or a ShapeDtypeStruct."""
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


def _cfgs(arch: str) -> tuple:
    return registry.get(arch), jax_registry.get(arch)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_token_specs_match_repro(arch, shape):
    cfg, jcfg = _cfgs(arch)
    got = S.batch_specs(cfg, SHAPES[shape])
    want = RS.batch_specs(jcfg, RS_SHAPES[shape])
    assert {k: _sig(v) for k, v in got.items()} == {k: _sig(v) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())
    assert _sig(S.decode_token_specs(cfg, SHAPES[shape])) == _sig(
        RS.decode_token_specs(jcfg, RS_SHAPES[shape]))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cache_specs_match_repro(arch, shape):
    cfg, jcfg = _cfgs(arch)
    got = S.cache_specs(cfg, SHAPES[shape])
    want = RS.cache_specs(jcfg, RS_SHAPES[shape])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, list):  # a stacked group: one dict a layer
            assert {len(g)} == {w[k].shape[0] for k in w}
            for layer in g:
                assert {k: _sig(v) for k, v in layer.items()} == {
                    k: (tuple(w[k].shape[1:]), str(w[k].dtype)) for k in w}
        else:
            assert {k: _sig(v) for k, v in g.items()} == {k: _sig(v) for k, v in w.items()}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_abstract_opt_state_matches_repro(arch):
    """f32 moments of every parameter (repro's stacked groups one tensor a
    layer) and an int32 step; nothing allocated."""
    cfg, jcfg = _cfgs(arch)
    opt = S.abstract_opt_state(cfg)
    defs = jax_build(jcfg).defs
    sizes = {}
    for name, m in opt["m"].items():
        d = param_def(defs, name)
        layer = len(name.split(".")) > len(_path_of(defs, name))
        want = d.shape[1:] if layer else d.shape
        assert _sig(m) == (tuple(want), "float32"), name
        assert _sig(opt["v"][name]) == _sig(m) and m.device.type == "meta"
        sizes[id(d)] = sizes.get(id(d), 0) + m.numel()
    leaves = jax.tree.leaves(defs, is_leaf=lambda x: hasattr(x, "axes"))
    assert sum(sizes.values()) == sum(math.prod(d.shape) for d in leaves)
    assert _sig(opt["step"]) == ((), "int32")


def _path_of(defs, name: str) -> list:
    """The keys of ``name`` that are keys of ``defs`` (a layer index of the
    port's per-layer modules is not)."""
    node, path = defs, []
    for part in name.split("."):
        if isinstance(node, (list, tuple)):
            node, path = node[int(part)], path + [part]
        elif part in node:
            node, path = node[part], path + [part]
    return path


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b", "seamless-m4t-medium",
                                  "qwen2-vl-7b"])
def test_specs_on_a_fake_mesh_carry_the_plans_placements(arch):
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    cfg = registry.get(arch)
    plan = default_plan(cfg, {"data": 16, "model": 16})
    with fake_mesh((16, 16), ("data", "model")) as mesh:

        def held(spec, axes):
            assert isinstance(spec, DTensor)
            assert spec.placements == plan.placements(mesh, *axes)
            local, _ = compute_local_shape_and_global_offset(
                spec.shape, mesh, spec.placements)
            assert spec.to_local().shape == torch.Size(local)
            assert spec.to_local().device.type == "meta"

        batch = S.batch_specs(cfg, SHAPES["train_4k"], mesh, plan)
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                "vision_embeds": ("batch", "seq", "act_embed"),
                "frames": ("batch", "frames", "act_embed")}
        for k, v in batch.items():
            held(v, axes[k])
        held(S.decode_token_specs(cfg, SHAPES["decode_32k"], mesh, plan), ("batch", "seq"))
        shape = SHAPES["decode_32k"]
        caches = S.cache_specs(cfg, shape, mesh, plan)
        stacked = (encdec.cache_shapes(cfg, shape.global_batch, shape.seq_len,
                                       S.AUDIO_FRAMES)
                   if cfg.family == "audio"
                   else lm.cache_shapes(cfg, shape.global_batch, shape.seq_len))
        for got, want in zip(caches, stacked):
            for layer in (got if isinstance(got, list) else [got]):
                for k, v in layer.items():
                    axes = want[k][1]
                    held(v, axes[1:] if axes[0] == "layers" else axes)
        opt = S.abstract_opt_state(cfg, mesh, plan)
        model = S.abstract_model(cfg, mesh, plan)
        for name, p in model.named_parameters():
            d = param_def(model.defs, name)
            axes = d.axes[1:] if isinstance(d, StackedDef) else d.axes
            held(opt["m"][name], axes)
            assert opt["m"][name].dtype == torch.float32
            assert p.placements == plan.placements(mesh, *axes)


def _regions(fn, *args) -> set:
    """The region paths the nodes of ``fn(*args)``'s graph were made in (the
    profiler's own record-function nodes aside)."""
    import torch.fx.traceback as fx_traceback
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core import regions

    with fx_traceback.preserve_node_meta(), regions.annotating():
        gm = make_fx(fn)(*args)
    return {n.meta.get("custom", {}).get("comm_region", "") for n in gm.graph.nodes
            if n.op == "call_function" and getattr(n.target, "namespace", "") != "profiler"}


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_prefill_and_decode_steps_give_the_models_outputs(arch):
    cfg = registry.get(arch).reduced()
    model = build_model(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    s_max = 16
    prefill = S.make_prefill_step(cfg, s_max)
    logits, caches = prefill(model, {"tokens": tokens})
    want_logits, want_caches = model.prefill({"tokens": tokens}, s_max)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    decode = S.make_decode_step(cfg)
    token = logits.argmax(-1)
    got, _ = decode(model, caches, token, 12)
    want, _ = model.decode(want_caches, token, 12)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    paths = _regions(lambda t: prefill(model, {"tokens": t}), tokens)
    assert {p.split("/")[0] for p in paths} == {"prefill"}
    assert {"prefill/embed", "prefill/lm_head"} <= paths
    _, caches = model.prefill({"tokens": tokens}, s_max)
    paths = _regions(lambda t: decode(model, caches, t, 12), token)
    assert {p.split("/")[0] for p in paths} == {"decode"}
    assert {"decode/embed", "decode/lm_head"} <= paths
