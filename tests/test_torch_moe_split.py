"""The MoE layer's groups split over the model axis, on 8 gloo CPU ranks.

``sharded_ranks.MOE_SPLIT``'s reduced grok-1-314b (8 query heads on
``model``, 2 KV heads whole, 2 layers, MoE groups of 16 tokens) on a (data
2, model 4) mesh under ``repro``'s default plan with the published
configs' FSDP rule (``embed`` over ``data``).  In the train step and the
prefill the sequence is split over ``model`` (8 rows a rank), so each group
lies on 2 ranks: the routing is computed whole, the dispatch over whole
groups and the combine and the backward over each rank's rows
(``context.moe_tiles``); in decode one group holds the batch's 8 tokens
whole, the combine takes each rank's own batch rows, and the expert
weights are gathered along ``embed``.  The ranks are spawned once for the
file (``sharded_ranks.seq_parallel_steps``), in f32 and in f64, and held,
as ``test_torch_heads_whole.py`` holds its archs (``seq_parallel_parity``),
against ``repro``'s sharded step, prefill and decode under the same plan
on 8 forced host devices (f64 within 1e-9 relative, each parameter's
gradient norm among them; f32 by ``train_parity``'s rule) and against the
port's one-device computations.
"""

import pytest

import seq_parallel_parity as SP
import sharded_ranks

ARCHS = list(sharded_ranks.MOE_SPLIT)
RULES = sharded_ranks.HEADS_WHOLE_RULES
#: the caches' length: 12 positions a model rank (the KV heads are whole,
#: so the caches' sequence is split)
S_MAX = 48


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return SP.make_inputs(tmp_path_factory.mktemp("moe_split"), sharded_ranks.MOE_SPLIT)


@pytest.fixture(scope="module")
def sharded(inputs):
    return SP.run_sharded(inputs, RULES, S_MAX)


@pytest.fixture(scope="module")
def reference(inputs):
    return SP.run_reference(inputs, RULES, S_MAX)


def test_the_groups_tile_the_rows(monkeypatch):
    """The train step's groups span 2 model ranks each (the dispatch takes
    all of a rank's 8 groups whole, the combine their tokens at the rank's
    offset, its own groups' alone); decode's one group is combined by batch
    rows."""
    from types import SimpleNamespace

    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import context
    from repro_torch.parallel.context import moe_tiles, parallel_context
    from repro_torch.parallel.sharding import default_plan

    # stand-ins for the DTensors of one rank (data 1, model 3) of the mesh
    monkeypatch.setattr(context, "_is_dtensor", lambda x: True)

    cfg = sharded_ranks.seq_parallel_config(ARCHS[0], sharded_ranks.MOE_SPLIT)
    assert cfg.moe.group_size == 16
    plan = default_plan(cfg, {"data": 2, "model": 4}).override(**RULES)

    def tensor(shape, placements, local, coordinate):
        mesh = SimpleNamespace(mesh_dim_names=("data", "model"), size=(2, 4).__getitem__,
                               get_coordinate=lambda: coordinate, ndim=2)
        return SimpleNamespace(shape=torch.Size(shape), placements=placements,
                               device_mesh=mesh, to_local=lambda: torch.empty(local))

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), size=(2, 4).__getitem__)
    with parallel_context(mesh, plan):
        x = tensor((8, 32, 128), (Shard(0), Replicate()), (4, 32, 128), [1, 3])
        xg = tensor((16, 16, 128), (Shard(0), Replicate()), (8, 16, 128), [1, 3])
        tiles = moe_tiles(x, xg)
        assert tiles.dispatch == (0, 8) and tiles.lead
        assert tiles.rows == (0, 8, 8, 8)
        assert tiles.own == tuple(g % 2 == 1 for g in range(8))
        assert tiles.dims == (1,)
    with parallel_context(mesh, plan.override(seq=None)):
        x = tensor((8, 1, 128), (Shard(0), Replicate()), (4, 1, 128), [1, 3])
        xg = tensor((1, 8, 128), (Replicate(), Replicate()), (1, 8, 128), [1, 3])
        tiles = moe_tiles(x, xg)
        assert tiles.rows == (0, 1, 4, 4) and tiles.dims == (0,)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_groups_step_and_decode_match_one_device(inputs, sharded, arch):
    got = sharded[arch, "float32"]
    want = SP.one_device(inputs, arch, s_max=S_MAX)
    exact = SP.one_device(inputs, arch, exact=True, s_max=S_MAX)
    SP.check_scalars(got, want, exact)
    SP.check_logits(got, want, exact)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_groups_train_step_matches_repro(sharded, reference, arch):
    SP.check_scalars(sharded[arch, "float32"], reference[arch, "float32"],
                     reference[arch, "float64"])
    SP.check_exact(sharded[arch, "float64"], reference[arch, "float64"])


@pytest.mark.parametrize("arch", ARCHS)
def test_split_groups_prefill_and_decode_match_repro(sharded, reference, arch):
    SP.check_logits(sharded[arch, "float32"], reference[arch, "float32"],
                    reference[arch, "float64"])
