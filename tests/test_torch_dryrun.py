"""The dry run on a fake process group, the roofline and the cell inspector.

The port of ``tests/test_dryrun_small.py::test_reduced_train_step_lowers_with_regions``
runs on a fake (2, 4) group with that test's config and plan: the captured
step's memory, cost and collectives by region, its argument bytes equal to
this rank's parameter, AdamW and batch bytes, its ``model_flops`` equal to
``repro``'s, and its FLOPs and wire bytes a device printed beside
``repro``'s on 8 forced host devices.  Then the records (``run_cell``'s
schema, a skipped cell, no process group left after a failing capture),
and ``figures.roofline`` and ``figures.inspect_cell`` over records and a
graph made here.
"""

import json

import pytest
import torch
import torch.distributed as dist
from helpers import run_with_devices

from repro.configs import registry as jax_registry
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import model_flops as jax_model_flops
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.figures import inspect_cell, paper_data, roofline
from repro_torch.launch import dryrun
from repro_torch.parallel.sharding import default_plan
from repro_torch.train import steps as S

#: repro's record keys (``repro/launch/dryrun.py``'s ``lower_cell``), less
#: those with no counterpart here, plus the port's three
RECORD_KEYS = ({"arch", "shape", "mesh", "n_devices", "plan", "status", "lower_s",
                "compile_s", "memory", "cost", "collectives", "roofline"}
               - {"compile_s"}) | {"device_type", "torch", "kernels"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "total_bytes"}
COST_KEYS = {"flops_per_device", "bytes_per_device"}
COLLECTIVE_KEYS = {"wire_bytes_per_device", "operand_bytes_per_device", "n_ops",
                   "by_kind", "by_region"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "step_s_lower_bound", "model_flops", "hlo_flops_global",
                 "model_to_hlo_flops", "roofline_fraction"}

SMALL = ShapeConfig("t", "train", 32, 8)

_REPRO_SMALL = """
    import jax
    from repro.configs import registry
    from repro.configs.base import ShapeConfig
    from repro.core.hlo import parse_hlo_collectives_with_loops, summarize_collectives
    from repro.core.hlo_cost import analyze_cost
    from repro.launch.mesh import make_debug_mesh, mesh_shape_dict
    from repro.parallel.context import parallel_context
    from repro.parallel.sharding import default_plan
    from repro.train import steps as S

    cfg = registry.get("olmo-1b").reduced(n_heads=4, n_kv_heads=4)
    mesh = make_debug_mesh(2, 4)
    plan = default_plan(cfg, mesh_shape_dict(mesh)) \\
        .override(heads="model", kv_heads="model", seq=None)
    step, model = S.make_train_step(cfg)
    with parallel_context(mesh, plan):
        aparams = model.abstract(mesh, plan)
        aopt = S.abstract_opt_state(cfg, mesh, plan)
        abatch = S.batch_specs(cfg, ShapeConfig("t", "train", 32, 8), mesh, plan)
        text = jax.jit(step).lower(aparams, aopt, abatch).compile().as_text()
    s = summarize_collectives(parse_hlo_collectives_with_loops(text, 8))
    print("REPRO", analyze_cost(text).flops, s.total_wire_bytes, s.n_ops)
"""


def _small_cfg():
    return registry.get("olmo-1b").reduced(n_heads=4, n_kv_heads=4)


@pytest.fixture(scope="module")
def small_cell():
    """(record, graph, argument bytes) of the reduced olmo-1b's train step
    on a fake (2, 4) group, with repro's test plan."""
    cfg = _small_cfg()
    plan = default_plan(cfg, {"data": 2, "model": 4}).override(
        heads="model", kv_heads="model", seq=None)
    with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
        record, gm = dryrun.lower(cfg, SMALL, mesh, plan)
        params = [p.to_local() for p in S.abstract_model(cfg, mesh, plan).parameters()]
        batch = S.batch_specs(cfg, SMALL, mesh, plan)
        local = sum(p.numel() * p.element_size() for p in params)
        adamw = sum(2 * p.numel() * 4 for p in params) + 4  # m, v and the int32 step
        tokens = sum(v.to_local().numel() * v.element_size() for v in batch.values())
    assert not dist.is_initialized()
    return record, gm, local + adamw + tokens


def test_reduced_train_step_captures_with_regions(small_cell):
    record, _, argument_bytes = small_cell
    mem, cost = record["memory"], record["cost"]
    assert mem["temp_bytes"] > 0
    assert mem["argument_bytes"] == argument_bytes
    assert mem["total_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                  + mem["temp_bytes"])
    assert cost["flops_per_device"] > 0 and cost["bytes_per_device"] > 0
    coll = record["collectives"]
    assert coll["n_ops"] > 0
    regions = set(coll["by_region"])
    assert regions & {"mlp", "attn", "grad", "lm_head", "fwd", "optimizer", "embed"}, regions
    assert record["n_devices"] == 8 and record["kernels"] == "plain"
    assert record["device_type"] == "cpu"
    jcfg = jax_registry.get("olmo-1b").reduced(n_heads=4, n_kv_heads=4)
    assert record["roofline"]["model_flops"] == jax_model_flops(
        jcfg, JaxShape("t", "train", 32, 8))
    rf = record["roofline"]
    assert rf["step_s_lower_bound"] == max(rf["compute_s"], rf["memory_s"],
                                           rf["collective_s"])
    assert rf["hlo_flops_global"] == cost["flops_per_device"] * 8


def test_flops_and_wire_bytes_beside_repro(small_cell):
    """The port's step on DTensor against repro's on GSPMD, a device: the
    port replicates products GSPMD splits (an MLP product keeps the whole
    d_ff) and gathers weights, so it does at least repro's work."""
    record, _, _ = small_cell
    flops, wire, n_ops = (float(x) for x in run_with_devices(
        _REPRO_SMALL).split("REPRO", 1)[1].split())
    port = record["cost"]["flops_per_device"], record["collectives"]["wire_bytes_per_device"]
    print(f"FLOPs a device: port {port[0]:.0f}, repro {flops:.0f}; wire bytes a "
          f"device: port {port[1]:.0f} in {record['collectives']['n_ops']} "
          f"collectives, repro {wire:.0f} in {n_ops:.0f}")
    assert port[0] >= flops > 0 and port[1] > 0


def test_inspect_cell_top_bytes(small_cell):
    _, gm, _ = small_cell
    top = inspect_cell.top_bytes(gm, 5)
    assert len(top) == 5
    assert [it[0] for it in top] == sorted((it[0] for it in top), reverse=True)
    every = sorted((b for b, *_ in inspect_cell.top_bytes(gm, 10**6)), reverse=True)
    assert [it[0] for it in top] == every[:5]
    assert all(isinstance(it[1], str) and it[3] for it in top)
    assert any(it[4].startswith(("grad", "optimizer")) for it in top)


@pytest.fixture
def reduced_cells(monkeypatch):
    """lower_cell's production meshes with the reduced configs and a small
    train_4k, so a cell captures in seconds."""
    real = registry.get
    monkeypatch.setattr(registry, "get", lambda arch: real(arch).reduced())
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", ShapeConfig("train_4k", "train", 64, 32))


def test_run_cell_writes_repros_schema(tmp_path, reduced_cells):
    rec = dryrun.run_cell("olmo-1b", "train_4k", False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("trace")
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS and set(rec["cost"]) == COST_KEYS
    assert set(rec["collectives"]) == COLLECTIVE_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert "seq->model" in rec["plan"]
    assert {"embed", "mlp", "grad", "optimizer"} <= set(rec["collectives"]["by_region"])
    path = tmp_path / "olmo-1b__train_4k__16x16.json"
    assert json.loads(path.read_text()) == rec
    assert dryrun.run_cell("olmo-1b", "train_4k", False, str(tmp_path)) == rec
    assert not dist.is_initialized()

    skipped = dryrun.run_cell("olmo-1b", "long_500k", True, str(tmp_path))
    assert skipped["status"] == "skipped" and skipped["mesh"] == "2x16x16"
    assert dryrun.cell_is_applicable("xlstm-1.3b", "long_500k") == (True, "")


def test_a_failing_capture_leaves_no_process_group(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        assert dist.is_initialized()
        raise RuntimeError("capture failed")

    monkeypatch.setattr(dryrun, "lower", broken)
    rec = dryrun.run_cell("olmo-1b", "decode_32k", False, str(tmp_path))
    assert rec["status"] == "error" and "capture failed" in rec["error"]
    assert not dist.is_initialized()


def test_fake_mesh_refuses_a_group_that_is_up(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_mesh((2, 2), ("data", "model")):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_main_prints_a_skipped_cell(tmp_path, capsys):
    dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k", "--mesh", "both",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("skipped") == 2
    assert len(list(tmp_path.glob("gemma-2b__long_500k__*.json"))) == 2


def _record(arch, shape, mesh, dominant, **extra):
    terms = {"compute_s": 0.1, "memory_s": 0.2, "collective_s": 0.3}
    terms[dominant] = 1.0
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "memory": {"total_bytes": 3 * 2**30},
            "roofline": {**terms, "dominant": dominant, "step_s_lower_bound": 1.0,
                         "model_to_hlo_flops": 0.5, "roofline_fraction": 0.25},
            **extra}


def test_roofline_reads_the_records_it_is_given(tmp_path, monkeypatch):
    monkeypatch.setattr(paper_data, "RESULTS", str(tmp_path / "results"))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert roofline.run(str(empty)) == []
    md = (tmp_path / "results" / "roofline.md").read_text()
    assert "| olmo-1b" not in md and "|---|" in md

    recs = tmp_path / "dryrun"
    recs.mkdir()
    rows = {
        "olmo-1b__train_4k__16x16": _record(
            "olmo-1b", "train_4k", "16x16", "collective_s",
            collectives={"by_kind": {"all-gather": [3, 9], "all-reduce": [1, 2]},
                         "by_region": {"mlp": [4, 11]}}),
        "xlstm-1.3b__prefill_32k__16x16": _record("xlstm-1.3b", "prefill_32k", "16x16",
                                                  "memory_s"),
        "gemma-2b__long_500k__16x16": {"arch": "gemma-2b", "shape": "long_500k",
                                       "mesh": "16x16", "status": "skipped",
                                       "reason": "dense"},
        "grok-1-314b__train_4k__2x16x16": {"arch": "grok-1-314b", "shape": "train_4k",
                                           "mesh": "2x16x16", "status": "error",
                                           "error": "boom"},
    }
    for name, rec in rows.items():
        (recs / f"{name}.json").write_text(json.dumps(rec))
    table = roofline.table("16x16", str(recs))
    assert "| olmo-1b | train_4k | 0.1000 | 0.2000 | 1.0000 | collective |" in table
    assert "all-gathers lead" in table
    assert "the card's mlstm_scan kernel" in roofline.improvement_note(
        rows["xlstm-1.3b__prefill_32k__16x16"])
    assert "| gemma-2b | long_500k | — | — | — | skipped |" in table
    assert "ERROR" in roofline.table("2x16x16", str(recs))
    got = roofline.run(str(recs))
    assert sorted(r[0] for r in got) == ["roofline/olmo-1b/train_4k/16x16",
                                         "roofline/xlstm-1.3b/prefill_32k/16x16"]
    assert all(us == 1e6 for _, us, _ in got)
    assert "MXU" not in table and "VMEM" not in table
