"""The multi-pod dry run: one (arch x shape x mesh) cell's cost, memory and
communication, on a host with no device.

The port of ``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh 16x16

For each cell, :func:`lower_cell` places the step on a production mesh
that no machine here has (256 or 512 ranks) and returns the record the
roofline reads (:mod:`repro_torch.figures.roofline`).  Where ``repro``
lowers and compiles the step with XLA on 512 forced host devices, the port
captures it with ``make_fx`` (:func:`capture`):

- the mesh is a ``DeviceMesh`` over torch's fake process group at world
  size 256 or 512, rank 0 (:func:`fake_mesh`), which moves no bytes;
- the model, the AdamW state and the batch are fake tensors (DTensors of
  this rank's shards) from :mod:`repro_torch.train.steps`'s helpers, so
  nothing is allocated and nothing runs;
- the kernels take their plain versions (``ops.plain()``), the math
  ``repro`` lowers: its models never call Pallas.  The record says so
  (``"kernels": "plain"``): the memory and byte terms hold attention's
  S^2 scores, which the card's flash kernels never write;
- nodes whose results nothing reads are dropped, as XLA drops them.

The record keeps ``repro``'s keys and meanings where they hold:

- ``memory``: argument, output, temp and total bytes a device, from a
  liveness walk over the graph in its order, each storage counted once
  (:func:`graph_memory`); the arguments are the parameter shards, the
  AdamW state and the batch;
- ``cost``: FLOPs and bytes a device (:func:`repro_torch.core.hlo_cost.graph_cost`;
  its bytes are of eager, unfused ops, not XLA's fused kernels);
- ``collectives``: the ``_c10d_functional`` collectives DTensor inserts,
  by kind and by region (``core.hlo.graph_collectives``);
- ``roofline``: the three terms, the dominant one, the step's lower
  bound, ``model_flops`` against the graph's FLOPs and the roofline
  fraction.

Left out, having no counterpart: ``compile_s`` (nothing is compiled;
``lower_s`` holds the capture's seconds) and ``cost``'s
``xla_flops_unscaled`` / ``xla_bytes_unscaled``.  Added: ``device_type``,
the fake mesh's device type (a ``"cpu"`` mesh records DTensor's fallback
of an all-to-all as an all-gather), ``torch``, the version whose DTensor
chose the redistributions (they differ between versions), and
``kernels``.

The hardware model is one NVIDIA H100 SXM5 a rank, datasheet values and
not measurements: ``benchpark.runner``'s ``PEAK_FLOPS`` (dense bf16),
``HBM_BW`` and ``LINK_BW`` (one 400 Gb/s port a GPU).

Importing this module sets nothing and touches no device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from dataclasses import replace

from repro_torch.benchpark.runner import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, model_flops
from repro_torch.core import compat, regions
from repro_torch.core.hlo import graph_collectives
from repro_torch.core.hlo_cost import graph_cost, node_value, tensors_in
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict
from repro_torch.parallel.context import parallel_context
from repro_torch.parallel.sharding import default_plan
from repro_torch.train import steps as S

#: where the records go unless ``--out`` says otherwise
RESULTS_DIR = os.path.join("build", "dryrun")

# long_500k runs only for sub-quadratic archs.
LONG_OK = ("zamba2-1.2b", "xlstm-1.3b")


def cell_is_applicable(arch: str, shape_name: str) -> tuple:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return False, ("pure full-attention stack: 512k dense decode "
                       "excluded per assignment; see DESIGN.md §4")
    return True, ""


@contextlib.contextmanager
def fake_mesh(shape: tuple, axis_names: tuple):
    """A ``DeviceMesh`` of ``shape`` over torch's fake process group, as
    rank 0 of ``prod(shape)``: its collectives record and move nothing.
    Its device type is the step's own: the card's where there is one (the
    fake group takes ``"cuda"``), else the host's.  The group is destroyed
    on exit, also when the block raises; a process group that is already
    up is an error (the fake one would replace it)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # registers the "fake" backend; torch keeps it under its testing tree
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the dry run "
                           "brings up a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cuda" if torch.cuda.is_available() else "cpu",
                               tuple(shape), mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()


def _materialize(tree, device: str):
    """Fake tensors (inside the caller's ``FakeTensorMode``) for the meta
    specs of ``tree``: a meta-local DTensor becomes a DTensor over a fake
    local tensor of the same shard shape."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        local = torch.zeros(tree.to_local().shape, dtype=tree.dtype, device=device)
        return DTensor.from_local(local, tree.device_mesh, tree.placements,
                                  run_check=False, shape=tree.shape, stride=tree.stride())
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: _materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v, device) for v in tree)
    return tree


def _local(tree):
    """``tree`` with each DTensor replaced by its local tensor (the tensor
    the captured graph computes)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return tree.to_local()
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local(v) for v in tree)
    return tree


def capture(cfg, shape, mesh=None, plan=None) -> tuple:
    """(graph module, argument tensors, seconds): ``make_fx`` of ``cfg``'s
    train, prefill or decode step at ``shape`` on the abstract model, the
    abstract inputs and (decode) position ``seq_len - 1``, on ``mesh`` (a
    DeviceMesh, with ``plan``) or on one device, its dead nodes removed.
    The arguments are the local tensors of the parameters, the AdamW state
    and the batch (or the caches and token)."""
    import torch.fx.traceback as fx_traceback
    from torch.fx.experimental.proxy_tensor import make_fx

    device = mesh.device_type if mesh is not None else "cpu"
    t0 = time.perf_counter()
    with parallel_context(mesh, plan):
        model = S.abstract_model(cfg, mesh, plan)
        if shape.kind == "train":
            step = S.make_train_step(cfg)
            specs = (S.abstract_opt_state(cfg, mesh, plan),
                     S.batch_specs(cfg, shape, mesh, plan))
        elif shape.kind == "prefill":
            step = S.make_prefill_step(cfg, s_max=shape.seq_len)
            batch = S.batch_specs(cfg, shape, mesh, plan)
            batch.pop("labels", None)
            specs = (batch,)
        else:  # decode
            step = S.make_decode_step(cfg)
            specs = (S.cache_specs(cfg, shape, mesh, plan),
                     S.decode_token_specs(cfg, shape, mesh, plan), shape.seq_len - 1)
        with S.fake_mode_of(model):
            args = _materialize(specs, device)
            with ops.plain(), fx_traceback.preserve_node_meta(), regions.annotating():
                gm = make_fx(lambda: _local(step(model, *args)))()
    # nodes whose results nothing reads are dropped, as XLA drops them: an
    # output the step discards (the SSD's final state in training) and, on
    # torch 2.11, the global-shape ops DTensor's sharding propagation runs
    # to infer an op's output, which the trace records (mutations stay)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    seconds = time.perf_counter() - t0
    arguments = tensors_in(_local(dict(model.named_parameters()))) + tensors_in(_local(args))
    return gm, arguments, seconds


def graph_memory(gm, arguments) -> dict:
    """A device's memory for the captured step, ``repro``'s four numbers:
    argument bytes (``arguments``' own bytes), output bytes (the outputs'
    storages that are not arguments'), temp bytes (the peak of the other
    storages live at once, walking the graph in its order: a storage is
    live from the node that makes it to the last node that reads it) and
    their total.  Each storage counts once, whatever views it has."""
    from torch.multiprocessing.reductions import StorageWeakRef

    def storages(tensors) -> dict:
        return {StorageWeakRef(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in tensors}

    args = storages(arguments)
    *nodes, out_node = gm.graph.nodes
    made = {node: storages(tensors_in(node_value(node))) for node in nodes}
    outputs = {k: n for a in out_node.all_input_nodes for k, n in made[a].items()
               if k not in args}
    temps = {k: n for node in nodes for k, n in made[node].items()
             if k not in args and k not in outputs}
    last = {}
    for i, node in enumerate(nodes):
        for src in (node, *node.all_input_nodes):
            for k in made[src]:
                if k in temps:
                    last[k] = i
    dies: dict = {}
    for k, i in last.items():
        dies.setdefault(i, []).append(k)
    live = peak = 0
    born: set = set()
    for i, node in enumerate(nodes):
        for k in made[node]:
            if k in temps and k not in born:
                born.add(k)
                live += temps[k]
        peak = max(peak, live)
        for k in dies.get(i, ()):
            live -= temps[k]
    argument = sum(t.numel() * t.element_size() for t in arguments)
    output = sum(outputs.values())
    return {"argument_bytes": argument, "output_bytes": output, "temp_bytes": peak,
            "total_bytes": argument + output + peak}


def lower(cfg, shape, mesh=None, plan=None) -> tuple:
    """(record, graph module) of one cell without its labels: ``cfg``'s
    step at ``shape`` captured on ``mesh`` (a DeviceMesh, with ``plan``)
    or, without one, on one device; the record's memory, cost,
    collectives and roofline are a device's."""
    import torch

    gm, arguments, seconds = capture(cfg, shape, mesh, plan)
    n_dev = mesh.size() if mesh is not None else 1
    if mesh is not None:
        buf = graph_collectives(gm.graph, total_devices=n_dev, device_mesh=mesh)
    else:
        buf = graph_collectives(gm.graph, mesh=compat.make_mesh((1,), ("data",)),
                                total_devices=1)
    summ = buf.summarize()
    cost = graph_cost(gm)

    flops_dev = float(cost.flops)
    bytes_dev = float(cost.bytes_accessed)
    wire_dev = float(summ.total_wire_bytes)
    terms = {"compute_s": flops_dev / PEAK_FLOPS, "memory_s": bytes_dev / HBM_BW,
             "collective_s": wire_dev / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_flops_global = flops_dev * n_dev
    record = {
        "n_devices": n_dev,
        "lower_s": round(seconds, 1),
        "device_type": mesh.device_type if mesh is not None else "cpu",
        "torch": torch.__version__,
        "kernels": "plain",
        "memory": graph_memory(gm, arguments),
        "cost": {"flops_per_device": flops_dev, "bytes_per_device": bytes_dev},
        "collectives": {
            "wire_bytes_per_device": wire_dev,
            "operand_bytes_per_device": float(summ.total_operand_bytes),
            "n_ops": summ.n_ops,
            "by_kind": {k: list(v) for k, v in summ.by_kind.items()},
            "by_region": {k: list(v) for k, v in summ.by_region.items()},
        },
        "roofline": {
            **terms,
            "dominant": dominant,
            "step_s_lower_bound": max(terms.values()),
            "model_flops": mf,
            "hlo_flops_global": hlo_flops_global,
            "model_to_hlo_flops": mf / hlo_flops_global if hlo_flops_global else 0.0,
            # useful-FLOPs throughput at the roofline-limited step time, as
            # a fraction of the aggregate peak
            "roofline_fraction": (mf / max(terms.values()) / (PEAK_FLOPS * n_dev)
                                  if max(terms.values()) > 0 else 0.0),
        },
    }
    return record, gm


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               plan_overrides: dict | None = None,
               cfg_overrides: dict | None = None) -> tuple:
    """Capture one (arch x shape x mesh) cell on a fake production mesh.

    Returns (record, graph module); the plan is ``repro``'s: decode drops
    ``seq``, a batch that does not divide over ``pod x data`` drops
    ``batch``, then ``plan_overrides``; ``cfg_overrides`` replaces
    ModelConfig fields."""
    cfg = registry.get(arch)
    if cfg_overrides:
        cfg = replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    prod = make_production_mesh(multi_pod=multi_pod)
    mesh_shape = mesh_shape_dict(prod)
    plan = default_plan(cfg, mesh_shape)
    if shape.kind == "decode":
        # single-token step: nothing to gain from seq sharding of the
        # 1-wide activations; cache sharding is governed by kv_seq.
        plan = plan.override(seq=None)
    dp = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
    if shape.global_batch % dp != 0:
        # e.g. long_500k's global_batch=1: replicate the batch dim; the
        # cache/state sharding (kv_seq / model axes) carries the scale-out.
        plan = plan.override(batch=None)
    if plan_overrides:
        plan = plan.override(**plan_overrides)
    with fake_mesh(prod.axis_sizes, prod.axis_names) as mesh:
        record, gm = lower(cfg, shape, mesh, plan)
    record = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16",
              "plan": plan.describe(), "status": "ok", **record}
    return record, gm


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str) -> dict:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    name = f"{arch}__{shape_name}__{mesh_tag}"
    path = os.path.join(out_dir, name + ".json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    applicable, why = cell_is_applicable(arch, shape_name)
    if not applicable:
        record = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                  "status": "skipped", "reason": why}
    else:
        try:
            record, _ = lower_cell(arch, shape_name, multi_pod=multi_pod)
        except Exception as e:  # a failing cell is a bug to fix, but keep
            record = {"arch": arch, "shape": shape_name,  # sweeping
                      "mesh": mesh_tag, "status": "error",
                      "error": f"{type(e).__name__}: {e}",
                      "trace": traceback.format_exc()[-2000:]}
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["16x16", "2x16x16", "both"],
                    default="both")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"16x16": [False], "2x16x16": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape_name, mp, args.out)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" step>={r['step_s_lower_bound']:.4f}s"
                             f" mem={rec['memory']['total_bytes']/2**30:.2f}GiB")
                elif status == "error":
                    extra = " " + rec.get("error", "")[:120]
                print(f"[{time.strftime('%H:%M:%S')}] {arch} {shape_name} "
                      f"{'2x16x16' if mp else '16x16'}: {status}{extra} "
                      f"({time.time()-t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
