"""Shared machinery of the dry-run parity tests (``test_torch_dryrun_heads.py``
and ``test_torch_dryrun_xlstm.py``): a cell of ``lower_cell`` at 2 layers
and cut shapes, with the published config's ``embed`` rule, captured by the
port and lowered by ``repro`` (one subprocess for a file's cells)."""

import json

from helpers import run_with_devices

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.hlo import graph_collectives
from repro_torch.launch import dryrun
from repro_torch.parallel.sharding import default_plan
from repro_torch.train import steps as S

#: the cut shapes (the ``reduced_cells`` fixture's cut, at lengths where
#: attention counts in the FLOPs): (seq_len, global_batch)
CUT = {"train_4k": ("train", 1024, 32), "prefill_32k": ("prefill", 1024, 32),
       "decode_32k": ("decode", 4096, 128), "long_500k": ("decode", 4096, 1)}
#: the layers each cell keeps
N_LAYERS = 2
#: how far a cell's FLOPs a device may lie from repro's (relative)
FLOPS_RTOL = 0.02


def mesh_shape(mesh: str) -> dict:
    return ({"pod": 2, "data": 16, "model": 16} if mesh == "2x16x16"
            else {"data": 16, "model": 16})


def embed_rule(arch: str, mesh: str):
    """The published config's ``embed`` rule on ``mesh`` (FSDP over the data
    axes at 7e9 parameters or more), which the cut depth would drop."""
    return default_plan(registry.get(arch), mesh_shape(mesh)).get("embed")


def cut_shapes(monkeypatch) -> None:
    for name, (kind, seq, batch) in CUT.items():
        monkeypatch.setitem(dryrun.SHAPES, name, ShapeConfig(name, kind, seq, batch))


def _sources(graph) -> dict:
    """Each node of ``graph`` -> the node it is made from alone: itself,
    or where all of a call's inputs are made from one node (views, casts,
    the gathers of other mesh dims and the reordering of their pieces),
    that node; so a ``get_attr`` node where the value is a parameter, cache
    or state tensor, or a function of it alone."""
    out = {}
    for node in graph.nodes:
        made = {out[n] for n in node.all_input_nodes} if node.op == "call_function" else ()
        out[node] = made.pop() if len(made) == 1 else node
    return out


def by_op(gm, top: int = 15) -> list:
    """The ``top`` largest products of a captured graph, summed by (op,
    input shapes): (FLOPs, calls, op, shapes) each, largest first."""
    from repro_torch.core.hlo_cost import _arg_values, node_flops

    sums = {}
    for node in gm.graph.nodes:
        flops = node_flops(node)
        if flops:
            key = (node.target.overloadpacket.__name__,
                   tuple(tuple(t.shape) for t in _arg_values(node)))
            total, calls = sums.get(key, (0.0, 0))
            sums[key] = (total + flops, calls + 1)
    rows = sorted(((f, n, op, shapes) for (op, shapes), (f, n) in sums.items()),
                  reverse=True)
    return rows[:top]


def port_cell(monkeypatch, arch: str, shape: str, mesh: str, graphs=None) -> tuple:
    """(record, the captured step's collectives: (region, kind, result
    bytes, what its input is: ``"weight"`` a parameter's local tensor,
    ``"cache"`` a decode cache's or recurrent state's, else
    ``"activation"``) each, the bytes of one layer's decode cache (or
    recurrent state) on a device, 0 for a train or prefill cell) of the
    port's cell; the captured graph is appended to ``graphs`` if given."""
    from torch.multiprocessing.reductions import StorageWeakRef

    from repro_torch.core.hlo_cost import node_value, tensors_in

    cut_shapes(monkeypatch)
    real_lower, real_capture, real_materialize = (dryrun.lower, dryrun.capture,
                                                  dryrun._materialize)
    made, captured, ops, cache = [], [], [], []

    def materialize(tree, device):
        made.append(real_materialize(tree, device))
        return made[-1]

    def capture(*a, **k):
        captured.append(real_capture(*a, **k))
        return captured[-1]

    def storages(tensors) -> set:
        return {StorageWeakRef(t.untyped_storage()) for t in tensors}

    def lower(cfg, shp, device_mesh=None, plan=None):
        record, gm = real_lower(cfg, shp, device_mesh, plan)
        if device_mesh is None:
            return record, gm
        if graphs is not None:
            graphs.append(gm)
        arguments, args = captured[-1][1], tensors_in(dryrun._local(made[-1]))
        # the arguments are the parameters' local tensors, then the step's
        # (the caches first in decode)
        kinds = {s: "weight" for s in storages(arguments[:len(arguments) - len(args)])}
        if shp.kind == "decode":
            kinds.update({s: "cache" for s in storages(tensors_in(dryrun._local(made[-1][0])))})
        nodes, sources = {n.name: n for n in gm.graph.nodes}, _sources(gm.graph)
        for op in graph_collectives(gm.graph, total_devices=device_mesh.size(),
                                    device_mesh=device_mesh).to_ops():
            src = sources[nodes[op.name].args[0]]
            moves = "activation"
            if src.op == "get_attr":
                moves = kinds.get(StorageWeakRef(node_value(src).untyped_storage()), moves)
            ops.append((op.region, op.kind, op.result_bytes, moves))
        if shp.kind == "decode":
            first = S.cache_specs(cfg, shp, device_mesh, plan)[0]
            first = first[0] if isinstance(first, list) else first
            cache.append(sum(t.to_local().numel() * t.element_size()
                             for t in first.values()))
        return record, gm

    monkeypatch.setattr(dryrun, "_materialize", materialize)
    monkeypatch.setattr(dryrun, "capture", capture)
    monkeypatch.setattr(dryrun, "lower", lower)
    record, _ = dryrun.lower_cell(
        arch, shape, multi_pod=mesh == "2x16x16",
        plan_overrides={"embed": embed_rule(arch, mesh)},
        cfg_overrides={"n_layers": N_LAYERS})
    return record, ops, sum(cache)


#: the regions that read the decode caches (and recurrent states)
CACHE_REGIONS = ("attn", "ssm")


def largest_activation_collective(ops) -> int:
    """The largest result bytes of a collective in a region that reads the
    caches (``CACHE_REGIONS``) that does not gather a weight (FSDP): a
    gathered cache would be one.  (The LM head's and the embedding's
    collectives, outside those regions, reduce logits and gather the
    table.)"""
    return max((b for region, _, b, moves in ops
                if region in CACHE_REGIONS and moves != "weight"), default=0)


def gathered_caches(ops) -> list:
    """The collectives whose input is a decode cache or recurrent state."""
    return [op for op in ops if op[3] == "cache"]


_REPRO = """
import json
from repro.launch import dryrun
from repro.configs.base import ShapeConfig
from repro.configs import registry
from repro.parallel.sharding import default_plan
for name, (kind, seq, batch) in {cut!r}.items():
    dryrun.SHAPES[name] = ShapeConfig(name, kind, seq, batch)
out = {{}}
for arch, shape, mesh in {cells!r}:
    ms = ({{"pod": 2, "data": 16, "model": 16}} if mesh == "2x16x16"
          else {{"data": 16, "model": 16}})
    embed = default_plan(registry.get(arch), ms).get("embed")
    rec, _ = dryrun.lower_cell(arch, shape, multi_pod=mesh == "2x16x16",
                               plan_overrides={{"embed": embed}},
                               cfg_overrides={{"n_layers": {layers}}})
    out["/".join((arch, shape, mesh))] = {{"flops": rec["cost"]["flops_per_device"],
                                          "collectives": rec["collectives"]}}
print("REPRO", json.dumps(out))
"""


_REPRO_BY_OP = """
import json, math
from repro.launch import dryrun
from repro.configs.base import ShapeConfig
from repro.configs import registry
from repro.core.hlo import _INSTR_RE, _OPERANDS_RE, computation_factors, split_computations
from repro.core.hlo_cost import _LHS_C_RE, _dims
from repro.parallel.sharding import default_plan
for name, (kind, seq, batch) in {cut!r}.items():
    dryrun.SHAPES[name] = ShapeConfig(name, kind, seq, batch)
arch, shape, mesh = {cell!r}
ms = ({{"pod": 2, "data": 16, "model": 16}} if mesh == "2x16x16"
      else {{"data": 16, "model": 16}})
embed = default_plan(registry.get(arch), ms).get("embed")
rec, compiled = dryrun.lower_cell(arch, shape, multi_pod=mesh == "2x16x16",
                                  plan_overrides={{"embed": embed}},
                                  cfg_overrides={{"n_layers": {layers}}})
hlo = compiled.as_text()
comps, entry = split_computations(hlo)
factors = computation_factors(hlo)
types, sums = {{}}, {{}}
for lines in comps.values():
    for line in lines:
        m = _INSTR_RE.match(line)
        if m:
            types[m.group(1)] = m.group(2)
for cname, lines in comps.items():
    f = factors.get(cname, 1)
    for line in lines:
        m = _INSTR_RE.match(line)
        if not m or m.group(3) != "dot" or f == 0:
            continue
        name, ts, op, rest = m.groups()
        operands = [o for o in _OPERANDS_RE.findall(rest.split("),", 1)[0]) if o in types]
        k, cm = 1, _LHS_C_RE.search(rest)
        lhs = _dims(types[operands[0]]) if operands else []
        for ci in (int(c) for c in (cm.group(1) if cm else "").split(",") if c):
            k *= lhs[ci] if ci < len(lhs) else 1
        key = json.dumps([_dims(types[o]) for o in operands])
        fl, n = sums.get(key, (0.0, 0))
        sums[key] = (fl + f * 2.0 * math.prod(_dims(ts)) * k, n + f)
rows = sorted(((fl, n, key) for key, (fl, n) in sums.items()), reverse=True)[:{top}]
print("BYOP", json.dumps({{"flops": rec["cost"]["flops_per_device"], "rows": rows}}))
"""


_REPRO_REGION = """
import json, re
from repro.core import compat
from repro.launch import dryrun
from repro.configs.base import ShapeConfig
from repro.configs import registry
from repro.parallel.sharding import default_plan
for name, (kind, seq, batch) in {cut!r}.items():
    dryrun.SHAPES[name] = ShapeConfig(name, kind, seq, batch)
arch, shape, mesh = {cell!r}
dims = tuple(int(n) for n in mesh.split("x"))
axes = ("pod", "data", "model")[-len(dims):]
dryrun.make_production_mesh = lambda multi_pod=False: compat.make_mesh(dims, axes)
if {batch!r}:
    cut = dryrun.SHAPES[shape]
    dryrun.SHAPES[shape] = ShapeConfig(shape, cut.kind, cut.seq_len, {batch!r})
embed = {embed!r}
if embed == "published":
    embed = default_plan(registry.get(arch), dict(zip(axes, dims))).get("embed")
rec, compiled = dryrun.lower_cell(arch, shape, multi_pod=len(dims) == 3,
                                  plan_overrides={{"embed": embed}},
                                  cfg_overrides={{"n_layers": {layers}}})
ops = []
for line in compiled.as_text().splitlines():
    if "commr::{region}/" in line and re.search(
            r" (dot|all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)\\(", line):
        line = re.sub(r", metadata=.*", "", line.strip())
        ops.append(re.sub(r"source_target_pairs=\\{{.*?\\}}\\}}", "source_target_pairs=...", line))
print("REGION", json.dumps({{"flops": rec["cost"]["flops_per_device"], "embed": embed,
                            "by_region": rec["collectives"]["by_region"], "ops": ops}}))
"""


def repro_region(cell, region: str, batch=None, embed="published") -> dict:
    """``repro``'s compiled HLO of one cell, read in ``region``: its FLOPs a
    device, wire bytes by region, and the region's dots and collectives
    (each instruction, its metadata dropped).  The cell's mesh may be any
    shape (``"8x16"``: data x model; ``"2x16x16"``: pod x data x model),
    ``batch`` replaces the cut shape's batch, and ``embed`` the published
    config's ``embed`` rule (a mesh axis, a tuple of them, or None): the
    probes that tell when GSPMD cuts a contraction."""
    out = run_with_devices(_REPRO_REGION.format(cut=CUT, cell=tuple(cell), layers=N_LAYERS,
                                                region=region, batch=batch, embed=embed),
                           n_devices=512, timeout=1800)
    return json.loads(out.split("REGION", 1)[1])


def repro_by_op(cell, top: int = 15) -> dict:
    """``repro``'s side of :func:`by_op` for one cell: its compiled HLO's
    dots summed by operand shapes, each times its computation's execution
    count, read with the HLO parsers ``benchmarks/inspect_cell.py`` uses
    (that tool lists bytes, not products)."""
    out = run_with_devices(_REPRO_BY_OP.format(cut=CUT, cell=tuple(cell), layers=N_LAYERS,
                                               top=top),
                           n_devices=512, timeout=1800)
    return json.loads(out.split("BYOP", 1)[1])


def repro_records(cells, timeout: int = 600) -> dict:
    """(arch, shape, mesh) -> ``{"flops": repro's FLOPs a device,
    "collectives": its record's collectives}`` for each cell, from
    ``repro``'s ``lower_cell`` on 512 forced host devices (one
    subprocess)."""
    out = run_with_devices(_REPRO.format(cut=CUT, cells=list(cells), layers=N_LAYERS),
                           n_devices=512, timeout=timeout)
    got = json.loads(out.split("REPRO", 1)[1])
    return {tuple(k.split("/")): v for k, v in got.items()}


def repro_flops(cells) -> dict:
    """(arch, shape, mesh) -> repro's FLOPs a device for each cell."""
    return {c: r["flops"] for c, r in repro_records(cells).items()}


#: how many times ``repro``'s wire bytes a device the port's ``embed``
#: region may move
EMBED_WIRE_RATIO = 2.0


def region_wire(collectives: dict, region: str) -> float:
    """A record's wire bytes a device in ``region`` (0 where it has none)."""
    return float(collectives.get("by_region", {}).get(region, (0, 0))[1])


def all_cells(skip=()) -> list:
    """Every applicable (arch, shape, mesh) cell of the dry run
    (``dryrun.cell_is_applicable``), but the archs in ``skip``."""
    return [(a, s, m) for a in registry.ARCH_IDS if a not in skip for s in CUT
            for m in ("16x16", "2x16x16") if dryrun.cell_is_applicable(a, s)[0]]


#: the cells DTensor could not place before the heads were kept whole
FAULT_2 = ([(a, s, m) for a in ("deepseek-coder-33b", "grok-1-314b", "qwen2-vl-7b")
            for s in ("train_4k", "prefill_32k", "decode_32k") for m in ("16x16", "2x16x16")
            if (s, m) != ("decode_32k", "16x16")]
           + [("xlstm-1.3b", s, m) for s in CUT for m in ("16x16", "2x16x16")]
           + [("minicpm3-4b", "decode_32k", m) for m in ("16x16", "2x16x16")])


def main(argv=None) -> None:
    """Each of ``FAULT_2``'s cells (or those named, or with ``--all`` every
    applicable cell but the ``--skip`` archs) captured by the port and
    lowered by ``repro`` at 2 layers and cut shapes: a line a cell with the
    two FLOPs a device and their ratio, the two sides' wire bytes a device
    and collective counts, in all and by region, the port's capture
    seconds, the largest collective of a cache region that is not a
    weight's against one layer's cache, the collectives that take a cache,
    and ``ok``: FLOPs within ``FLOPS_RTOL`` (where ``repro`` counts any)
    and the ``embed`` region's wire bytes at most ``EMBED_WIRE_RATIO``
    times ``repro``'s; the records as JSON to ``--out``.  ``--by-op`` also
    prints each cell's 15 largest products by (op, input shapes)
    (:func:`by_op`); ``--region`` prints ``repro``'s HLO in one region of
    each cell instead (:func:`repro_region`).  Exits 1 where a cell is not
    ``ok``.

        PYTHONPATH=src python tests/dryrun_cells.py --out build/dryrun_parity.json
        PYTHONPATH=src python tests/dryrun_cells.py --all --skip xlstm-1.3b
        PYTHONPATH=src python tests/dryrun_cells.py --by-op --cell zamba2-1.2b/train_4k/16x16
        PYTHONPATH=src python tests/dryrun_cells.py --region attn --embed data \\
            --batch 4096 --cell deepseek-coder-33b/decode_32k/8x16
    """
    import argparse
    import sys
    import time

    import pytest

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    ap.add_argument("--cell", nargs="*", default=None, help="arch/shape/mesh")
    ap.add_argument("--all", action="store_true",
                    help="every applicable cell (dryrun.cell_is_applicable)")
    ap.add_argument("--skip", nargs="*", default=(), metavar="ARCH",
                    help="with --all, the archs left out")
    ap.add_argument("--out", default=None)
    ap.add_argument("--by-op", action="store_true",
                    help="print each cell's 15 largest products by (op, input shapes)")
    ap.add_argument("--no-repro", action="store_true",
                    help="the port's side only (no repro subprocess)")
    ap.add_argument("--region", default=None,
                    help="print repro's HLO dots and collectives in this region of each "
                         "--cell (any mesh shape, e.g. 8x16) and stop")
    ap.add_argument("--batch", type=int, default=None,
                    help="with --region, the batch in place of the cut shape's")
    ap.add_argument("--embed", default="published",
                    help="with --region, the embed rule: a mesh axis, axes joined by '+', "
                         "or 'none'")
    args = ap.parse_args(argv)
    if args.region:
        embed = (None if args.embed == "none" else tuple(args.embed.split("+"))
                 if "+" in args.embed else args.embed)
        for cell in args.cell or ():
            got = repro_region(cell.split("/"), args.region, args.batch, embed)
            print(f"{cell} batch {args.batch or CUT[cell.split('/')[1]][2]} embed "
                  f"{got['embed']}: {got['flops']:.0f} FLOPs a device, by region "
                  f"{got['by_region']}", flush=True)
            for op in got["ops"]:
                print("  " + op[:300], flush=True)
        return
    cells = ([tuple(c.split("/")) for c in args.cell] if args.cell
             else all_cells(args.skip) if args.all else FAULT_2)
    want = ({c: None for c in cells} if args.no_repro
            else repro_records(cells, timeout=600 + 120 * len(cells)))
    rows = []
    for cell in cells:
        t = time.perf_counter()
        graphs = []
        with pytest.MonkeyPatch.context() as mp:
            try:
                record, ops, cache = port_cell(mp, *cell, graphs=graphs)
            except Exception as e:  # a failing cell is reported and the sweep goes on
                record, ops, cache = {"status": "error", "error": f"{type(e).__name__}: {e}"}, [], 0
        seconds = time.perf_counter() - t
        got = record.get("cost", {}).get("flops_per_device")
        mine = record.get("collectives", {})
        theirs = want[cell] or {"flops": None, "collectives": {}}
        flops = theirs["flops"]
        ratio = got / flops if got and flops else None
        embed = (region_wire(mine, "embed"), region_wire(theirs["collectives"], "embed"))
        ok = (record["status"] == "ok" and (ratio is None or abs(ratio - 1) <= FLOPS_RTOL)
              and (args.no_repro or embed[0] <= EMBED_WIRE_RATIO * embed[1]))
        row = {"cell": "/".join(cell), "status": record["status"], "ok": ok,
               "port": got, "repro": flops, "ratio": ratio,
               "wire": (mine.get("wire_bytes_per_device"),
                        theirs["collectives"].get("wire_bytes_per_device")),
               "n_ops": (mine.get("n_ops"), theirs["collectives"].get("n_ops")),
               "embed_wire": embed,
               "by_region": (mine.get("by_region"), theirs["collectives"].get("by_region")),
               "seconds": seconds, "largest_collective": largest_activation_collective(ops),
               "layer_cache": cache, "caches_gathered": len(gathered_caches(ops)),
               "error": record.get("error")}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.by_op and graphs:
            for flops_, calls, op, shapes in by_op(graphs[-1]):
                share = flops_ / got if got else 0.0
                print(f"  port {op} {[list(s) for s in shapes]} x{calls}: {flops_:.4g} "
                      f"({share:.1%})", flush=True)
        if args.by_op and not args.no_repro:
            split = repro_by_op(cell)
            for flops_, calls, shapes in split["rows"]:
                print(f"  repro dot {shapes} x{calls}: {flops_:.4g} "
                      f"({flops_ / split['flops']:.1%})", flush=True)
    print(f"{sum(r['ok'] for r in rows)} of {len(rows)} cells ok, "
          f"{sum(r['seconds'] for r in rows):.0f} s of capture", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if not all(r["ok"] for r in rows):
        sys.exit(1)


if __name__ == "__main__":
    main()
