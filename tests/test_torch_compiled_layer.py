"""The port's compiled collective layer against ``repro``'s HLO layer.

``scan_graph_collectives`` captures the per-rank program's graph and reads
one row per collective custom op; ``repro`` compiles the same program on 8
forced host devices and scans the post-SPMD HLO (one subprocess).  fig 7's
kripke-8 must match op for op, and its ``hlo_vs_traced`` markdown must be
equal.  For amg, laghos and beatnik the per-(region, kind) totals of ops,
wire, operand and result bytes must agree, except where XLA's passes
change the program (``DEPARTURES``): a captured graph runs none of them.
"""

import json
import os
import tempfile
from collections import defaultdict

import pytest
import torch

from helpers import run_with_devices
from repro_torch.apps import multirank
from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.hlo import graph_collectives, scan_graph_collectives
from repro_torch.core.regions import comm_region
from repro_torch.core.reports import hlo_vs_traced
from repro_torch.figures import fig7_hlo_vs_traced

APPS = ["amg", "laghos", "beatnik"]

#: (app, region, kind) -> (the port's ops, repro's ops), where the two
#: layers' op counts differ by design; their bytes still agree.
DEPARTURES = {
    # XLA's all-reduce combiner folds the three steps' reduce_norm psums
    # (4 bytes each, no data dependence between them) into one all-reduce
    # of 12 bytes; the captured graph keeps the three custom ops.
    ("beatnik", "reduce_norm", "all-reduce"): (3, 1),
}

_JAX = """
import json
import jax
from repro.apps import amg, beatnik, kripke, laghos
from repro.apps.stencil import Decomp3D
from repro.core.hlo import scan_hlo_collectives
from repro.core.profiler import CommPatternProfiler
from repro.core.regions import recording
from repro.core.reports import hlo_vs_traced

params = json.load(open({params!r}))

def ops(buf):
    return [dict(kind=o.kind, region=o.region, result_bytes=o.result_bytes,
                 operand_bytes=o.operand_bytes, wire_bytes=o.wire_bytes,
                 group_size=o.group_size, n_groups=o.n_groups,
                 trip_factor=o.trip_factor) for o in buf.to_ops()]

def scan(fn, *args):
    text = jax.jit(fn).lower(*args).compile().as_text()
    return scan_hlo_collectives(text, total_devices=8, with_loops=True)

out = {{}}
cfg = kripke.KripkeConfig(decomp=Decomp3D(2, 2, 2), nx=4, ny=4, nz=4,
                          n_dirsets=2, n_groupsets=2, dirs_per_set=2,
                          groups_per_set=2)
fn = kripke.distributed_sweep(cfg, cfg.decomp.make_mesh())
q = jax.ShapeDtypeStruct((2, 2, 8, 8, 8, 2, 2), cfg.dtype)
with cfg.decomp.topology():
    with recording() as rec:
        jax.eval_shape(fn, q)
    buf = scan(fn, q)
prof = CommPatternProfiler.from_recorder(rec, name="kripke-8")
out["fig7"] = {{"ops": ops(buf), "markdown": hlo_vs_traced(
    [prof], [("kripke-8", 8, buf, {{"app": "kripke"}})])}}
for app, (mod, cls, inputs) in {{
    "amg": (amg, amg.AMGConfig, amg.make_rhs),
    "laghos": (laghos, laghos.LaghosConfig, laghos.make_state),
    "beatnik": (beatnik, beatnik.BeatnikConfig, beatnik.make_state),
}}.items():
    p = dict(params[app])
    c = cls(decomp=Decomp3D(*p.pop("decomp")), **p)
    run = getattr(mod, "solve" if app == "amg" else "run_steps")
    out[app] = {{"ops": ops(scan(run(c, c.decomp.make_mesh()), inputs(c)))}}
with open({out!r}, "w") as f:
    json.dump(out, f)
print("OK")
"""


def _ops(buf) -> list:
    return [
        dict(kind=o.kind, region=o.region, result_bytes=o.result_bytes,
             operand_bytes=o.operand_bytes, wire_bytes=o.wire_bytes,
             group_size=o.group_size, n_groups=o.n_groups, trip_factor=o.trip_factor)
        for o in buf.to_ops()
    ]


def _port_layer(app: str):
    cfg = multirank.app_config(app, multirank.PARITY_PARAMS[app])
    mesh = cfg.decomp.make_mesh()
    x = multirank.app_inputs(app, cfg, torch.device("cpu"))
    return scan_graph_collectives(multirank.app_driver(app, cfg), x, mesh=mesh,
                                  total_devices=cfg.decomp.n_ranks)


def _totals(ops: list) -> dict:
    out = defaultdict(lambda: dict(ops=0, wire=0, operand=0, result=0))
    for o in ops:
        t = out[(o["region"], o["kind"])]
        t["ops"] += 1
        t["wire"] += o["wire_bytes"]
        t["operand"] += o["operand_bytes"]
        t["result"] += o["result_bytes"]
    return dict(out)


@pytest.fixture(scope="module")
def repro_layers():
    """repro's HLO ops for fig 7's kripke-8 and the three apps, and fig 7's
    ``hlo_vs_traced`` markdown, from 8 forced host devices."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"params": os.path.join(tmp, "params.json"),
                 "out": os.path.join(tmp, "out.json")}
        with open(paths["params"], "w") as f:
            json.dump(multirank.PARITY_PARAMS, f)
        run_with_devices(_JAX.format(**paths))
        with open(paths["out"]) as f:
            return json.load(f)


def test_kripke_fig7_layer_matches_repro_op_for_op(repro_layers):
    _prof, _rec, buf = fig7_hlo_vs_traced.layers(backend="numpy")
    got = _ops(buf)
    assert got == repro_layers["fig7"]["ops"]
    assert buf.n_ops == 3 and int(buf.wire_bytes.sum()) == 3072
    assert buf.region_names == ["sweep_comm"]


def test_fig7_markdown_equals_repro(repro_layers):
    prof, _rec, buf = fig7_hlo_vs_traced.layers(backend="numpy")
    got = hlo_vs_traced([prof], [("kripke-8", 8, buf, {"app": "kripke"})],
                        backend="numpy")
    assert got == repro_layers["fig7"]["markdown"]


@pytest.mark.parametrize("app", APPS)
def test_app_layer_per_region_and_kind_matches_repro(app, repro_layers):
    got, want = _totals(_ops(_port_layer(app))), _totals(repro_layers[app]["ops"])
    assert set(got) == set(want)
    for key in want:
        g, w = dict(got[key]), dict(want[key])
        departure = DEPARTURES.get((app, *key))
        if departure is not None:
            assert (g.pop("ops"), w.pop("ops")) == departure, key
        assert g == w, key


@pytest.mark.parametrize("app", APPS)
def test_app_layer_totals(app, repro_layers):
    """The layers' wire bytes agree in total; their op counts differ only
    by the departures."""
    buf = _port_layer(app)
    want = repro_layers[app]["ops"]
    extra = sum(p - r for (a, *_), (p, r) in DEPARTURES.items() if a == app)
    assert int(buf.wire_bytes.sum()) == sum(o["wire_bytes"] for o in want)
    assert buf.n_ops == len(want) + extra
    assert all(name.startswith("commr::main/") for name in buf.op_names)


def _per_rank(x):
    with comm_region("outer"):
        with comm_region("inner"):
            y = coll.psum(x * 2, "x")
        z = coll.ppermute(y, "y", [(0, 1)])
    return z + 1


_MESH = compat.make_mesh((2, 2, 2), ("x", "y", "z"))
_WANT = {
    "op_names": ["commr::outer/commr::inner/all-reduce",
                 "commr::outer/collective-permute"],
    "regions": ["inner", "outer"],
    "wire": [48, 48],  # all-reduce over x (2 ranks): 2 * (2 - 1) / 2 * 48
}


def _read(buf) -> dict:
    return {"op_names": buf.op_names, "regions": buf.region_names,
            "wire": [int(w) for w in buf.wire_bytes]}


def test_region_path_reaches_the_node_under_make_fx():
    buf = scan_graph_collectives(_per_rank, torch.empty(4, 3), mesh=_MESH,
                                 total_devices=8)
    assert _read(buf) == _WANT


def test_region_path_reaches_the_node_under_torch_compile():
    """Dynamo drops ``record_function`` scopes; the path is an argument."""
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    torch._dynamo.reset()
    with compat.axis_env(_MESH):
        torch.compile(_per_rank, backend=backend, fullgraph=True)(
            torch.empty(4, 3, device="meta"))
    torch._dynamo.reset()
    assert len(graphs) == 1
    assert _read(graph_collectives(graphs[0].graph, mesh=_MESH,
                                   total_devices=8)) == _WANT
