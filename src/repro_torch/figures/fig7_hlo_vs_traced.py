"""Two-layer per-region join — compiled collectives vs traced collectives.

No direct paper analog: the extension the ``commr::`` region names enable.
The kripke sweep (8 ranks) goes through the profiling stack twice: traced
(instrumented collectives -> TraceBuffer -> CommProfile) and captured (the
per-rank program's graph -> one row per collective custom op ->
HloCollectiveBuffer, :func:`repro_torch.core.hlo.scan_graph_collectives`).
Both layers land in one ``thicket.Frame``, joined per region by
``reports.hlo_vs_traced``.  The capture traces on meta tensors, so it needs
no process group and no device.
"""

from __future__ import annotations

import torch

from repro_torch.apps.kripke import KripkeConfig, distributed_sweep
from repro_torch.apps.stencil import Decomp3D
from repro_torch.core.hlo import scan_graph_collectives
from repro_torch.core.profiler import CommPatternProfiler
from repro_torch.core.regions import recording
from repro_torch.core.reports import hlo_vs_traced
from repro_torch.core.thicket import Frame
from repro_torch.figures.paper_data import write

CONFIG = KripkeConfig(decomp=Decomp3D(2, 2, 2), nx=4, ny=4, nz=4, n_dirsets=2,
                      n_groupsets=2, dirs_per_set=2, groups_per_set=2)


def layers(backend=None) -> tuple:
    """(traced profile, its recorder, the captured layer's buffer) of
    :data:`CONFIG`; the trace is reduced on ``backend`` (default: the
    resolved default)."""
    cfg = CONFIG
    mesh = cfg.decomp.make_mesh()
    fn = distributed_sweep(cfg, mesh)
    dc = cfg.decomp
    q = torch.empty(
        (cfg.n_dirsets, cfg.n_groupsets, cfg.nx * dc.px, cfg.ny * dc.py,
         cfg.nz * dc.pz, cfg.dirs_per_set, cfg.groups_per_set),
        dtype=cfg.torch_dtype,
        device="meta",
    )
    n = dc.n_ranks
    with dc.topology():
        with recording() as rec:
            fn(q)
        buf = scan_graph_collectives(fn, q, mesh=mesh, total_devices=n)
    prof = CommPatternProfiler.from_recorder(rec, name=f"kripke-{n}", backend=backend)
    return prof, rec, buf


def run() -> list:
    prof, rec, buf = layers()
    entries = [(prof.name, prof.n_ranks, buf, {"app": "kripke"})]
    frame = Frame.concat([Frame.from_profiles([prof]), Frame.from_hlo(entries)])
    shared = sorted(set(prof.regions) & set(buf.region_names))
    hlo_wire = int(buf.wire_bytes.sum())
    lines = [
        "## Fig 7 analog — compiled-HLO vs traced traffic per region "
        "(kripke, 8 ranks)\n",
        hlo_vs_traced([prof], entries),
        "",
        f"traced events: {int(rec.buffer.n_events)}  /  "
        f"HLO collective ops: {buf.n_ops}  /  "
        f"regions in both layers: {', '.join(shared) or '(none)'}",
        "",
        "### joined two-layer frame (CSV)",
        "```",
        frame.to_csv(),
        "```",
    ]
    write("fig7_hlo_vs_traced.md", "\n".join(lines))
    return [
        (
            "fig7/kripke-8",
            0.0,
            f"hlo_ops={buf.n_ops};hlo_wire={hlo_wire};shared_regions={len(shared)}",
        ),
    ]
