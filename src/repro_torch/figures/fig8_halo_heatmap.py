"""Paper Fig 8 analog — halo-exchange peer-pair heatmaps + modeled congestion.

The paper's signature visualization: for each app, the (src rank, dst rank)
message-count matrix of its dominant communication region (the GKE study
emits the same artifact from Caliper data).  On top, the modeled network
layer (``repro_torch.core.network``) joins per region with the traced layer
(``reports.network_vs_traced``) and a small scaling sweep plots modeled
link congestion per region vs process count on all three fabric models.

Each app traces on meta tensors (no rank needs a device) under a
``trace_observer`` hook that keeps the finished recorder, so the same
trace yields the traced profile, the ``layer="network"`` rows, and the
heatmap matrix; the reductions run on the default backend (torch on the
CUDA card).  ``smoke_artifacts`` is the smoke sweep's entry point: it
re-traces the 8192-rank kripke scale point and emits binned heatmap
CSV/ASCII artifacts plus the network-layer frame.
"""

from __future__ import annotations

import os

from repro_torch.apps.stencil import Decomp3D
from repro_torch.benchpark.runner import app_profile_fns
from repro_torch.core.network import (
    DRAGONFLY,
    FAT_TREE,
    RING,
    ascii_heatmap,
    heatmap_csv,
    peer_heatmap,
)
from repro_torch.core.profiler import trace_observer
from repro_torch.core.reports import ascii_scaling_plot, network_vs_traced
from repro_torch.core.thicket import Frame
from repro_torch.figures.paper_data import write

#: Paper-scale configs per app (small enough to render a full heatmap).
_APP_PARAMS = {
    "kripke": dict(nx=8, ny=8, nz=8, n_octants=1),
    "amg": dict(nx=4, ny=4, nz=4, n_cycles=1),
    "laghos": dict(nx=64, ny=32, n_steps=2),
    "beatnik": dict(nx=16, ny=16, n_steps=2),
}

#: Heatmap decomposition per app + the small congestion-scaling sweep.
_APP_DECOMPS = {
    "kripke": ((4, 4, 4), [(2, 2, 2), (4, 2, 2), (4, 4, 2), (4, 4, 4)]),
    "amg": ((4, 4, 4), [(2, 2, 2), (4, 2, 2), (4, 4, 2), (4, 4, 4)]),
    "laghos": ((8, 4, 1), [(2, 2, 1), (4, 2, 1), (4, 4, 1), (8, 4, 1)]),
    "beatnik": ((4, 4, 1), [(2, 2, 1), (4, 2, 1), (4, 4, 1)]),
}


def _make_config(app: str, decomp: tuple):
    from repro_torch.apps.amg import AMGConfig
    from repro_torch.apps.beatnik import BeatnikConfig
    from repro_torch.apps.kripke import KripkeConfig
    from repro_torch.apps.laghos import LaghosConfig

    cls = {
        "kripke": KripkeConfig,
        "amg": AMGConfig,
        "laghos": LaghosConfig,
        "beatnik": BeatnikConfig,
    }[app]
    params = dict(_APP_PARAMS[app])
    if app == "laghos":
        # strong scaling: global mesh must divide every decomposition
        params["nx"] = max(params["nx"], decomp[0] * 8)
        params["ny"] = max(params["ny"], decomp[1] * 8)
    return cls(decomp=Decomp3D(*decomp), **params)


def trace_app(app: str, decomp: tuple, name: str | None = None) -> tuple:
    """(CommProfile, finished recorder) for one app at one decomposition."""
    holder: dict = {}

    def keep_recorder(rec, *, name, replication, meta):
        holder["rec"] = rec
        return None  # fall through to the batch reduction

    cfg = _make_config(app, decomp)
    with trace_observer(keep_recorder):
        prof = app_profile_fns()[app](cfg, name=name or f"{app}-{cfg.decomp.n_ranks}")
    return prof, holder["rec"]


def _dominant_region(prof) -> str:
    return max(prof.regions.values(), key=lambda s: s.total_bytes_sent).region


def run() -> list:
    rows_out = []
    lines = ["## Fig 8 analog — halo-exchange heatmaps + modeled network layer\n"]
    for app, (decomp, sweep) in _APP_DECOMPS.items():
        prof, rec = trace_app(app, decomp)
        region = _dominant_region(prof)
        n = prof.n_ranks

        H = peer_heatmap(rec, region=region)
        lines.append(ascii_heatmap(H, title=f"{app} @ {n} ranks — {region}"))
        csv_name = f"fig8_heatmap_{app}.csv"
        write(csv_name, heatmap_csv(H))
        lines.append(f"\n(full matrix: results/{csv_name})\n")

        # three-layer join at the heatmap scale, one row set per fabric
        entries = [(prof.name, n, rec, fab) for fab in (RING, FAT_TREE, DRAGONFLY)]
        lines.append(network_vs_traced([prof], entries))
        net = Frame.from_network(entries).where(region=region)
        for r in net:
            rows_out.append(
                (
                    f"fig8/{app}-{n}-{r['net_fabric']}",
                    r["net_wire_s"] * 1e6,
                    f"region={region};congestion={r['net_congestion']:.3f};"
                    f"links={r['net_links_used']}",
                )
            )

        # per-region modeled-congestion scaling (ring fabric)
        frames = []
        for d in sweep:
            sprof, srec = trace_app(app, d)
            frames.append(
                Frame.from_network([(sprof.name, sprof.n_ranks, srec, RING)])
            )
        sweep_frame = Frame.concat(frames).where(region=region)
        xs = [r["n_ranks"] for r in sweep_frame]
        ys = [r["net_congestion"] for r in sweep_frame]
        lines.append("")
        lines.append(
            ascii_scaling_plot(
                xs, ys, title=f"{app} {region}: modeled ring congestion vs ranks"
            )
        )
        lines.append("")
    write("fig8_halo_heatmap.md", "\n".join(lines))
    return rows_out


def smoke_artifacts(out_dir: str, backend=None) -> dict:
    """Smoke-sweep leg: the 8192-rank kripke point through the network
    layer.

    Emits into ``out_dir``:

    - ``fig8_halo_heatmap_8192.csv`` — 64x64 rank-binned peer-pair matrix
    - ``fig8_halo_heatmap_8192.txt`` — ASCII rendering + three-layer join
    - ``fig8_network_frame.csv``     — ``layer="network"`` rows, all fabrics

    Asserts the O(unique structs) contract at scale: the struct table of
    the 8192-rank trace must stay orders of magnitude smaller than the
    logical event count the model covers.  ``backend`` (name or instance;
    default resolved as every entry point does, torch on the CUDA card)
    runs the profile's, the report's and the network frame's reductions.
    """
    from repro_torch.benchpark.spec import SCALE_EXPERIMENTS
    from repro_torch.core.backend import resolve_backend, use_backend

    be = resolve_backend(backend)

    spec = SCALE_EXPERIMENTS["kripke-weak-scale"]
    (pt,) = [p for p in spec.points if p.n_ranks == 8192]
    cfg = _make_config("kripke", tuple(pt.decomp))
    cfg = type(cfg)(decomp=cfg.decomp, **spec.app_params)
    holder: dict = {}

    def keep_recorder(rec, *, name, replication, meta):
        holder["rec"] = rec
        return None

    with use_backend(be), trace_observer(keep_recorder):
        prof = app_profile_fns()["kripke"](cfg, name="kripke-8192")
    rec = holder["rec"]
    buf = rec.buffer
    S = buf.structs.n_structs
    total_sends = sum(s.total_sends for s in prof.regions.values())
    assert total_sends >= 50 * S, (total_sends, S)

    region = _dominant_region(prof)
    H = peer_heatmap(rec, region=region, bins=64)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fig8_halo_heatmap_8192.csv"), "w") as f:
        f.write(heatmap_csv(H))
    entries = [
        (prof.name, prof.n_ranks, rec, fab) for fab in (RING, FAT_TREE, DRAGONFLY)
    ]
    txt = "\n".join(
        [
            ascii_heatmap(H, title=f"kripke @ 8192 ranks — {region} (64x64 bins)"),
            "",
            network_vs_traced([prof], entries, backend=be),
        ]
    )
    with open(os.path.join(out_dir, "fig8_halo_heatmap_8192.txt"), "w") as f:
        f.write(txt)
    frame = Frame.from_network(entries, backend=be)
    with open(os.path.join(out_dir, "fig8_network_frame.csv"), "w") as f:
        f.write(frame.to_csv())
    return {"n_structs": S, "total_sends": total_sends, "regions": len(frame)}
