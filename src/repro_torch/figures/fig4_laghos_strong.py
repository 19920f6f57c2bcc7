"""Paper Fig 4 — Laghos strong scaling: per-region time vs processes."""

from __future__ import annotations

from repro_torch.core.thicket import Frame
from repro_torch.figures.paper_data import profiles, write


def run() -> list:
    rows = []
    profs = profiles("laghos-strong")
    frame = Frame.from_profiles(profs)
    he = {r["n_ranks"]: r for r in frame.where(region="halo_exchange")}
    ts = {r["n_ranks"]: r for r in frame.where(region="timestep")}
    lines = [
        "## Fig 4 analog — Laghos strong scaling (rs-analog config)\n",
        "| ranks | step_s (roofline) | halo bytes/rank (max) | "
        "timestep collectives | timestep coll bytes (max) |",
        "|---|---|---|---|---|",
    ]
    for p in profs:
        h = he.get(p.n_ranks)
        t = ts.get(p.n_ranks)
        halo_bytes = h["bytes_sent_max"] if h else 0
        lines.append(
            f"| {p.n_ranks} | {p.meta['seconds']:.3e} | "
            f"{halo_bytes} | {t['coll'] if t else 0} | "
            f"{t['coll_bytes_max'] if t else 0} |"
        )
        rows.append(
            (
                f"fig4/{p.name}",
                p.meta["seconds"] * 1e6,
                f"halo_bytes_max={halo_bytes}",
            )
        )
    write("fig4_laghos_strong.md", "\n".join(lines))
    return rows
