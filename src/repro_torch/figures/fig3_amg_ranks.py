"""Paper Fig 3 — AMG average source ranks per multigrid level."""

from __future__ import annotations

from repro_torch.core.reports import per_level_report
from repro_torch.core.thicket import Frame
from repro_torch.figures.paper_data import profiles, write


def run() -> list:
    rows = []
    parts = [
        "## Fig 3 analog — AMG max src ranks per process, per MG "
        "level (coarse_solve row shows the all-ranks gather)\n"
    ]
    for exp in ("amg-weak-dane", "amg-weak-tioga"):
        parts.append(f"### {exp}\n")
        profs = profiles(exp)
        parts.append(per_level_report(profs, metric="src_ranks_max"))
        parts.append("\n| ranks | coarse_solve collective bytes (max/rank) |")
        parts.append("|---|---|")
        frame = Frame.from_profiles(profs)
        cs = {r["n_ranks"]: r for r in frame.where(region="coarse_solve")}
        lv0 = {r["n_ranks"]: r for r in frame.where(region="mg_level_0")}
        for p in profs:
            c = cs.get(p.n_ranks)
            parts.append(f"| {p.n_ranks} | {c['coll_bytes_max'] if c else 0} |")
            l0 = lv0.get(p.n_ranks)
            rows.append(
                (
                    f"fig3/{p.name}",
                    p.meta["seconds"] * 1e6,
                    f"lvl0_src_ranks={l0['src_ranks_max'] if l0 else 0}",
                )
            )
        parts.append("")
    write("fig3_amg_ranks.md", "\n".join(parts))
    return rows
