"""Paper Fig 2 — AMG bytes sent per multigrid level vs processes."""

from __future__ import annotations

from repro_torch.core.reports import per_level_report
from repro_torch.core.thicket import Frame
from repro_torch.figures.paper_data import profiles, write


def run() -> list:
    rows = []
    parts = ["## Fig 2 analog — AMG max bytes sent per process, per MG level\n"]
    for exp in ("amg-weak-dane", "amg-weak-tioga"):
        parts.append(f"### {exp}\n")
        profs = profiles(exp)
        parts.append(per_level_report(profs, metric="bytes_sent_max"))
        parts.append("")
        frame = Frame.from_profiles(profs).where(region="mg_level_0")
        for r in frame:
            rows.append(
                (
                    f"fig2/{r['profile']}",
                    r["meta_seconds"] * 1e6,
                    f"lvl0_bytes_max={r['bytes_sent_max']}",
                )
            )
    write("fig2_amg_levels.md", "\n".join(parts))
    return rows
