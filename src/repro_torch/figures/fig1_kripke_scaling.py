"""Paper Fig 1 — Kripke time per region vs processes (roofline seconds)."""

from __future__ import annotations

from repro_torch.core.thicket import Frame
from repro_torch.figures.paper_data import profiles, write


def run() -> list:
    rows_out = []
    lines = ["## Fig 1 analog — Kripke per-region share vs processes\n"]
    for exp in ("kripke-weak-dane", "kripke-weak-tioga"):
        frame = Frame.from_profiles(profiles(exp)).where(region="sweep_comm")
        cols = ("profile", "n_ranks", "meta_seconds", "bytes_sent_max", "sends_max")
        frame = frame.select(*cols).sort("n_ranks")
        lines.append(f"### {exp}\n")
        lines.append(
            "| ranks | step_s (roofline) | sweep_comm bytes/rank "
            "(max) | sends/rank (max) |"
        )
        lines.append("|---|---|---|---|")
        for r in frame:
            lines.append(
                f"| {r['n_ranks']} | {r['meta_seconds']:.3e} | "
                f"{r['bytes_sent_max']} | {r['sends_max']} |"
            )
            rows_out.append(
                (
                    f"fig1/{r['profile']}",
                    r["meta_seconds"] * 1e6,
                    f"sweep_bytes_max={r['bytes_sent_max']}",
                )
            )
        lines.append("")
    write("fig1_kripke_scaling.md", "\n".join(lines))
    return rows_out
