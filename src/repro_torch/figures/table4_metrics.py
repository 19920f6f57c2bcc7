"""Paper Table IV — sample metric collection from annotated regions."""

from __future__ import annotations

from repro_torch.core.reports import table4_metrics
from repro_torch.core.thicket import Frame
from repro_torch.figures.paper_data import profiles, write


def run() -> list:
    profs = []
    for exp in (
        "kripke-weak-dane",
        "kripke-weak-tioga",
        "amg-weak-dane",
        "amg-weak-tioga",
        "laghos-strong",
    ):
        profs.extend(profiles(exp))
    md = "## Table IV analog — per-app totals across scales\n\n"
    write("table4_metrics.md", md + table4_metrics(profs))
    frame = Frame.from_profiles(profs).agg(
        ("profile", "meta_seconds"),
        {
            "tb": ("total_bytes_sent", sum),
            "ts": ("total_sends", sum),
        },
    )
    rows = []
    for r in frame:
        rows.append(
            (
                f"table4/{r['profile']}",
                r["meta_seconds"] * 1e6,
                f"bytes={r['tb']:.3e};sends={r['ts']:.3e}",
            )
        )
    return rows
