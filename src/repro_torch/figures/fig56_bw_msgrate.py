"""Paper Figs 5/6 — per-process bandwidth and message rate, all three apps."""

from __future__ import annotations

from repro_torch.core.reports import bandwidth_msgrate_report
from repro_torch.core.thicket import Frame
from repro_torch.figures.paper_data import profiles, write


def run() -> list:
    profs = []
    for exp in (
        "amg-weak-dane",
        "kripke-weak-dane",
        "laghos-strong",
        "amg-weak-tioga",
        "kripke-weak-tioga",
    ):
        profs.extend(profiles(exp))
    hdr = "## Fig 5/6 analog — bandwidth & message rate (roofline-time denominator)"
    write("fig56_bw_msgrate.md", hdr + "\n\n" + bandwidth_msgrate_report(profs))
    frame = Frame.from_profiles(profs).agg(
        ("profile", "n_ranks", "meta_seconds"),
        {
            "tb": ("total_bytes_sent", sum),
            "ts": ("total_sends", sum),
        },
    )
    rows = []
    for r in frame:
        sec = r["meta_seconds"]
        n = max(1, r["n_ranks"])
        rows.append(
            (
                f"fig56/{r['profile']}",
                sec * 1e6,
                f"bw={r['tb'] / n / sec:.3e}B/s;rate={r['ts'] / n / sec:.3e}/s",
            )
        )
    return rows
