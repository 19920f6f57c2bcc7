"""Report emitters reproducing the paper's tables/figures as markdown/CSV.

Each function maps one paper artifact onto the profiling data collected by
this framework ("time" columns read ``meta['seconds']``, which the sweep
runner stamps on each profile).  All tabular aggregation routes through the
NumPy-backed :class:`repro_torch.core.thicket.Frame`; every emitter
tolerates empty profile sets and profiles with disjoint region name sets
(sparse scaling sweeps).

The emitters that group, pivot or reduce take ``backend=`` (a name or a
:class:`~repro_torch.core.backend.ReduceBackend`): the default is torch on
the CUDA card, which raises ``BackendUnavailable`` without one; the
rendered text is identical on every backend.
"""

from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.core.backend import resolve_backend
from repro_torch.core.profiler import CommProfile
from repro_torch.core.thicket import Frame, add_rate_metrics


def table1_schema() -> str:
    """Paper Table I — the attribute schema the profiler collects."""
    rows = [
        ("Sends", "Min/Max number of messages sent"),
        ("Recvs", "Min/Max number of messages received"),
        ("Dest ranks", "Min/Max number of distinct destination ranks"),
        ("Src ranks", "Min/Max number of distinct source ranks"),
        ("Bytes sent", "Min/Max message size sent by a process in a region"),
        ("Bytes recv", "Min/Max message size received by a process in a region"),
        ("Coll", "Max collective calls in a region"),
        ("Coll bytes*", "Min/Max collective bytes per rank (extension)"),
    ]
    out = ["| Attribute | Description |", "|---|---|"]
    out += [f"| {a} | {d} |" for a, d in rows]
    return "\n".join(out)


def table4_metrics(
    profiles: Iterable[CommProfile], region: Optional[str] = None, backend=None
) -> str:
    """Paper Table IV — total bytes sent / sends / largest / average send.

    One row per (profile name, n_ranks), in input order; aggregates over all
    regions unless ``region`` is given.  Profiles lacking the requested
    region (disjoint region sets across a sweep) contribute an explicit zero
    row rather than silently falling back to all their regions; an empty
    profile set yields just the header.
    """
    be = resolve_backend(backend)
    profiles = list(profiles)
    frame = Frame.from_profiles(profiles)
    if region is not None:
        frame = frame.where(region=region)
    by_key: dict = {}
    if len(frame):
        agg = frame.agg(
            ("profile", "n_ranks"),
            {
                "tb": ("total_bytes_sent", sum),
                "ts": ("total_sends", sum),
                "lg": ("largest_send", max),
            },
            backend=be,
        )
        by_key = {(r["profile"], r["n_ranks"]): r for r in agg}
    out = [
        "| Application - Processes | Total Bytes Sent | Total Sends | "
        "Largest Send (bytes) | Average Send Size (bytes) |",
        "|---|---|---|---|---|",
    ]
    seen = set()
    for p in profiles:
        key = (p.name, p.n_ranks)
        if key in seen:
            continue
        seen.add(key)
        r = by_key.get(key)
        tb = r["tb"] if r else 0
        ts = r["ts"] if r else 0
        lg = r["lg"] if r else 0
        avg = tb / ts if ts else 0.0
        out.append(
            f"| {p.name} - {p.n_ranks} | {tb:.3e} | {ts:.3e} | {lg} | {avg:.3e} |"
        )
    return "\n".join(out)


def region_stats_table(profile: CommProfile) -> str:
    """Full Table-I-schema dump for every region in one profile."""
    out = [
        "| Region | Inst | Sends (mn/mx) | Recvs (mn/mx) | "
        "Dst ranks | Src ranks | Bytes sent (mn/mx) | "
        "Bytes recv (mn/mx) | Coll | Coll bytes (mx) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name in sorted(profile.regions):
        s = profile.regions[name]
        out.append(
            f"| {name} | {s.instances} | {s.sends[0]}/{s.sends[1]} | "
            f"{s.recvs[0]}/{s.recvs[1]} | "
            f"{s.dest_ranks[0]}/{s.dest_ranks[1]} | "
            f"{s.src_ranks[0]}/{s.src_ranks[1]} | "
            f"{s.bytes_sent[0]}/{s.bytes_sent[1]} | "
            f"{s.bytes_recv[0]}/{s.bytes_recv[1]} | "
            f"{s.coll} | {s.coll_bytes[1]} |"
        )
    return "\n".join(out)


def hlo_vs_traced(profiles: Iterable[CommProfile], hlo_entries, backend=None) -> str:
    """Two-layer per-region comparison (no paper analog — an extension).

    Joins application-layer traffic (instrumented collectives, recorded at
    trace time) with compiled-layer traffic (GSPMD collectives extracted
    from post-SPMD HLO by the columnar analyzer) on (profile, region) —
    the ``commr::`` named scopes give both layers the same region
    namespace.  ``hlo_entries`` is an iterable of
    ``(profile_name, n_ranks, HloCollectiveBuffer)`` tuples; regions
    present in only one layer get zero cells for the other.
    """
    be = resolve_backend(backend)
    both = Frame.concat(
        [Frame.from_profiles(profiles), Frame.from_hlo(hlo_entries, backend=be)]
    )

    def total(values):
        return sum(v for v in values if v)

    out = [
        "| Profile | Region | Traced bytes | Traced sends | Traced coll | "
        "HLO ops | HLO wire bytes | hlo/traced bytes |",
        "|---|---|---|---|---|---|---|---|",
    ]
    if len(both):
        agg = both.agg(
            ("profile", "region"),
            {
                "traced_bytes": ("total_bytes_sent", total),
                "traced_sends": ("total_sends", total),
                "traced_coll": ("coll", total),
                "hlo_ops": ("hlo_ops", total),
                "hlo_wire": ("hlo_wire_bytes", total),
            },
            backend=be,
        )
        for r in agg.sort("profile", "region"):
            if r["traced_bytes"]:
                ratio = f"{r['hlo_wire'] / r['traced_bytes']:.3f}"
            else:
                ratio = "-"
            out.append(
                f"| {r['profile']} | {r['region']} | {r['traced_bytes']} | "
                f"{r['traced_sends']} | {r['traced_coll']} | {r['hlo_ops']} | "
                f"{r['hlo_wire']} | {ratio} |"
            )
    return "\n".join(out)


def network_vs_traced(
    profiles: Iterable[CommProfile], network_entries, hlo_entries=(), backend=None
) -> str:
    """Three-layer per-region join: traced traffic vs modeled fabric cost.

    Concatenates ``layer="traced"`` rows (instrumented collectives),
    ``layer="network"`` rows (modeled wire time / hops / link congestion
    from :mod:`repro_torch.core.network` — ``network_entries`` is the
    ``Frame.from_network`` tuple form), and optionally ``layer="hlo"`` rows
    (``hlo_entries`` as in :func:`hlo_vs_traced`) into one frame, then
    aggregates per (profile, region): the table the paper's heatmap figures
    annotate, with each region's logical bytes beside what the fabric model
    says they cost on the wire.
    """
    be = resolve_backend(backend)
    layers = [
        Frame.from_profiles(profiles),
        Frame.from_network(network_entries, backend=be),
    ]
    if hlo_entries:
        layers.append(Frame.from_hlo(hlo_entries, backend=be))
    both = Frame.concat(layers)

    def total(values):
        return sum(v for v in values if v)

    def peak(values):
        return max((v for v in values if v is not None), default=0.0)

    out = [
        "| Profile | Region | Traced bytes | Traced sends | HLO wire | "
        "Net msgs | Net hops | Net max-link bytes | Net congestion | "
        "Net wire s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    if len(both):
        agg = both.agg(
            ("profile", "region"),
            {
                "traced_bytes": ("total_bytes_sent", total),
                "traced_sends": ("total_sends", total),
                "hlo_wire": ("hlo_wire_bytes", total),
                "net_msgs": ("net_msgs", total),
                "net_hops": ("net_hops_total", total),
                "net_linkmax": ("net_link_bytes_max", peak),
                "net_congestion": ("net_congestion", peak),
                "net_wire_s": ("net_wire_s", total),
            },
            backend=be,
        )
        for r in agg.sort("profile", "region"):
            out.append(
                f"| {r['profile']} | {r['region']} | {r['traced_bytes']} | "
                f"{r['traced_sends']} | {r['hlo_wire']} | {r['net_msgs']} | "
                f"{r['net_hops']} | {r['net_linkmax']} | "
                f"{r['net_congestion']:.3f} | {r['net_wire_s']:.3e} |"
            )
    return "\n".join(out)


def _degraded_note(profiles) -> str:
    """Honesty footer: name the sweep points that never produced data.

    A degraded point (exhausted supervised retries in the sweep runner)
    has no region rows, so it cannot appear
    in a scaling table — the note makes the gap explicit instead of
    letting an absent point read as a converged curve.
    """
    pts = [
        f"{p.name} ({int(p.meta.get('retries', 0))} attempts)"
        for p in profiles
        if p.meta.get("degraded")
    ]
    if not pts:
        return ""
    return "\n\n> **degraded points (no data, not zero):** " + ", ".join(pts)


def scaling_report(
    profiles: Iterable[CommProfile],
    region: str,
    metric: str = "total_bytes_sent",
    title: str = "",
) -> str:
    """Fig 1/4-style per-region scaling table (metric vs process count)."""
    profiles = list(profiles)
    frame = Frame.from_profiles(profiles).where(region=region)
    frame = frame.select("n_ranks", metric).sort("n_ranks")
    hdr = f"### {title or region}: {metric} vs processes\n"
    return hdr + frame.to_markdown() + _degraded_note(profiles)


def per_level_report(
    profiles: Iterable[CommProfile],
    level_prefix: str = "mg_level_",
    metric: str = "bytes_sent_max",
    backend=None,
) -> str:
    """Fig 2/3-style AMG per-multigrid-level breakdown.

    Regions named ``<prefix><k>`` become columns; rows are process counts.
    Sparse sweeps (levels present at only some scales) pivot to empty cells.
    """
    be = resolve_backend(backend)
    skip = len(level_prefix)
    frame = Frame.from_profiles(profiles)
    frame = frame.filter(lambda r: str(r.get("region", "")).startswith(level_prefix))
    frame = frame.with_column("level", lambda r: int(str(r["region"])[skip:]))
    piv = frame.pivot("n_ranks", "level", metric, backend=be)
    return f"### {metric} per multigrid level (rows = processes)\n" + piv.to_markdown()


def bandwidth_msgrate_report(profiles: Iterable[CommProfile], backend=None) -> str:
    """Fig 5/6-style bandwidth + message-rate comparison.

    Each profile must carry ``meta['seconds']`` (roofline step seconds).
    Degraded points carry no seconds and no rates — they are excluded
    from the table and listed in a footer note instead.
    """
    be = resolve_backend(backend)
    profiles = list(profiles)
    frame = Frame.from_profiles(profiles)
    frame = frame.filter(lambda r: not r.get("meta_degraded"))
    frame = frame.agg(
        ("profile", "n_ranks", "meta_app", "meta_seconds"),
        {
            "total_bytes_sent": ("total_bytes_sent", sum),
            "total_sends": ("total_sends", sum),
        },
        backend=be,
    )
    frame = add_rate_metrics(frame)
    frame = frame.sort("meta_app", "n_ranks")
    md = frame.to_markdown(
        cols=["meta_app", "n_ranks", "bandwidth_Bps", "msg_rate_per_s"]
    )
    return (
        "### Per-process bandwidth (B/s) and message rate (msg/s)\n"
        + md
        + _degraded_note(profiles)
    )


def ascii_scaling_plot(
    xs: list, ys: list, width: int = 60, height: int = 12, title: str = ""
) -> str:
    """Terminal-friendly scaling plot (the paper's figures, ASCII edition).

    Points are sorted by x before plotting, so unsorted sweep output (e.g.
    completion-order rows) draws the same curve — and the axis labels are
    the true x extremes, not whatever happened to be first/last.
    """
    if not xs or not ys or max(ys) <= 0:
        return f"{title}: (no data)"
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    xs = [xs[i] for i in order]
    ys = [ys[i] for i in order]
    lo, hi = min(ys), max(ys)
    span = (hi - lo) or 1.0
    sampled = _resample(xs, ys, width)  # one resample per plot, not per row
    rows = []
    for level in range(height, -1, -1):
        thresh = lo + span * level / height
        line = "".join(
            "*"
            if y >= thresh and (level == 0 or y < lo + span * (level + 1) / height)
            else " "
            for y in sampled
        )
        rows.append(f"{thresh:10.3e} |{line}")
    axis = " " * 11 + "+" + "-" * width
    xlab = " " * 12 + f"{xs[0]:<10}" + " " * max(0, width - 20) + f"{xs[-1]:>10}"
    return "\n".join([f"## {title}"] + rows + [axis, xlab])


def _resample(xs: list, ys: list, width: int) -> list:
    out = []
    for i in range(width):
        # piecewise-constant resample by x order
        j = min(len(ys) - 1, i * len(ys) // width)
        out.append(ys[j])
    return out
