"""§Roofline — read the dry-run cell records and build the full table.

The port of ``benchmarks/roofline.py``.  The records are those
:mod:`repro_torch.launch.dryrun` writes (``build/dryrun/`` unless the
caller names another directory); none is committed, so with no records
the tables are empty and :func:`run` returns no row.  The terms are the
dry run's: one H100 a rank, datasheet rates.  ``benchmarks/roofline.py``'s
baseline-against-optimized table is not ported: nothing writes optimized
records.
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch.figures.paper_data import write
from repro_torch.launch.dryrun import RESULTS_DIR as DRYRUN

ARCH_ORDER = (
    "minicpm3-4b",
    "deepseek-coder-33b",
    "gemma-2b",
    "olmo-1b",
    "zamba2-1.2b",
    "qwen2-vl-7b",
    "seamless-m4t-medium",
    "xlstm-1.3b",
    "granite-moe-3b-a800m",
    "grok-1-314b",
)
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load_records(pattern: str = "*.json", dryrun: str | None = None) -> list:
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun or DRYRUN, pattern))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def improvement_note(rec: dict) -> str:
    """One sentence on what would move the dominant term down on the card."""
    r = rec.get("roofline", {})
    dom = r.get("dominant", "")
    arch = rec["arch"]
    shape = rec["shape"]
    if dom == "memory_s":
        if "xlstm" in arch:
            return (
                "mLSTM matrix memory (1024^2/head) round-trips HBM every "
                "chunk in the plain graph; the card's mlstm_scan kernel "
                "keeps C~ on chip"
            )
        if shape.startswith(("prefill", "train")):
            return (
                "plain attention writes S^2 f32 scores; the card's flash "
                "kernel never writes them"
            )
        return "decode reads the full KV cache; quantized KV would halve it"
    if dom == "collective_s":
        coll = rec.get("collectives", {})
        if coll.get("by_region", {}).get("moe"):
            return (
                "GShard dense dispatch einsum + EP traffic dominates; "
                "sort-based dispatch or wider expert sharding helps"
            )
        kinds = coll.get("by_kind", {})
        if kinds and max(kinds, key=lambda k: kinds[k][1]) == "all-gather":
            return (
                "all-gathers lead: DTensor gathers sharded weights where "
                "GSPMD splits the product; sharded projections cut them"
            )
        return (
            "TP activation all-reduces dominate; lower TP degree / more "
            "DP, or overlap collectives with compute"
        )
    return "compute-bound: raise tensor-core utilization (fused kernels, bf16)"


def table(mesh: str = "16x16", dryrun: str | None = None) -> str:
    rows = [
        "| arch | shape | compute_s | memory_s | collective_s | "
        "dominant | MODEL/HLO flops | roofline frac | mem GiB/dev | "
        "note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    recs = {
        (r["arch"], r["shape"]): r
        for r in load_records(dryrun=dryrun)
        if r.get("mesh") == mesh
    }
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape))
            if r is None:
                continue
            if r["status"] == "skipped":
                rows.append(
                    f"| {arch} | {shape} | — | — | — | skipped | — "
                    f"| — | — | {r['reason'][:60]} |"
                )
                continue
            if r["status"] != "ok":
                rows.append(
                    f"| {arch} | {shape} | — | — | — | ERROR | — | "
                    f"— | — | {r.get('error', '')[:60]} |"
                )
                continue
            rf = r["roofline"]
            mem = r["memory"]["total_bytes"] / 2**30
            rows.append(
                f"| {arch} | {shape} | {rf['compute_s']:.4f} | "
                f"{rf['memory_s']:.4f} | {rf['collective_s']:.4f} | "
                f"{rf['dominant'].replace('_s', '')} | "
                f"{rf['model_to_hlo_flops']:.3f} | "
                f"{rf['roofline_fraction']:.4f} | {mem:.1f} | "
                f"{improvement_note(r)[:80]} |"
            )
    return "\n".join(rows)


def run(dryrun: str | None = None) -> list:
    """Write ``roofline.md`` (the figures' results directory) from the
    records in ``dryrun`` (default ``build/dryrun``); one row a record
    whose status is ``ok``."""
    md = [
        "## Roofline table — single-pod 16x16 (256 H100s), baseline plans\n",
        table("16x16", dryrun),
        "\n## Multi-pod 2x16x16 (512 H100s)\n",
        table("2x16x16", dryrun),
    ]
    write("roofline.md", "\n".join(md))
    rows = []
    for r in load_records(dryrun=dryrun):
        if r.get("status") != "ok":
            continue
        rf = r["roofline"]
        rows.append(
            (
                f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
                rf["step_s_lower_bound"] * 1e6,
                f"dom={rf['dominant']};frac={rf['roofline_fraction']:.4f}",
            )
        )
    return rows
