#!/usr/bin/env python3
"""Time the segmented reduce at ``chip_smoke.py``'s phase-3 cases.

    python3 tools/segment_reduce_times.py [--src DIR] [--piece-elems 4096,8192]

Runs on a machine with a CUDA card.  For each of phase 3's seven cases, its
piece edges and the HLO corpus's reductions it prints one JSON line: the
kernel's time a call (CUDA events, host launch cost included) and a call's
device time with the launches queued, the same two for one
``scatter_reduce_`` call, and whether the two results agree.  The first
line is the card's name and power limit.

``--src`` times the wrapper of another checkout (its ``src/repro_torch``,
built into its own ``build/``), so two commits compare on one card in one
call; the cases are always this checkout's.  ``--piece-elems`` repeats every
case with each value of ``PIECE_ELEMS`` (a wrapper that has one).
``--profile`` adds each launch's device time in one call (``torch.profiler``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT, help="root of the checkout to time")
    ap.add_argument("--piece-elems", default="", help="comma-separated PIECE_ELEMS values")
    ap.add_argument("--profile", action="store_true", help="device time of each launch")
    ap.add_argument("--edge-rows", type=int, default=1 << 15,
                    help="R of the piece-edge spans (this checkout's rows_per_piece(1))")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card only")
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import segment_reduce as seg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "src": str(args.src), "wrapper": seg.__file__}))
    sizes = [int(x) for x in args.piece_elems.split(",") if x] or [None]
    dev = torch.device("cuda")
    cases = cs.reduce_cases(args.edge_rows)
    cases += [(f"hlo corpus {i}", *call) for i, call in enumerate(cs.hlo_reductions(seg))]
    for label, host_vals, starts_np, ends_np, op in cases:
        vals, starts, ends = (
            t.to(dev) if torch.is_tensor(t) else torch.from_numpy(t).to(dev)
            for t in (host_vals, starts_np, ends_np)
        )
        for size in sizes:
            if size is not None:
                seg.PIECE_ELEMS = size
            t = cs.reduce_timings(seg, vals, starts, ends, op)
            del t["library_out"]
            if args.profile:
                prof = cs.device_profile(lambda: seg.segment_reduce(vals, starts, ends, op))
                t["profile_ms"] = {name[:60]: ms for name, ms in prof["kernels"].items()}
            print(json.dumps({
                "case": label, "op": op, "dtype": str(vals.dtype).replace("torch.", ""),
                "shape": list(vals.shape), "spans": starts.shape[0],
                "piece_elems": getattr(seg, "PIECE_ELEMS", None), **t,
            }), flush=True)


if __name__ == "__main__":
    main()
