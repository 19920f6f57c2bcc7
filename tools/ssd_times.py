#!/usr/bin/env python3
"""Time the SSD scan at ``chip_smoke.py``'s phase-9 cases.

    python3 tools/ssd_times.py [--src DIR] [--heads 2,4,8]

Runs on a machine with a CUDA card.  For each of phase 9's cases it prints
one JSON line: whether the kernel agrees with its plain version under
phase 9's tolerances, its device time a call with the launches queued, its
time a call (CUDA events, host launch cost included), the plain version's
device time and each CUDA kernel's device time in one call
(``torch.profiler``).  The first line is the card's name and power limit.

``--src`` times the wrapper of another checkout (its ``src/repro_torch``,
built into its own ``build/``), so two commits compare on one card in one
call: run parent, change, change, parent.  The cases are always this
checkout's, drawn from the same seed.  ``--heads`` repeats every case with
each value of ``HEADS_PER_BLOCK`` (a wrapper that has it).
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
    ap.add_argument("--heads", default="", help="comma-separated HEADS_PER_BLOCK values")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card only")
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as ssd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "src": str(args.src), "wrapper": ssd.__file__}))
    heads = [int(x) for x in args.heads.split(",") if x]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 9)
    for label, b, s, h, p, n, chunk, dtype, kind in cs.SSD_CASES:
        xh, la, bm, cm, h0 = cs.ssd_inputs(gen, b, s, h, p, n, dtype, kind)
        for group in heads or [None]:
            if group is not None:
                ssd.HEADS_PER_BLOCK = group
            got = ssd.ssd_scan(xh, la, bm, cm, h0, block_q=chunk)
            torch.cuda.synchronize()
            want = ssd.ssd_scan_plain(xh, la, bm, cm, h0, block_q=chunk)
            err_y, err_h, holds = cs.ssd_errors(got, want)
            del got, want
            t = cs.ssd_timings(ssd, xh, la, bm, cm, h0, chunk)
            print(json.dumps({
                "case": label, "shape": [b, s, h, p, n], "chunk": chunk,
                "dtype": str(dtype).replace("torch.", ""),
                "heads_per_block": getattr(ssd, "HEADS_PER_BLOCK", None),
                "holds": holds, "max_abs_err": err_y, "h_final_max_abs_err": err_h,
                **t,
            }), flush=True)
        del xh, la, bm, cm, h0
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
