#!/usr/bin/env python3
"""Time the SSD and mLSTM scan backwards at ``chip_smoke.py``'s phase-17 cases.

    python3 tools/scan_bwd_times.py [--src DIR] [--runs N] [--check] [--only TEXT]

Runs on a machine with a CUDA card.  For each case of
``chip_smoke.SCAN_BWD_CASES`` it prints one JSON line: the route the call
took, the kernels' device time a call with the launches queued, each CUDA
kernel's device time in one call (``torch.profiler``, summed over its
launches), and a SHA-256 of the gradients' bytes, so two checkouts'
gradients can be compared bit for bit.  ``--check`` also holds the kernels
to the plain backward by ``BWD_TOL``'s rule (``excess`` <= 0 holds) and
times the plain backward.  The first line is the card's name and power
limit.

``--src`` times the wrappers of another checkout (its ``src/repro_torch``,
built into its own ``build/``), so two commits compare on one card in one
call: run parent, change, change, parent.  The cases are always this
checkout's, drawn from phase 17's seed in phase 17's order; ``--only``
keeps the cases whose label holds TEXT (the draws of the others are still
made, so every case's inputs stay the same).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT, help="root of the checkout to time")
    ap.add_argument("--runs", type=int, default=3, help="calls timed a case")
    ap.add_argument("--check", action="store_true", help="hold to the plain backward")
    ap.add_argument("--only", default="", help="keep the cases whose label holds this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card only")
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import mlstm_scan_bwd as mlb
    from repro_torch.kernels import ssd_scan_bwd as ssb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "src": str(args.src), "wrapper": mlb.__file__}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 24)
    for kind, label, b, s, h, p, n, chunk, dtype, opts in cs.SCAN_BWD_CASES:
        name = f"{kind}_scan_bwd"
        mod = ssb if kind == "ssd" else mlb
        args_ = cs.scan_bwd_inputs(gen, kind, b, s, h, p, n, dtype, opts)
        if args.only not in label:
            del args_
            continue
        fn = getattr(mod, name)

        def kernel(fn=fn, a=args_, chunk=chunk):
            return fn(*a, block_q=chunk)

        def flat(r):
            r = [*r[:5], *(r[5] or ())] if kind == "mlstm" else r
            return [t for t in r if t is not None]

        got = flat(kernel())
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in got:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        route_fn = getattr(mod, "kernel_route", None)
        if route_fn is None:
            route = "simt"  # a checkout from before the tensor-core route
        else:
            route = route_fn(dtype) if kind == "ssd" else route_fn(dtype, p)
        row = {"kernel": name, "case": label, "shape": [b, s, h, p, n, chunk],
               "dtype": str(dtype).replace("torch.", ""), "route": route,
               "sha256": digest.hexdigest()[:16]}
        if args.check:
            want = flat(getattr(mod, name + "_plain")(*args_, block_q=chunk))
            row["excess"] = cs._bwd_excess(got, want, cs.BWD_TOL[dtype])
            row["max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                     for g, w in zip(got, want))
            del want
        del got
        timing = cs.device_ms(kernel, args.runs)
        row["ms"], row["queued"] = timing["ms"], timing["queued"]
        row["kernel_ms"] = {
            key.replace("(anonymous namespace)::", "").split("(")[0]: ms
            for key, ms in cs.device_profile(kernel)["kernels"].items()
        }
        if args.check:
            row["plain_ms"] = cs.device_ms(
                lambda: getattr(mod, name + "_plain")(*args_, block_q=chunk), 1)["ms"]
        print(json.dumps(row), flush=True)
        del args_
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
