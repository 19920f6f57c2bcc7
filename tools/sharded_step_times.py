#!/usr/bin/env python3
"""Time a training step on one process and on a (1, 1) mesh, on the card.

    python3 tools/sharded_step_times.py [--src DIR] [--steps N]

Runs on a machine with a CUDA card.  olmo-1b at its published size
(2 x 4096 tokens, remat "full", ``chip_smoke.TRAIN_ARGV``) trains ``N``
steps through ``launch.train.main`` twice in this process: first on one
process, then on a (1, 1) ``DeviceMesh`` over NCCL at world size 1, the
launcher's mesh path (every parameter and batch a DTensor, the kernels
through ``local_map``), as ``chip_smoke.py``'s phase 18 runs it.  It
prints the card's name and power limit, then one JSON line: each path's
losses, step times and warm step (the median of steps 2 to ``N``), and
the mesh path's warm step over the single process's.

``--src`` runs another checkout's package (its ``src/repro_torch``, its
kernels built into its own ``build/``), so two trees compare on one card
in one call: run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def warm_step(times: list) -> float:
    return statistics.median(dt for _, dt in times[1:])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT, help="root of the checkout to time")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card only")
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.launch import train as launch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "src": str(args.src), "launcher": launch.__file__}))
    argv = list(cs.TRAIN_ARGV)
    argv[argv.index("--steps") + 1] = str(args.steps)
    tmp = Path(tempfile.mkdtemp(prefix="sharded-step-times-"))
    try:
        row = {"src": str(args.src), "steps": args.steps}
        losses, mon = launch.main(argv + ["--ckpt-dir", str(tmp / "one")])
        row["one"] = {"losses": losses, "step_s": [dt for _, dt in mon.times],
                      "warm_step_s": warm_step(mon.times)}
        torch.cuda.empty_cache()
        dist.init_process_group("nccl", init_method=f"file://{tmp / 'store'}",
                                rank=0, world_size=1)
        try:
            losses, mon = launch.main(argv + ["--ckpt-dir", str(tmp / "mesh"),
                                              "--data-mesh", "1", "1"])
        finally:
            dist.destroy_process_group()
        row["mesh"] = {"losses": losses, "step_s": [dt for _, dt in mon.times],
                       "warm_step_s": warm_step(mon.times)}
        row["mesh_over_one"] = row["mesh"]["warm_step_s"] / row["one"]["warm_step_s"]
        print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
