#!/usr/bin/env python3
"""Time the host trace of ``chip_smoke.py``'s phase-4 and phase-13 points.

    python3 tools/trace_times.py [--src DIR] [--repeat N] [--serial]

For each of phase 4's kripke points and phase 13's amg, laghos and beatnik
points it prints one JSON line: the seconds from the call of the app's
``profile`` to the finished trace (phase 4's and 13's ``trace_s``; with
``--repeat``, the least and the median of N traces) and the instrumented
collective calls the trace made.  Then the microseconds a call of
``psum`` and of ``ppermute`` takes on a meta tensor with no recorder
(least and median of 5 rounds of 2000 calls).  ``--serial`` adds
kripke-weak-dane's points, each alone on the serial executor, uncached
(phase 14's serial pass).  The first line is the card's name and power
limit; the last sums the seconds.  The trace runs on the host on meta
tensors; a point's reduction (not timed) runs on the default backend, the
card.

``--src`` times another checkout's ``src/repro_torch``; the points are
always this checkout's.  To compare two commits, run each in its own
process within one call, in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

#: the instrumented wrappers whose calls are counted
WRAPPERS = ("ppermute", "psum", "pmean", "pmax", "pmin", "all_gather",
            "psum_scatter", "all_to_all", "pbroadcast")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT, help="root of the checkout to time")
    ap.add_argument("--repeat", type=int, default=1, help="traces of each point")
    ap.add_argument("--serial", action="store_true",
                    help="also time kripke-weak-dane's points on the serial executor")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card's machine only")
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.apps import amg, beatnik, kripke, laghos
    from repro_torch.apps.stencil import Decomp3D
    from repro_torch.core import collectives, compat
    from repro_torch.core.profiler import trace_observer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "src": str(args.src),
                      "collectives": collectives.__file__}), flush=True)
    calls = {"n": 0}

    def counted(fn):
        def wrapper(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return wrapper

    for name in WRAPPERS:
        setattr(collectives, name, counted(getattr(collectives, name)))
    # torch's meta kernels are imported at first use, once a process
    torch.empty(2, device="meta") / 2.0

    def trace(module, cfg) -> dict:
        times = []
        for _ in range(args.repeat):
            calls["n"] = 0
            t0 = time.perf_counter()

            def observe(rec, **_kw):
                times.append(time.perf_counter() - t0)
                return None  # the batch reduction follows, untimed

            with trace_observer(observe):
                module.profile(cfg, name="trace-times")
        return {"trace_s": min(times), "median_s": statistics.median(times),
                "calls": calls["n"]}

    points = [("kripke", kripke, kripke.KripkeConfig(decomp=Decomp3D(*shape), **params))
              for shape, params in cs.KRIPKE_POINTS]
    modules = {"amg": amg, "laghos": laghos, "beatnik": beatnik}
    points += [(app, modules[app], cs._app_config(app, shape))
               for app, shapes in cs.APP_POINTS.items() for shape in shapes]
    totals: dict = {}
    for app, module, cfg in points:
        row = trace(module, cfg)
        totals[app] = totals.get(app, 0.0) + row["trace_s"]
        print(json.dumps({"app": app, "decomp": list(cfg.decomp.shape),
                          "n_ranks": cfg.decomp.n_ranks, **row}), flush=True)
    mesh = compat.make_mesh((8,), ("x",))
    x = torch.empty(16, 16, device="meta")
    ops = {"psum": lambda: collectives.psum(x, "x"),
           "ppermute": lambda: collectives.ppermute(x, "x", [(i, (i + 1) % 8)
                                                             for i in range(8)])}
    with compat.axis_env(mesh):
        for name, op in ops.items():
            rounds = []
            for _ in range(5):
                t = time.perf_counter()
                for _ in range(2000):
                    op()
                rounds.append((time.perf_counter() - t) / 2000 * 1e6)
            print(json.dumps({"call": name, "us": min(rounds),
                              "median_us": statistics.median(rounds)}), flush=True)
    if args.serial:
        from repro_torch.benchpark.runner import run_experiment
        from repro_torch.benchpark.spec import PAPER_EXPERIMENTS

        spec = PAPER_EXPERIMENTS["kripke-weak-dane"]
        serial = []
        for pt in spec.points:
            t = time.perf_counter()
            run_experiment(replace(spec, points=(pt,)), verbose=False, executor="serial")
            serial.append(time.perf_counter() - t)
        totals["serial kripke-weak-dane"] = sum(serial)
        print(json.dumps({"serial": "kripke-weak-dane",
                          "n_ranks": [pt.n_ranks for pt in spec.points],
                          "point_s": serial}), flush=True)
    print(json.dumps({"src": str(args.src), "total_s": totals}), flush=True)


if __name__ == "__main__":
    main()
