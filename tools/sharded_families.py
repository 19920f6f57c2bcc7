#!/usr/bin/env python3
"""One sharded train step of every architecture on 8 gloo CPU ranks.

    python3 tools/sharded_families.py [--archs olmo-1b,zamba2-1.2b]

Each reduced architecture (f32) takes one train step on the launcher's
(data 2, model 4) mesh and plan (batch on ``data``, the FFN and vocab dims
on ``model``; ``tests/sharded_ranks.family_steps``), and the same step on
one process from the same seeded parameters and batch.  One JSON line an
arch: the sharded and single-device loss and gradient norm and their
relative distances, or, where DTensor cannot run the arch, the error and
the port's frames it came from.  Runs on the CPU; ~70 s for the ten.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import sharded_ranks  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.ranks import run_ranks  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import steps  # noqa: E402


def single_device(arch: str) -> tuple:
    cfg = launch.run_config(launch.RunConfig(arch=arch))
    model = build_model(cfg, device="cpu").float().requires_grad_(True)
    loss, _ = steps.make_loss_fn(cfg)(model, sharded_ranks._family_batch(cfg))
    loss.backward()
    gn = float(sum((p.grad.double() ** 2).sum() for p in model.parameters()) ** 0.5)
    return float(loss.detach()), gn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=",".join(registry.ARCH_IDS))
    archs = ap.parse_args().archs.split(",")
    got = run_ranks(sharded_ranks.family_steps, 8, backend="gloo", args=(archs,),
                    timeout_s=900)
    for arch in archs:
        row = {"arch": arch}
        if got[arch][0] == "failed":
            row.update(failed=got[arch][1], frames=got[arch][2])
        else:
            (loss, gn), (want_loss, want_gn) = got[arch], single_device(arch)
            row.update(loss=loss, single_loss=want_loss, loss_rel=abs(loss / want_loss - 1),
                       grad_norm=gn, single_grad_norm=want_gn,
                       grad_norm_rel=abs(gn / want_gn - 1))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
