#!/usr/bin/env python3
"""Time the flash-attention forward at ``chip_smoke.py``'s phase-7 cases.

    python3 tools/flash_times.py [--src DIR]

Runs on a machine with a CUDA card.  For each of phase 7's flash cases it
prints one JSON line: the forward kernel's device time a call with the
launches queued and a SHA-256 of its output's bytes (no log-sum-exp
asked for), so two checkouts' outputs can be compared bit for bit.  The
first line is the card's name and power limit.

``--src`` times the wrapper of another checkout (its ``src/repro_torch``,
built into its own ``build/``), so two commits compare on one card in one
call: run parent, change, change, parent.  The cases are always this
checkout's, drawn from phase 7's seed in phase 7's order.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card only")
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "src": str(args.src), "wrapper": fa.__file__}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for label, b, hq, hkv, sq, sk, d, causal, dtype in cs.FLASH_CASES:
        draw = [(b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)]
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype) for s in draw)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.view(torch.uint8).cpu().numpy().tobytes())
        timing = cs.device_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 20)
        print(json.dumps({"case": label, "ms": timing["ms"], "queued": timing["queued"],
                          "sha256": digest.hexdigest()[:16]}), flush=True)
        del q, k, v, out


if __name__ == "__main__":
    main()
