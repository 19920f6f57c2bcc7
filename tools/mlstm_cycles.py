#!/usr/bin/env python3
"""Where a chunk's time goes in the mLSTM kernel's wgmma state pass.

    python3 tools/mlstm_cycles.py          # on a machine with the H100

Builds ``src/repro_torch/csrc/mlstm_scan.cu`` with ``-DMLSTM_CYCLES`` (a
library of its own in ``build/repro_torch/``): at each ``CYCLE_MARK(i)`` of
``state_tc_kernel``'s chunk loop, thread 0 of block (0, 0) adds the
``clock64()`` cycles since the previous mark to a device array.  It then
runs one call at xlstm-1.3b's bf16 prefill shape and one at S 16384 and
prints each phase's cycles per chunk, with the card's name and power
limit.  The instrumented build's times are not the kernel's: they serve to
rank the phases.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: the phase that ends at CYCLE_MARK(i) of the state pass, by i
PHASES = [
    "scalars of the chunk",
    "C~ to bf16 hi + lo, barrier",
    "W prefetch, wait for q",
    "issue q C~",
    "q . n~ (CUDA cores)",
    "wgt v to bf16 hi + lo (CUDA cores)",
    "wait q C~, carry",
    "W v",
    "cluster barrier wait",
    "stage P, barrier, issue copies",
    "wait for k",
    "issue the update",
    "n~ update (CUDA cores)",
    "wait for the inbox",
    "finish h from the inbox",
    "wait for the update, barrier",
]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the card only")
    from repro_torch.kernels import _build
    from repro_torch.kernels import mlstm_scan as ms

    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _build.DEFINES["mlstm_scan"] = ("MLSTM_CYCLES",)  # before the first load
    lib = _build.load("mlstm_scan")  # the wrapper launches this build
    lib.repro_read_cycles.argtypes = [ctypes.c_void_p]
    print(f"card: {smi}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    for b, s, h, d, chunk in ((4, 1024, 4, 1024, 128), (1, 16384, 4, 1024, 128)):
        q, k, v, lf, li, _ = cs.mlstm_inputs(gen, b, s, h, d, torch.bfloat16, None)
        before = (ctypes.c_ulonglong * 32)()
        lib.repro_read_cycles(ctypes.addressof(before))
        ms.mlstm_scan(q, k, v, lf, li, block_q=chunk)
        torch.cuda.synchronize()
        after = (ctypes.c_ulonglong * 32)()
        lib.repro_read_cycles(ctypes.addressof(after))
        n_chunks = -(-s // chunk)
        per = [(after[i] - before[i]) / n_chunks for i in range(len(PHASES))]
        total = sum(per)
        print(f"state pass, block (0, 0), B {b} S {s} H {h} D {d} chunk {chunk}: "
              f"{total:.0f} cycles a chunk")
        for name, cycles in zip(PHASES, per):
            print(f"  {name:34s} {cycles:8.0f}  {cycles / total:6.1%}")


if __name__ == "__main__":
    main()
