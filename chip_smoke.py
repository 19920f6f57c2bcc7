#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check every phase.

    python3 chip_smoke.py [--parent DIR]

Phases (each one fails the run with a non-zero exit on any mismatch):

1. card — the device's name, and ``nvidia-smi``'s name and power limit;
2. build — compile the CUDA kernels from ``src/repro_torch/csrc`` (the
   flash backward among them); log
   every kernel's ``ptxas`` registers and spills, and fail unless the
   flash, flash backward, SSD, mLSTM and both scan backward libraries'
   SASS holds ``HGMMA`` (their bf16 kernels run on the tensor cores);
3. kernel — the segmented-reduce kernel against its plain PyTorch version
   on the card at 2^24 int64 rows (about 4096 spans, one holding half the
   rows), a (2^20, 8) int64 grid and a float64 sum, then spans of exactly
   one piece and of one piece and a row, empty spans among long ones, and
   the HLO corpus's own reductions (the arguments phase 5's calls pass);
   each case's rows a piece, cuts and pieces, its time a call (CUDA
   events) and its device time with the launches queued, the same two for
   ``scatter_reduce_``, the bytes bound and the plain version's time;
4. kripke — ``repro_torch.apps.kripke.profile`` at the paper's Dane points
   and the weak-scale points up to 131072 ranks, each trace reduced on the
   card and with the port's ``NumpyBackend`` (byte-equal ``to_json()``;
   then three warm reductions on each, alternated, for a like-for-like
   median), then ``Frame.from_profiles`` over them;
5. hlo — ``Frame.from_hlo`` over the golden HLO corpus on the card against
   ``NumpyBackend``; the kernel's launch count must rise on phases 4-5;
6. solve — kripke's ``reference_sweep`` at the paper's per-rank size on the
   card against the same run on the CPU;
7. attention — the flash and decode kernels against their plain versions on
   the card at olmo-1b's, deepseek-coder-33b's (GQA), gemma-2b's (MQA,
   head dim 256) and zamba2-1.2b's shared-block shapes, a decode-style
   Sq < Sk case, an odd f32 case, ragged 1000-token tiles and head dim 64,
   and phase 16's shapes: GQA groups of 3 (granite-moe, D 64) and 7
   (qwen2-vl with its 256-token vision prefix), bidirectional bf16 (the
   encoder), cross-attention with Sq > Sk (16 keys, under one TMA tile)
   and Sq < Sk, the reduced grok-1's head dim 32; decode also at batch 1
   over a 16000-key cache, at kv_len 1, where the last split of the keys
   holds one key, at granite's and qwen2-vl's GQA, and over 16 and 1024
   cross-attention keys (each decode row records its split plan); each
   case's median time, its bound, the plain version's time and
   ``F.scaled_dot_product_attention``'s; every flash case also asks for
   the log-sum-exp the training path stores: the output must be the same
   bits as without it, and the lse within 1e-4 of ``torch.logsumexp`` of
   the plain scores;
8. serve — ``python -m repro_torch.serve_lm --arch olmo-1b --full`` at its
   published width and depth (16 layers, d 2048): 4 prompts of 1024 tokens,
   32 greedy tokens; exactly 16 flash and 496 decode launches; prefill and
   the first 4 decode steps against the same model under ``ops.plain()``;
   decode logits against the teacher-forced ``train_logits``;
9. ssd — the SSD scan kernel against its plain version at zamba2-1.2b's
   prefill shape (B 4, S 1024, 64 heads, P = N = 64) in bf16 and f32, a
   ragged S 1000, S 1, a long S 16384 in bf16 and f32, the model's layout
   (Bm, Cm strided slices of one tensor, an initial state), the reduced
   P 32, N 16 with chunks of 16 in both dtypes, and rows one element off
   16 bytes (copied by the wrapper); each case's route (``wgmma`` or
   ``simt``), device time, per-call time, each pass's device time
   (``torch.profiler``), the bytes the passes move beside the bound, the
   plain version's time and, with ``--parent DIR``, the time of that
   checkout's kernel on this card (``tools/ssd_times.py``); no single
   PyTorch call computes this function, so there is no library time;
10. zamba2 — ``python -m repro_torch.serve_lm --arch zamba2-1.2b --full``
   at its published width and depth (38 Mamba-2 layers, d 2048, the shared
   block 6 times): 4 prompts of 1024 tokens, 32 greedy tokens; exactly 38
   SSD, 6 flash and 186 decode launches; every SSD and attention call held
   to its plain version in the model; the prefill's card time split by
   ``torch.profiler`` into the SSD kernel's three passes, flash attention,
   the projections and the rest; the reduced zamba2 end to end in f32
   against the same model under ``ops.plain()`` and against teacher
   forcing, and in bf16 on the 2-layer config of ``tests/test_models.py``;
11. mlstm — the mLSTM scan kernel against its plain version, h and the
   final (C, n, m), at xlstm-1.3b's prefill shape (B 4, S 1024, 4 heads,
   head dim 1024) in bf16 and f32, a ragged S 1000, S 1, a long S 16384,
   the reduced head dim 64 with chunks of 16, a given initial state and
   steep gates; each case's route (``wgmma`` or ``mma.sync``), device
   time, per-call time, bound and the plain version's time (no single
   PyTorch call computes this function, so there is no library time);
12. xlstm — ``python -m repro_torch.serve_lm --arch xlstm-1.3b --full`` at
   its published width and depth (48 mLSTM layers, d 2048, 4 heads of
   1024): 4 prompts of 1024 tokens, 32 greedy tokens; exactly 48 mLSTM
   launches and no other kernel; every mLSTM call held to its plain version
   in the model; the prefill's card time split by ``torch.profiler`` into
   the mLSTM state, W and gate passes, the projections and the rest; the
   full-width model in f32, and the reduced xlstm in bf16 and f32, end to
   end against the same model under ``ops.plain()`` and against teacher
   forcing;
13. apps — amg, laghos and beatnik (``repro_torch.apps``) at the paper's
   per-rank sizes and rank counts: amg-weak-dane (64–512 ranks, 32×32×16 a
   rank), laghos-strong (16–128 ranks, 512×512, 2 steps), amg-weak-scale
   and laghos-strong-scale up to 8192 ranks, beatnik-weak-scale (2048–8192
   ranks, 32×32, 4 steps); each trace reduced on the card and with
   ``NumpyBackend`` (byte-equal ``to_json()``; host trace seconds, then
   warm reductions alternated as in phase 4); ``Frame.from_network`` over
   every trace with the ring, fat-tree and dragonfly models (CSV byte-equal
   to ``NumpyBackend``); ``CommPatternProfiler.incremental`` on one point of
   each app in several updates (byte-equal to the batch profile; the
   shards pickled, reloaded and merged in another order give the same);
   the traced + hlo + network frame with the HLO corpus of phase 5, and
   ``network_vs_traced`` / ``hlo_vs_traced`` / ``table4_metrics`` /
   ``per_level_report`` equal on the card and on NumPy (the segmented-
   reduce kernel must be launched in this phase); the single-domain
   oracles (amg at the 512-rank grid 256×256×128, laghos at 512×512 for 2
   steps, beatnik at the 2048-rank grid) on the card against the CPU;
14. sweeps — the Benchpark sweeps and the paper's figures
   (``repro_torch.figures.run``) on the card: (a) the smoke in its own
   process (``--smoke --backend torch``: kripke-weak-dane, 64–512 ranks,
   on a process pool filling a fresh cache, a serial pass served wholly
   from it, an uncached NumPy pass, all byte-equal; the four scale
   experiments up to 8192 ranks; fig 8's artifacts; its peak RSS); a pool
   worker's cold start (start, imports, CUDA context) against its first
   point, and kripke-weak-dane's points one by one on the serial executor
   against the whole sweep on a fresh pool; (b) the live smoke (three
   paper experiments through a process pool into a ``SweepAggregator``,
   every merged profile byte-equal to batch); (c) the chaos smoke (a hard
   worker crash, a torn shard, a corrupt cache entry: converged or
   flagged); (d) Table IV, figs 1–6 and 8 and the roofline table (empty:
   no dry-run records) on the card and again with ``REPRO_BACKEND=numpy``,
   every file byte-equal.  No fault-free pass may return a degraded point
   or log a retry (fig 7 is among the figures);
15. distributed — the four apps' distributed drivers run for real over
   ``torch.distributed`` (``repro_torch.core.ranks.run_ranks``): (a) NCCL
   at world size 1 on the card, each app at one rank of its paper per-rank
   size (kripke 16×32×32 zones and 2 octants, amg 32×32×16, laghos
   512×512 for 2 steps, beatnik 32×32 for 4 steps), held to its oracle on
   the card at the CPU tests' tolerances, the profile recorded during the
   run byte-equal to the meta trace's, the driver's seconds (a first, cold
   call and a second, warm one) beside the oracle's; with one rank every group has one member and every perm is
   empty, so this checks placement, group set-up and the collectives'
   launches, not traffic; (b) gloo on 8 ranks with CPU tensors on the
   card's host: kripke and laghos at the CPU tests' 8-rank configs, held
   the same way, with the spawn and join seconds and each rank's peak RSS;
   (c) the compiled layer (``scan_graph_collectives``) of fig 7's kripke-8
   (3 ops, 3072 wire bytes) and of the four apps at 8 ranks:
   ``Frame.from_hlo`` on the card byte-equal to ``NumpyBackend`` with the
   segmented-reduce kernel launched, and fig 7's markdown and CSV equal on
   the card and on NumPy;
16. families — ``python -m repro_torch.serve_lm`` for each family the
   earlier phases do not serve, 4 prompts of 1024 tokens and 32 greedy
   tokens, one model at a time: seamless-m4t-medium (the encoder-decoder,
   1024 source frames; served cold, then warm), minicpm3-4b (MLA),
   granite-moe-3b-a800m (MoE) and qwen2-vl-7b (M-RoPE, 256 vision tokens
   on a 16 x 16 grid) at their published width and depth, grok-1-314b
   (MoE) reduced; exactly the flash and decode launches each makes (MLA
   none); every attention call of a prefill and 4 decode steps held to its
   plain version; prefill s, decode ms a step and tok/s, peak CUDA MB, the
   card's work in a decode step and a prefill (``torch.profiler``) and so
   the idle shares; each reduced config (MoE with ample capacity) against
   the same model under ``ops.plain()`` and against teacher forcing, by the
   rule, held in f32 and in bf16 where the rule is well posed (the plain
   model stays inside it when every attention output moves by 1e-6,
   ``rule_probe``; else bf16 is reported);
17. train — (a) the flash-attention backward kernel
   (``csrc/flash_attention_bwd.cu``) against autograd of the plain version,
   dq, dk and dv, at olmo-1b's train shape (B 2, S 4096, bf16),
   deepseek-coder-33b's GQA, gemma-2b's MQA at head dim 256, the encoder's
   bidirectional shape, cross-attention with Sq > Sk (16 keys) and Sq < Sk,
   ragged 1000-token tiles, head dims 32 and 64 and two f32 cases (bf16 rtol
   2e-2 and atol 2e-2 x each tensor's max|plain|, f32 1e-4), two calls
   bit-equal, each case's device time (launches queued; and the median of
   10 calls timed alone), each of its CUDA kernels' device time a launch
   (``torch.profiler``: the dK/dV, dQ, Delta and group-sum passes), bound
   (5 products of Sq x Sk x D a head, halved when causal, against the
   bytes of q, k, v, o, dO and the three gradients), the plain version's
   time and ``sdpa``'s backward; then the SSD and mLSTM scans' backward
   kernels (``csrc/ssd_scan_bwd.cu``, ``csrc/mlstm_scan_bwd.cu``) against
   their plain backwards by the same rule, two calls bit-equal: SSD at
   zamba2-1.2b's train shape (B 2, S 4096, H 64, P = N = 64, bf16), in f32,
   ragged S 1000, with h0 and dh_final, with the model's strided Bm / Cm and
   at the reduced shape; mLSTM at xlstm-1.3b's train shape (B 2, S 4096,
   H 4, D 1024, bf16) and at B 1, D 1024 in f32, D 64,
   ragged S 1000, with an entering
   state and the final state's gradients, and with steep gates; then the
   SSD at 4 heads, the split a mesh gives a rank (zamba2-1.2b's 64 over 16
   ranks); each case's
   route (``wgmma`` for bf16, and for the mLSTM at head dims that are
   multiples of 64; ``simt`` otherwise), device time, its CUDA kernels'
   time in one call (``SCAN_BWD_PASSES``), bound and the plain backward's
   time;
   (b) ``python -m repro_torch.launch.train --arch olmo-1b --full-size``,
   2 x 4096 tokens a step, 5 steps (2 of warm-up), under the config's
   remat "full" (each layer recomputed in the backward): exactly 32 flash
   (16 forward, 16 recomputed) and 16 backward launches a step and no
   other model kernel, seconds a step,
   tokens/s, the share of 989 TFLOP/s by ``configs/base.py``'s
   ``model_flops``, peak CUDA MB; then one step of the same model with
   every backward call held to the plain version and no input copied into
   a layout TMA takes, one profiled by ``torch.profiler`` (flash forward,
   the flash backward's two product kernels, its Delta and group-sum
   passes, GEMMs, the rest; the backward's share of the kernels; the idle
   share) and one split on the device clock into forward, backward and
   optimizer; (c) one reduced f32 step (its loss, gradient norm and
   every gradient leaf) of olmo, gemma, deepseek, minicpm3, granite, grok,
   qwen2-vl, seamless, zamba2 and xlstm against the same step under
   ``ops.plain()``, with exactly the model kernels' launches of a step;
   (d) ``python -m repro_torch.launch.train --full-size`` of zamba2-1.2b
   and xlstm-1.3b (2 x 4096 tokens a step, remat "full"; without it
   xlstm-1.3b does not fit 80 GB at batch 2), 4 steps each: exactly two
   scan forward launches (the forward and its recompute) and one scan
   backward launch a layer a step (38 and 48) and the shared block's 12
   flash and 6 flash-backward launches (zamba2), finite
   losses, seconds a step, tokens/s, the share of 989 TFLOP/s, peak CUDA
   MB; then one more step of each profiled by ``torch.profiler`` and split
   by kernel group (scan backward, scan forward, flash, GEMMs, the rest:
   elementwise passes and the optimizer; and idle against the warm step),
   so the scan backward's share of a step is measured; then the remat
   settings side by side: a warm step and a timed one of olmo-1b and
   zamba2-1.2b (2 x 4096) without remat, and of xlstm-1.3b (1 x 4096) with
   and without, their peak CUDA MB and seconds beside the launcher's
   "full" runs (``REMAT_PROBES``); and the recompute held bit for bit: at
   published width and cut depth (``RECOMPUTE_MODELS``, 1 x 4096, bf16)
   every forward kernel call's recompute gives its first call's bits, and
   the loss and every gradient under "full" equal those under "none";
   (e) ``python -m repro_torch.examples.train_lm`` (the ~100M olmo) for
   300 steps, its loss falling; (f) a save, then a resume, the resumed
   losses within 1e-3 of the uninterrupted run's;
18. sharded — ``python -m repro_torch.launch.train``'s mesh path on the
   card: the published olmo-1b (2 x 4096, remat "full") for 4 steps on a
   (1, 1) ``DeviceMesh`` over NCCL at world size 1 (``run_ranks``), every
   parameter, AdamW moment and batch a DTensor and every flash call
   entering through ``local_map`` (counted: as many as the flash
   launches); exactly phase 17's launches a step; its first loss within
   2e-2 of phase 17's at the same seed; its warm step (steps 2-3) and peak
   CUDA MB beside phase 17's; then, after the last step, one more step
   profiled by ``torch.profiler`` beside phase 17's profiled step: kernel
   ms, launches, the idle share, kernel ms by group and the kernels that
   grew most, so the gap in the warm step splits into the card's extra
   work and the host's (the card idle).  One rank moves no bytes: the
   traffic is tested on gloo CPU ranks;
19. dryrun — ``repro_torch.launch.dryrun`` on the card's host, which
   captures and runs nothing on the card: (a) ``lower_cell("olmo-1b",
   "train_4k")`` on a fake 16 x 16 mesh (torch's fake process group, 256
   ranks): status ``ok``, collectives in ``embed``, ``grad``, ``mlp`` and
   ``optimizer``, no process group left up; its capture seconds, roofline
   terms, memory a device, collectives by region and the mesh's device
   type; (b) one device at phase 17's cell (2 x 4096, remat "full"): its
   ``model_flops`` equal to phase 17's, its ``compute_s`` at most phase
   17's measured warm step, and its predicted memory beside the measured
   peak CUDA MB; (c) deepseek-coder-33b train_4k and xlstm-1.3b
   decode_32k, whose heads do not divide the model axis, and zamba2-1.2b
   and xlstm-1.3b train_4k cut to 32 x 1024 (the SSD's heads and the
   mLSTM's chunk rows split over the model axis), gemma-2b and
   deepseek-coder-33b decode_32k cut to 128 x 4096, at 2 layers on the
   fake 16 x 16 mesh with the published embed rule, each ``ok``, FLOPs a
   device logged, deepseek's decode held within 2 % of ``repro``'s FLOPs
   and gemma's ``embed`` region to at most twice ``repro``'s wire bytes
   (``REPRO_HELD``: the embedding looked up in each rank's vocab rows,
   decode's q/k/v over each model rank's slice of d_model); on
   the card, (d) the flash kernel on a rank's query rows at an offset of
   the keys (``ops.flash_attention_rows``: K/V cut to the rows' end),
   forward and backward, against the plain version masked over the whole
   K, and (e) the decode kernel's log-sum-exp over a slice of a cache, a
   slice past ``kv_len`` launching nothing, and two halves merged by their
   log-sum-exp, against the plain version.

It prints a ``{"kernels": [...]}`` line, then, as the last line,
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
SEED = 20260808
#: warm reductions per backend and kripke point, for a like-for-like median
WARM_REDUCTIONS = 3
#: the CUDA sources the main paths run (src/repro_torch/csrc/<name>.cu)
KERNEL_SOURCES = (
    "segment_reduce", "flash_attention", "flash_attention_bwd", "decode_attention",
    "ssd_scan", "ssd_scan_bwd", "mlstm_scan", "mlstm_scan_bwd",
)
#: the TPU kernel each model kernel replaces
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:81",
    # no TPU kernel: repro differentiates its plain attention through XLA
    "flash_attention_bwd": "none (the gradient of src/repro/kernels/flash_attention.py:81)",
    "decode_attention": "src/repro/kernels/decode_attention.py:66",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:70",
    "mlstm_scan": "src/repro/kernels/mlstm_scan.py:79",
    # no TPU kernel: repro's models differentiate the plain chunked scans
    # through XLA
    "ssd_scan_bwd": "none (the gradient of src/repro/kernels/ssd_scan.py:70)",
    "mlstm_scan_bwd": "none (the gradient of src/repro/kernels/mlstm_scan.py:79)",
}

#: kripke's paper (Dane) points and weak-scale points: (decomp, params).
_PAPER = dict(nx=16, ny=32, nz=32, n_octants=2, fuse_messages=False)
_SCALE = dict(nx=16, ny=32, nz=32, n_octants=1, fuse_messages=True)
KRIPKE_POINTS = [
    ((4, 4, 4), _PAPER),
    ((8, 4, 4), _PAPER),
    ((8, 8, 4), _PAPER),
    ((8, 8, 8), _PAPER),
    ((16, 16, 8), _SCALE),
    ((32, 16, 8), _SCALE),
    ((32, 32, 8), _SCALE),
    ((64, 64, 8), _SCALE),
    ((128, 64, 8), _SCALE),
    ((128, 128, 8), _SCALE),
]


def ptxas_summary(text: str) -> list:
    """Each kernel's registers and spill bytes from ``nvcc -Xptxas=-v``."""
    out, name = [], None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)  # mangled: the template arguments stay in it
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            out.append({"kernel": name, "spill_stores": int(spill.group(1)),
                        "spill_loads": int(spill.group(2))})
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out and out[-1]["kernel"] == name and "registers" not in out[-1]:
            out[-1]["registers"] = int(regs.group(1))
    return out


def sass_count(library: Path, opcode: str) -> int:
    """How often ``opcode`` occurs in a built library's SASS (cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "--dump-sass", str(library)], capture_output=True, text=True,
        check=True,
    ).stdout
    return len(re.findall(rf"\b{opcode}\b", sass))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def memory_rate(card: str) -> tuple:
    """Datasheet memory bandwidth (bytes/s) for the card's name."""
    if "PCIe" in card:
        return 2.0e12, "2.0 TB/s (H100 PCIe datasheet)"
    return 3.35e12, "3.35 TB/s (H100 SXM datasheet)"


def op_rate(card: str, dtype: torch.dtype) -> tuple:
    """Datasheet dense peak (operations/s) for the card and input dtype.

    bf16 inputs: the tensor cores' bf16 rate; f32 inputs: the f32 rate
    outside the tensor cores (the f32 the kernels compute in).
    """
    pcie = "PCIe" in card
    if dtype == torch.bfloat16:
        if pcie:
            return 756e12, "756 TFLOP/s bf16 dense (H100 PCIe datasheet)"
        return 989e12, "989 TFLOP/s bf16 dense (H100 SXM datasheet)"
    if pcie:
        return 51e12, "51 TFLOP/s f32 (H100 PCIe datasheet)"
    return 67e12, "67 TFLOP/s f32 (H100 SXM datasheet)"


# ---------------------------------------------------------------------------
# Phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def cuda_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` (ms)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: cycles of the sleep kernel that holds the stream while launches queue
SLEEP_CYCLES = 400_000_000


def device_ms(fn, runs: int) -> dict:
    """Device time per call of ``fn()`` (ms), the launches queued up front.

    A sleep kernel holds the stream while the host enqueues ``runs`` calls,
    so the events time the device's work without the host's launch gaps
    (what :func:`cuda_ms` sees for a call shorter than its Python overhead).
    ``queued`` says whether the host finished enqueueing before the sleep
    ended; if not, host gaps are in the time.
    """
    fn()
    sleep_start = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    sleep_start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t = time.perf_counter()
    for _ in range(runs):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    end.synchronize()
    return {
        "ms": start.elapsed_time(end) / runs,
        "queued": host_ms < sleep_start.elapsed_time(start),
    }


#: profiles taken before one that recorded no device kernel is reported as
#: such: the card's activity records of a whole profile sometimes do not
#: arrive
PROFILE_ATTEMPTS = 3


def device_profile(fn, runs: int = 1) -> dict:
    """``runs`` calls of ``fn()`` under ``torch.profiler``, after one call it
    runs but does not record; taken again, up to ``PROFILE_ATTEMPTS`` times,
    while it records no device kernel.  Per call: the device time of the
    kernels (the regions' annotations left out), the kernel launches the
    host made, the five kernels that took longest and each kernel's time
    (ms); each kernel's mean time a launch over the launches it recorded
    (ms; a record lost from one call does not shrink it); and the attempts
    it took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        saved = []  # the recorded cycle's events (repeat=1: no cycle after it)
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=runs, repeat=1),
            on_trace_ready=lambda p: saved.append(p.key_averages()),
        ) as prof:
            for _ in range(runs + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if not saved:
            fail("torch.profiler recorded no cycle")
        kernels, per_launch, launches = {}, {}, 0
        for e in saved[-1]:
            if "LaunchKernel" in e.key:
                launches += e.count
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / runs
                per_launch[e.key] = us / 1e3 / e.count
        if kernels:
            break
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {
        "device_ms": sum(kernels.values()),
        "launches": launches // runs,
        "top": [[name[:80], ms] for name, ms in top],
        "kernels": kernels,
        "per_launch": per_launch,
        "attempts": attempt,
    }


def split_kernels(kernels: dict, groups: dict) -> dict:
    """Device ms of a profile's kernels by group: the first group whose
    name pattern (a regex) matches a kernel's name takes it; "rest" the
    others."""
    out = dict.fromkeys([*groups, "rest"], 0.0)
    for name, ms in kernels.items():
        group = next((g for g, pat in groups.items() if re.search(pat, name)), "rest")
        out[group] += ms
    return out


def spans_with_giant(rng, n: int, n_spans: int) -> tuple:
    """~n_spans contiguous spans tiling [0, n); one holds half the rows."""
    half = n // 2
    cuts = np.unique(rng.integers(1, n - half, n_spans - 2))
    small_starts = np.concatenate(([0], cuts))
    small_ends = np.append(cuts, n - half)
    k = len(small_starts) // 2
    a = int(small_starts[k])
    starts = np.concatenate((small_starts[:k], [a], small_starts[k:] + half))
    ends = np.concatenate((small_ends[:k], [a + half], small_ends[k:] + half))
    return starts.astype(np.int64), ends.astype(np.int64)


def random_spans(rng, n: int, n_spans: int) -> tuple:
    cuts = np.unique(rng.integers(1, n, n_spans - 1))
    starts = np.concatenate(([0], cuts)).astype(np.int64)
    return starts, np.append(cuts, n).astype(np.int64)


def piece_edge_spans(rows: int) -> tuple:
    """Spans of exactly ``rows`` rows, of ``rows`` + 1, and empty spans among
    long ones (the two-pass plan's edges), tiling their rows."""
    lens = [rows, rows + 1, 0, 40 * rows + 17, 0, 0, rows, rows + 1, 3, 0, 7 * rows]
    ends = np.cumsum(lens).astype(np.int64)
    return ends - np.asarray(lens, np.int64), ends


def hlo_reductions(seg) -> list:
    """The (vals, starts, ends, op) of every segmented reduce that
    ``Frame.from_hlo`` runs on the card over the HLO corpus, module by module
    and over the whole corpus (phase 5's calls), recorded by wrapping the
    kernel's wrapper for the duration."""
    from repro_torch.core.hlo import scan_hlo_collectives
    from repro_torch.core.thicket import Frame

    calls, wrapped = [], seg.segment_reduce

    def record(vals, starts, ends, op):
        calls.append((vals.clone(), starts.clone(), ends.clone(), op))
        return wrapped(vals, starts, ends, op)

    seg.segment_reduce = record
    try:
        entries = []
        for path in sorted((ROOT / "tests" / "fixtures" / "hlo").glob("*.txt")):
            expected = json.loads(path.with_name(f"{path.stem}.expected.json").read_text())
            buf = scan_hlo_collectives(path.read_text(), expected["total_devices"], with_loops=True)
            entries.append((path.stem, 8, buf))
            Frame.from_hlo(entries[-1:])
        Frame.from_hlo(entries)  # the whole-corpus frame, as phase 5 builds it
    finally:
        seg.segment_reduce = wrapped
    return calls


def reduce_cases(piece_rows: int) -> list:
    """Phase 3's seven cases and the piece edges at ``piece_rows`` rows a
    piece, as host ``(label, vals, starts, ends, op)``, made from ``SEED``."""
    rng = np.random.default_rng(SEED)
    n_seg_rows = 1 << 24
    seg_starts, seg_ends = spans_with_giant(rng, n_seg_rows, 4096)
    seg_int = rng.integers(0, 1 << 40, (n_seg_rows, 1), dtype=np.int64)
    seg_f64 = rng.random((n_seg_rows, 1))
    grid_rows = 1 << 20
    blk_starts, blk_ends = random_spans(rng, grid_rows, 4096)
    blk_int = rng.integers(0, 1 << 40, (grid_rows, 8), dtype=np.int64)
    edge_starts, edge_ends = piece_edge_spans(piece_rows)
    edge_int = rng.integers(0, 1 << 62, (int(edge_ends[-1]), 1), dtype=np.int64)
    ops = ("sum", "max", "min")
    cases = [("segment_reduce", seg_int, seg_starts, seg_ends, op) for op in ops]
    cases += [("block_reduce", blk_int, blk_starts, blk_ends, op) for op in ops]
    cases.append(("segment_reduce_f64", seg_f64, seg_starts, seg_ends, "sum"))
    cases += [("piece edges", edge_int, edge_starts, edge_ends, op) for op in ops]
    return cases


def reduce_timings(seg, vals, starts, ends, op: str, runs: int = 20) -> dict:
    """The segmented reduce of ``seg`` and one ``scatter_reduce_`` call of the
    same function on the card: ``ms`` / ``library_ms`` are CUDA-event times
    of one call (host launch cost included), ``device_ms`` /
    ``library_device_ms`` the device time a call with the launches queued
    (:func:`device_ms`).  ``check`` says whether ``scatter_reduce_`` and
    the kernel gave the same result (bit-equal for integers, 1e-12 ×
    max|result| for floats)."""
    s, c = starts.shape[0], vals.shape[1]
    ids = torch.repeat_interleave(torch.arange(s, device=vals.device), ends - starts)
    ids = ids.unsqueeze(1).expand(-1, c).contiguous()
    lib_op = {"sum": "sum", "max": "amax", "min": "amin"}[op]
    init = seg.init_value(op, vals.dtype)

    def kernel():
        return seg.segment_reduce(vals, starts, ends, op)

    def library():
        out = torch.full((s, c), init, dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, ids, vals[: ids.shape[0]], lib_op, include_self=True)

    k_out, lib_out = kernel(), library()
    if vals.dtype.is_floating_point:
        tol = 1e-12 * float(lib_out.abs().max()) if s else 0.0
        check = float((k_out - lib_out).abs().max()) <= tol if s else True
    else:
        check = torch.equal(k_out, lib_out)
    k_dev, lib_dev = device_ms(kernel, runs), device_ms(library, runs)
    return {
        "ms": cuda_ms(kernel, runs),
        "device_ms": k_dev["ms"],
        "library_ms": cuda_ms(library, runs),
        "library_device_ms": lib_dev["ms"],
        "queued": k_dev["queued"] and lib_dev["queued"],
        "library_agrees": check,
        "library_out": lib_out,
    }


def kernel_phase(seg, bw: float) -> list:
    dev = torch.device("cuda")
    cases = reduce_cases(seg.rows_per_piece(1))
    hlo_calls = hlo_reductions(seg)
    if not hlo_calls:
        fail("kernel: the HLO corpus ran no segmented reduce")
    cases += [
        (f"hlo corpus {i}", vals, starts, ends, op)
        for i, (vals, starts, ends, op) in enumerate(hlo_calls)
    ]
    results = []
    for label, host_vals, starts_np, ends_np, op in cases:
        vals, starts, ends = (
            t.to(dev) if torch.is_tensor(t) else torch.from_numpy(t).to(dev)
            for t in (host_vals, starts_np, ends_np)
        )
        n, c = vals.shape
        s = starts.shape[0]
        got = seg.segment_reduce(vals, starts, ends, op)
        torch.cuda.synchronize()
        want = seg.segment_reduce_plain(vals, starts, ends, op)
        timings = reduce_timings(seg, vals, starts, ends, op)
        lib_out = timings.pop("library_out")
        if vals.dtype.is_floating_point:
            err = float((got - want).abs().max())
            tol = 1e-12 * float(want.abs().max())
            if err > tol:
                fail(f"{label} {op}: kernel error {err} above {tol}")
            if not torch.allclose(lib_out, want, rtol=1e-9, atol=0):
                fail(f"{label} {op}: scatter_reduce_ differs from the plain version")
        else:
            err = 0.0
            if not torch.equal(got, want):
                fail(f"{label} {op}: kernel differs from its plain version")
            if not torch.equal(lib_out, want):
                fail(f"{label} {op}: scatter_reduce_ differs from the plain version")
        rows = seg.rows_per_piece(c)
        cuts = seg.cut_count(n, rows)
        pieces = seg.pieces(starts, ends, n, rows)[0].shape[0]
        nbytes = (n * c + s * c) * vals.element_size() + 2 * s * 8
        row = {
            "case": label,
            "op": op,
            "dtype": str(vals.dtype).replace("torch.", ""),
            "shape": [n, c],
            "spans": s,
            "longest_span": int((ends - starts).max()) if s else 0,
            "rows_per_piece": rows,
            "cuts": cuts,
            "pieces": pieces,
            "passes": 2 if cuts else 1,
            "max_abs_err": err,
            "ms": timings["ms"],
            "device_ms": timings["device_ms"],
            "plain_ms": cuda_ms(
                lambda: seg.segment_reduce_plain(vals, starts, ends, op), 3, 1
            ),
            "library_ms": timings["library_ms"],
            "library_device_ms": timings["library_device_ms"],
            "queued": timings["queued"],
            "bytes": nbytes,
            "bound_ms": nbytes / bw * 1e3,
        }
        results.append(row)
        if not label.startswith("hlo corpus"):
            log(
                f"kernel {label} {op} {row['dtype']} ({n}, {c}) spans={s} "
                f"rows_per_piece={rows} cuts={cuts} pieces={pieces} passes={row['passes']}: "
                f"ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} plain_ms={row['plain_ms']:.2f} "
                f"scatter_reduce_ms={row['library_ms']:.4f} "
                f"scatter_reduce_device_ms={row['library_device_ms']:.4f} "
                f"queued={row['queued']} max_abs_err={err}"
            )
        del vals, starts, ends, got, want, lib_out
    hlo = [r for r in results if r["case"].startswith("hlo corpus")]
    log(
        f"kernel hlo corpus: {len(hlo)} reductions, rows {min(r['shape'][0] for r in hlo)}"
        f"..{max(r['shape'][0] for r in hlo)}, spans {min(r['spans'] for r in hlo)}"
        f"..{max(r['spans'] for r in hlo)}, all one pass: "
        f"{all(r['passes'] == 1 for r in hlo)}"
    )
    for key, lib_key in (("ms", "library_ms"), ("device_ms", "library_device_ms")):
        log(
            f"kernel hlo corpus {key}: kernel sum {sum(r[key] for r in hlo):.4f} "
            f"(median {statistics.median(r[key] for r in hlo):.4f}) against "
            f"scatter_reduce_ sum {sum(r[lib_key] for r in hlo):.4f} (median "
            f"{statistics.median(r[lib_key] for r in hlo):.4f}); faster in "
            f"{sum(r[key] < r[lib_key] for r in hlo)}/{len(hlo)}"
        )
    return results


# ---------------------------------------------------------------------------
# Phase 4: kripke's main path
# ---------------------------------------------------------------------------


def kripke_phase(rt) -> tuple:
    from repro_torch.apps import kripke
    from repro_torch.apps.stencil import Decomp3D
    from repro_torch.core.backend import NumpyBackend, TorchBackend, resolve_backend
    from repro_torch.core.profiler import CommPatternProfiler, trace_observer
    from repro_torch.core.thicket import Frame

    card = resolve_backend(None)
    if not (isinstance(card, TorchBackend) and card.device.type == "cuda"):
        fail(f"the default backend is {card!r}, not torch on the card")

    class TimedBackend(TorchBackend):
        """The card backend with each copy timed behind a synchronize."""

        def __init__(self):
            super().__init__()
            self.h2d_s = self.d2h_s = self.wait_s = 0.0

        def _put(self, arr):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = super()._put(arr)
            torch.cuda.synchronize()
            self.h2d_s += time.perf_counter() - t
            return out

        def _get(self, t_dev):
            t = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = TorchBackend._get(t_dev)
            self.wait_s += t1 - t
            self.d2h_s += time.perf_counter() - t1
            return out

    # torch's meta kernels are Python code imported at first use (once per
    # process); time that apart from the first point's trace
    t = time.perf_counter()
    torch.empty(2, device="meta") / 2.0
    meta_init_s = time.perf_counter() - t
    log(f"kripke: first meta-tensor op (one-time import) {meta_init_s:.3f} s")
    rows, profiles = [], []
    for shape, params in KRIPKE_POINTS:
        cfg = kripke.KripkeConfig(decomp=Decomp3D(*shape), **params)
        n = cfg.decomp.n_ranks
        row = {"n_ranks": n, "decomp": list(shape), **params}
        t0 = time.perf_counter()

        def observe(rec, *, name, replication, meta, row=row, t0=t0):
            row["trace_s"] = time.perf_counter() - t0
            # the struct table's slab view is built once (host) and cached;
            # time it apart so the reductions below compare like with like
            t = time.perf_counter()
            rec.buffer.structs.reduction_view()
            row["view_s"] = time.perf_counter() - t

            def reduce(be):
                torch.cuda.synchronize()
                t = time.perf_counter()
                prof = CommPatternProfiler.from_recorder(
                    rec, name=name, replication=replication, meta=meta, backend=be
                )
                torch.cuda.synchronize()
                return prof, time.perf_counter() - t

            torch.cuda.reset_peak_memory_stats()
            prof, row["card_reduce_s"] = reduce(card)
            row["peak_cuda_bytes"] = torch.cuda.max_memory_allocated()
            ref, row["numpy_reduce_s"] = reduce(NumpyBackend())
            if prof.to_json() != ref.to_json():
                fail(f"kripke {n} ranks: card profile differs from NumpyBackend")
            timed = TimedBackend()
            _, total = reduce(timed)
            # like for like: both backends warm, alternated, median of three
            card_s, numpy_s = [], []
            for _ in range(WARM_REDUCTIONS):
                card_s.append(reduce(card)[1])
                numpy_s.append(reduce(NumpyBackend())[1])
            row["card_warm_s"] = statistics.median(card_s)
            row["numpy_warm_s"] = statistics.median(numpy_s)
            row["timed_reduce_s"] = total
            row["h2d_s"], row["d2h_s"] = timed.h2d_s, timed.d2h_s
            row["device_wait_s"] = timed.wait_s
            row["host_s"] = total - timed.h2d_s - timed.d2h_s - timed.wait_s
            row["h2d_share"] = timed.h2d_s / total
            return prof

        with trace_observer(observe):
            profiles.append(kripke.profile(cfg, name=f"kripke-{n:06d}"))
        row["launches"] = rt.launch_count()
        rows.append(row)
        log(
            f"kripke {n} ranks {shape}: trace_s={row['trace_s']:.3f} "
            f"view_s={row['view_s']:.4f} "
            f"card_reduce_s={row['card_reduce_s']:.4f} "
            f"numpy_reduce_s={row['numpy_reduce_s']:.4f} "
            f"card_warm_s={row['card_warm_s']:.4f} "
            f"numpy_warm_s={row['numpy_warm_s']:.4f} "
            f"h2d_share={row['h2d_share']:.3f} (h2d_s={row['h2d_s']:.4f} "
            f"device_wait_s={row['device_wait_s']:.4f} d2h_s={row['d2h_s']:.4f} "
            f"host_s={row['host_s']:.4f}) "
            f"peak_cuda_MB={row['peak_cuda_bytes'] / 2**20:.1f} "
            f"kernel_launches_so_far={row['launches']}"
        )
    frame = Frame.from_profiles(profiles)
    n_rows = len(frame.to_csv().splitlines()) - 1
    log(f"kripke Frame.from_profiles: {n_rows} csv rows over {len(profiles)} points")
    if n_rows != len(frame) or n_rows < len(profiles):
        fail("Frame.from_profiles lost rows")
    return rows, n_rows


# ---------------------------------------------------------------------------
# Phase 5: the HLO layer
# ---------------------------------------------------------------------------


def hlo_phase(rt) -> list:
    from repro_torch.core.backend import NumpyBackend, resolve_backend
    from repro_torch.core.hlo import scan_hlo_collectives
    from repro_torch.core.thicket import Frame

    card = resolve_backend(None)
    fixtures = sorted((ROOT / "tests" / "fixtures" / "hlo").glob("*.txt"))
    if len(fixtures) != 7:
        fail(f"expected the 7-module HLO corpus, found {len(fixtures)}")
    entries, rows = [], []
    for path in fixtures:
        expected = json.loads(path.with_name(f"{path.stem}.expected.json").read_text())
        buf = scan_hlo_collectives(
            path.read_text(), expected["total_devices"], with_loops=True
        )
        entry = (path.stem, 8, buf)
        before = rt.launch_count()
        got = Frame.from_hlo([entry], backend=card)
        launches = rt.launch_count() - before
        want = Frame.from_hlo([entry], backend=NumpyBackend())
        if got.to_csv() != want.to_csv() or got.rows != want.rows:
            fail(f"hlo {path.stem}: card rows differ from NumpyBackend")
        rows.append({"module": path.stem, "ops": buf.n_ops, "launches": launches})
        log(f"hlo {path.stem}: {buf.n_ops} ops, {len(got)} rows, launches={launches}")
        entries.append(entry)
    got = Frame.from_hlo(entries, backend=card)
    want = Frame.from_hlo(entries, backend=NumpyBackend())
    if got.to_markdown() != want.to_markdown():
        fail("hlo corpus frame differs from NumpyBackend")
    log(f"hlo Frame.from_hlo over the corpus: {len(got)} rows equal to NumpyBackend")
    return rows


# ---------------------------------------------------------------------------
# Phase 13: amg, laghos and beatnik; the network layer, streaming, reports
# ---------------------------------------------------------------------------

#: per-rank sizes of the paper's experiments (``repro/benchpark/spec.py``):
#: amg 32x32x16 a rank; laghos a fixed 512x512 global grid; beatnik 32x32 a
#: rank.  Points: the Dane decompositions (64-512 ranks; laghos-strong's
#: 16-128) and the scale points up to 8192 ranks.
APP_PARAMS = {
    "amg": dict(nx=32, ny=32, nz=16),
    "laghos": dict(nx=512, ny=512, n_steps=2),
    "beatnik": dict(nx=32, ny=32, n_steps=4),
}
APP_POINTS = {
    "amg": [(4, 4, 4), (8, 4, 4), (8, 8, 4), (8, 8, 8), (16, 16, 8), (32, 16, 8),
            (32, 32, 8)],
    "laghos": [(4, 4, 1), (8, 4, 1), (8, 8, 1), (16, 8, 1), (64, 32, 1), (64, 64, 1),
               (128, 64, 1)],
    "beatnik": [(32, 64, 1), (64, 64, 1), (128, 64, 1)],
}
#: the point of each app that phase 13 also profiles incrementally
STREAM_POINTS = {"amg": (8, 8, 8), "laghos": (16, 8, 1), "beatnik": (32, 64, 1)}
#: updates the incremental profiler takes over one trace
STREAM_UPDATES = 6
ORACLE_TOL = dict(rtol=5e-5, atol=5e-6)


def _app_config(app: str, shape: tuple):
    from repro_torch.apps import amg, beatnik, laghos
    from repro_torch.apps.stencil import Decomp3D

    cls = {"amg": amg.AMGConfig, "laghos": laghos.LaghosConfig,
           "beatnik": beatnik.BeatnikConfig}[app]
    return cls(decomp=Decomp3D(*shape), **APP_PARAMS[app])


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def app_profiles(card) -> tuple:
    """(a) Every app point traced once; the trace reduced on the card and on
    NumPy.  Returns (rows, {(app, shape): (profile, recorder)})."""
    from repro_torch.apps import amg, beatnik, laghos
    from repro_torch.core.backend import NumpyBackend
    from repro_torch.core.profiler import CommPatternProfiler, trace_observer

    modules = {"amg": amg, "laghos": laghos, "beatnik": beatnik}
    rows, traces = [], {}
    for app, shapes in APP_POINTS.items():
        for shape in shapes:
            cfg = _app_config(app, shape)
            n = cfg.decomp.n_ranks
            row = {"app": app, "n_ranks": n, "decomp": list(shape), **APP_PARAMS[app]}
            held = {}
            t0 = time.perf_counter()

            def observe(rec, *, name, replication, meta, row=row, held=held, t0=t0):
                row["trace_s"] = time.perf_counter() - t0
                t = time.perf_counter()
                rec.buffer.structs.reduction_view()
                row["view_s"] = time.perf_counter() - t
                row["rows"], row["structs"] = rec.buffer.n_rows, rec.buffer.structs.n_structs

                def reduce(be):
                    return _timed(lambda: CommPatternProfiler.from_recorder(
                        rec, name=name, replication=replication, meta=meta, backend=be))

                prof, row["card_reduce_s"] = reduce(card)
                ref, row["numpy_reduce_s"] = reduce(NumpyBackend())
                if prof.to_json() != ref.to_json():
                    fail(f"{app} {n} ranks: card profile differs from NumpyBackend")
                card_s, numpy_s = [], []
                for _ in range(WARM_REDUCTIONS):
                    card_s.append(reduce(card)[1])
                    numpy_s.append(reduce(NumpyBackend())[1])
                row["card_warm_s"] = statistics.median(card_s)
                row["numpy_warm_s"] = statistics.median(numpy_s)
                held["rec"] = rec
                return prof

            with trace_observer(observe):
                prof = modules[app].profile(cfg, name=f"{app}-{n:06d}")
            traces[(app, shape)] = (prof, held["rec"])
            rows.append(row)
            log(
                f"apps {app} {n} ranks {shape}: trace_s={row['trace_s']:.3f} "
                f"view_s={row['view_s']:.4f} rows={row['rows']} "
                f"structs={row['structs']} card_reduce_s={row['card_reduce_s']:.4f} "
                f"numpy_reduce_s={row['numpy_reduce_s']:.4f} "
                f"card_warm_s={row['card_warm_s']:.4f} "
                f"numpy_warm_s={row['numpy_warm_s']:.4f}"
            )
    return rows, traces


def network_rows(traces: dict) -> list:
    """(b) Modeled-network rows of every trace on three fabrics: the card's
    frame (the default backend) against NumpyBackend's, CSV byte for byte."""
    from repro_torch.core.backend import NumpyBackend
    from repro_torch.core.network import FABRICS
    from repro_torch.core.thicket import Frame

    rows = []
    for (app, shape), (prof, rec) in traces.items():
        entries = [(prof.name, prof.n_ranks, rec, fab) for fab in FABRICS.values()]
        got, card_s = _timed(lambda: Frame.from_network(entries))
        want, numpy_s = _timed(lambda: Frame.from_network(entries, NumpyBackend()))
        if got.to_csv() != want.to_csv():
            fail(f"network {app} {prof.n_ranks} ranks: card rows differ from NumPy")
        rows.append({"app": app, "n_ranks": prof.n_ranks, "rows": len(got),
                     "card_s": card_s, "numpy_s": numpy_s})
        log(f"network {app} {prof.n_ranks} ranks: {len(got)} rows on "
            f"{len(FABRICS)} fabrics, card_s={card_s:.4f} numpy_s={numpy_s:.4f}")
    return rows


def streaming_rows(traces: dict) -> list:
    """(c) Incremental profiles on the card, equal to the batch profile; the
    shards pickled, reloaded and merged in another order give the same."""
    import pickle

    from repro_torch.core.profiler import CommPatternProfiler
    from repro_torch.core.streaming import merge_tree

    rng = np.random.default_rng(SEED)
    rows = []
    for app, shape in STREAM_POINTS.items():
        prof, rec = traces[(app, shape)]
        n_rows = rec.buffer.n_rows
        cuts = np.linspace(0, n_rows, STREAM_UPDATES).astype(int)
        sp = CommPatternProfiler.incremental(rec)  # the default: the card

        def stream():
            return [sp.update(int(c)) for c in cuts] + [sp.update()]

        shards, card_s = _timed(stream)
        live = sp.profile(name=prof.name, meta=prof.meta)
        if live.to_json() != prof.to_json():
            fail(f"streaming {app} {prof.n_ranks} ranks: differs from the batch profile")
        for shard in shards:
            for rs in shard.regions.values():
                arrays = (rs.sends, rs.part, rs.dest_codes, rs.src_codes, rs.cbytes)
                if not all(isinstance(a, np.ndarray) for a in arrays):
                    fail(f"streaming {app}: a shard holds something other than NumPy")
        blobs = [pickle.dumps(s) for s in shards]
        order = rng.permutation(len(blobs))
        merged = merge_tree(pickle.loads(blobs[i]) for i in order)
        if merged.finalize(name=prof.name, meta=prof.meta).to_json() != prof.to_json():
            fail(f"streaming {app}: reloaded shards merged out of order differ")
        rows.append({"app": app, "n_ranks": prof.n_ranks, "trace_rows": n_rows,
                     "updates": len(shards), "card_s": card_s,
                     "shard_bytes": sum(len(b) for b in blobs)})
        log(f"streaming {app} {prof.n_ranks} ranks: {len(shards)} updates over "
            f"{n_rows} rows, card_s={card_s:.4f}, {sum(len(b) for b in blobs)} "
            "pickled shard bytes; equal to the batch profile in any merge order")
    return rows


def report_rows(rt, traces: dict) -> dict:
    """(d) The traced + hlo + network frame and the reports, on the card and
    on NumPy; the segmented-reduce kernel runs the HLO layer's reductions."""
    from repro_torch.core import reports
    from repro_torch.core.backend import NumpyBackend
    from repro_torch.core.hlo import scan_hlo_collectives
    from repro_torch.core.network import FABRICS
    from repro_torch.core.thicket import Frame

    hlo = []
    for path in sorted((ROOT / "tests" / "fixtures" / "hlo").glob("*.txt")):
        expected = json.loads(path.with_name(f"{path.stem}.expected.json").read_text())
        hlo.append((path.stem, 8, scan_hlo_collectives(
            path.read_text(), expected["total_devices"], with_loops=True)))
    profiles = [prof for prof, _ in traces.values()]
    network = [(prof.name, prof.n_ranks, rec, fab)
               for prof, rec in traces.values() for fab in FABRICS.values()]
    amg = [prof for (app, _), (prof, _) in traces.items() if app == "amg"]
    before = rt.launch_count()

    def render(be):
        frame = Frame.concat([Frame.from_profiles(profiles),
                              Frame.from_hlo(hlo, backend=be),
                              Frame.from_network(network, backend=be)])
        return {
            "frame": frame.to_csv(),
            "network_vs_traced": reports.network_vs_traced(
                profiles, network, hlo_entries=hlo, backend=be),
            "hlo_vs_traced": reports.hlo_vs_traced(profiles, hlo, backend=be),
            "table4_metrics": reports.table4_metrics(profiles, backend=be),
            "per_level_report": reports.per_level_report(amg, backend=be),
        }

    got, card_s = _timed(lambda: render(None))  # the default: the card
    launches = rt.launch_count() - before
    want, numpy_s = _timed(lambda: render(NumpyBackend()))
    for key in want:
        if got[key] != want[key]:
            fail(f"reports: {key} differs between the card and NumPy")
    if launches <= 0:
        fail("the segmented-reduce kernel was not launched by the three-layer frame")
    n_frame = len(got["frame"].splitlines()) - 1
    log(f"reports: three-layer frame of {n_frame} rows and 4 reports equal on the "
        f"card and NumPy; card_s={card_s:.3f} numpy_s={numpy_s:.3f} "
        f"segment_reduce launches={launches}")
    (OUT_DIR / "apps_reports.md").write_text(
        "\n\n".join(got[k] for k in got if k != "frame"))
    return {"frame_rows": n_frame, "card_s": card_s, "numpy_s": numpy_s,
            "launches": launches}


def oracle_rows() -> list:
    """(e) The single-domain oracles on the card against the CPU."""
    from repro_torch.apps import amg, beatnik, laghos

    def amg_run(device):
        cfg = _app_config("amg", (8, 8, 8))
        run, _ = amg.reference_solve(cfg)
        u, rn = run(amg.make_rhs(cfg, device=device))
        return [u, rn]

    def laghos_run(device):
        cfg = _app_config("laghos", (16, 8, 1))
        state, dts = laghos.reference_steps(cfg)(laghos.make_state(cfg, device=device))
        return [*state.values(), dts]

    def beatnik_run(device):
        cfg = _app_config("beatnik", (32, 64, 1))
        (z, w), nrms = beatnik.reference_steps(cfg)(beatnik.make_state(cfg, device=device))
        return [z, w, nrms]

    rows = []
    for app, fn in (("amg", amg_run), ("laghos", laghos_run), ("beatnik", beatnik_run)):
        t = time.perf_counter()
        want = fn("cpu")
        cpu_s = time.perf_counter() - t
        got, card_s = _timed(lambda: fn(None))  # the default device: the card
        if any(g.device.type != "cuda" for g in got):
            fail(f"oracle {app}: did not run on the card")
        err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        for g, w in zip(got, want):
            if not torch.isfinite(w).all() or not torch.allclose(g.cpu(), w, **ORACLE_TOL):
                fail(f"oracle {app}: card differs from the CPU (max {err})")
        shape = list(want[0].shape)
        rows.append({"app": app, "shape": shape, "card_s": card_s, "cpu_s": cpu_s,
                     "max_abs_err": err})
        log(f"oracle {app} {shape}: card_s={card_s:.3f} cpu_s={cpu_s:.3f} "
            f"max_abs_err={err}")
    return rows


def apps_phase(rt) -> dict:
    from repro_torch.core.backend import TorchBackend, resolve_backend

    card = resolve_backend(None)
    if not (isinstance(card, TorchBackend) and card.device.type == "cuda"):
        fail(f"the default backend is {card!r}, not torch on the card")
    rows, traces = app_profiles(card)
    network = network_rows(traces)
    streaming = streaming_rows(traces)
    reports_row = report_rows(rt, traces)
    oracles = oracle_rows()
    return {"profiles": rows, "network": network, "streaming": streaming,
            "reports": reports_row, "oracles": oracles}


# ---------------------------------------------------------------------------
# Phase 6: kripke's solve on the card
# ---------------------------------------------------------------------------


def solve_phase() -> dict:
    from repro_torch.apps import kripke
    from repro_torch.apps.stencil import Decomp3D

    cfg = kripke.KripkeConfig(decomp=Decomp3D(1, 1, 1), nx=16, ny=32, nz=32)
    q = kripke.make_source(cfg, device="cpu")
    t = time.perf_counter()
    want = kripke.reference_sweep(cfg)(q)
    cpu_s = time.perf_counter() - t
    q_dev = kripke.make_source(cfg)  # the default device: the card
    if q_dev.device.type != "cuda":
        fail(f"kripke.make_source built on {q_dev.device}, not the card")
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = kripke.reference_sweep(cfg)(q_dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    err = float((got.cpu() - want).abs().max())
    if not torch.allclose(got.cpu(), want, rtol=5e-5, atol=5e-6):
        fail(f"kripke reference_sweep on the card differs from the CPU (max {err})")
    log(
        f"solve reference_sweep {tuple(q.shape)} float32: card_s={card_s:.3f} "
        f"cpu_s={cpu_s:.3f} max_abs_err={err}"
    )
    return {"shape": list(q.shape), "card_s": card_s, "cpu_s": cpu_s, "err": err}


# ---------------------------------------------------------------------------
# Phase 7: the attention kernels against their plain versions
# ---------------------------------------------------------------------------

#: flash cases: (label, B, Hq, Hkv, Sq, Sk, D, causal, dtype)
FLASH_CASES = [
    ("olmo-1b prefill", 4, 16, 16, 1024, 1024, 128, True, torch.bfloat16),
    ("deepseek-coder-33b GQA", 1, 56, 8, 2048, 2048, 128, True, torch.bfloat16),
    ("gemma-2b MQA", 1, 8, 1, 1024, 1024, 256, True, torch.bfloat16),
    ("zamba2-1.2b shared prefill", 4, 32, 32, 1024, 1024, 128, True, torch.bfloat16),
    ("decode-style Sq < Sk", 2, 4, 4, 64, 256, 128, True, torch.bfloat16),
    ("odd non-causal f32", 1, 2, 2, 33, 33, 32, False, torch.float32),
    ("ragged 1000-token tiles", 1, 8, 8, 1000, 1000, 128, True, torch.bfloat16),
    ("head dim 64", 2, 16, 16, 1024, 1024, 64, True, torch.bfloat16),
    # phase 16's models: GQA groups of 3 and 7, bidirectional bf16 (the
    # encoder), cross-attention with Sq > Sk (keys shorter than one TMA
    # tile) and Sq < Sk, the reduced grok-1's head dim 32
    ("granite-moe-3b GQA 24:8", 4, 24, 8, 1024, 1024, 64, True, torch.bfloat16),
    ("qwen2-vl-7b GQA 28:4, vision prefix", 4, 28, 4, 1280, 1280, 128, True,
     torch.bfloat16),
    ("seamless encoder non-causal", 4, 16, 16, 1024, 1024, 64, False, torch.bfloat16),
    ("cross Sq > Sk, 16 frames", 4, 16, 16, 1024, 16, 64, False, torch.bfloat16),
    ("cross Sq < Sk non-causal", 2, 16, 16, 100, 1000, 64, False, torch.bfloat16),
    ("grok-1 reduced head dim 32", 4, 4, 2, 1024, 1024, 32, True, torch.bfloat16),
]
#: decode cases: (label, B, Hq, Hkv, S, kv_len, D, dtype)
DECODE_CASES = [
    ("olmo-1b decode", 4, 16, 16, 1056, 1040, 128, torch.bfloat16),
    ("deepseek-coder-33b GQA decode", 8, 56, 8, 32768, 30000, 128, torch.bfloat16),
    ("zamba2-1.2b shared decode", 4, 32, 32, 1056, 1040, 128, torch.bfloat16),
    ("olmo-1b batch 1, long cache", 1, 16, 16, 16384, 16000, 128, torch.bfloat16),
    ("olmo-1b kv_len 1", 4, 16, 16, 1056, 1, 128, torch.bfloat16),
    ("olmo-1b last split of 1 key", 4, 16, 16, 1056, 769, 128, torch.bfloat16),
    ("granite-moe-3b GQA decode", 4, 24, 8, 1056, 1040, 64, torch.bfloat16),
    ("qwen2-vl-7b GQA decode", 4, 28, 4, 1312, 1296, 128, torch.bfloat16),
    ("seamless cross decode, 16 frames", 4, 16, 16, 16, 16, 64, torch.bfloat16),
    ("seamless cross decode, 1024 frames", 4, 16, 16, 1024, 1024, 64,
     torch.bfloat16),
]
#: tests/test_kernels.py's tolerances: bf16 2e-2, f32 2e-5 (rtol = atol)
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
#: the stored log-sum-exp against torch.logsumexp of the plain f32 scores
LSE_ATOL = 1e-4


def row_scaled_excess(got, want, tol: float) -> float:
    """How far |got - want| passes rtol = tol and atol = tol * the row's
    largest |want| (a row is one query's D outputs), at its worst; <= 0 holds.
    Over a long cache an output row is a few hundredths, so an absolute 2e-2
    cannot see a key range dropped or weighted wrongly: this rule can."""
    got, want = got.float(), want.float()
    scale = want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() - tol * (want.abs() + scale)).max())


def _attn_timings(kernel, plain, library) -> dict:
    """Device ms of kernel, plain version and library (queued launches), and
    the kernel's ms per call with the host's launch overhead (median of 20
    calls, each timed alone)."""
    k, p, lib = device_ms(kernel, 20), device_ms(plain, 5), device_ms(library, 20)
    return {
        "ms": k["ms"],
        "plain_ms": p["ms"],
        "library_ms": lib["ms"],
        "call_ms": cuda_ms(kernel, 20),
        "queued": k["queued"] and p["queued"] and lib["queued"],
    }


def _attn_row(label, kind, shape, dtype, got, want, lib_out, timings, work, card,
              **extra):
    """Check kernel and library against the plain version; the case's row."""
    tol = ATTN_TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"{kind} {label}: kernel differs from its plain version (max {err})")
    # bf16 rows also against the rule scaled to each row (f32's 2e-5 is
    # already well below its outputs)
    excess = row_scaled_excess(got, want, tol) if dtype == torch.bfloat16 else None
    if excess is not None and excess > 0:
        fail(f"{kind} {label}: kernel differs from its plain version by "
             f"{excess} past the row-scaled rule (rtol {tol}, atol {tol} * "
             "the row's max |plain|)")
    lib_err = float((lib_out.float() - want.float()).abs().max())
    if not torch.allclose(lib_out.float(), want.float(), rtol=tol, atol=tol):
        fail(f"{kind} {label}: sdpa differs from the plain version (max {lib_err})")
    flops, nbytes = work
    bw, _ = memory_rate(card)
    peak, _ = op_rate(card, dtype)
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / bw * 1e3
    row = {
        "case": label,
        "kind": kind,
        "shape": shape,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err,
        "row_scaled_excess": excess,
        "sdpa_max_abs_err": lib_err,
        **timings,
        "flops": flops,
        "bytes": nbytes,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        **extra,
    }
    log(
        f"attention {kind} {label} {shape} {row['dtype']}{extra or ''}: "
        f"ms={row['ms']:.4f} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
        f"plain_ms={row['plain_ms']:.3f} sdpa_ms={row['library_ms']:.4f} "
        f"call_ms={row['call_ms']:.4f} queued={row['queued']} "
        f"max_abs_err={err} row_scaled_excess={excess} "
        f"sdpa_max_abs_err={lib_err}"
    )
    return row


def attention_phase(card: str) -> tuple:
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.to(dtype)

    flash_rows = []
    for label, b, hq, hkv, sq, sk, d, causal, dtype in FLASH_CASES:
        q = randn(b, hq, sq, d, dtype=dtype)
        k, v = randn(b, hkv, sk, d, dtype=dtype), randn(b, hkv, sk, d, dtype=dtype)
        got = fa.flash_attention(q, k, v, causal=causal)
        with_lse, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        if not torch.equal(got, with_lse):
            fail(f"flash {label}: the output differs when the lse is stored")
        lse_err = float((lse - fa.flash_attention_lse_plain(q, k, v, causal=causal))
                        .abs().max())
        if not lse_err <= LSE_ATOL:
            fail(f"flash {label}: lse differs from logsumexp of the plain scores "
                 f"by {lse_err} (atol {LSE_ATOL})")
        mask = None
        if causal and sq != sk:
            qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
            mask = qpos >= torch.arange(sk, device=dev)[None, :]

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=hq != hkv,
            )

        timings = _attn_timings(
            lambda: fa.flash_attention(q, k, v, causal=causal),
            lambda: fa.flash_attention_plain(q, k, v, causal=causal),
            library,
        )
        # pairs of (query, key) the causal mask leaves: what this input needs
        pairs = sq * (sk - sq) + sq * (sq + 1) // 2 if causal else sq * sk
        es = q.element_size()
        work = (4 * b * hq * d * pairs, (2 * b * hq * sq + 2 * b * hkv * sk) * d * es)
        flash_rows.append(
            _attn_row(label, "flash", [b, hq, hkv, sq, sk, d], dtype, got, want,
                      library(), timings, work, card, lse_max_abs_err=lse_err)
        )
        del q, k, v, got, want, mask, with_lse, lse
    decode_rows = []
    for label, b, hq, hkv, s, kv_len, d, dtype in DECODE_CASES:
        q = randn(b, hq, 1, d, dtype=dtype)
        k, v = randn(b, hkv, s, d, dtype=dtype), randn(b, hkv, s, d, dtype=dtype)
        n_split, per = dec.card_split_plan(q, k, kv_len)
        wave = dec.card_wave(q.device, dtype, d)
        if "last split" in label and (n_split < 2 or (kv_len - 1) % per):
            fail(f"decode {label}: plan ({n_split}, {per}) for kv_len {kv_len} "
                 "does not leave one key in the last split")
        got = dec.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        want = dec.decode_attention_plain(q, k, v, kv_len)

        def library():
            return F.scaled_dot_product_attention(
                q, k[:, :, :kv_len], v[:, :, :kv_len], enable_gqa=hq != hkv
            )

        timings = _attn_timings(
            lambda: dec.decode_attention(q, k, v, kv_len),
            lambda: dec.decode_attention_plain(q, k, v, kv_len),
            library,
        )
        es = q.element_size()
        work = (4 * b * hq * d * kv_len, (2 * b * hq + 2 * b * hkv * kv_len) * d * es)
        decode_rows.append(
            _attn_row(label, "decode", [b, hq, hkv, s, kv_len, d], dtype, got, want,
                      library(), timings, work, card, n_split=n_split,
                      keys_per_split=per, **wave)
        )
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return flash_rows, decode_rows


# ---------------------------------------------------------------------------
# Phase 8: serve olmo-1b at full width and depth
# ---------------------------------------------------------------------------

SERVE_ARGV = [
    "--arch", "olmo-1b", "--full", "--batch", "4", "--prompt-len", "1024",
    "--new-tokens", "32", "--seed", str(SEED),
]
#: the reduced olmo-1b (4 layers, d 128), where the logits rule is well posed
SMALL_ARGV = [
    "--arch", "olmo-1b", "--batch", "4", "--prompt-len", "64",
    "--new-tokens", "8", "--seed", str(SEED),
]
#: a row whose top two attention scores lie closer than this (relative) is a
#: tie that f32 rounding may break either way; both answers are right
TIE_RTOL = 1e-4


def _logits_diff(got, want, scale: float) -> dict:
    """The tests/test_models.py rule: rtol 2e-2, atol 0.02 * max|logits|."""
    return {
        "max_abs_err": float((got - want).abs().max()),
        "scale": scale,
        "holds": bool(torch.allclose(got, want, rtol=2e-2, atol=0.02 * scale)),
    }


def end_to_end(model, res, prompts, n_new: int, inputs=None) -> dict:
    """Served logits against the same model on the plain attention (prefill
    and the first 4 steps) and against teacher forcing (every step).
    ``inputs`` are the stub embeddings the served run took (serve_lm's)."""
    from repro_torch.kernels import ops

    inputs = inputs or {}
    start = res.start
    out = {}
    with ops.plain():
        logits, caches = model.prefill({"tokens": prompts, **inputs}, s_max=start + n_new)
        scale = float(logits.abs().max())
        out["prefill vs plain"] = _logits_diff(res.prefill_logits, logits, scale)
        for t in range(min(4, n_new - 1)):
            tok = res.tokens[:, t : t + 1]
            logits, caches = model.decode(caches, tok, start + t)
            diff = _logits_diff(res.decode_logits[t], logits, scale)
            out[f"decode {t} vs plain"] = diff
    del caches, logits
    seq = torch.cat([prompts, res.tokens[:, : n_new - 1]], dim=1)
    with torch.no_grad():
        full, _ = model.train_logits({"tokens": seq, **inputs})
    scale = float(full.abs().max())
    want = full[:, start - 1]
    diff = _logits_diff(res.prefill_logits[:, 0], want, scale)
    out["prefill vs teacher forcing"] = diff
    for t, step in enumerate(res.decode_logits):
        diff = _logits_diff(step[:, 0], full[:, start + t], scale)
        out[f"decode {t} vs teacher forcing"] = diff
    return out


def _scores(q, k, mask) -> torch.Tensor:
    """The plain versions' f32 scores (B, Hq, Sq, Sk), masked to -1e30."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1) if rep > 1 else k
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    return torch.where(mask, s, -1e30)


class AttentionSwap:
    """While entered, the models' attention calls (``ops.flash_attention``,
    ``ops.decode_attention``) go to this object's ``flash`` and ``decode``."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops = ops
        self._saved = ops.flash_attention, ops.decode_attention
        ops.flash_attention, ops.decode_attention = self.flash, self.decode
        return self

    def __exit__(self, *exc):
        self._ops.flash_attention, self._ops.decode_attention = self._saved


class ShadowAttention(AttentionSwap):
    """Run every attention call of the model on the kernel and, on the same
    inputs, on its plain version, and hold each row to the plain version
    under the rule (rtol 2e-2, atol 0.02 * max|out|) unless its top two
    scores tie below f32 resolution (``TIE_RTOL``).  The model goes on with
    the kernel's output.  Fails the run on any other mismatch."""

    def __init__(self):
        self.calls = self.rows = self.tie_rows = self.tie_rows_differing = 0
        self.max_abs_err = 0.0

    def flash(self, q, k, v, *, causal=True):
        from repro_torch.kernels import flash_attention as fa

        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        sq, sk = q.shape[2], k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = qpos >= torch.arange(sk, device=q.device)[None, :]
        self._check("flash", got, want, _scores(q, k, mask | (not causal)))
        return got

    def decode(self, q, k, v, kv_len):
        from repro_torch.kernels import decode_attention as dec

        got = dec.decode_attention(q, k, v, kv_len)
        want = dec.decode_attention_plain(q, k, v, kv_len)
        mask = torch.arange(k.shape[2], device=q.device) < kv_len
        self._check("decode", got, want, _scores(q, k, mask))
        return got

    def _check(self, kind, got, want, scores) -> None:
        top = scores.topk(2, dim=-1).values
        tie = top[..., 0] - top[..., 1] <= TIE_RTOL * top[..., 0].abs().clamp_min(1.0)
        g, w = got.float(), want.float()
        err = (g - w).abs()
        bad = (err > 2e-2 * w.abs() + 0.02 * float(w.abs().max())).any(-1)
        if bool((bad & ~tie).any()):
            worst = float(err.amax(-1)[bad & ~tie].max())
            fail(f"serve: {kind} kernel differs from its plain version in the "
                 f"model on {int((bad & ~tie).sum())} untied rows (max {worst})")
        self.calls += 1
        self.rows += tie.numel()
        self.tie_rows += int(tie.sum())
        self.tie_rows_differing += int((bad & tie).sum())
        if bool((~tie).any()):
            self.max_abs_err = max(self.max_abs_err, float(err.amax(-1)[~tie].max()))

    def summary(self) -> dict:
        return {k: getattr(self, k) for k in (
            "calls", "rows", "tie_rows", "tie_rows_differing", "max_abs_err")}


def seeded_batch(cfg, batch: int, n_prompt: int, dtype=None, **stub) -> tuple:
    """serve_lm's model (cast to ``dtype``), prompts and stub inputs for
    ``cfg`` (``stub``: serve_lm's ``vision_tokens`` / ``source_frames``,
    16 each by default), drawn again from SEED: the same weights, prompts
    and embeddings as ``serve_lm.main``."""
    from repro_torch.models.model import build_model
    from repro_torch.serve_lm import stub_inputs

    model = build_model(cfg, seed=SEED)
    if dtype is not None:
        model = model.to(dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(
        0, cfg.vocab, (batch, n_prompt), generator=gen, device="cuda"
    )
    stub = {"vision_tokens": 16, "source_frames": 16, **stub}
    return model, prompts, stub_inputs(cfg, batch, gen, **stub)


def seeded(cfg, batch: int, n_prompt: int, dtype=None) -> tuple:
    """serve_lm's model (cast to ``dtype``) and prompts for ``cfg``."""
    model, prompts, _ = seeded_batch(cfg, batch, n_prompt, dtype)
    return model, prompts


def serve_phase() -> dict:
    from repro_torch import serve_lm
    from repro_torch.configs import registry
    from repro_torch.kernels import ops

    cfg = registry.get("olmo-1b")
    n_prompt, n_new = 1024, 32
    # a first run warms cuBLAS and the kernels' libraries; its counts are reset
    t = time.perf_counter()
    cold = serve_lm.main(SERVE_ARGV)
    cold_s = time.perf_counter() - t
    del cold
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = serve_lm.main(SERVE_ARGV)
    main_s = time.perf_counter() - t
    counts = ops.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    want_counts = {
        "flash_attention": cfg.n_layers,
        "flash_attention_bwd": 0,
        "decode_attention": cfg.n_layers * (n_new - 1),
        "ssd_scan": 0,
        "ssd_scan_bwd": 0,
        "mlstm_scan": 0,
        "mlstm_scan_bwd": 0,
    }
    if counts != want_counts:
        fail(f"serve: kernel launches {counts}, expected {want_counts}")
    if res.tokens.shape != (4, n_new) or res.tokens.device.type != "cuda":
        fail(f"serve: tokens {tuple(res.tokens.shape)} on {res.tokens.device}")
    if int(res.tokens.max()) >= cfg.vocab_padded or int(res.tokens.min()) < 0:
        fail("serve: a token outside the padded vocab")
    all_logits = [res.prefill_logits, *res.decode_logits]
    if not all(bool(torch.isfinite(x).all()) for x in all_logits):
        fail("serve: non-finite logits")
    if res.prefill_logits.shape != (4, 1, cfg.vocab_padded):
        fail(f"serve: prefill logits {tuple(res.prefill_logits.shape)}")

    model, prompts = seeded(cfg, 4, n_prompt)
    n_params = sum(p.numel() for p in model.parameters())
    with ShadowAttention() as shadow:
        logits, caches = model.prefill({"tokens": prompts}, s_max=n_prompt + n_new)
        for t in range(4):
            tok = res.tokens[:, t : t + 1]
            logits, caches = model.decode(caches, tok, n_prompt + t)
        seq = torch.cat([prompts, res.tokens[:, : n_new - 1]], dim=1)
        with torch.no_grad():
            model.train_logits({"tokens": seq})
    del caches, logits
    # the device's share of a step: its work timed with the launches queued
    # behind a sleep kernel, against the host clock of the served run
    _, caches = model.prefill({"tokens": prompts}, s_max=n_prompt + n_new)
    step = device_ms(lambda: model.decode(caches, res.tokens[:, :1], n_prompt), 5)
    pre = device_ms(
        lambda: model.prefill({"tokens": prompts}, s_max=n_prompt + n_new), 2
    )
    del caches
    # reported, not held: at this width and depth the random model's one-hot
    # attention breaks score ties either way (see the shadow's tie rows)
    full_e2e = end_to_end(model, res, prompts, n_new)
    del model
    torch.cuda.empty_cache()

    # the rule held end to end on the reduced config, on the card
    scfg = registry.get("olmo-1b").reduced()
    small = serve_lm.main(SMALL_ARGV)
    smodel, sprompts = seeded(scfg, 4, 64)
    small_e2e = end_to_end(smodel, small, sprompts, 8)
    for label, diff in small_e2e.items():
        if not diff["holds"]:
            fail(f"serve (reduced olmo-1b): {label}: {diff}")
    del smodel, small

    n_dec = 4 * (n_new - 1)
    row = {
        "arch": cfg.name,
        "layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "params": n_params,
        "batch": 4,
        "prompt_len": n_prompt,
        "new_tokens": n_new,
        "cold_main_s": cold_s,
        "main_s": main_s,
        "prefill_s": res.prefill_s,
        "decode_s": res.decode_s,
        "decode_tok_s": n_dec / res.decode_s,
        "ms_per_decode_step": res.decode_s / (n_new - 1) * 1e3,
        "peak_cuda_mb": peak_mb,
        "decode_step_device_ms": step["ms"],
        "decode_step_queued": step["queued"],
        "decode_idle_share": 1 - step["ms"] / (res.decode_s / (n_new - 1) * 1e3),
        "prefill_device_ms": pre["ms"],
        "prefill_queued": pre["queued"],
        "prefill_idle_share": 1 - pre["ms"] / (res.prefill_s * 1e3),
        "launches": counts,
        "shadow": shadow.summary(),
        "full_end_to_end": full_e2e,
        "reduced_end_to_end": small_e2e,
        "sample": res.tokens[0].tolist(),
    }
    log(
        f"serve {cfg.name} ({n_params} params, {cfg.n_layers} layers, "
        f"d {cfg.d_model}) 4x{n_prompt} + {n_new} tokens: "
        f"prefill_s={res.prefill_s:.4f} decode_s={res.decode_s:.4f} "
        f"decode_tok_s={row['decode_tok_s']:.1f} "
        f"ms_per_step={row['ms_per_decode_step']:.3f} peak_cuda_MB={peak_mb:.1f} "
        f"cold_main_s={cold_s:.2f} launches={counts}"
    )
    log(
        f"serve device time (queued): decode step {step['ms']:.3f} ms "
        f"(queued={step['queued']}, idle share {row['decode_idle_share']:.3f}), "
        f"prefill {pre['ms']:.3f} ms (queued={pre['queued']}, idle share "
        f"{row['prefill_idle_share']:.3f})"
    )
    log(f"serve shadow (kernel vs plain on every call): {shadow.summary()}")
    worst = max(full_e2e.items(), key=lambda kv: kv[1]["max_abs_err"])
    n_hold = sum(d["holds"] for d in full_e2e.values())
    log(
        f"serve full-size logits rule (reported): {n_hold}/{len(full_e2e)} hold; "
        f"worst {worst[0]}: {worst[1]}"
    )
    worst = max(small_e2e.items(), key=lambda kv: kv[1]["max_abs_err"])
    log(
        f"serve reduced olmo-1b logits rule: all {len(small_e2e)} hold; "
        f"worst {worst[0]}: {worst[1]}"
    )
    return row


# ---------------------------------------------------------------------------
# Phase 9: the SSD scan kernel against its plain version
# ---------------------------------------------------------------------------

#: SSD cases: (label, B, S, H, P, N, chunk, dtype, kind).  kind "model"
#: passes Bm / Cm as slices of one (B, S, H P + 2 N) tensor, as mamba_train
#: passes its conv output, and an initial state; "offset" puts xh, Bm and Cm
#: one element into wider buffers, so no row is 16-byte aligned and the
#: wrapper copies them first
SSD_CASES = [
    ("zamba2-1.2b prefill", 4, 1024, 64, 64, 64, 128, torch.bfloat16, None),
    ("zamba2-1.2b prefill f32", 4, 1024, 64, 64, 64, 128, torch.float32, None),
    ("ragged tail S 1000", 4, 1000, 64, 64, 64, 128, torch.bfloat16, None),
    ("one position S 1", 4, 1, 64, 64, 64, 128, torch.bfloat16, None),
    ("long context S 16384", 1, 16384, 64, 64, 64, 128, torch.bfloat16, None),
    ("long context S 16384 f32", 1, 16384, 64, 64, 64, 128, torch.float32, None),
    ("model layout: strided B, C and h0", 4, 1024, 64, 64, 64, 128, torch.bfloat16,
     "model"),
    ("reduced P 32, N 16, chunk 16", 4, 1024, 8, 32, 16, 16, torch.bfloat16, None),
    ("reduced P 32, N 16, chunk 16 f32", 4, 1024, 8, 32, 16, 16, torch.float32, None),
    ("rows one element off 16 bytes", 2, 1000, 64, 64, 64, 128, torch.bfloat16,
     "offset"),
]
#: y: bf16 rtol = atol = 2e-2 (tests/test_kernels.py's bf16 tolerance: y
#: rounds to bf16); f32 rtol 1e-4, atol 1e-4 * max|y| (sums of up to 128
#: terms of that size in another order).  h_final (f32 on both sides): rtol
#: 1e-4, atol 1e-4 * max|h_final|.
SSD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: the kernel's three passes by their CUDA kernels' names
SSD_PASSES = {
    "chunk states": r"chunk_states",
    "state passing": r"state_passing",
    "chunk outputs": r"chunk_outputs",
}


def ssd_inputs(gen, b, s, h, p, n, dtype, kind=None) -> tuple:
    """xh, la, Bm, Cm and h0 (or None) of one SSD case, drawn on the card
    with tests/test_kernels.py's scales; la (log decays) f32 and <= 0."""
    dev = torch.device("cuda")

    def randn(*shape, scale, dtype=dtype):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * scale).to(dtype)

    xh = randn(b, s, h, p, scale=0.5)
    bm, cm = randn(b, s, n, scale=0.5), randn(b, s, n, scale=0.5)
    la = -randn(b, s, h, scale=0.3, dtype=torch.float32).abs()
    h0 = None
    if kind == "model":
        xbc = randn(b, s, h * p + 2 * n, scale=0.5)
        bm, cm = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
        h0 = randn(b, h, p, n, scale=1.0, dtype=torch.float32)
    elif kind == "offset":

        def shifted(t):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            flat[1:] = t.reshape(-1)
            return flat[1:].view(t.shape)

        xh, bm, cm = shifted(xh), shifted(bm), shifted(cm)
    return xh, la, bm, cm, h0


def ssd_errors(got, want) -> tuple:
    """(max |y err|, max |h err|, holds) under the SSD tolerances."""
    (y, h), (y_p, h_p) = got, want
    y, y_p = y.float(), y_p.float()
    tol = SSD_TOL[got[0].dtype]
    atol_y = tol if got[0].dtype == torch.bfloat16 else tol * float(y_p.abs().max())
    holds = torch.allclose(y, y_p, rtol=tol, atol=atol_y) and torch.allclose(
        h, h_p, rtol=1e-4, atol=1e-4 * float(h_p.abs().max())
    )
    return float((y - y_p).abs().max()), float((h - h_p).abs().max()), bool(holds)


def ssd_work(b, s, h, p, n, chunk, elem) -> tuple:
    """(operations, bytes) one scan needs: per chunk of n_q real positions
    2 (N + P) n_q (n_q + 1) / 2 for C Bᵀ and W xh over the causal triangle,
    and 4 n_q N P for C hᵀ and the state update; xh, Bm, Cm, y in the input
    dtype and la, h_final in f32, each read or written once."""
    flops = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        flops += (n + p) * q * (q + 1) + 4 * q * n * p
    flops *= b * h
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * elem + (b * s * h + b * h * p * n) * 4
    return flops, nbytes


def ssd_design_bytes(ssd, b, s, h, p, n, chunk, elem, with_h0: bool) -> int:
    """The bytes the kernel's three passes move as designed (what ``ssd_work``
    does not count): xh twice; Bm once a block of pass 1 and Bm, Cm once a
    block of pass 3 (a block takes a group of heads); la twice; each chunk's 64 x 64 f32 state written (pass
    1), read and written again as the entering state (2: f32, or bf16 hi +
    lo, the same bytes) and read (3); y, h_final and h0 once."""
    nc = -(-s // chunk)
    tiles = b * h * nc * 64 * 64 * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = -(-h // ssd.heads_per_block(ssd.HEADS_PER_BLOCK, b * nc, h, sms))
    inputs = 2 * b * s * h * p * elem + 3 * groups * b * s * n * elem + 2 * b * s * h * 4
    outputs = b * s * h * p * elem + b * h * p * n * 4 * (2 if with_h0 else 1)
    return inputs + outputs + 4 * tiles + 2 * b * h * nc * 4


def ssd_timings(ssd, xh, la, bm, cm, h0, chunk, runs: int = 20) -> dict:
    """Device ms of a call with the launches queued, ms a call (CUDA events),
    the plain version's device ms, and each pass's device ms: its kernel's
    mean launch over three profiled calls (``torch.profiler``; a pass is one
    launch a call; "rest" for a wrapper whose kernel is one launch)."""

    def kernel():
        return ssd.ssd_scan(xh, la, bm, cm, h0, block_q=chunk)

    def plain():
        return ssd.ssd_scan_plain(xh, la, bm, cm, h0, block_q=chunk)

    k, pl = device_ms(kernel, runs), device_ms(plain, 3)
    prof = device_profile(kernel, runs=3)
    return {
        "ms": k["ms"],
        "call_ms": cuda_ms(kernel, runs),
        "plain_ms": pl["ms"],
        "queued": k["queued"] and pl["queued"],
        "pass_ms": {k_: v for k_, v in split_kernels(prof["per_launch"], SSD_PASSES).items()
                    if v > 0},
        "profile_ms": prof["device_ms"],
        "profile_attempts": prof["attempts"],
    }


def ssd_parent_times(parent: Path) -> dict:
    """Case label -> the timings of the checkout at ``parent`` on this card
    (``tools/ssd_times.py --src parent``, its own process)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "ssd_times.py"), "--src", str(parent)],
        capture_output=True, text=True, check=True,
    ).stdout
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    return {r["case"]: r for r in rows if "case" in r}


def ssd_phase(card: str, parent: Path | None = None) -> list:
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bw, _ = memory_rate(card)
    parent_rows = ssd_parent_times(parent) if parent is not None else {}
    rows = []
    for label, b, s, h, p, n, chunk, dtype, kind in SSD_CASES:
        xh, la, bm, cm, h0 = ssd_inputs(gen, b, s, h, p, n, dtype, kind)
        got = ssd.ssd_scan(xh, la, bm, cm, h0, block_q=chunk)
        torch.cuda.synchronize()
        want = ssd.ssd_scan_plain(xh, la, bm, cm, h0, block_q=chunk)
        err_y, err_h, holds = ssd_errors(got, want)
        if not holds:
            fail(f"ssd {label}: kernel differs from its plain version "
                 f"(y {err_y}, h_final {err_h})")
        max_y = float(want[0].float().abs().max())
        del got, want
        t = ssd_timings(ssd, xh, la, bm, cm, h0, chunk)
        flops, nbytes = ssd_work(b, s, h, p, n, chunk, xh.element_size())
        design = ssd_design_bytes(ssd, b, s, h, p, n, chunk, xh.element_size(),
                                  h0 is not None)
        peak, _ = op_rate(card, dtype)
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / bw * 1e3
        par = parent_rows.get(label, {})
        row = {
            "case": label,
            "shape": [b, s, h, p, n],
            "dtype": str(dtype).replace("torch.", ""),
            "chunk": chunk,
            "route": ssd.kernel_route(dtype),
            "max_abs_err": err_y,
            "h_final_max_abs_err": err_h,
            "max_abs_y": max_y,
            **t,
            "parent_ms": par.get("ms"),
            "parent_call_ms": par.get("call_ms"),
            "library_ms": None,
            "flops": flops,
            "bytes": nbytes,
            "design_bytes": design,
            "design_bytes_ms": design / bw * 1e3,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        }
        rows.append(row)
        log(
            f"ssd {label} {row['shape']} {row['dtype']} chunk {chunk} route "
            f"{row['route']}: ms={row['ms']:.4f} call_ms={row['call_ms']:.4f} "
            f"passes (ms) {row['pass_ms']} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
            f"the passes move {design / 1e6:.1f} MB, {row['design_bytes_ms']:.4f} ms) "
            f"plain_ms={row['plain_ms']:.3f} parent_ms={row['parent_ms']} "
            f"queued={row['queued']} max_abs_err y={err_y} h_final={err_h} "
            f"(max|y| {max_y:.3f}); library: none (no single PyTorch call "
            "computes this scan)"
        )
        del xh, la, bm, cm, h0
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 10: serve zamba2-1.2b at full width and depth
# ---------------------------------------------------------------------------

ZAMBA_ARGV = [
    "--arch", "zamba2-1.2b", "--full", "--batch", "4", "--prompt-len", "1024",
    "--new-tokens", "32", "--seed", str(SEED),
]
#: the reduced zamba2 (5 layers in groups 2+2+1, d 128, the shared block twice)
ZAMBA_SMALL_ARGV = [
    "--arch", "zamba2-1.2b", "--batch", "4", "--prompt-len", "64",
    "--new-tokens", "8", "--seed", str(SEED),
]


#: the zamba2 prefill's kernels by part (regexes over the profiler's names):
#: the SSD kernel's three passes, the flash kernel, cuBLAS's matrix products
ZAMBA_PREFILL_GROUPS = {
    **{f"ssd {name}": pat for name, pat in SSD_PASSES.items()},
    "flash attention": r"flash_(tc_)?kernel",
    "projections": r"gemm|gemv|xmma|cutlass|nvjet|sm90_",
}


class ShadowSSD:
    """Run every SSD call of the model on the kernel and, on the same inputs,
    on its plain version, and hold y and h_final to it (``SSD_TOL``; no
    argmax is involved, so no call is exempt).  The model goes on with the
    kernel's output.  Fails the run on any mismatch."""

    def __init__(self):
        self.calls = 0
        self.max_abs_err = self.h_final_max_abs_err = 0.0

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops = ops
        self._saved = ops.ssd_scan
        ops.ssd_scan = self.scan
        return self

    def __exit__(self, *exc):
        self._ops.ssd_scan = self._saved

    def scan(self, xh, la, Bm, Cm, h0=None, *, block_q=128):
        from repro_torch.kernels import ssd_scan as ssd

        got = ssd.ssd_scan(xh, la, Bm, Cm, h0, block_q=block_q)
        want = ssd.ssd_scan_plain(xh, la, Bm, Cm, h0, block_q=block_q)
        err_y, err_h, holds = ssd_errors(got, want)
        if not holds:
            fail(f"zamba2: ssd kernel differs from its plain version in the model "
                 f"on call {self.calls} {tuple(xh.shape)} (y {err_y}, h_final {err_h})")
        self.calls += 1
        self.max_abs_err = max(self.max_abs_err, err_y)
        self.h_final_max_abs_err = max(self.h_final_max_abs_err, err_h)
        return got

    def summary(self) -> dict:
        return {k: getattr(self, k) for k in (
            "calls", "max_abs_err", "h_final_max_abs_err")}


def zamba2_phase() -> dict:
    from repro_torch import serve_lm
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models.lm import layer_plan
    from repro_torch.serve_lm import serve

    cfg = registry.get("zamba2-1.2b")
    n_prompt, n_new = 1024, 32
    n_shared = len(layer_plan(cfg)) - 1
    # a first run warms cuBLAS and the kernels' libraries; its counts are reset
    t = time.perf_counter()
    cold = serve_lm.main(ZAMBA_ARGV)
    cold_s = time.perf_counter() - t
    del cold
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve_lm.main(ZAMBA_ARGV)
    counts = ops.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    want_counts = {
        "flash_attention": n_shared,
        "flash_attention_bwd": 0,
        "decode_attention": n_shared * (n_new - 1),
        "ssd_scan": cfg.n_layers,
        "ssd_scan_bwd": 0,
        "mlstm_scan": 0,
        "mlstm_scan_bwd": 0,
    }
    if counts != want_counts:
        fail(f"zamba2: kernel launches {counts}, expected {want_counts}")
    if res.tokens.shape != (4, n_new) or res.tokens.device.type != "cuda":
        fail(f"zamba2: tokens {tuple(res.tokens.shape)} on {res.tokens.device}")
    if int(res.tokens.max()) >= cfg.vocab_padded or int(res.tokens.min()) < 0:
        fail("zamba2: a token outside the padded vocab")
    if not all(bool(torch.isfinite(x).all())
               for x in [res.prefill_logits, *res.decode_logits]):
        fail("zamba2: non-finite logits")
    if res.prefill_logits.shape != (4, 1, cfg.vocab_padded):
        fail(f"zamba2: prefill logits {tuple(res.prefill_logits.shape)}")

    # the same weights and prompts; every kernel call held to its plain
    # version on the same inputs
    model, prompts = seeded(cfg, 4, n_prompt)
    n_params = sum(p.numel() for p in model.parameters())
    with ShadowSSD() as ssd_shadow, ShadowAttention() as attn_shadow:
        logits, caches = model.prefill({"tokens": prompts}, s_max=n_prompt + n_new)
        for t in range(4):
            logits, caches = model.decode(caches, res.tokens[:, t : t + 1], n_prompt + t)
        seq = torch.cat([prompts, res.tokens[:, : n_new - 1]], dim=1)
        with torch.no_grad():
            model.train_logits({"tokens": seq})
    if ssd_shadow.calls != 2 * cfg.n_layers:
        fail(f"zamba2: the shadow saw {ssd_shadow.calls} ssd calls")
    del caches, logits
    _, caches = model.prefill({"tokens": prompts}, s_max=n_prompt + n_new)
    step = device_ms(lambda: model.decode(caches, res.tokens[:, :1], n_prompt), 5)
    pre = device_ms(lambda: model.prefill({"tokens": prompts}, s_max=n_prompt + n_new), 2)
    del caches
    # the prefill's card time by part (torch.profiler), against the host clock
    # of the served run: the idle share
    pre_prof = device_profile(
        lambda: model.prefill({"tokens": prompts}, s_max=n_prompt + n_new)
    )
    prefill_split = split_kernels(pre_prof["kernels"], ZAMBA_PREFILL_GROUPS)
    # reported, not held: the shared block's attention is one-hot under the
    # reference init at this width (see the attention shadow's tie rows)
    full_e2e = end_to_end(model, res, prompts, n_new)
    del model
    torch.cuda.empty_cache()

    # the reduced zamba2 on the card.  In bf16 its shared block's attention
    # is one-hot under the reference init and a one-step rounding difference
    # upstream flips it (the reference's own bf16 decode misses the teacher-
    # forcing rule there), so bf16 is reported and f32 is held: against the
    # same model under ops.plain() and against teacher forcing
    small = serve_lm.main(ZAMBA_SMALL_ARGV)
    scfg = cfg.reduced()
    smodel, sprompts = seeded(scfg, 4, 64)
    small_e2e = end_to_end(smodel, small, sprompts, 8)
    del smodel, small
    fmodel, fprompts = seeded(scfg, 4, 64, torch.float32)
    fres = serve(fmodel, fprompts, 8)
    f32_e2e = end_to_end(fmodel, fres, fprompts, 8)
    for label, diff in f32_e2e.items():
        if not diff["holds"]:
            fail(f"zamba2 (reduced, f32): {label}: {diff}")
    del fmodel, fres
    # bf16 on tests/test_models.py's config for recurrent archs (2 layers,
    # no shared block): against ops.plain() by the rule, and decode within
    # 0.05 * max|logits| of teacher forcing
    rcfg = cfg.reduced(n_layers=2, shared_attn_every=2)
    rmodel, rprompts = seeded(rcfg, 4, 64)
    rres = serve(rmodel, rprompts, 8)
    rec_e2e = end_to_end(rmodel, rres, rprompts, 8)
    for label, diff in rec_e2e.items():
        ok = diff["holds"] if "vs plain" in label else (
            diff["max_abs_err"] < 0.05 * diff["scale"])
        if not ok:
            fail(f"zamba2 (2 layers): {label}: {diff}")
    del rmodel, rres

    n_dec = 4 * (n_new - 1)
    row = {
        "arch": cfg.name,
        "layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "params": n_params,
        "batch": 4,
        "prompt_len": n_prompt,
        "new_tokens": n_new,
        "cold_main_s": cold_s,
        "prefill_s": res.prefill_s,
        "decode_s": res.decode_s,
        "decode_tok_s": n_dec / res.decode_s,
        "ms_per_decode_step": res.decode_s / (n_new - 1) * 1e3,
        "peak_cuda_mb": peak_mb,
        "decode_step_device_ms": step["ms"],
        "decode_step_queued": step["queued"],
        "prefill_device_ms": pre["ms"],
        "prefill_queued": pre["queued"],
        "prefill_profile": pre_prof,
        "prefill_split_ms": prefill_split,
        "prefill_idle_share": 1 - pre_prof["device_ms"] / (res.prefill_s * 1e3),
        "launches": counts,
        "ssd_shadow": ssd_shadow.summary(),
        "attention_shadow": attn_shadow.summary(),
        "full_end_to_end": full_e2e,
        "reduced_end_to_end": small_e2e,
        "reduced_f32_end_to_end": f32_e2e,
        "two_layer_end_to_end": rec_e2e,
        "sample": res.tokens[0].tolist(),
    }
    log(
        f"zamba2 serve {cfg.name} ({n_params} params, {cfg.n_layers} Mamba-2 "
        f"layers + shared block x{n_shared}, d {cfg.d_model}) 4x{n_prompt} + "
        f"{n_new} tokens: prefill_s={res.prefill_s:.4f} decode_s={res.decode_s:.4f} "
        f"decode_tok_s={row['decode_tok_s']:.1f} "
        f"ms_per_step={row['ms_per_decode_step']:.3f} peak_cuda_MB={peak_mb:.1f} "
        f"cold_main_s={cold_s:.2f} launches={counts}"
    )
    log(
        f"zamba2 device time (queued): decode step {step['ms']:.3f} ms "
        f"(queued={step['queued']}), prefill {pre['ms']:.3f} ms "
        f"(queued={pre['queued']})"
    )
    log(
        f"zamba2 prefill's kernels (torch.profiler): {pre_prof['device_ms']:.3f} ms "
        f"({pre_prof['launches']} launches; idle share {row['prefill_idle_share']:.3f})"
        "; by part (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in prefill_split.items())
    )
    log(f"zamba2 prefill's top kernels (ms): {pre_prof['top']}")
    log(f"zamba2 ssd shadow (kernel vs plain on every call): {ssd_shadow.summary()}")
    log(f"zamba2 attention shadow: {attn_shadow.summary()}")
    for name, e2e in (("full-size", full_e2e), ("reduced bf16", small_e2e),
                      ("reduced f32", f32_e2e), ("2-layer bf16", rec_e2e)):
        worst = max(e2e.items(), key=lambda kv: kv[1]["max_abs_err"])
        n_hold = sum(d["holds"] for d in e2e.values())
        log(f"zamba2 {name} logits rule: {n_hold}/{len(e2e)} hold at 0.02; "
            f"worst {worst[0]}: {worst[1]}")
    return row


# ---------------------------------------------------------------------------
# Phase 11: the mLSTM scan kernel against its plain version
# ---------------------------------------------------------------------------

#: mLSTM cases: (label, B, S, H, D, chunk, dtype, inputs); "state" adds an
#: initial (C, n, m), "steep" draws lf near -10 and li with std 4
MLSTM_CASES = [
    ("xlstm-1.3b prefill", 4, 1024, 4, 1024, 128, torch.bfloat16, None),
    ("xlstm-1.3b prefill f32", 4, 1024, 4, 1024, 128, torch.float32, None),
    ("ragged tail S 1000", 4, 1000, 4, 1024, 128, torch.bfloat16, None),
    ("one position S 1", 4, 1, 4, 1024, 128, torch.bfloat16, None),
    ("long context S 16384", 1, 16384, 4, 1024, 128, torch.bfloat16, None),
    ("reduced D 64, chunk 16", 4, 1024, 4, 64, 16, torch.bfloat16, None),
    ("initial state", 4, 1024, 4, 1024, 128, torch.bfloat16, "state"),
    ("steep gates", 4, 1024, 4, 1024, 128, torch.bfloat16, "steep"),
]
#: h and the final C, n, m against the plain version: rtol 1e-3 and atol
#: 1e-3 * max|plain| each.  Both sides read the same inputs and sum in f32
#: in another order (the kernel's prefix sums of the gates, its tiles of D);
#: sums of up to 1024 terms per product, and exponents of prefix sums that
#: reach ~1e3 at steep gates, move the last digits of f32.
MLSTM_RTOL = 1e-3


def mlstm_errors(got, want) -> tuple:
    """({name: max abs err}, holds) for h, C, n, m under ``MLSTM_RTOL``."""
    (h, (c, n, m)), (h_p, (c_p, n_p, m_p)) = got, want
    errs, holds = {}, True
    for name, g, w in (("h", h, h_p), ("C", c, c_p), ("n", n, n_p), ("m", m, m_p)):
        errs[name] = float((g - w).abs().max())
        atol = MLSTM_RTOL * float(w.abs().max())
        holds = holds and bool(torch.isfinite(g).all()) and torch.allclose(
            g, w, rtol=MLSTM_RTOL, atol=atol
        )
    return errs, bool(holds)


def mlstm_work(b, s, h, d, chunk, elem, with_state: bool) -> tuple:
    """(operations, bytes) one scan needs: per (b, h) and chunk of n_q real
    positions, 2 n_q D² each for q C̃ and the update (k ⊙ wgt)ᵀ v, and
    D n_q (n_q + 1) each for q kᵀ and W v over the causal triangle; q, k, v
    in the input dtype and lf, li, h and the final state in f32, each read
    or written once (the initial state too, where one is given)."""
    flops = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        flops += 4 * q * d * d + 2 * d * q * (q + 1)
    flops *= b * h
    state = (b * h * d * d + b * h * d + b * h) * 4
    nbytes = 3 * b * s * h * d * elem + 2 * b * s * h * 4 + b * s * h * d * 4 + state
    return flops, nbytes + (state if with_state else 0)


def mlstm_inputs(gen, b, s, h, d, dtype, kind) -> tuple:
    """q, k (scaled by 1/√D), v, lf, li and the optional initial state."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    q, k, v = randn(b, s, h, d), randn(b, s, h, d) / math.sqrt(d), randn(b, s, h, d)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if kind == "steep":
        lf, li = -10.0 + 0.1 * randn(b, s, h), 4.0 * randn(b, s, h)
    else:
        # tests/test_kernels.py's gates
        lf, li = F.logsigmoid(2.0 * randn(b, s, h)), randn(b, s, h)
    state = None
    if kind == "state":
        state = (0.1 * randn(b, h, d, d), 0.1 * randn(b, h, d), randn(b, h))
    return q, k, v, lf, li, state


def mlstm_phase(card: str) -> list:
    from repro_torch.kernels import mlstm_scan as ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    bw, _ = memory_rate(card)
    rows = []
    for label, b, s, h, d, chunk, dtype, kind in MLSTM_CASES:
        q, k, v, lf, li, state = mlstm_inputs(gen, b, s, h, d, dtype, kind)

        def kernel():
            return ms.mlstm_scan(q, k, v, lf, li, state, block_q=chunk)

        def plain():
            return ms.mlstm_scan_plain(q, k, v, lf, li, state, block_q=chunk)

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        errs, holds = mlstm_errors(got, want)
        if not holds:
            fail(f"mlstm {label}: kernel differs from its plain version ({errs})")
        max_h = float(want[0].abs().max())
        del got, want
        k_t, p_t = device_ms(kernel, 10), device_ms(plain, 3)
        flops, nbytes = mlstm_work(b, s, h, d, chunk, q.element_size(), state is not None)
        peak, _ = op_rate(card, dtype)
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / bw * 1e3
        row = {
            "case": label,
            "shape": [b, s, h, d],
            "dtype": str(dtype).replace("torch.", ""),
            "chunk": chunk,
            "route": ms.kernel_route(dtype, d),
            "max_abs_err": max(errs.values()),
            "errors": errs,
            "max_abs_h": max_h,
            "ms": k_t["ms"],
            "call_ms": cuda_ms(kernel, 10),
            "plain_ms": p_t["ms"],
            "queued": k_t["queued"] and p_t["queued"],
            "library_ms": None,
            "flops": flops,
            "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        }
        rows.append(row)
        log(
            f"mlstm {label} {row['shape']} {row['dtype']} chunk {chunk} "
            f"route {row['route']}: "
            f"ms={row['ms']:.4f} call_ms={row['call_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
            f"plain_ms={row['plain_ms']:.3f} queued={row['queued']} "
            f"max_abs_err {errs} (max|h| {max_h:.3f}); "
            "library: none (no single PyTorch call computes this scan)"
        )
        del q, k, v, lf, li, state
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 12: serve xlstm-1.3b at full width and depth
# ---------------------------------------------------------------------------

XLSTM_ARGV = [
    "--arch", "xlstm-1.3b", "--full", "--batch", "4", "--prompt-len", "1024",
    "--new-tokens", "32", "--seed", str(SEED),
]
#: the reduced xlstm (4 mLSTM layers, d 128, 4 heads of 64, chunks of 16)
XLSTM_SMALL_ARGV = [
    "--arch", "xlstm-1.3b", "--batch", "4", "--prompt-len", "64",
    "--new-tokens", "8", "--seed", str(SEED),
]


#: the xlstm prefill's kernels by part (regexes over the profiler's names):
#: the mLSTM kernel's three passes, then cuBLAS's matrix products
XLSTM_PREFILL_GROUPS = {
    "mlstm state pass": r"state_(tc_)?kernel",
    "mlstm W pass": r"w_(tc_)?kernel",
    "mlstm gate pass": r"gate_kernel",
    "projections": r"gemm|gemv|xmma|cutlass|nvjet|sm90_",
}


class ShadowMLSTM:
    """Run every mLSTM call of the model on the kernel and, on the same
    inputs, on its plain version, and hold h and the final state to it
    (``mlstm_errors``).  The model goes on with the kernel's output.  Fails
    the run on any mismatch."""

    def __init__(self):
        self.calls = 0
        self.errors = {}

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops = ops
        self._saved = ops.mlstm_scan
        ops.mlstm_scan = self.scan
        return self

    def __exit__(self, *exc):
        self._ops.mlstm_scan = self._saved

    def scan(self, q, k, v, lf, li, state=None, *, block_q=128):
        from repro_torch.kernels import mlstm_scan as ms

        got = ms.mlstm_scan(q, k, v, lf, li, state, block_q=block_q)
        want = ms.mlstm_scan_plain(q, k, v, lf, li, state, block_q=block_q)
        errs, holds = mlstm_errors(got, want)
        if not holds:
            fail(f"xlstm: mlstm kernel differs from its plain version in the model "
                 f"on call {self.calls} {tuple(q.shape)} ({errs})")
        self.calls += 1
        for name, err in errs.items():
            self.errors[name] = max(self.errors.get(name, 0.0), err)
        return got

    def summary(self) -> dict:
        return {"calls": self.calls, "max_abs_err": self.errors}


def xlstm_phase() -> dict:
    from repro_torch import serve_lm
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.serve_lm import serve

    cfg = registry.get("xlstm-1.3b")
    n_prompt, n_new = 1024, 32
    # a first run warms cuBLAS and the kernels' libraries; its counts are reset
    t = time.perf_counter()
    cold = serve_lm.main(XLSTM_ARGV)
    cold_s = time.perf_counter() - t
    del cold
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve_lm.main(XLSTM_ARGV)
    counts = ops.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    want_counts = {
        "flash_attention": 0,
        "flash_attention_bwd": 0,
        "decode_attention": 0,
        "ssd_scan": 0,
        "ssd_scan_bwd": 0,
        "mlstm_scan": cfg.n_layers,
        "mlstm_scan_bwd": 0,
    }
    if counts != want_counts:
        fail(f"xlstm: kernel launches {counts}, expected {want_counts}")
    if res.tokens.shape != (4, n_new) or res.tokens.device.type != "cuda":
        fail(f"xlstm: tokens {tuple(res.tokens.shape)} on {res.tokens.device}")
    if int(res.tokens.max()) >= cfg.vocab_padded or int(res.tokens.min()) < 0:
        fail("xlstm: a token outside the padded vocab")
    if not all(bool(torch.isfinite(x).all())
               for x in [res.prefill_logits, *res.decode_logits]):
        fail("xlstm: non-finite logits")
    if res.prefill_logits.shape != (4, 1, cfg.vocab_padded):
        fail(f"xlstm: prefill logits {tuple(res.prefill_logits.shape)}")

    # the same weights and prompts; every kernel call held to its plain
    # version on the same inputs
    model, prompts = seeded(cfg, 4, n_prompt)
    n_params = sum(p.numel() for p in model.parameters())
    with ShadowMLSTM() as shadow:
        logits, caches = model.prefill({"tokens": prompts}, s_max=n_prompt + n_new)
        for t in range(4):
            logits, caches = model.decode(caches, res.tokens[:, t : t + 1], n_prompt + t)
        seq = torch.cat([prompts, res.tokens[:, : n_new - 1]], dim=1)
        with torch.no_grad():
            model.train_logits({"tokens": seq})
    if shadow.calls != 2 * cfg.n_layers:
        fail(f"xlstm: the shadow saw {shadow.calls} mlstm calls")
    del caches, logits
    # the card's busy time in a prefill and a decode step (torch.profiler),
    # against the host clock of the served run: the idle shares
    pre = device_profile(
        lambda: model.prefill({"tokens": prompts}, s_max=n_prompt + n_new)
    )
    _, caches = model.prefill({"tokens": prompts}, s_max=n_prompt + n_new)
    step = device_profile(lambda: model.decode(caches, res.tokens[:, :1], n_prompt))
    del caches
    torch.cuda.empty_cache()
    prefill_split = split_kernels(pre["kernels"], XLSTM_PREFILL_GROUPS)
    # reported: in bf16 at this width and depth the random model is chaotic
    # (a one-step rounding difference grows through 48 layers; the JAX
    # reference's own bf16 decode drifts the same way), so the decode path
    # at full width is also held in f32, where the rule is well posed
    full_e2e = end_to_end(model, res, prompts, n_new)
    del model
    torch.cuda.empty_cache()
    fmodel, fprompts = seeded(cfg, 4, n_prompt, torch.float32)
    fres = serve(fmodel, fprompts, 8)
    full_f32_e2e = end_to_end(fmodel, fres, fprompts, 8)
    for label, diff in full_f32_e2e.items():
        if not diff["holds"]:
            fail(f"xlstm (full width, f32): {label}: {diff}")
    del fmodel, fres
    torch.cuda.empty_cache()

    # the reduced xlstm on the card: in bf16 against the same model under
    # ops.plain() by the rule, and decode within 0.05 * max|logits| of
    # teacher forcing (tests/test_models.py's rule for recurrent archs);
    # in f32 against both by the rule
    small = serve_lm.main(XLSTM_SMALL_ARGV)
    scfg = cfg.reduced()
    smodel, sprompts = seeded(scfg, 4, 64)
    small_e2e = end_to_end(smodel, small, sprompts, 8)
    for label, diff in small_e2e.items():
        ok = diff["holds"] if "vs plain" in label else (
            diff["max_abs_err"] < 0.05 * diff["scale"])
        if not ok:
            fail(f"xlstm (reduced, bf16): {label}: {diff}")
    del smodel, small
    fmodel, fprompts = seeded(scfg, 4, 64, torch.float32)
    fres = serve(fmodel, fprompts, 8)
    f32_e2e = end_to_end(fmodel, fres, fprompts, 8)
    for label, diff in f32_e2e.items():
        if not diff["holds"]:
            fail(f"xlstm (reduced, f32): {label}: {diff}")
    del fmodel, fres

    n_dec = 4 * (n_new - 1)
    row = {
        "arch": cfg.name,
        "layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "params": n_params,
        "batch": 4,
        "prompt_len": n_prompt,
        "new_tokens": n_new,
        "cold_main_s": cold_s,
        "prefill_s": res.prefill_s,
        "decode_s": res.decode_s,
        "decode_tok_s": n_dec / res.decode_s,
        "ms_per_decode_step": res.decode_s / (n_new - 1) * 1e3,
        "peak_cuda_mb": peak_mb,
        "decode_step_profile": step,
        "decode_idle_share": 1 - step["device_ms"] / (res.decode_s / (n_new - 1) * 1e3),
        "prefill_profile": pre,
        "prefill_split_ms": prefill_split,
        "prefill_idle_share": 1 - pre["device_ms"] / (res.prefill_s * 1e3),
        "launches": counts,
        "mlstm_shadow": shadow.summary(),
        "full_end_to_end": full_e2e,
        "full_f32_end_to_end": full_f32_e2e,
        "reduced_end_to_end": small_e2e,
        "reduced_f32_end_to_end": f32_e2e,
        "sample": res.tokens[0].tolist(),
    }
    log(
        f"xlstm serve {cfg.name} ({n_params} params, {cfg.n_layers} mLSTM layers, "
        f"d {cfg.d_model}) 4x{n_prompt} + {n_new} tokens: "
        f"prefill_s={res.prefill_s:.4f} decode_s={res.decode_s:.4f} "
        f"decode_tok_s={row['decode_tok_s']:.1f} "
        f"ms_per_step={row['ms_per_decode_step']:.3f} peak_cuda_MB={peak_mb:.1f} "
        f"cold_main_s={cold_s:.2f} launches={counts}"
    )
    log(
        f"xlstm device time (torch.profiler): prefill {pre['device_ms']:.3f} ms "
        f"({pre['launches']} launches; idle share {row['prefill_idle_share']:.3f}), "
        f"decode step {step['device_ms']:.3f} ms ({step['launches']} launches; "
        f"idle share {row['decode_idle_share']:.3f})"
    )
    log(f"xlstm prefill's top kernels (ms): {pre['top']}")
    log("xlstm prefill's card time by part (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in prefill_split.items()))
    log(f"xlstm decode step's top kernels (ms): {step['top']}")
    log(f"xlstm mlstm shadow (kernel vs plain on every call): {shadow.summary()}")
    for name, e2e in (("full-size", full_e2e), ("full-size f32", full_f32_e2e),
                      ("reduced bf16", small_e2e), ("reduced f32", f32_e2e)):
        worst = max(e2e.items(), key=lambda kv: kv[1]["max_abs_err"])
        n_hold = sum(d["holds"] for d in e2e.values())
        log(f"xlstm {name} logits rule: {n_hold}/{len(e2e)} hold at 0.02; "
            f"worst {worst[0]}: {worst[1]}")
    return row


# ---------------------------------------------------------------------------
# Phase 14: the Benchpark sweeps and the paper's figures
# ---------------------------------------------------------------------------

#: seconds the smoke sweep's own process may take
SMOKE_TIMEOUT_S = 420


def _cold_start_probe(t_submit: float) -> dict:
    """Runs in a fresh sweep-pool worker: the seconds to start it, to import
    the runner and the four apps, to open a CUDA context, then the first
    and a second (warm) trace + reduction of kripke's 64-rank paper point
    on the card."""
    t0 = time.time()
    preloaded = "torch" in sys.modules and "repro_torch" in sys.modules
    from dataclasses import replace

    from repro_torch.benchpark import runner
    from repro_torch.benchpark.spec import PAPER_EXPERIMENTS

    runner.app_profile_fns()
    t1 = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t2 = time.time()
    spec = PAPER_EXPERIMENTS["kripke-weak-dane"]
    spec = replace(spec, points=spec.points[:1])
    points = []
    for _ in range(2):
        t = time.time()
        (prof,) = runner.run_experiment(spec, verbose=False, executor="serial")
        points.append(time.time() - t)
    return {
        "start_s": t0 - t_submit,
        "repro_torch_preloaded": preloaded,
        "import_s": t1 - t0,
        "cuda_context_s": t2 - t1,
        "first_point_s": points[0],
        "second_point_s": points[1],
        "n_ranks": prof.n_ranks,
    }


def _files(root: Path) -> dict:
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(root.rglob("*"))
        if p.is_file()
    }


def _pool_against_serial(card) -> dict:
    """kripke-weak-dane's four points, uncached: each point alone on the
    serial executor, then the whole sweep on a fresh process pool."""
    from dataclasses import replace
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.benchpark.runner import RetryLog, _pool_mp_context, run_experiment
    from repro_torch.benchpark.spec import PAPER_EXPERIMENTS

    with ProcessPoolExecutor(max_workers=1, mp_context=_pool_mp_context()) as ex:
        probe = ex.submit(_cold_start_probe, time.time()).result()
    log(f"sweeps worker cold start: {probe}")
    spec = PAPER_EXPERIMENTS["kripke-weak-dane"]
    rlog = RetryLog()
    serial, serial_profs = [], []
    for pt in spec.points:
        t = time.perf_counter()
        serial_profs += run_experiment(
            replace(spec, points=(pt,)), verbose=False, executor="serial",
            backend=card, retry_log=rlog,
        )
        serial.append(time.perf_counter() - t)
    t = time.perf_counter()
    pool_profs = run_experiment(
        spec, verbose=False, executor="process", backend=card, retry_log=rlog
    )
    pool_s = time.perf_counter() - t
    if rlog.events or any(p.meta.get("degraded") for p in serial_profs + pool_profs):
        fail(f"sweeps: a fault-free pass has degraded points or retries: {rlog.events}")
    if [p.to_json() for p in pool_profs] != [p.to_json() for p in serial_profs]:
        fail("sweeps: the process pool's profiles differ from the serial ones")
    row = {
        "cold_start": probe,
        "ranks": [pt.n_ranks for pt in spec.points],
        "serial_point_s": serial,
        "serial_s": sum(serial),
        "pool_s": pool_s,
        "pool_workers": min(4, len(spec.points)),
    }
    log(f"sweeps kripke-weak-dane uncached: serial a point {serial} "
        f"(sum {sum(serial):.3f} s), process pool {pool_s:.3f} s")
    return row


def sweeps_phase() -> dict:
    import contextlib
    import io
    import os
    import resource
    import tempfile

    from repro_torch.benchpark.runner import CacheManifest
    from repro_torch.core.backend import TorchBackend, resolve_backend
    from repro_torch.figures import paper_data
    from repro_torch.figures.run import run_chaos, run_figures, run_live

    card = resolve_backend(None)
    if not (isinstance(card, TorchBackend) and card.device.type == "cuda"):
        fail(f"the default backend is {card!r}, not torch on the card")
    out = OUT_DIR / "sweeps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    work = Path(tempfile.mkdtemp(prefix="sweeps-"))
    row: dict = {}
    seconds: dict = {}

    # (a) smoke: its own process, so its peak RSS is the sweeps' own
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_PROFILE_CACHE_DIR=str(work / "smoke-cache"))
    env.pop("REPRO_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.figures.run", "--smoke",
         "--backend", "torch", "--out", str(out / "smoke")],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=SMOKE_TIMEOUT_S,
    )
    seconds["smoke"] = time.perf_counter() - t
    (out / "smoke.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"sweeps smoke exited {proc.returncode}: {proc.stderr[-3000:]}")
    smoke = json.loads((out / "smoke" / "smoke_summary.json").read_text())
    if (smoke["first_pass_misses"], smoke["cached_pass_hits"]) != (4, 4):
        fail(f"sweeps smoke: a fresh cache should miss 4 then hit 4: {smoke}")
    if "cuda" not in smoke["backend"] or "numpy" not in smoke["other_backend"]:
        fail(f"sweeps smoke compared {smoke['backend']} with {smoke['other_backend']}")
    row["smoke"] = smoke
    last = proc.stdout.strip().splitlines()[-1]
    log(f"sweeps (a) smoke: {seconds['smoke']:.1f} s; {last}")

    # worker cold start and per-point seconds, pool against serial
    t = time.perf_counter()
    row["pool_vs_serial"] = _pool_against_serial(card)
    seconds["pool_vs_serial"] = time.perf_counter() - t

    # (b) live and (c) chaos on the card
    for name, fn in (("live", run_live), ("chaos", run_chaos)):
        t = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            row[name] = fn(str(out / name), backend=card)
        seconds[name] = time.perf_counter() - t
        log(f"sweeps ({'b' if name == 'live' else 'c'}) {name}: "
            f"{seconds[name]:.1f} s; {buf.getvalue().strip()}")
    if "pool_broken" not in row["chaos"]["event_kinds"]:
        fail(f"sweeps chaos: the hard worker crash left no trace: {row['chaos']}")

    # (d) the figures on the card, then the same drivers on NumPy
    figures = {}
    prev = {k: os.environ.get(k) for k in ("REPRO_BACKEND", "REPRO_PROFILE_CACHE_DIR")}
    try:
        for name, backend_env in (("card", None), ("numpy", "numpy")):
            os.environ.pop("REPRO_BACKEND", None)
            if backend_env:
                os.environ["REPRO_BACKEND"] = backend_env
            cache = work / f"figures-cache-{name}"
            os.environ["REPRO_PROFILE_CACHE_DIR"] = str(cache)
            t = time.perf_counter()
            with open(out / f"figures_{name}.csv", "w") as f, \
                    contextlib.redirect_stdout(f):
                rows = run_figures(results=str(out / f"figures_{name}"))
            seconds[f"figures_{name}"] = time.perf_counter() - t
            figures[name] = {
                "rows": len(rows), "manifest": CacheManifest(str(cache)).read()
            }
    finally:
        for k, v in prev.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    paper_data.profiles.cache_clear()
    got = _files(out / "figures_card")
    want = _files(out / "figures_numpy")
    if set(got) != set(want):
        fail(f"sweeps figures: the card wrote {sorted(set(got) ^ set(want))} apart")
    differ = [k for k in got if got[k] != want[k]]
    if differ:
        fail(f"sweeps figures: card and NumPy files differ: {differ}")
    md = sorted(k for k in got if k.endswith(".md"))
    if len(md) != 9 or "roofline.md" not in md:
        fail(f"sweeps figures: expected 9 markdown files (the roofline's among "
             f"them), found {md}")
    figures["files"] = len(got)
    figures["markdown"] = md
    row["figures"] = figures
    log(f"sweeps (d) figures: card {seconds['figures_card']:.1f} s, NumPy "
        f"{seconds['figures_numpy']:.1f} s; {len(got)} files byte-equal "
        f"({', '.join(md)})")
    shutil.rmtree(work, ignore_errors=True)
    row["seconds"] = seconds
    peak_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    row["parent_peak_rss_mb"] = peak_kib / 1024.0
    log(f"sweeps seconds: {seconds}; smoke peak RSS {smoke['peak_rss_mb']:.0f} MiB, "
        f"{smoke['sweep_rss_mb']:.0f} above the {smoke['start_rss_mb']:.0f} "
        "it started with")
    return row


# ---------------------------------------------------------------------------
# Phase 15: the apps across ranks over torch.distributed; the compiled layer
# ---------------------------------------------------------------------------

def _held(label: str, res: dict, apps, smi: str) -> list:
    """Each app's driver against its oracle at ``multirank.TOLERANCES``, and
    the profile recorded during the run against the meta trace's."""
    from repro_torch.apps import multirank

    rows = []
    for app in apps:
        row = multirank.check(app, res[app])
        row["shapes"] = [list(o.shape) for o in res[app]["out"]]
        if not row["within_tolerance"]:
            fail(f"{label} {app}: the driver differs from the oracle "
                 f"(max {row['max_abs_err']})")
        if not row["profile_equal"]:
            fail(f"{label} {app}: the profile recorded in the run differs from the "
                 "meta trace's")
        rows.append(row)
        log(f"distributed {label} {app}: driver_s={row['driver_s']:.4f} "
            f"(cold {row['driver_cold_s']:.4f}) oracle_s={row['oracle_s']:.4f} "
            f"(cold {row['oracle_cold_s']:.4f}) max_abs_err={row['max_abs_err']} "
            f"profile equal to the meta trace's [{smi}]")
    return rows


def distributed_phase(rt, smi: str) -> dict:
    from repro_torch.apps import multirank
    from repro_torch.core import reports
    from repro_torch.core.backend import NumpyBackend, resolve_backend
    from repro_torch.core.hlo import scan_graph_collectives
    from repro_torch.core.ranks import run_ranks
    from repro_torch.core.thicket import Frame
    from repro_torch.figures import fig7_hlo_vs_traced

    out: dict = {}
    # (a) NCCL at world size 1 on the card, each app at its paper rank size
    t = time.perf_counter()
    params = multirank.ONE_RANK_PARAMS
    res = run_ranks(multirank.run_apps, 1, args=(params,))
    out["nccl_world_1"] = {"seconds": time.perf_counter() - t,
                           "apps": _held("(a) nccl world 1", res, params, smi),
                           "ranks": res["ranks"]}
    log(f"distributed (a) nccl world 1: {out['nccl_world_1']['seconds']:.1f} s for "
        f"the call, rank peak RSS {res['ranks'][0]['peak_rss_mb']:.0f} MiB (of "
        f"VmRSS samples) [{smi}]")

    # (b) gloo, 8 ranks, CPU tensors on the card's host
    params = {a: multirank.PARITY_PARAMS[a] for a in ("kripke", "laghos")}
    t_call = time.time()
    res = run_ranks(multirank.run_apps, 8, backend="gloo", args=(params, "cpu"))
    t_back = time.time()
    stats = res["ranks"]
    spawn_s = max(s["t_enter"] for s in stats) - t_call
    join_s = t_back - max(s["t_exit"] for s in stats)
    out["gloo_8_cpu"] = {
        "apps": _held("(b) gloo 8 ranks, CPU", res, params, smi),
        "spawn_s": spawn_s, "join_s": join_s, "call_s": t_back - t_call,
        "peak_rss_mb": [s["peak_rss_mb"] for s in stats],
    }
    log(f"distributed (b) gloo 8 ranks, CPU tensors: spawn (start, import, "
        f"rendezvous) {spawn_s:.2f} s, join {join_s:.2f} s, call {t_back - t_call:.2f} "
        f"s; peak RSS a rank (MiB, of VmRSS samples) "
        f"{[round(s['peak_rss_mb']) for s in stats]}")

    # (c) the compiled layer: fig 7's kripke-8 and the four apps at 8 ranks
    card = resolve_backend(None)
    entries, layer = [], {}
    t = time.perf_counter()
    prof, _rec, buf = fig7_hlo_vs_traced.layers(backend=card)
    fig7_entries = [(prof.name, prof.n_ranks, buf, {"app": "kripke"})]
    entries += fig7_entries
    layer["fig7-kripke-8"] = {"ops": buf.n_ops, "wire_bytes": int(buf.wire_bytes.sum())}
    if (buf.n_ops, int(buf.wire_bytes.sum()), buf.region_names) != (
            3, 3072, ["sweep_comm"]):
        fail(f"compiled layer: fig 7's kripke-8 is {layer['fig7-kripke-8']}, "
             "not 3 ops and 3072 wire bytes in sweep_comm")
    for app, p in multirank.PARITY_PARAMS.items():
        cfg = multirank.app_config(app, p)
        x = multirank.app_inputs(app, cfg, torch.device("cpu"))
        b = scan_graph_collectives(multirank.app_driver(app, cfg), x,
                                   mesh=cfg.decomp.make_mesh(),
                                   total_devices=cfg.decomp.n_ranks)
        entries.append((f"{app}-8", 8, b, {"app": app}))
        layer[app] = {"ops": b.n_ops, "wire_bytes": int(b.wire_bytes.sum())}
    capture_s = time.perf_counter() - t
    before = rt.launch_count()
    got, card_s = _timed(lambda: Frame.from_hlo(entries, backend=card).to_csv())
    launches = rt.launch_count() - before
    want, numpy_s = _timed(lambda: Frame.from_hlo(entries, backend=NumpyBackend()).to_csv())
    if got != want:
        fail("compiled layer: Frame.from_hlo on the card differs from NumPy")
    if launches <= 0:
        fail("compiled layer: the segmented-reduce kernel was not launched")

    def fig7(be):
        return (reports.hlo_vs_traced([prof], fig7_entries, backend=be),
                Frame.concat([Frame.from_profiles([prof]),
                              Frame.from_hlo(fig7_entries, backend=be)]).to_csv())

    if fig7(card) != fig7(NumpyBackend()):
        fail("compiled layer: fig 7's markdown or CSV differs between the card and NumPy")
    (OUT_DIR / "fig7_card.md").write_text("\n\n".join(fig7(card)))
    out["compiled_layer"] = {"layers": layer, "capture_s": capture_s,
                             "card_s": card_s, "numpy_s": numpy_s,
                             "frame_rows": len(got.splitlines()) - 1,
                             "launches": launches}
    log(f"distributed (c) compiled layer: {layer}; captured in {capture_s:.2f} s; "
        f"Frame.from_hlo card_s={card_s:.4f} numpy_s={numpy_s:.4f}, byte-equal, "
        f"segment_reduce launches={launches}; fig 7 equal on the card and NumPy [{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase 16: serve the MLA, MoE, VLM and encoder-decoder families
# ---------------------------------------------------------------------------

#: (arch, the published config?, stub sizes: serve_lm's --vision-tokens /
#: --source-frames); the first is the smallest published model, served
#: cold and then warm
FAMILY_SERVES = [
    ("seamless-m4t-medium", True, {"source_frames": 1024}),
    ("minicpm3-4b", True, {}),
    ("granite-moe-3b-a800m", True, {}),
    ("qwen2-vl-7b", True, {"vision_tokens": 256}),
    # about 628 GB of bf16 weights at the published size: reduced only
    ("grok-1-314b", False, {}),
]
FAMILY_PROMPT, FAMILY_NEW = 1024, 32


def family_launches(cfg, n_new: int) -> dict:
    """The kernel launches a serve of ``cfg`` makes (prefill + n_new - 1
    steps): flash for each attention of the prefill (an encoder-decoder's
    encoder layers, then each decoder layer's self- and cross-attention),
    decode for each of a step's; MLA runs on einsums, no kernel."""
    steps = n_new - 1
    if cfg.family in ("encdec", "audio"):
        flash, per_step = cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    elif cfg.mla is not None:
        flash = per_step = 0
    else:
        flash = per_step = cfg.n_layers
    return {"flash_attention": flash, "flash_attention_bwd": 0,
            "decode_attention": per_step * steps, "ssd_scan": 0, "ssd_scan_bwd": 0,
            "mlstm_scan": 0, "mlstm_scan_bwd": 0}


def _family_serve(arch: str, full: bool, stub: dict, cold: bool) -> dict:
    """Serve one model through serve_lm.main; check its launches, tokens
    and logits; hold every attention call of a prefill and 4 decode steps
    of the same model to its plain version; time a decode step's card work;
    hold the reduced config's bf16 decode to teacher forcing."""
    from repro_torch import serve_lm
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.serve_lm import serve

    cfg = registry.get(arch) if full else registry.get(arch).reduced()
    n_prompt, n_new = FAMILY_PROMPT, FAMILY_NEW
    argv = ["--arch", arch, "--batch", "4", "--prompt-len", str(n_prompt),
            "--new-tokens", str(n_new), "--seed", str(SEED)]
    argv += ["--full"] if full else []
    for key, n in stub.items():
        argv += ["--" + key.replace("_", "-"), str(n)]
    cold_s = None
    if cold:
        t = time.perf_counter()
        cold_res = serve_lm.main(argv)
        cold_s = time.perf_counter() - t
        del cold_res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = serve_lm.main(argv)
    main_s = time.perf_counter() - t
    counts = ops.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    want = family_launches(cfg, n_new)
    if counts != want:
        fail(f"families {arch}: kernel launches {counts}, expected {want}")
    if res.tokens.shape != (4, n_new) or res.tokens.device.type != "cuda":
        fail(f"families {arch}: tokens {tuple(res.tokens.shape)} on {res.tokens.device}")
    if int(res.tokens.max()) >= cfg.vocab_padded or int(res.tokens.min()) < 0:
        fail(f"families {arch}: a token outside the padded vocab")
    if not all(bool(torch.isfinite(x).all())
               for x in [res.prefill_logits, *res.decode_logits]):
        fail(f"families {arch}: non-finite logits")
    if res.prefill_logits.shape != (4, 1, cfg.vocab_padded):
        fail(f"families {arch}: prefill logits {tuple(res.prefill_logits.shape)}")

    model, prompts, inputs = seeded_batch(cfg, 4, n_prompt, **stub)
    n_params = sum(p.numel() for p in model.parameters())
    start = res.start
    batch = {"tokens": prompts, **inputs}
    with ShadowAttention() as shadow:
        _, caches = model.prefill(batch, s_max=start + n_new)
        for t in range(4):
            _, caches = model.decode(caches, res.tokens[:, t : t + 1], start + t)
    per_step = want["decode_attention"] // (n_new - 1)
    if shadow.calls != want["flash_attention"] + 4 * per_step:
        fail(f"families {arch}: the shadow saw {shadow.calls} attention calls")
    # the card's work in a decode step and a prefill (torch.profiler), against
    # the host clock of the served run: the idle shares
    step = device_profile(lambda: model.decode(caches, res.tokens[:, 4:5], start + 4))
    del caches
    pre = device_profile(lambda: model.prefill(batch, s_max=start + n_new))
    del model, batch, inputs
    torch.cuda.empty_cache()

    # the reduced config end to end (MoE with ample capacity: at the
    # published factor a 4-token step drops tokens, in the reference too).
    # f32 is held.  bf16 is held where the rule can tell right from wrong:
    # where the plain model's own logits stay inside it when every attention
    # output moves by an f32-level 1e-6 (``rule_probe``); elsewhere a bf16
    # rounding flipped upstream (or a near-tie in the router) moves the
    # logits past the rule whatever the kernels do, and bf16 is reported
    rcfg = registry.get(arch).reduced()
    if rcfg.moe is not None:
        rcfg = replace(rcfg, moe=replace(rcfg.moe, capacity_factor=64.0))
    e2e = {}
    for dtype in (torch.bfloat16, torch.float32):
        rmodel, rprompts, rinputs = seeded_batch(rcfg, 4, 64, dtype)
        rres = serve(rmodel, rprompts, 8, rinputs)
        e2e[dtype] = end_to_end(rmodel, rres, rprompts, 8, rinputs)
        if dtype == torch.bfloat16:
            probe = rule_probe(rmodel, rprompts, 8, rinputs)
        del rmodel, rres
    bf16_held = all(d["holds"] for d in probe.values())
    held = {"float32": e2e[torch.float32]}
    if bf16_held:
        held["bfloat16"] = e2e[torch.bfloat16]
    for name, rule in held.items():
        for label, diff in rule.items():
            if not diff["holds"]:
                fail(f"families {arch} (reduced, {name}): {label}: {diff}")

    steps = n_new - 1
    ms_step = res.decode_s / steps * 1e3
    row = {
        "arch": cfg.name,
        "published": full,
        "layers": cfg.n_layers,
        "encoder_layers": cfg.n_enc_layers,
        "d_model": cfg.d_model,
        "params": n_params,
        "batch": 4,
        "prompt_len": n_prompt,
        "new_tokens": n_new,
        **stub,
        "cold_main_s": cold_s,
        "main_s": main_s,
        "prefill_s": res.prefill_s,
        "decode_s": res.decode_s,
        "decode_tok_s": 4 * steps / res.decode_s,
        "ms_per_decode_step": ms_step,
        "decode_step_device_ms": step["device_ms"],
        "decode_step_launches": step["launches"],
        "decode_step_top": step["top"],
        "decode_idle_share": 1 - step["device_ms"] / ms_step,
        "prefill_device_ms": pre["device_ms"],
        "prefill_launches": pre["launches"],
        "prefill_top": pre["top"],
        "prefill_idle_share": 1 - pre["device_ms"] / (res.prefill_s * 1e3),
        "peak_cuda_mb": peak_mb,
        "launches": counts,
        "shadow": shadow.summary(),
        "reduced_bf16_end_to_end": e2e[torch.bfloat16],
        "reduced_f32_end_to_end": e2e[torch.float32],
        "reduced_bf16_probe": probe,
        "reduced_bf16_held": bf16_held,
        "sample": res.tokens[0].tolist(),
    }
    log(
        f"families {cfg.name} ({n_params} params, {cfg.n_layers} layers, d "
        f"{cfg.d_model}{', ' + str(stub) if stub else ''}) 4x{n_prompt} + {n_new} "
        f"tokens: prefill_s={res.prefill_s:.4f} decode_s={res.decode_s:.4f} "
        f"decode_tok_s={row['decode_tok_s']:.1f} ms_per_step={ms_step:.3f} "
        f"peak_cuda_MB={peak_mb:.1f} main_s={main_s:.2f} cold_main_s={cold_s} "
        f"launches={counts}"
    )
    log(
        f"families {cfg.name} card work (torch.profiler): decode step "
        f"{step['device_ms']:.3f} ms in {step['launches']} launches (idle share "
        f"{row['decode_idle_share']:.3f}), prefill {pre['device_ms']:.3f} ms in "
        f"{pre['launches']} launches (idle share {row['prefill_idle_share']:.3f}); "
        f"top decode kernels (ms) {step['top']}; top prefill kernels {pre['top']}"
    )
    log(f"families {cfg.name} shadow: {shadow.summary()}")
    for name, rule in (("bf16", e2e[torch.bfloat16]), ("bf16 probe", probe),
                       ("f32", e2e[torch.float32])):
        worst = max(rule.items(), key=lambda kv: kv[1]["max_abs_err"])
        n_hold = sum(d["holds"] for d in rule.values())
        log(f"families {cfg.name} reduced {name} rule: {n_hold}/{len(rule)} hold; "
            f"worst {worst[0]}: {worst[1]}")
    log(f"families {cfg.name}: reduced bf16 {'held' if bf16_held else 'reported'}, "
        "f32 held")
    return row


#: the relative change the rule probe puts on every attention output: an
#: f32-level difference, below what a kernel route differs from its plain
#: version by (the bf16 flash's P carries about 16 bits)
PROBE_NOISE = 1e-6


class NoisyAttention(AttentionSwap):
    """Run every attention call on its plain version in f32 and move the
    output by a relative ``PROBE_NOISE`` (a seeded normal draw) before the
    rounding to the model's dtype."""

    def __init__(self):
        self.gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def _moved(self, out: torch.Tensor, dtype) -> torch.Tensor:
        noise = torch.randn(out.shape, generator=self.gen, device=out.device)
        return (out * (1 + PROBE_NOISE * noise)).to(dtype)

    def flash(self, q, k, v, *, causal=True):
        from repro_torch.kernels import flash_attention as fa

        out = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        return self._moved(out, q.dtype)

    def decode(self, q, k, v, kv_len):
        from repro_torch.kernels import decode_attention as dec

        out = dec.decode_attention_plain(q.float(), k.float(), v.float(), kv_len)
        return self._moved(out, q.dtype)


def rule_probe(model, prompts, n_new: int, inputs) -> dict:
    """``end_to_end`` of the plain model against itself with every attention
    output moved by ``PROBE_NOISE`` (``NoisyAttention``): where this breaks
    the rule, the rule cannot hold a kernel to the plain version end to
    end on this model, however right the kernel."""
    from repro_torch.kernels import ops
    from repro_torch.serve_lm import serve

    with ops.plain():
        ref = serve(model, prompts, n_new, inputs)
    with NoisyAttention():
        return end_to_end(model, ref, prompts, n_new, inputs)


def families_phase() -> dict:
    t = time.perf_counter()
    rows = [
        _family_serve(arch, full, stub, cold=i == 0)
        for i, (arch, full, stub) in enumerate(FAMILY_SERVES)
    ]
    launches = {}
    for row in rows:
        for name, n in row["launches"].items():
            launches[name] = launches.get(name, 0) + n
    seconds = time.perf_counter() - t
    log(f"families: {len(rows)} models in {seconds:.1f} s; launches {launches}")
    return {"models": rows, "launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 17: train on one device
# ---------------------------------------------------------------------------

#: backward cases: (label, B, Hq, Hkv, Sq, Sk, D, causal, dtype)
BWD_CASES = [
    ("olmo-1b train S 4096", 2, 16, 16, 4096, 4096, 128, True, torch.bfloat16),
    ("deepseek-coder-33b GQA", 1, 56, 8, 2048, 2048, 128, True, torch.bfloat16),
    ("gemma-2b MQA D 256", 1, 8, 1, 1024, 1024, 256, True, torch.bfloat16),
    ("seamless encoder non-causal", 4, 16, 16, 1024, 1024, 64, False, torch.bfloat16),
    ("cross Sq > Sk, 16 frames", 4, 16, 16, 1024, 16, 64, False, torch.bfloat16),
    ("cross Sq < Sk non-causal", 2, 16, 16, 100, 1000, 64, False, torch.bfloat16),
    ("ragged 1000-token tiles", 1, 8, 8, 1000, 1000, 128, True, torch.bfloat16),
    ("head dim 32", 4, 4, 2, 1024, 1024, 32, True, torch.bfloat16),
    ("head dim 64", 2, 16, 16, 1024, 1024, 64, True, torch.bfloat16),
    ("odd non-causal f32", 1, 2, 2, 33, 33, 32, False, torch.float32),
    ("olmo-1b f32", 1, 16, 16, 1024, 1024, 128, True, torch.float32),
]
#: the backward's CUDA kernels by name: bf16 (dkv_tc, dq_tc and the two
#: bytes-bound passes) and f32 (dq, dkv)
BWD_PASSES = {
    "dkv": r"dkv_tc_kernel|dkv_kernel",
    "dq": r"dq_tc_kernel|dq_kernel",
    "delta": r"delta_kernel",
    "group_sum": r"group_sum_kernel",
}
#: dq, dk, dv against autograd of the plain version: rtol and atol x the
#: tensor's max|plain| (phase 7's row-scaled rule, per tensor); bf16 sums
#: run in another order and the gradients round to bf16
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: scan backward cases: (kernel, label, B, S, H, P or D, N, chunk, dtype,
#: options); the first of each kernel is its train shape, the main path's
SCAN_BWD_CASES = [
    ("ssd", "zamba2-1.2b train S 4096", 2, 4096, 64, 64, 64, 128, torch.bfloat16, {}),
    ("ssd", "zamba2 heads f32", 1, 2048, 64, 64, 64, 128, torch.float32, {}),
    ("ssd", "ragged S 1000", 1, 1000, 64, 64, 64, 128, torch.bfloat16, {}),
    ("ssd", "h0 + dh_final", 1, 1024, 64, 64, 64, 128, torch.bfloat16, {"h0": True}),
    ("ssd", "the model's strided Bm / Cm", 2, 1024, 64, 64, 64, 128, torch.bfloat16,
     {"strided": True}),
    ("ssd", "reduced P 32 / N 16 / chunk 16", 2, 256, 8, 32, 16, 16, torch.bfloat16, {}),
    ("mlstm", "xlstm-1.3b train S 4096", 2, 4096, 4, 1024, 0, 128, torch.bfloat16, {}),
    ("mlstm", "xlstm-1.3b at batch 1", 1, 4096, 4, 1024, 0, 128, torch.bfloat16, {}),
    ("mlstm", "D 1024 f32", 1, 512, 4, 1024, 0, 128, torch.float32, {}),
    ("mlstm", "D 64", 2, 2048, 8, 64, 0, 128, torch.bfloat16, {}),
    ("mlstm", "ragged S 1000", 1, 1000, 4, 1024, 0, 128, torch.bfloat16, {}),
    ("mlstm", "entering state + final grads", 1, 1024, 4, 256, 0, 128, torch.bfloat16,
     {"state": True}),
    ("mlstm", "steep gates", 1, 1024, 4, 256, 0, 128, torch.bfloat16, {"steep": True}),
]
#: the SSD backward at 4 heads, a rank's share of zamba2-1.2b's 64 on a
#: model axis of 16
SCAN_BWD_SPLIT_CASES = [
    ("ssd", "zamba2-1.2b train, 4 heads a rank", 2, 4096, 4, 64, 64, 128, torch.bfloat16, {}),
]
#: the scan backwards' CUDA kernels by name, each group the SIMT route's
#: kernel and the tensor-core route's (``_tc``, ``pass_parts``); the SSD's
#: tensor-core route fuses chunk_mats and chunk_grads into ``chunk_tc``
SCAN_BWD_PASSES = {
    "ssd_scan_bwd": {
        "states": r"(?<!\w)states_(tc_)?kernel", "passing": r"(?<!\w)passing_(tc_)?kernel",
        "chunk_mats": r"(?<!\w)chunk_mats_kernel", "chunk_grads": r"(?<!\w)chunk_grads_kernel",
        "chunk": r"(?<!\w)chunk_tc_kernel", "head_sum": r"(?<!\w)head_sum_kernel",
    },
    "mlstm_scan_bwd": {
        "gates": r"(?<!\w)(gates|final)_kernel", "outer": r"(?<!\w)outer_(tc_)?kernel",
        "pass": r"(?<!\w)pass_(parts_)?kernel", "z": r"(?<!\w)z_(tc_)?kernel",
        "rows": r"(?<!\w)rows_(tc_)?kernel", "dstate": r"(?<!\w)dstate_(tc_)?kernel",
    },
}
#: (d): a scan arch's train step on the device clock, by kernel group (the
#: first group whose pattern matches a kernel's name takes it; "rest" is the
#: elementwise passes, reductions and the optimizer)
SCAN_STEP_GROUPS = {
    "scan_bwd": "|".join(f"(?:{pat})" for passes in SCAN_BWD_PASSES.values()
                         for pat in passes.values()),
    "scan_fwd": r"(?<!\w)(state_passing|chunk_states|chunk_outputs|chunk_states_tc|"
                r"chunk_outputs_tc|gate|w|w_tc|state|state_tc)_kernel",
    "flash": r"(?<!\w)(flash|flash_tc|dq|dq_tc|dkv|dkv_tc|delta|group_sum)_kernel",
    "gemm": r"gemm|sm90_xmma|cutlass|nvjet",
}
#: the published olmo-1b trained at repro's train_4k sequence length
TRAIN_ARGV = [
    "--arch", "olmo-1b", "--full-size", "--seq-len", "4096", "--global-batch", "2",
    "--steps", "5", "--warmup-steps", "2",
]
#: the archs whose reduced f32 step is held to ops.plain()
TRAIN_ARCHS = ["olmo-1b", "gemma-2b", "deepseek-coder-33b", "minicpm3-4b",
               "granite-moe-3b-a800m", "grok-1-314b", "qwen2-vl-7b",
               "seamless-m4t-medium", "zamba2-1.2b", "xlstm-1.3b"]
#: the reduced f32 step, kernels against plain versions: each arch's worst
#: gradient leaf (relative to its max|plain|) and gradient-norm distance as
#: an H100 (700 W) read them when these steps were first held, kernels
#: against plain; f32 gradients of the reduced random models are
#: ill-conditioned (nearly one-hot attention), so a kernel's rounding moves
#: them by more than its own error, which (a) holds.  The limits are
#: TRAIN_MARGIN x each reading, and the loss is held to rtol 1e-5
TRAIN_READINGS = {
    "olmo-1b": {"leaf": 4.89e-4, "grad_norm": 4.81e-4},
    "gemma-2b": {"leaf": 1.96e-4, "grad_norm": 1.15e-4},
    "deepseek-coder-33b": {"leaf": 1.54e-4, "grad_norm": 6.6e-7},
    "minicpm3-4b": {"leaf": 0.0, "grad_norm": 0.0},
    "granite-moe-3b-a800m": {"leaf": 2.45e-4, "grad_norm": 2.08e-4},
    "grok-1-314b": {"leaf": 2.45e-4, "grad_norm": 2.08e-4},
    "qwen2-vl-7b": {"leaf": 2.81e-4, "grad_norm": 1.45e-5},
    "seamless-m4t-medium": {"leaf": 8.58e-3, "grad_norm": 1.15e-3},
    "zamba2-1.2b": {"leaf": 5.24e-4, "grad_norm": 3.59e-5},
    "xlstm-1.3b": {"leaf": 9.75e-6, "grad_norm": 6.06e-7},
}
#: the scan archs trained at their published size through the launcher:
#: (arch, global batch) at repro's train_4k sequence length, under their
#: config's remat "full" (without it xlstm-1.3b ran out of the card's 80 GB
#: at batch 2 and trained at batch 1)
SCAN_TRAINS = [("zamba2-1.2b", 2), ("xlstm-1.3b", 2)]
#: the published trainings under the other remat setting, beside the
#: launcher's "full": (arch, global batch, remat), a warm step and one timed
#: step each; xlstm-1.3b at batch 1 both ways (batch 2 without remat does
#: not fit 80 GB)
REMAT_PROBES = [("olmo-1b", 2, "none"), ("zamba2-1.2b", 2, "none"),
                ("xlstm-1.3b", 1, "none"), ("xlstm-1.3b", 1, "full")]
#: the published widths at a cut depth (one shared block for zamba2) whose
#: "full" step is held bit for bit to its "none" step, and every forward
#: kernel's recompute to its first call (arch, layers)
RECOMPUTE_MODELS = [("olmo-1b", 2), ("zamba2-1.2b", 7), ("xlstm-1.3b", 2)]
SCAN_TRAIN_STEPS = 4
TRAIN_MARGIN = 3.0
#: the floor of every limit: a few hundred f32 ulps, where a reading is 0
#: (minicpm3 runs no flash kernel) and the embedding's backward may sum in
#: another order on the card from one run to the next
TRAIN_FLOOR = 1e-5
TRAIN_LOSS_RTOL = 1e-5
#: steps of examples/train_lm.py's ~100M model, and the resume's
EXAMPLE_STEPS = 300
RESUME_RTOL = 1e-3


def _bwd_excess(got, want, tol: float) -> float:
    """How far each of dq, dk, dv passes rtol = tol and atol = tol x its
    max|plain|, at the worst; <= 0 holds."""
    return max(
        float(((g.float() - w.float()).abs()
               - tol * (w.float().abs() + w.float().abs().max())).max())
        for g, w in zip(got, want)
    )


def backward_cases(card: str) -> list:
    """(a): the backward kernel against autograd of the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []
    bw, _ = memory_rate(card)
    for label, b, hq, hkv, sq, sk, d, causal, dtype in BWD_CASES:
        q = randn(b, hq, sq, d, dtype=dtype)
        k, v = randn(b, hkv, sk, d, dtype=dtype), randn(b, hkv, sk, d, dtype=dtype)
        dout = randn(b, hq, sq, d, dtype=dtype)
        out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        got = fab.flash_attention_bwd(q, k, v, out, dout, causal=causal, lse=lse)
        again = fab.flash_attention_bwd(q, k, v, out, dout, causal=causal, lse=lse)
        torch.cuda.synchronize()
        want = fab.flash_attention_bwd_plain(q, k, v, dout, causal=causal)
        tol = BWD_TOL[dtype]
        excess = _bwd_excess(got, want, tol)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        if excess > 0:
            fail(f"train: backward {label}: kernel differs from autograd of the "
                 f"plain version by {excess} past the rule (max {err})")
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"train: backward {label}: two calls differ")
        mask = None
        if causal and sq != sk:
            qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
            mask = qpos >= torch.arange(sk, device=dev)[None, :]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=hq != hkv)
        del want
        def kernel():
            return fab.flash_attention_bwd(q, k, v, out, dout, causal=causal, lse=lse)

        k_ms = device_ms(kernel, 10)
        launch_ms = split_kernels(device_profile(kernel)["per_launch"], BWD_PASSES)
        median_ms = cuda_ms(kernel, 10)
        p_ms = device_ms(lambda: fab.flash_attention_bwd_plain(q, k, v, dout,
                                                               causal=causal), 3)
        l_ms = device_ms(lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                     retain_graph=True), 10)
        pairs = sq * (sk - sq) + sq * (sq + 1) // 2 if causal else sq * sk
        es = q.element_size()
        flops = 5 * 2 * b * hq * d * pairs
        nbytes = (4 * b * hq * sq + 4 * b * hkv * sk) * d * es
        peak, _ = op_rate(card, dtype)
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / bw * 1e3
        row = {
            "case": label, "shape": [b, hq, hkv, sq, sk, d], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "excess": excess, "bit_equal_calls": True,
            "ms": k_ms["ms"], "median_ms": median_ms, "plain_ms": p_ms["ms"],
            "library_ms": l_ms["ms"],
            "queued": k_ms["queued"] and p_ms["queued"] and l_ms["queued"],
            "flops": flops, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "launch_ms": launch_ms,
        }
        log(f"train backward {label} {row['shape']} {row['dtype']} causal={causal}: "
            f"ms={row['ms']:.4f} median_ms={median_ms:.4f} launch_ms={launch_ms} bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']}) plain_ms={row['plain_ms']:.3f} "
            f"sdpa_bwd_ms={row['library_ms']:.4f} queued={row['queued']} "
            f"max_abs_err={err} excess={excess}")
        rows.append(row)
        del q, k, v, dout, out, lse, got, again, leaves, lib_out, mask
        torch.cuda.empty_cache()
    return rows


def scan_bwd_inputs(gen, kind, b, s, h, p, n, dtype, opts) -> tuple:
    """The arguments of one scan backward call on the card, drawn from
    ``gen`` at tests/test_kernels.py's scales."""
    dev = torch.device("cuda")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    if kind == "ssd":
        xh = randn(b, s, h, p, dtype=dtype) * 0.5
        la = -randn(b, s, h).abs() * 0.3
        if opts.get("strided"):
            # the model's layout: slices of the conv output (B, S, P H + 2 N)
            wide = randn(b, s, h * p + 2 * n, dtype=dtype) * 0.5
            bm, cm = wide[..., h * p:h * p + n], wide[..., h * p + n:]
        else:
            bm, cm = randn(b, s, n, dtype=dtype) * 0.5, randn(b, s, n, dtype=dtype) * 0.5
        h0 = randn(b, h, p, n) * 0.3 if opts.get("h0") else None
        dhf = randn(b, h, p, n) if opts.get("h0") else None
        return xh, la, bm, cm, h0, randn(b, s, h, p, dtype=dtype), dhf
    q = randn(b, s, h, p, dtype=dtype)
    k = (randn(b, s, h, p) / p**0.5).to(dtype)
    v = randn(b, s, h, p, dtype=dtype)
    z = randn(b, s, h)
    if opts.get("steep"):
        lf, li = -3.0 + 2.0 * z, 4.0 * randn(b, s, h)
    else:
        lf, li = F.logsigmoid(2.0 * z), randn(b, s, h)
    state, fin = None, (None, None, None)
    if opts.get("state"):
        state = (0.1 * randn(b, h, p, p), 0.1 * randn(b, h, p), randn(b, h))
        fin = (randn(b, h, p, p), randn(b, h, p), randn(b, h))
    return q, k, v, lf, li, state, randn(b, s, h, p), *fin


def scan_bwd_work(kind, b, s, h, p, n, chunk, elem, opts) -> tuple:
    """(operations, bytes) the scan's gradient needs: each input read once
    and each output written once; the chunked algorithm's products, its
    causal Q x Q ones counted on their triangle."""
    qn = min(chunk, s)
    nc = -(-s // qn)
    if kind == "ssd":
        per = 5 * qn * p * n + qn * qn * (p + n) + qn * qn * n // h
        flops = 2 * b * nc * h * per
        nbytes = 3 * b * s * h * p * elem + 2 * b * s * h * 4 + 4 * b * s * n * elem
        if opts.get("h0"):
            nbytes += 3 * b * h * p * n * 4
        return flops, nbytes
    per = 5 * qn * p * p + 5 * qn * qn * p // 2
    flops = 2 * b * h * nc * per
    nbytes = 6 * b * s * h * p * elem + b * s * h * p * 4 + 4 * b * s * h * 4
    if opts.get("state"):
        nbytes += 5 * b * h * (p * p + p + 1) * 4
    return flops, nbytes


def scan_backward_cases(card: str) -> dict:
    """(a): each scan backward kernel against its plain backward, per tensor
    by BWD_TOL's rule, two calls bit-equal; times beside the bound."""
    from repro_torch.kernels import mlstm_scan_bwd as mlb
    from repro_torch.kernels import ssd_scan_bwd as ssb

    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    bw, _ = memory_rate(card)
    out = {"ssd_scan_bwd": [], "mlstm_scan_bwd": []}
    for kind, label, b, s, h, p, n, chunk, dtype, opts in (SCAN_BWD_CASES
                                                           + SCAN_BWD_SPLIT_CASES):
        name = f"{kind}_scan_bwd"
        mod = ssb if kind == "ssd" else mlb
        args = scan_bwd_inputs(gen, kind, b, s, h, p, n, dtype, opts)

        def kernel(fn=getattr(mod, name), args=args, chunk=chunk):
            return fn(*args, block_q=chunk)

        def plain(fn=getattr(mod, name + "_plain"), args=args, chunk=chunk):
            return fn(*args, block_q=chunk)

        def flat(r):
            """The gradients as one list (mLSTM's entering state's unpacked)."""
            r = [*r[:5], *(r[5] or ())] if kind == "mlstm" else r
            return [t for t in r if t is not None]

        got = flat(kernel())
        again = flat(kernel())
        torch.cuda.synchronize()
        want = flat(plain())
        tol = BWD_TOL[dtype]
        excess = _bwd_excess(got, want, tol)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        if excess > 0:
            fail(f"train: {name} {label}: kernel differs from the plain backward by "
                 f"{excess} past the rule (max {err})")
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"train: {name} {label}: two calls differ")
        del got, again, want
        route = mod.kernel_route(dtype) if kind == "ssd" else mod.kernel_route(dtype, p)
        k_ms = device_ms(kernel, 3)
        # each group's device ms in one call, summed over its launches
        kernel_ms = split_kernels(device_profile(kernel)["kernels"], SCAN_BWD_PASSES[name])
        p_ms = device_ms(plain, 1)
        flops, nbytes = scan_bwd_work(kind, b, s, h, p, n, chunk,
                                      torch.finfo(dtype).bits // 8, opts)
        peak, _ = op_rate(card, dtype)
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / bw * 1e3
        row = {
            "case": label, "shape": [b, s, h, p, n, chunk], "options": opts,
            "dtype": str(dtype).replace("torch.", ""), "route": route, "max_abs_err": err,
            "excess": excess, "bit_equal_calls": True, "ms": k_ms["ms"],
            "plain_ms": p_ms["ms"], "library_ms": None,
            "queued": k_ms["queued"] and p_ms["queued"], "flops": flops, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "kernel_ms": kernel_ms,
        }
        log(f"train {name} {label} {row['shape']} {row['dtype']} {opts} route={route}: "
            f"ms={row['ms']:.4f} "
            f"kernel_ms={kernel_ms} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"plain_ms={row['plain_ms']:.3f} queued={row['queued']} max_abs_err={err} "
            f"excess={excess}")
        out[name].append(row)
        del args
        torch.cuda.empty_cache()
    return out


class ShadowBackward:
    """While entered, every call of the backward kernel through autograd also
    runs autograd of the plain version on the same inputs and holds the
    kernel to it by BWD_TOL's rule; the step goes on with the kernel's
    gradients."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention_bwd as fab

        self._fab, self._saved = fab, fab.flash_attention_bwd
        self.calls, self.worst_excess, self.max_abs_err = 0, -math.inf, 0.0

        def shadowed(q, k, v, out, dout, *, causal=True, lse=None):
            got = self._saved(q, k, v, out, dout, causal=causal, lse=lse)
            want = fab.flash_attention_bwd_plain(q, k, v, dout, causal=causal)
            excess = _bwd_excess(got, want, BWD_TOL[q.dtype])
            if excess > 0:
                fail(f"train: backward call {self.calls} differs from the plain "
                     f"version in the model by {excess} past the rule")
            self.calls += 1
            self.worst_excess = max(self.worst_excess, excess)
            self.max_abs_err = max(self.max_abs_err, max(
                float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)))
            return got

        fab.flash_attention_bwd = shadowed
        return self

    def __exit__(self, *exc):
        self._fab.flash_attention_bwd = self._saved

    def summary(self) -> dict:
        return {"calls": self.calls, "worst_excess": self.worst_excess,
                "max_abs_err": self.max_abs_err}


def _train_batch(cfg, seq: int, batch: int, step: int = 0) -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                seed=SEED))
    return {k: v.cuda() for k, v in ds.batch(step).items()}


#: olmo-1b's train step's kernels by group (regexes over the profiler's names)
OLMO_GROUPS = {
    "flash_bwd": r"dq_tc_kernel|dkv_tc_kernel|dq_kernel|dkv_kernel",
    "flash_bwd_passes": r"delta_kernel|group_sum_kernel",
    "flash_fwd": r"flash_tc_kernel|flash_kernel",
    "gemm": r"gemm|sm90_xmma|cutlass|nvjet",
}


def olmo_train(card: str) -> dict:
    """(b): the published olmo-1b trained 5 steps through the launcher, then
    one step of the same model shadowed, profiled and split by phase."""
    from repro_torch.configs import base, registry
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg = registry.get("olmo-1b")
    seq, batch, n_steps = 4096, 2, 5
    ckpt = OUT_DIR / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    losses, mon = launch.main(TRAIN_ARGV + ["--ckpt-dir", str(ckpt)])
    main_s = time.perf_counter() - t
    counts = ops.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    shutil.rmtree(ckpt, ignore_errors=True)
    want = train_launches(cfg, n_steps)
    if counts != want:
        fail(f"train: kernel launches {counts}, expected {want}")
    if len(losses) != n_steps or not all(math.isfinite(x) for x in losses):
        fail(f"train: losses {losses}")
    step_s = [dt for _, dt in mon.times]
    warm_s = statistics.median(step_s[1:])
    tokens = seq * batch
    flops = base.model_flops(cfg, base.ShapeConfig("train", "train", seq, batch))
    peak, peak_name = op_rate(card, torch.bfloat16)

    # one more model: a step shadowed, a step profiled, a step split by phase
    torch.cuda.empty_cache()
    model = build_model(cfg, seed=SEED)
    opt_cfg = adamw.OptConfig(lr=3e-4, warmup_steps=2, total_steps=n_steps)
    step = steps.make_train_step(cfg, opt_cfg)
    opt = adamw.init_state(dict(model.named_parameters()))
    data = _train_batch(cfg, seq, batch)
    opt, metrics = step(model, opt, data)  # warm
    fab.reset_launch_count()
    with ShadowBackward() as shadow:
        opt, metrics = step(model, opt, data)
    copies = fab.copy_count()
    if copies:
        fail(f"train: the backward copied {copies} inputs into a layout TMA takes "
             "in one step; the model's layouts should need none")
    if shadow.calls != cfg.n_layers:
        fail(f"train: {shadow.calls} backward calls shadowed, {cfg.n_layers} expected")
    gnorm = float(metrics["grad_norm"])
    if not (math.isfinite(float(metrics["loss"])) and gnorm > 0):
        fail(f"train: loss {float(metrics['loss'])}, grad norm {gnorm}")
    prof = device_profile(lambda: step(model, opt, data))
    split = split_kernels(prof["kernels"], OLMO_GROUPS)
    bwd_share = (split["flash_bwd"] + split["flash_bwd_passes"]) / prof["device_ms"]
    # the step's phases on the device clock: events between the forward,
    # the backward and the optimizer (each span includes its idle gaps)
    loss_fn = steps.make_loss_fn(cfg)
    params = dict(model.named_parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev[0].record()
    loss, _ = loss_fn(model, data)
    ev[1].record()
    loss.backward()
    ev[2].record()
    grads = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    opt, _ = adamw.apply_updates(opt_cfg, params, grads, opt, adamw.decay_mask(model))
    ev[3].record()
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t
    phases = {name: ev[i].elapsed_time(ev[i + 1])
              for i, name in enumerate(("forward", "backward", "optimizer"))}
    del model, opt, data, grads, params, loss
    torch.cuda.empty_cache()
    step_ms = sum(phases.values())
    row = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "seq_len": seq, "global_batch": batch, "steps": n_steps,
        "losses": losses, "main_s": main_s, "step_s": step_s,
        "warm_step_s": warm_s, "tokens_per_s": tokens / warm_s,
        "model_flops_per_step": flops, "peak_rate": peak_name,
        "mfu": flops / warm_s / peak, "peak_cuda_mb": peak_mb,
        "launches": counts, "shadow": shadow.summary(), "grad_norm": gnorm,
        "profile": {"device_ms": prof["device_ms"], "launches": prof["launches"],
                    "top": prof["top"], "split_ms": split,
                    "flash_bwd_share": bwd_share, "kernels": prof["kernels"]},
        "bwd_input_copies": copies,
        "phases_ms": phases, "split_step_s": split_s,
        # the card's idle share of a user's step: the profiled step's kernel
        # time against the launcher's warm step on the host clock
        "idle_share": 1 - prof["device_ms"] / (warm_s * 1e3),
        "split_step_ms": step_ms,
    }
    log(f"train {cfg.name} full size, {batch} x {seq} tokens, {n_steps} steps: "
        f"losses={losses} warm step {warm_s:.3f} s, {row['tokens_per_s']:.0f} tok/s, "
        f"MFU {row['mfu']:.4f} of {peak_name}; peak_cuda_MB={peak_mb:.1f}; "
        f"launches={counts}")
    log(f"train step split (device clock, ms): {phases}; kernels {prof['device_ms']:.1f} "
        f"ms by group {split}; flash backward {bwd_share:.3f} of the kernels; "
        f"idle share {row['idle_share']:.3f}; backward input copies {copies}")
    log(f"train shadow (every backward call of a step vs plain): {shadow.summary()}")
    return row


def train_launches(cfg, steps: int = 1) -> dict:
    """The model kernels' launches in ``steps`` train steps of ``cfg``: each
    forward kernel once a layer that runs it, its backward kernel as often;
    an encoder-decoder's encoder, self- and cross-attention; MLA none.
    Under ``cfg.remat == "full"`` each checkpointed layer (every layer, the
    hybrid's shared block, the encoder-decoder's decoder layers; not its
    encoder) runs its forward kernels again in the backward: twice a step."""
    again = 2 if cfg.remat == "full" else 1
    flash = ssd = mlstm = enc = 0
    if cfg.family in ("encdec", "audio"):
        enc, flash = cfg.n_enc_layers, 2 * cfg.n_layers
    elif cfg.family == "hybrid":
        ssd = cfg.n_layers
        flash = -(-cfg.n_layers // cfg.shared_attn_every) - 1
    elif cfg.family == "ssm":
        mlstm = cfg.n_layers
    elif cfg.mla is None:
        flash = cfg.n_layers
    return {"flash_attention": (enc + again * flash) * steps,
            "flash_attention_bwd": (enc + flash) * steps, "decode_attention": 0,
            "ssd_scan": again * ssd * steps, "ssd_scan_bwd": ssd * steps,
            "mlstm_scan": again * mlstm * steps, "mlstm_scan_bwd": mlstm * steps}


def remat_probe(arch: str, batch: int, remat: str) -> dict:
    """The published ``arch`` at ``batch`` x 4096 under ``remat``: a warm
    step, then one step timed on the host clock (to the loss's read), and
    the peak of ``torch.cuda.max_memory_allocated`` over both."""
    from repro_torch.configs import registry
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg = replace(registry.get(arch), remat=remat)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, seed=SEED)
    step = steps.make_train_step(cfg, adamw.OptConfig(lr=3e-4, warmup_steps=2,
                                                      total_steps=4))
    opt = adamw.init_state(dict(model.named_parameters()))
    data = _train_batch(cfg, 4096, batch)
    opt, metrics = step(model, opt, data)
    first = float(metrics["loss"])
    t = time.perf_counter()
    opt, metrics = step(model, opt, data)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    del model, opt, data, step, metrics
    torch.cuda.empty_cache()
    if not (math.isfinite(first) and math.isfinite(loss)):
        fail(f"train {arch} remat={remat}: losses {first}, {loss}")
    row = {"arch": arch, "global_batch": batch, "seq_len": 4096, "remat": remat,
           "step_s": step_s, "tokens_per_s": 4096 * batch / step_s,
           "peak_cuda_mb": peak_mb, "losses": [first, loss]}
    log(f"train {arch} remat={remat}, {batch} x 4096: a warm step {step_s:.3f} s, "
        f"peak_cuda_MB={peak_mb:.1f}")
    return row


def _bits_digest(t: torch.Tensor) -> tuple:
    """Two integer sums over a tensor's bits (plain and position-weighted):
    equal tensors give equal digests."""
    b = t.detach().contiguous().view(-1)
    b = b.view(torch.int16 if b.element_size() == 2 else torch.int32).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) % 65521 + 1
    return int(b.sum()), int((b * w).sum())


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


class ForwardDigests:
    """While entered, every forward kernel call (flash, SSD, mLSTM) is
    recorded as (its inputs' digest, its outputs' digest)."""

    NAMES = (("flash_attention", "flash_attention"), ("ssd_scan", "ssd_scan"),
             ("mlstm_scan", "mlstm_scan"))

    def __enter__(self):
        import importlib

        self.calls, self._saved = [], []
        for mod_name, fn_name in self.NAMES:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            inner = getattr(mod, fn_name)

            def recorded(*args, _inner=inner, _name=mod_name, **kwargs):
                out = _inner(*args, **kwargs)
                self.calls.append((_name, tuple(_bits_digest(t) for t in _tensors(args)),
                                   tuple(_bits_digest(t) for t in _tensors(out))))
                return out

            self._saved.append((mod, fn_name, inner))
            setattr(mod, fn_name, recorded)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, inner in self._saved:
            setattr(mod, fn_name, inner)


def recompute_check() -> list:
    """Under remat "full" each layer's forward kernels run again in the
    backward: at each ``RECOMPUTE_MODELS`` config (published width, cut
    depth, 1 x 4096, bf16) every recomputed forward call must give its
    first call's bits, and the step's loss and every gradient must equal
    the "none" step's bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train import steps

    rows = []
    for arch, layers in RECOMPUTE_MODELS:
        base = replace(registry.get(arch), n_layers=layers)
        grads, losses = {}, {}
        for remat in ("full", "none"):
            cfg = replace(base, remat=remat)
            model = build_model(cfg, seed=SEED).requires_grad_(True)
            data = _train_batch(cfg, 4096, 1)
            ops.reset_launch_counts()
            with ForwardDigests() as dig:
                loss, _ = steps.make_loss_fn(cfg)(model, data)
                loss.backward()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            if counts != train_launches(cfg):
                fail(f"recompute {arch} remat={remat}: launches {counts}, "
                     f"expected {train_launches(cfg)}")
            losses[remat] = loss.detach()
            grads[remat] = {n: p.grad for n, p in model.named_parameters()}
            if remat == "full":
                by_input: dict = {}
                for name, inp, out in dig.calls:
                    by_input.setdefault((name, inp), []).append(out)
                twice = [outs for outs in by_input.values() if len(outs) == 2]
                if len(twice) != len(by_input) or len(dig.calls) != 2 * len(by_input):
                    fail(f"recompute {arch}: {len(dig.calls)} forward calls over "
                         f"{len(by_input)} inputs; each should run exactly twice")
                same = sum(a == b for a, b in twice)
                calls = len(dig.calls)
            del model, data, loss
            torch.cuda.empty_cache()
        equal = [n for n, g in grads["full"].items() if torch.equal(g, grads["none"][n])]
        row = {"arch": arch, "layers": layers, "forward_calls": calls,
               "recomputes": len(twice), "recomputes_bit_equal": same,
               "loss_equal": bool(torch.equal(losses["full"], losses["none"])),
               "grads": len(grads["full"]), "grads_bit_equal": len(equal)}
        log(f"train recompute {arch} ({layers} layers, 1 x 4096, bf16): {row}")
        if same != len(twice) or not row["loss_equal"] or len(equal) != row["grads"]:
            fail(f"recompute {arch}: remat 'full' is not bit-equal to 'none': {row}")
        rows.append(row)
        del grads
        torch.cuda.empty_cache()
    return rows


def _grads_of_step(cfg, plain: bool) -> tuple:
    """(loss, grad norm, {name: grad}, launches) of a reduced f32 step's
    backward on the card, kernels or (``plain``) plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train import steps

    model = build_model(cfg, seed=SEED).float().requires_grad_(True)
    data = _train_batch(cfg, 32, 2)
    if cfg.family == "vlm":
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        data["vision_embeds"] = 0.01 * torch.randn(2, 16, cfg.d_model, generator=g,
                                                   device="cuda")
    if cfg.family in ("encdec", "audio"):
        g = torch.Generator(device="cuda").manual_seed(SEED + 3)
        data["frames"] = 0.1 * torch.randn(2, 16, cfg.d_model, generator=g,
                                           device="cuda")
    ops.reset_launch_counts()
    with ops.plain() if plain else contextlib.nullcontext():
        loss, _ = steps.make_loss_fn(cfg)(model, data)
        loss.backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    gn = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values())))
    return float(loss.detach()), gn, grads, counts


def reduced_steps() -> list:
    """(c): reduced f32 steps, kernels against ops.plain()."""
    from repro_torch.configs import registry

    rows = []
    for arch in TRAIN_ARCHS:
        cfg = registry.get(arch).reduced()
        loss, gn, grads, counts = _grads_of_step(cfg, plain=False)
        p_loss, p_gn, p_grads, p_counts = _grads_of_step(cfg, plain=True)
        if counts != train_launches(cfg):
            fail(f"train (reduced {arch}): launches {counts}, expected {train_launches(cfg)}")
        if any(p_counts.values()):
            fail(f"train (reduced {arch}): plain step launched {p_counts}")
        leaf = max(float((grads[n].float() - g.float()).abs().max())
                   / max(float(g.float().abs().max()), 1e-30) for n, g in p_grads.items())
        limit = {k: max(TRAIN_MARGIN * r, TRAIN_FLOOR)
                 for k, r in TRAIN_READINGS[arch].items()}
        gn_rel = abs(gn / p_gn - 1)
        held = (abs(loss / p_loss - 1) <= TRAIN_LOSS_RTOL
                and gn_rel <= limit["grad_norm"] and leaf <= limit["leaf"])
        row = {"arch": arch, "loss": loss, "plain_loss": p_loss, "grad_norm": gn,
               "plain_grad_norm": p_gn, "grad_norm_rel": gn_rel, "worst_leaf_rel": leaf,
               "limits": limit, "launches": counts, "holds": held}
        log(f"train reduced {arch} f32 step vs plain: {row}")
        if not held:
            fail(f"train (reduced {arch}): the step differs from ops.plain(): {row}")
        rows.append(row)
    return rows


def scan_train(card: str, arch: str, batch: int, bwd_ms: float) -> dict:
    """(d): the published zamba2-1.2b or xlstm-1.3b trained through the
    launcher at repro's train_4k length; each step runs every scan layer's
    forward and backward kernel once.  Then one step of the same model
    profiled and split by kernel group (``SCAN_STEP_GROUPS``), so the scan
    backward's share of the step is measured.  ``bwd_ms``: the scan
    backward's device ms a call at this train shape, from (a), for the
    reckoned share beside it."""
    from repro_torch.configs import base, registry
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg = registry.get(arch)
    seq, n_steps = 4096, SCAN_TRAIN_STEPS
    ckpt = OUT_DIR / "scan_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    losses, mon = launch.main([
        "--arch", arch, "--full-size", "--seq-len", str(seq), "--global-batch",
        str(batch), "--steps", str(n_steps), "--warmup-steps", "2", "--ckpt-dir", str(ckpt),
    ])
    main_s = time.perf_counter() - t
    counts = ops.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    want = train_launches(cfg, n_steps)
    if counts != want:
        fail(f"train {arch}: kernel launches {counts}, expected {want}")
    if len(losses) != n_steps or not all(math.isfinite(x) for x in losses):
        fail(f"train {arch}: losses {losses}")
    step_s = [dt for _, dt in mon.times]
    warm_s = statistics.median(step_s[1:])
    tokens = seq * batch
    flops = base.model_flops(cfg, base.ShapeConfig("train", "train", seq, batch))
    peak, peak_name = op_rate(card, torch.bfloat16)
    scan = "ssd_scan" if cfg.family == "hybrid" else "mlstm_scan"
    per_step = {k: v // n_steps for k, v in counts.items()}

    # one more model: a warm step, then a step profiled and split by group
    model = build_model(cfg, seed=SEED)
    opt_cfg = adamw.OptConfig(lr=3e-4, warmup_steps=2, total_steps=n_steps)
    step = steps.make_train_step(cfg, opt_cfg)
    opt = adamw.init_state(dict(model.named_parameters()))
    data = _train_batch(cfg, seq, batch)
    opt, _ = step(model, opt, data)
    prof = device_profile(lambda: step(model, opt, data))
    del model, opt, data, step
    torch.cuda.empty_cache()
    split = split_kernels(prof["kernels"], SCAN_STEP_GROUPS)
    split["idle"] = max(0.0, warm_s * 1e3 - prof["device_ms"])
    shares = {g: ms / (warm_s * 1e3) for g, ms in split.items()}
    row = {
        "arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model, "seq_len": seq,
        "global_batch": batch, "steps": n_steps, "losses": losses, "main_s": main_s,
        "step_s": step_s, "warm_step_s": warm_s, "tokens_per_s": tokens / warm_s,
        "model_flops_per_step": flops, "peak_rate": peak_name, "mfu": flops / warm_s / peak,
        "peak_cuda_mb": peak_mb, "launches": counts, "launches_per_step": per_step,
        # the profiled step by kernel group (device ms; "idle": the warm
        # step's host time less the kernels') and each group's share of the
        # warm step; the scan backward's share is split["scan_bwd"]'s
        "profile": {"device_ms": prof["device_ms"], "launches": prof["launches"],
                    "top": prof["top"], "split_ms": split, "shares": shares},
        "scan_bwd_ms_per_step": split["scan_bwd"],
        "scan_bwd_share": shares["scan_bwd"],
        # as reckoned before the split: launches a step x (a)'s ms a call
        "scan_bwd_reckoned_ms": per_step[scan + "_bwd"] * bwd_ms,
    }
    log(f"train {arch} full size, {batch} x {seq} tokens, {n_steps} steps: losses={losses} "
        f"warm step {warm_s:.3f} s, {row['tokens_per_s']:.0f} tok/s, MFU {row['mfu']:.4f} of "
        f"{peak_name}; peak_cuda_MB={peak_mb:.1f}; launches a step {per_step}; the scan "
        f"backward {row['scan_bwd_ms_per_step']:.1f} ms a step ({row['scan_bwd_share']:.3f}; "
        f"reckoned {row['scan_bwd_reckoned_ms']:.1f})")
    log(f"train {arch} step split (device ms, profiled step of "
        f"{prof['device_ms']:.1f} ms in {prof['launches']} launches): "
        + ", ".join(f"{g} {ms:.1f} ({shares[g]:.3f})" for g, ms in split.items()))
    return row


def example_and_resume() -> dict:
    """(e) examples/train_lm.py end to end; (f) a save, then a resume."""
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as launch

    out = {}
    ckpt = OUT_DIR / "train_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t = time.perf_counter()
    losses, mon = train_lm.main(["--steps", str(EXAMPLE_STEPS), "--ckpt-dir", str(ckpt)])
    out["example"] = {"steps": EXAMPLE_STEPS, "seconds": time.perf_counter() - t,
                      "first_loss": losses[0], "last_loss": losses[-1],
                      "losses_every_10": losses[::10],
                      "median_step_s": statistics.median(dt for _, dt in mon.times)}
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"train example (~100M olmo, {EXAMPLE_STEPS} steps): {out['example']}")

    run = launch.RunConfig(arch="olmo-1b", steps=6, seq_len=64, global_batch=4,
                           ckpt_every=3, warmup_steps=2, ckpt_dir=str(ckpt))
    whole, _ = launch.train(run, verbose=False)
    shutil.rmtree(ckpt / "step_00000006")
    resumed, _ = launch.train(run, verbose=False)
    shutil.rmtree(ckpt, ignore_errors=True)
    rel = max(abs(a / b - 1) for a, b in zip(resumed, whole[3:]))
    out["resume"] = {"whole": whole, "resumed": resumed, "max_rel": rel}
    log(f"train resume (reduced olmo-1b, from step 3 of 6): {out['resume']}")
    if len(resumed) != 3 or rel > RESUME_RTOL:
        fail(f"train: the resumed losses {resumed} differ from {whole[3:]}")
    return out


def train_phase(card: str) -> dict:
    t = time.perf_counter()
    cases = backward_cases(card)
    scan_cases = scan_backward_cases(card)
    olmo = olmo_train(card)
    reduced = reduced_steps()
    scans = [scan_train(card, arch, batch,
                        scan_cases[("ssd" if arch.startswith("zamba2") else "mlstm")
                                   + "_scan_bwd"][0]["ms"])
             for arch, batch in SCAN_TRAINS]
    probes = [remat_probe(*p) for p in REMAT_PROBES]
    recompute = recompute_check()
    rest = example_and_resume()
    seconds = time.perf_counter() - t
    log(f"train: phase 17 in {seconds:.1f} s")
    launches = {k: olmo["launches"][k] + sum(r["launches"][k] for r in scans)
                for k in olmo["launches"]}
    # the remat settings side by side: the launcher's "full" runs, the probes
    remat = [{"arch": r["arch"], "global_batch": r["global_batch"], "remat": "full",
              "step_s": r["warm_step_s"], "peak_cuda_mb": r["peak_cuda_mb"],
              "source": "launcher"} for r in [olmo, *scans]]
    remat += [dict(p, source="probe") for p in probes]
    for r in remat:
        log(f"train remat {r['arch']} {r['global_batch']} x 4096 remat={r['remat']}: "
            f"{r['step_s']:.3f} s a warm step, peak {r['peak_cuda_mb']:.1f} MB "
            f"({r['source']})")
    return {"backward": cases, **scan_cases, "olmo": olmo, "reduced": reduced,
            "scan_trains": scans, "remat": remat, "recompute": recompute, **rest,
            "launches": launches, "seconds": seconds}


def sharded_rank(argv: list) -> dict:
    """Phase 18's ``run_ranks`` target (at module level, so the spawned rank
    imports it): ``launch.train.main(argv)`` on this rank of the initialized
    process group (the launcher's mesh path), counting the kernel calls
    that enter through ``local_map`` (``ops._on_shards``); after its last
    step, with the run's counts taken, one more step on the mesh profiled
    (``device_profile``; the last step's time holds it).  The losses, step
    times, launches, the profile, peak CUDA MB and what the run saw of the
    mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.train import steps

    inner, seen = ops._on_shards, {"calls": 0, "dtensor_q": 0}
    make_step, taken = steps.make_train_step, {}
    n_steps = int(argv[argv.index("--steps") + 1])

    def counted(fn, args, *rest):
        seen["calls"] += 1
        seen["dtensor_q"] += isinstance(args[0], DTensor)
        return inner(fn, args, *rest)

    def profiled(cfg, opt_cfg):
        step = make_step(cfg, opt_cfg)

        def run(model, opt, batch):
            out = step(model, opt, batch)
            taken["steps"] = taken.get("steps", 0) + 1
            if taken["steps"] == n_steps:
                torch.cuda.synchronize()
                # the profiled step keeps a second AdamW state alive: the
                # run's peak is read before it
                taken.update(launches=ops.launch_counts(), on_shards=dict(seen),
                             peak_mb=torch.cuda.max_memory_allocated() / 2**20)
                taken["profile"] = device_profile(lambda: step(model, out[0], batch))
            return out
        return run

    ops._on_shards, steps.make_train_step = counted, profiled
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        losses, mon = launch.main(argv)
    finally:
        ops._on_shards, steps.make_train_step = inner, make_step
    torch.cuda.synchronize()
    prof = taken["profile"]
    return {"losses": losses, "step_s": [dt for _, dt in mon.times],
            "launches": taken["launches"], "on_shards": taken["on_shards"],
            "profile": {"device_ms": prof["device_ms"], "launches": prof["launches"],
                        "top": prof["top"], "kernels": prof["kernels"],
                        "attempts": prof["attempts"]},
            "peak_cuda_mb": taken["peak_mb"], "world": dist.get_world_size(),
            "backend": dist.get_backend(),
            "device": torch.cuda.get_device_name(torch.cuda.current_device())}


def sharded_phase(train: dict, smi: str) -> dict:
    """Phase 18: the sharded launcher on the card.  The published olmo-1b
    (2 x 4096, remat "full") trains 4 steps through ``launch.train``'s mesh
    path on a (1, 1) DeviceMesh over NCCL at world size 1 (``run_ranks``):
    every parameter, AdamW moment and batch a DTensor, every flash call
    through ``local_map``; its first loss held to phase 17's at the same
    seed (``BWD_TOL``'s bf16 rule), its launches exact, its warm step (the
    median of steps 2-3; the last holds the profile) and peak beside phase
    17's.  The warm step's gap to phase 17's splits by the two profiled
    steps into the card's extra kernel time (and by group, and the kernels
    that grew most) and the rest, the host's, which the card idles."""
    from repro_torch.configs import registry
    from repro_torch.core.ranks import run_ranks

    cfg = registry.get("olmo-1b")
    n_steps = 4
    ckpt = OUT_DIR / "sharded_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = [a for a in TRAIN_ARGV] + ["--ckpt-dir", str(ckpt), "--data-mesh", "1", "1"]
    argv[argv.index("--steps") + 1] = str(n_steps)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    res = run_ranks(sharded_rank, 1, args=(argv,))
    call_s = time.perf_counter() - t
    shutil.rmtree(ckpt, ignore_errors=True)
    want = train_launches(cfg, n_steps)
    if res["launches"] != want:
        fail(f"sharded: kernel launches {res['launches']}, expected {want}")
    if res["on_shards"] != {"calls": want["flash_attention"],
                            "dtensor_q": want["flash_attention"]}:
        fail(f"sharded: {res['on_shards']} kernel calls through local_map, "
             f"{want['flash_attention']} flash launches")
    losses = res["losses"]
    if len(losses) != n_steps or not all(math.isfinite(x) for x in losses):
        fail(f"sharded: losses {losses}")
    olmo = train["olmo"]
    rel = abs(losses[0] / olmo["losses"][0] - 1)
    if rel > BWD_TOL[torch.bfloat16]:
        fail(f"sharded: first loss {losses[0]} against phase 17's {olmo['losses'][0]}")
    warm_s = statistics.median(res["step_s"][1:-1])
    prof, prof17 = res["profile"], olmo["profile"]
    gap_ms = (warm_s - olmo["warm_step_s"]) * 1e3
    device_gap_ms = prof["device_ms"] - prof17["device_ms"]
    groups, groups17 = (split_kernels(p["kernels"], OLMO_GROUPS) for p in (prof, prof17))
    grown = sorted(((name[:80], ms - prof17["kernels"].get(name, 0.0))
                    for name, ms in prof["kernels"].items()), key=lambda kv: -kv[1])[:5]
    split = {"gap_ms": gap_ms, "device_gap_ms": device_gap_ms,
             "host_gap_ms": gap_ms - device_gap_ms,
             "device_ms": prof["device_ms"], "phase17_device_ms": prof17["device_ms"],
             "launches": prof["launches"], "phase17_launches": prof17["launches"],
             "idle_share": 1 - prof["device_ms"] / (warm_s * 1e3),
             "phase17_idle_share": olmo["idle_share"],
             "groups_ms": groups, "phase17_groups_ms": groups17, "grown_ms": grown,
             "attempts": prof["attempts"]}
    row = {"arch": cfg.name, "global_batch": 2, "seq_len": 4096, "steps": n_steps,
           "mesh": (1, 1), "world": res["world"], "backend": res["backend"],
           "device": res["device"], "losses": losses, "first_loss_rel": rel,
           "phase17_first_loss": olmo["losses"][0], "step_s": res["step_s"],
           "warm_step_s": warm_s, "phase17_warm_step_s": olmo["warm_step_s"],
           "step_gap_s": warm_s - olmo["warm_step_s"], "gap_split": split,
           "peak_cuda_mb": res["peak_cuda_mb"],
           "phase17_peak_cuda_mb": olmo["peak_cuda_mb"], "launches": res["launches"],
           "on_shards": res["on_shards"], "call_s": call_s}
    log(f"sharded olmo-1b on a (1, 1) mesh, {res['backend']} world {res['world']}, "
        f"2 x 4096, {n_steps} steps: losses={losses} (first {rel:.2e} from phase "
        f"17's); warm step {warm_s:.3f} s against phase 17's "
        f"{olmo['warm_step_s']:.3f} s; peak_cuda_MB={res['peak_cuda_mb']:.1f} against "
        f"{olmo['peak_cuda_mb']:.1f}; launches={res['launches']}; {call_s:.1f} s for "
        f"the call [{smi}]")
    log(f"sharded step gap {gap_ms:.1f} ms (profiled steps): the card's kernels "
        f"{prof['device_ms']:.1f} ms in {prof['launches']} launches against phase 17's "
        f"{prof17['device_ms']:.1f} ms in {prof17['launches']} ({device_gap_ms:+.1f} ms), "
        f"the rest {gap_ms - device_gap_ms:+.1f} ms on the host; idle share "
        f"{split['idle_share']:.3f} against {olmo['idle_share']:.3f}; by group {groups} "
        f"against {groups17}; grown most {grown}")
    return row


#: phase 19 (c)'s cells, at 2 layers on the fake 16 x 16 mesh with the
#: published config's embed rule: (arch, shape, (seq, batch) the shape is
#: cut to, or None): the archs whose heads do not divide the model axis at
#: their published shapes; zamba2's Mamba block on rows with its SSD heads
#: split and xlstm's mLSTM scan with each chunk's rows split at the parity
#: tests' cut (tests/dryrun_cells.CUT), whose FLOPs a device PERF.md lists
HEADS_CELLS = (("deepseek-coder-33b", "train_4k", None), ("xlstm-1.3b", "decode_32k", None),
               ("zamba2-1.2b", "train_4k", (1024, 32)), ("xlstm-1.3b", "train_4k", (1024, 32)),
               ("gemma-2b", "decode_32k", (4096, 128)),
               ("deepseek-coder-33b", "decode_32k", (4096, 128)))
#: phase 19 (c): repro's record of a cell at the same cut, from ``python
#: tests/dryrun_cells.py`` on a CPU (JAX is not installed beside the card),
#: held here: FLOPs a device within ``HELD_FLOPS_RTOL`` (decode's q/k/v
#: contracted over each model rank's slice of d_model) and the embed
#: region's wire bytes a device at most ``HELD_EMBED_RATIO`` times repro's
#: (the tokens looked up in each rank's vocab rows)
REPRO_HELD = {("deepseek-coder-33b", "decode_32k"): {"flops": 2950692864.0},
              ("gemma-2b", "decode_32k"): {"embed_wire": 122880.0}}
HELD_FLOPS_RTOL = 0.02
HELD_EMBED_RATIO = 2.0
#: phase 19 (d): the flash kernel on a rank's query rows at an offset of the
#: keys (label, batch, q heads, kv heads, keys, rows, offset, head dim)
ROWS_CASES = (("deepseek-coder-33b rows 1024-1279 of 2048", 1, 56, 8, 2048, 256, 1024, 128),
              ("gemma-2b rows 448-511 of 512", 2, 8, 1, 512, 64, 448, 256))
#: phase 19 (e): the decode kernel over one slice of a split cache (label,
#: batch, q heads, kv heads, slice length, the slice's filled keys)
SLICE_CASES = (("deepseek-coder-33b slice of 2048, 1500 filled", 4, 56, 8, 2048, 1500),
               ("deepseek-coder-33b slice of 256, 100 filled", 8, 56, 8, 256, 100),
               ("slice past kv_len", 8, 56, 8, 256, 0))


def heads_cells(smi: str) -> list:
    """Phase 19 (c): ``lower_cell`` of ``HEADS_CELLS`` at their shapes, each
    required ``ok``, FLOPs and collectives a device logged."""
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.parallel.sharding import default_plan

    rows = []
    for arch, shape, cut in HEADS_CELLS:
        embed = default_plan(registry.get(arch), {"data": 16, "model": 16}).get("embed")
        published = dryrun.SHAPES[shape]
        shapes = {} if cut is None else {shape: ShapeConfig(shape, published.kind, *cut)}
        t = time.perf_counter()
        try:
            with mock.patch.dict(dryrun.SHAPES, shapes):
                rec, gm = dryrun.lower_cell(arch, shape, multi_pod=False,
                                            plan_overrides={"embed": embed},
                                            cfg_overrides={"n_layers": 2})
        except Exception as e:  # reported, then the phase fails
            fail(f"dryrun: {arch} {shape} 16x16 at 2 layers failed: {type(e).__name__}: {e}")
        seconds = time.perf_counter() - t
        del gm
        if rec["status"] != "ok" or dist.is_initialized():
            fail(f"dryrun: {arch} {shape} gave {rec['status']}, a process group left up: "
                 f"{dist.is_initialized()}")
        row = {"arch": arch, "shape": shape, "cut": cut, "mesh": rec["mesh"], "plan": rec["plan"],
               "status": rec["status"], "seconds": seconds, "lower_s": rec["lower_s"],
               "torch": rec["torch"], "cost": rec["cost"],
               "collectives": rec["collectives"], "roofline": rec["roofline"]}
        held = REPRO_HELD.get((arch, shape), {})

        def beside(key):
            return f" (repro {held[key]:.0f})" if key in held else ""

        flops = rec["cost"]["flops_per_device"]
        embed_wire = float(rec["collectives"]["by_region"].get("embed", (0, 0))[1])
        if "flops" in held:
            row["repro_flops"], row["flops_ratio"] = held["flops"], flops / held["flops"]
            if abs(row["flops_ratio"] - 1) > HELD_FLOPS_RTOL:
                fail(f"dryrun: {arch} {shape} does {flops:.0f} FLOPs a device against "
                     f"repro's {held['flops']:.0f} (ratio {row['flops_ratio']:.4f})")
        if "embed_wire" in held:
            row["repro_embed_wire"], row["embed_wire"] = held["embed_wire"], embed_wire
            if embed_wire > HELD_EMBED_RATIO * held["embed_wire"]:
                fail(f"dryrun: {arch} {shape} moves {embed_wire:.0f} wire bytes a device "
                     f"in embed against repro's {held['embed_wire']:.0f}")
        log(f"dryrun (c) {arch} {shape} (seq, batch cut to {cut}) 16x16, 2 layers, "
            f"embed -> {embed}: ok in "
            f"{seconds:.1f} s (torch {rec['torch']}); {flops:.0f} FLOPs a device"
            f"{beside('flops')}, embed wire bytes {embed_wire:.0f}{beside('embed_wire')}"
            f", collectives by region {rec['collectives']['by_region']} [{smi}]")
        rows.append(row)
    return rows


def rows_offset_cases() -> list:
    """Phase 19 (d): ``ops.flash_attention_rows`` on the card (the flash
    kernel, forward and backward, over K/V cut to the rows' end) against
    the plain version over the whole K masked at the offset, forward and
    autograd, at bf16; its launches counted, K/V's gradient past the rows'
    end exactly 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    dtype = torch.bfloat16
    rows = []
    for label, b, hq, hkv, sk, sq, off, d in ROWS_CASES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype).requires_grad_(True)

        q, k, v = randn(b, hq, sq, d), randn(b, hkv, sk, d), randn(b, hkv, sk, d)
        dout = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
        before = (fa.launch_count(), fab.launch_count())
        got = ops.flash_attention_rows(q, k, v, off)
        grads = torch.autograd.grad(got, (q, k, v), dout)
        launched = (fa.launch_count() - before[0], fab.launch_count() - before[1])
        if launched != (1, 1):
            fail(f"dryrun: rows {label}: {launched} flash / flash backward launches, not 1 each")
        want = fa.flash_attention_rows_plain(q, k, v, off)
        want_grads = torch.autograd.grad(want, (q, k, v), dout)
        tol = ATTN_TOL[dtype]
        excess = row_scaled_excess(got.detach(), want.detach(), tol)
        bwd_excess = _bwd_excess(grads, want_grads, BWD_TOL[dtype])
        tail = max(float(g[:, :, off + sq:].abs().max()) if off + sq < sk else 0.0
                   for g in grads[1:])
        err = float((got - want).detach().abs().max())
        if excess > 0 or bwd_excess > 0 or tail != 0:
            fail(f"dryrun: rows {label}: forward excess {excess}, backward excess "
                 f"{bwd_excess}, K/V gradient past the rows {tail}")
        row = {"case": label, "shape": [b, hq, hkv, sk, sq, off, d], "max_abs_err": err,
               "row_scaled_excess": excess, "bwd_excess": bwd_excess,
               "bwd_max_abs_err": max(float((g - w).abs().max())
                                      for g, w in zip(grads, want_grads))}
        log(f"dryrun (d) flash rows {label} {row['shape']} bf16: max_abs_err={err} "
            f"row_scaled_excess={excess} bwd_excess={bwd_excess} "
            f"bwd_max_abs_err={row['bwd_max_abs_err']}")
        rows.append(row)
    return rows


def slice_cases() -> list:
    """Phase 19 (e): ``ops.decode_attention_slice`` on the card (the decode
    kernel with its log-sum-exp) against the plain version's output and
    log-sum-exp, a slice past ``kv_len`` launching nothing (out 0, lse
    -inf); and a cache's two halves merged by their log-sum-exp against
    the plain version over the whole cache."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    dtype = torch.bfloat16
    tol = ATTN_TOL[dtype]
    rows = []
    for label, b, hq, hkv, sk, kv_len in SLICE_CASES:
        q = torch.randn((b, hq, 1, 128), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, hkv, sk, 128), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        before = dec.launch_count()
        out, lse = ops.decode_attention_slice(q, k, v, kv_len)
        launched = dec.launch_count() - before
        if kv_len == 0:
            if launched or out.abs().max() != 0 or not torch.isneginf(lse).all():
                fail(f"dryrun: slice {label}: {launched} launches, max|out| "
                     f"{float(out.abs().max())}, lse not all -inf")
            rows.append({"case": label, "launches": launched})
            log(f"dryrun (e) decode slice {label}: no launch, out 0, lse -inf")
            continue
        want, want_lse = dec.decode_attention_plain(q, k, v, kv_len, return_lse=True)
        n_split = dec.card_split_plan(q, k, kv_len)[0]
        excess = row_scaled_excess(out, want, tol)
        lse_err = float((lse - want_lse).abs().max())
        # the halves [0, h) and [h, sk), merged by their log-sum-exp
        h = sk // 2
        parts = [ops.decode_attention_slice(q, k[:, :, :h], v[:, :, :h], kv_len),
                 ops.decode_attention_slice(q, k[:, :, h:], v[:, :, h:], kv_len - h)]
        top = torch.maximum(parts[0][1], parts[1][1])
        w = [torch.exp(p[1] - top)[..., None] for p in parts]
        merged = sum(p[0].float() * wi for p, wi in zip(parts, w)) / sum(w)
        merged_excess = row_scaled_excess(merged, want, tol)
        if launched != 1 or excess > 0 or lse_err > LSE_ATOL or merged_excess > 0:
            fail(f"dryrun: slice {label}: {launched} launches, excess {excess}, lse "
                 f"{lse_err}, merged halves' excess {merged_excess}")
        row = {"case": label, "shape": [b, hq, hkv, sk, kv_len], "n_split": n_split,
               "launches": launched, "max_abs_err": float((out - want).abs().max()),
               "row_scaled_excess": excess, "lse_max_abs_err": lse_err,
               "merged_excess": merged_excess}
        log(f"dryrun (e) decode slice {label} {row['shape']} bf16, n_split {n_split}: "
            f"max_abs_err={row['max_abs_err']} row_scaled_excess={excess} "
            f"lse_max_abs_err={lse_err} merged halves' excess={merged_excess}")
        rows.append(row)
    return rows


def dryrun_phase(train: dict, smi: str) -> dict:
    """Phase 19: the dry run on the card's host.  (a) ``lower_cell`` of
    olmo-1b at ``train_4k`` on the fake 16 x 16 mesh (256 ranks of torch's
    fake process group): its status, capture seconds, the three roofline
    terms, memory a device, collectives by region and the mesh's device
    type.  (b) A one-device dry run of olmo-1b at phase 17's cell (its
    batch x seq, remat "full"): its ``model_flops`` equal to phase 17's,
    its ``compute_s`` (the graph's FLOPs at 989 TFLOP/s) at most phase 17's
    measured warm step, and the predicted memory (argument + output + temp
    bytes) beside the measured peak CUDA MB.  It launches no kernel: the
    dry run captures and runs nothing."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    t = time.perf_counter()
    rec, gm = dryrun.lower_cell("olmo-1b", "train_4k", multi_pod=False)
    cell_s = time.perf_counter() - t
    del gm
    if rec["status"] != "ok" or dist.is_initialized():
        fail(f"dryrun: olmo-1b train_4k 16x16 gave {rec['status']}, a process group "
             f"left up: {dist.is_initialized()}")
    regions = rec["collectives"]["by_region"]
    if not {"embed", "grad", "mlp", "optimizer"} <= set(regions):
        fail(f"dryrun: collectives by region {sorted(regions)}")
    rf, mem = rec["roofline"], rec["memory"]
    log(f"dryrun (a) olmo-1b train_4k on a fake 16x16 mesh ({rec['device_type']}): "
        f"capture {rec['lower_s']} s, the cell {cell_s:.1f} s; compute "
        f"{rf['compute_s']:.4f} s, memory {rf['memory_s']:.4f} s, collective "
        f"{rf['collective_s']:.4f} s ({rf['dominant']}); memory a device "
        f"{mem['total_bytes'] / 2**30:.2f} GiB {mem}; {rec['collectives']['n_ops']} "
        f"collectives, by region (count, wire bytes) {regions}; plan {rec['plan']}")

    olmo = train["olmo"]
    cfg = registry.get("olmo-1b")
    shape = ShapeConfig("train", "train", olmo["seq_len"], olmo["global_batch"])
    t = time.perf_counter()
    one, gm = dryrun.lower(cfg, shape)
    one_s = time.perf_counter() - t
    del gm
    rf1, mem1 = one["roofline"], one["memory"]
    if rf1["model_flops"] != olmo["model_flops_per_step"]:
        fail(f"dryrun: model_flops {rf1['model_flops']} against phase 17's "
             f"{olmo['model_flops_per_step']}")
    if not 0 < rf1["compute_s"] <= olmo["warm_step_s"]:
        fail(f"dryrun: compute_s {rf1['compute_s']} against phase 17's measured warm "
             f"step {olmo['warm_step_s']} s")
    predicted_mb = mem1["total_bytes"] / 2**20
    ratio = predicted_mb / olmo["peak_cuda_mb"]
    log(f"dryrun (b) olmo-1b one device, {shape.global_batch} x {shape.seq_len}, remat "
        f"{cfg.remat}: capture {one['lower_s']} s ({one_s:.1f} s in all); compute_s "
        f"{rf1['compute_s']:.4f} s against phase 17's warm step "
        f"{olmo['warm_step_s']:.3f} s; memory_s {rf1['memory_s']:.4f} s; predicted "
        f"{predicted_mb:.1f} MB {mem1} against the measured peak "
        f"{olmo['peak_cuda_mb']:.1f} MB (ratio {ratio:.3f}) [{smi}]")
    heads = heads_cells(smi)
    rows = rows_offset_cases()
    slices = slice_cases()
    return {"heads_cells": heads, "flash_rows": rows, "decode_slices": slices,
            "cell": {k: rec[k] for k in ("arch", "shape", "mesh", "n_devices", "plan",
                                         "status", "lower_s", "device_type", "torch", "kernels",
                                         "memory", "cost", "collectives", "roofline")},
            "cell_s": cell_s,
            "one_device": {"shape": [shape.global_batch, shape.seq_len],
                           "remat": cfg.remat, "lower_s": one["lower_s"],
                           "seconds": one_s, "memory": mem1, "cost": one["cost"],
                           "roofline": rf1, "predicted_mb": predicted_mb,
                           "peak_cuda_mb": olmo["peak_cuda_mb"],
                           "predicted_over_peak": ratio,
                           "warm_step_s": olmo["warm_step_s"]}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", type=Path, default=None,
        help="a checkout of another commit: phase 9 also times its SSD kernel "
        "on this card (tools/ssd_times.py --src PARENT)",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the card only")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import mlstm_scan_bwd as mlb
    from repro_torch.kernels import segment_reduce as seg
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssd_scan_bwd as ssb

    # 1. card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    log(f"card: {kind}")
    log(f"nvidia-smi: {smi}")
    bw, bw_name = memory_rate(kind)
    log(f"memory bound uses {bw_name}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t = time.perf_counter()
    build_logs = _build.build_all(KERNEL_SOURCES)
    build_s = time.perf_counter() - t
    names = ", ".join(KERNEL_SOURCES)
    log(f"build: {build_s:.2f} s ({names}: one nvcc each, started together)")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "nvcc.log").write_text(
        "".join(f"== {n}\n{text}" for n, text in build_logs.items())
    )
    ptxas = {name: ptxas_summary(text) for name, text in build_logs.items()}
    for name, kernels in ptxas.items():
        for k in kernels:
            log(f"  ptxas[{name}] {k['kernel']}: {k.get('registers')} registers, "
                f"{k['spill_stores']} bytes spill stores, {k['spill_loads']} "
                "bytes spill loads")
    hgmma = {}
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan", "mlstm_scan",
                 "ssd_scan_bwd", "mlstm_scan_bwd"):
        hgmma[name] = sass_count(_build.library_path(name), "HGMMA")
        if not hgmma[name]:
            fail(f"build: the {name} library's SASS holds no HGMMA: its bf16 "
                 "kernels do not run on the tensor cores")
        log(f"build: the {name} library's SASS holds {hgmma[name]} HGMMA instructions")

    # 3. kernel against its plain version
    cases = kernel_phase(seg, bw)

    # 4-5. the main path; launches counted from here on
    seg.reset_launch_count()
    kripke_rows, frame_rows = kripke_phase(seg)
    kripke_launches = seg.launch_count()
    hlo_rows = hlo_phase(seg)
    launches = seg.launch_count()
    if launches <= kripke_launches:
        fail("the segmented-reduce kernel was not launched on the HLO path")
    log(f"main path kernel launches: kripke={kripke_launches} total={launches}")

    # 6. solve
    solve = solve_phase()

    # 7. attention kernels against their plain versions
    flash_rows, decode_rows = attention_phase(kind)

    # 8. serve olmo-1b; attention launches counted from here on
    serve = serve_phase()

    # 9. the SSD kernel against its plain version
    ssd_rows = ssd_phase(kind, args.parent)

    # 10. serve zamba2-1.2b; its launches counted from here on
    zamba2 = zamba2_phase()

    # 11. the mLSTM kernel against its plain version
    mlstm_rows = mlstm_phase(kind)

    # 12. serve xlstm-1.3b; its launches counted from here on
    xlstm = xlstm_phase()

    # 13. amg, laghos, beatnik; network rows, streaming, the three-layer
    # reports; the segmented reduce's launches counted from here on
    seg.reset_launch_count()
    apps = apps_phase(seg)
    apps["segment_reduce_launches"] = seg.launch_count()
    log(f"apps path kernel launches: segment_reduce={apps['segment_reduce_launches']}")

    # 14. the Benchpark sweeps and the paper's figures; the sweeps'
    # reductions run no kernel of this repo (traced profiles take the
    # f64-limb matmul, pair_codes and torch.unique); fig 7's compiled layer
    # runs the segmented reduce
    seg.reset_launch_count()
    sweeps = sweeps_phase()
    sweeps["segment_reduce_launches"] = seg.launch_count()
    log("sweeps path kernel launches: "
        f"segment_reduce={sweeps['segment_reduce_launches']}")

    # 15. the four apps across ranks over torch.distributed, and the
    # compiled layer captured from their graphs; launches counted from here
    seg.reset_launch_count()
    distributed = distributed_phase(seg, smi)
    distributed["segment_reduce_launches"] = seg.launch_count()
    log("distributed path kernel launches: "
        f"segment_reduce={distributed['segment_reduce_launches']}")

    # 16. serve the MLA, MoE, VLM and encoder-decoder families; attention
    # launches counted from here on
    families = families_phase()

    # 17. train olmo-1b, zamba2-1.2b and xlstm-1.3b at their published
    # size, and the backward kernels; their launches counted from here on
    train = train_phase(kind)

    # 18. the sharded launcher on a (1, 1) mesh over NCCL; its launches are
    # counted in its rank
    sharded = sharded_phase(train, smi)

    # 19. the dry run on the card's host: a fake 256-rank mesh, and one
    # device at phase 17's cell; it launches no kernel
    t = time.perf_counter()
    dry = dryrun_phase(train, smi)
    dry["seconds"] = time.perf_counter() - t
    log(f"dryrun: phase 19 in {dry['seconds']:.1f} s")

    main_case = cases[0]
    entry = {
        "name": "segment_reduce",
        "route": "cuda",
        "source": seg.SOURCE,
        "replaces": "src/repro/core/backend.py:554",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
    }
    entries = [entry]
    # olmo-1b's shapes for the attention kernels, with the launches of its
    # path and phases 16-17's (the backward: olmo-1b's train shape, phase
    # 17's launches); zamba2-1.2b's for the SSD scan, xlstm-1.3b's for the
    # mLSTM scan
    model_kernels = ((fa, flash_rows, (serve, families, train, sharded)),
                     (fab, train["backward"], (train, sharded)),
                     (dec, decode_rows, (serve, families)),
                     (ssd, ssd_rows, (zamba2, train)), (ms, mlstm_rows, (xlstm, train)),
                     (ssb, train["ssd_scan_bwd"], (train,)),
                     (mlb, train["mlstm_scan_bwd"], (train,)))
    for mod, rows, paths in model_kernels:
        name = mod.__name__.rsplit(".", 1)[-1]
        main_row = rows[0]  # the main path's shape
        entries.append(
            {
                "name": name,
                "route": "cuda",
                "source": mod.SOURCE,
                "replaces": REPLACES[name],
                "launches": sum(path["launches"][name] for path in paths),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main_row["ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"],
            }
        )
    OUT_DIR.mkdir(exist_ok=True)
    details = {
        "card": kind,
        "nvidia_smi": smi,
        "memory_rate": bw_name,
        "build_s": build_s,
        "ptxas": ptxas,
        "hgmma": hgmma,
        "kernel_cases": cases,
        "kripke": kripke_rows,
        "kripke_frame_rows": frame_rows,
        "hlo": hlo_rows,
        "solve": solve,
        "attention_flash": flash_rows,
        "attention_decode": decode_rows,
        "serve": serve,
        "ssd": ssd_rows,
        "zamba2": zamba2,
        "mlstm": mlstm_rows,
        "xlstm": xlstm,
        "apps": apps,
        "sweeps": sweeps,
        "distributed": distributed,
        "families": families,
        "train": train,
        "sharded": sharded,
        "dryrun": dry,
        "op_rates": {str(dt): op_rate(kind, dt)[1] for dt in ATTN_TOL},
        "kernels": entries,
    }
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(details, indent=2))
    log(json.dumps({"kernels": entries}))
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
