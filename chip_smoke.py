#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check every phase.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit on any mismatch):

1. card — the device's name, and ``nvidia-smi``'s name and power limit;
2. build — compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernel — the segmented-reduce kernel against its plain PyTorch version
   on the card at 2^24 int64 rows (about 4096 spans, one holding half the
   rows), a (2^20, 8) int64 grid and a float64 sum; its median time, the
   bytes bound, the plain version's time and ``scatter_reduce_``'s;
4. kripke — ``repro_torch.apps.kripke.profile`` at the paper's Dane points
   and the weak-scale points up to 131072 ranks, each trace reduced on the
   card and with the port's ``NumpyBackend`` (byte-equal ``to_json()``;
   then three warm reductions on each, alternated, for a like-for-like
   median), then ``Frame.from_profiles`` over them;
5. hlo — ``Frame.from_hlo`` over the golden HLO corpus on the card against
   ``NumpyBackend``; the kernel's launch count must rise on phases 4-5;
6. solve — kripke's ``reference_sweep`` at the paper's per-rank size on the
   card against the same run on the CPU.

It prints a ``{"kernels": [...]}`` line, then, as the last line,
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
SEED = 20260808
#: warm reductions per backend and kripke point, for a like-for-like median
WARM_REDUCTIONS = 3

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


def kernel_phase(seg, bw: float) -> list:
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    n_seg_rows = 1 << 24
    seg_starts, seg_ends = spans_with_giant(rng, n_seg_rows, 4096)
    seg_int = rng.integers(0, 1 << 40, (n_seg_rows, 1), dtype=np.int64)
    seg_f64 = rng.random((n_seg_rows, 1))
    grid_rows = 1 << 20
    blk_starts, blk_ends = random_spans(rng, grid_rows, 4096)
    blk_int = rng.integers(0, 1 << 40, (grid_rows, 8), dtype=np.int64)
    lib_op = {"sum": "sum", "max": "amax", "min": "amin"}
    cases = [
        ("segment_reduce", seg_int, seg_starts, seg_ends, op)
        for op in ("sum", "max", "min")
    ]
    cases += [
        ("block_reduce", blk_int, blk_starts, blk_ends, op)
        for op in ("sum", "max", "min")
    ]
    cases.append(("segment_reduce_f64", seg_f64, seg_starts, seg_ends, "sum"))
    results = []
    for label, host_vals, starts_np, ends_np, op in cases:
        vals = torch.from_numpy(host_vals).to(dev)
        starts = torch.from_numpy(starts_np).to(dev)
        ends = torch.from_numpy(ends_np).to(dev)
        n, c = vals.shape
        s = starts.shape[0]
        got = seg.segment_reduce(vals, starts, ends, op)
        torch.cuda.synchronize()
        want = seg.segment_reduce_plain(vals, starts, ends, op)
        ids = torch.repeat_interleave(torch.arange(s, device=dev), ends - starts)
        ids = ids.unsqueeze(1).expand(n, c).contiguous()
        init = seg.init_value(op, vals.dtype)

        def library():
            out = torch.full((s, c), init, dtype=vals.dtype, device=dev)
            return out.scatter_reduce_(0, ids, vals, lib_op[op], include_self=True)

        lib_out = library()
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
        nbytes = (n * c + s * c) * vals.element_size() + 2 * s * 8
        row = {
            "case": label,
            "op": op,
            "dtype": str(vals.dtype).replace("torch.", ""),
            "shape": [n, c],
            "spans": s,
            "longest_span": int((ends - starts).max()),
            "max_abs_err": err,
            "ms": cuda_ms(lambda: seg.segment_reduce(vals, starts, ends, op), 20),
            "plain_ms": cuda_ms(
                lambda: seg.segment_reduce_plain(vals, starts, ends, op), 3, 1
            ),
            "library_ms": cuda_ms(library, 20),
            "bytes": nbytes,
            "bound_ms": nbytes / bw * 1e3,
        }
        results.append(row)
        log(
            f"kernel {label} {op} {row['dtype']} ({n}, {c}) spans={s}: "
            f"ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
            f"plain_ms={row['plain_ms']:.2f} scatter_reduce_ms="
            f"{row['library_ms']:.4f} max_abs_err={err}"
        )
        del vals, starts, ends, got, want, ids, lib_out
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the card only")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_reduce as seg

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
    build_log = _build.build("segment_reduce")
    build_s = time.perf_counter() - t
    log(f"build: {build_s:.2f} s")
    for line in build_log.splitlines():
        log(f"  nvcc[segment_reduce]: {line}")

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
    OUT_DIR.mkdir(exist_ok=True)
    details = {
        "card": kind,
        "nvidia_smi": smi,
        "memory_rate": bw_name,
        "build_s": build_s,
        "kernel_cases": cases,
        "kripke": kripke_rows,
        "kripke_frame_rows": frame_rows,
        "hlo": hlo_rows,
        "solve": solve,
        "kernels": [entry],
    }
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(details, indent=2))
    log(json.dumps({"kernels": [entry]}))
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
