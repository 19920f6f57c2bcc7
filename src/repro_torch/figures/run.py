"""The paper's tables and figures, and the sweep smokes, on the port.

    python -m repro_torch.figures.run [--results DIR] [--backend torch|numpy]
    python -m repro_torch.figures.run --smoke [--out DIR]
    python -m repro_torch.figures.run --live [--out DIR]
    python -m repro_torch.figures.run --chaos [--out DIR]

Without a mode flag it renders Table IV and figs 1–6 and 8 into
``--results`` (default ``build/figure_results/``) and prints
``name,us_per_call,derived`` CSV rows.  The backend defaults to a
``REPRO_BACKEND`` setting, else torch on the CUDA card; without a card the
default raises instead of falling back (``--backend numpy`` runs on the
host).  Profiles are cached in ``REPRO_PROFILE_CACHE_DIR`` (default
``~/.cache/repro-torch-profiles``).
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.figures import paper_data


def _fault_free(profs, retry_log, label: str) -> None:
    """A pass with no fault injected has no degraded point and no retry
    event: either would mean a worker failed (e.g. missed the card)."""
    bad = [p.name for p in profs if p.meta.get("degraded")]
    assert not bad, f"{label}: degraded points in a fault-free pass: {bad}"
    assert not retry_log.events, f"{label}: retry events: {retry_log.events}"


def run_figures(backend=None, results: str | None = None) -> list:
    """Run every figure driver; returns the CSV rows.

    Every driver runs even when one fails, but any failure (or a degraded
    point in the sweeps they read) raises ``RuntimeError`` at the end, so
    a broken table never passes for a finished run.  ``backend`` (name or
    instance) holds for every driver through ``use_backend``; it is
    resolved first, so without a card the default raises
    ``BackendUnavailable`` before any driver runs.  ``results`` replaces
    :data:`paper_data.RESULTS`.
    """
    from contextlib import nullcontext

    from repro_torch.core.backend import resolve_backend, use_backend
    from repro_torch.figures import (
        fig1_kripke_scaling,
        fig2_amg_levels,
        fig3_amg_ranks,
        fig4_laghos_strong,
        fig8_halo_heatmap,
        fig56_bw_msgrate,
        table4_metrics,
    )

    resolve_backend(backend)
    if results is not None:
        paper_data.RESULTS = results
    paper_data.profiles.cache_clear()  # this run's backend and cache
    paper_data.RETRY_LOG.events.clear()
    # Figure 7 (HLO against traced) waits for the HLO producer, and the
    # roofline table for the model stack's dry-run records.
    modules = [
        ("table4", table4_metrics),
        ("fig1", fig1_kripke_scaling),
        ("fig2", fig2_amg_levels),
        ("fig3", fig3_amg_ranks),
        ("fig4", fig4_laghos_strong),
        ("fig56", fig56_bw_msgrate),
        ("fig8", fig8_halo_heatmap),
    ]
    out, errors = [], []
    ctx = use_backend(backend) if backend is not None else nullcontext()
    with ctx:
        print("name,us_per_call,derived")
        for name, mod in modules:
            try:
                rows = mod.run()
            except Exception as e:  # run the rest, then fail below
                print(f"{name}/ERROR,0,{type(e).__name__}:{e}")
                errors.append(f"{name}: {type(e).__name__}: {e}")
                continue
            for row_name, us, derived in rows:
                print(f"{row_name},{us:.2f},{derived}")
            out += rows
        try:
            profs = [
                p
                for exp in paper_data.PAPER_EXPERIMENTS
                for p in paper_data.profiles(exp)
            ]
            _fault_free(profs, paper_data.RETRY_LOG, "figures")
        except Exception as e:
            errors.append(f"sweeps: {type(e).__name__}: {e}")
    if errors:
        raise RuntimeError("figure drivers failed: " + "; ".join(errors))
    return out


def _rss_mb() -> float:
    """The process's resident set now (``VmRSS``) in MiB; its peak so far
    where ``/proc`` does not say."""
    import resource

    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _other_backend(used):
    """The backend the cross-backend pass compares with: NumPy for torch;
    for NumPy, torch on the card, or on the host where there is none."""
    import torch

    from repro_torch.core.backend import NumpyBackend, TorchBackend

    if used.name == "numpy":
        return TorchBackend(device="cuda" if torch.cuda.is_available() else "cpu")
    return NumpyBackend()


def run_smoke(out_dir: str, backend=None) -> dict:
    """Smoke: paper-scale cache sweep + an 8192-rank four-app sweep.

    First, the paper's 64..512-rank kripke experiment runs twice: the
    first pass traces under the process-pool executor and populates the
    shared profile cache (the directory manifest must account for every
    worker's hits/misses exactly); the second (serial) pass must be served
    entirely from the cache and produce byte-identical profiles.  A third,
    uncached serial pass re-traces the sweep on the *other* reduction
    backend (NumPy when this run used torch, torch when it used NumPy) and
    must also be byte-identical — the cross-backend exactness contract
    from ``repro_torch.core.backend``, asserted end to end.  Then every
    ``SCALE_EXPERIMENTS`` app (the paper's three plus the beatnik
    global-communication stressor) sweeps its points up to 8192 ranks and
    the aggregated frame lands in ``scale_frame.csv``; the 32k+ points
    stay offline.  No pass may return a degraded point or log a retry.
    Peak RSS is recorded to ``scale_peak_rss.txt``, and the peak above the
    RSS the process holds when the smoke starts (its imports done) has a
    soft threshold from ``REPRO_SMOKE_RSS_SOFT_MB``: importing torch alone
    can hold more than the threshold on a CUDA host (4.5 GB resident after
    a 7.3 GB peak on an H100 host), and that cost is not the sweep's.  The
    fig8
    network-layer artifacts
    (binned 8192-rank halo heatmap + modeled-fabric frame) ride along via
    ``fig8_halo_heatmap.smoke_artifacts``.  Profile JSONs, the
    Thicket-frame CSVs and ``smoke_summary.json`` (the seconds and
    counters below) land in ``out_dir``; the summary is also returned.
    """
    import resource
    import time
    from dataclasses import replace

    from repro_torch.benchpark.runner import (
        ProfileCache,
        RetryLog,
        default_cache_dir,
        run_experiment,
    )
    from repro_torch.benchpark.spec import PAPER_EXPERIMENTS, SCALE_EXPERIMENTS
    from repro_torch.core.backend import resolve_backend
    from repro_torch.core.thicket import Frame
    from repro_torch.figures import fig8_halo_heatmap

    start_mb = _rss_mb()
    be = resolve_backend(backend)
    spec = PAPER_EXPERIMENTS["kripke-weak-dane"]  # 64..512 ranks
    cache_root = default_cache_dir()
    n = len(spec.points)
    rlog = RetryLog()

    cache = ProfileCache(cache_root)
    m0 = cache.manifest.read()
    t0 = time.perf_counter()
    first = run_experiment(
        spec, out_dir=out_dir, cache=cache, executor="process", backend=be,
        retry_log=rlog,
    )
    t1 = time.perf_counter()
    assert len(first) == n
    m1 = cache.manifest.read()
    served = m1["hits"] - m0["hits"]
    traced = m1["misses"] - m0["misses"]
    # exact cross-process accounting via the shared manifest
    assert served + traced == n, (m0, m1)

    cache2 = ProfileCache(cache_root)
    second = run_experiment(
        spec, out_dir=out_dir, cache=cache2, executor="serial", backend=be,
        retry_log=rlog,
    )
    t2 = time.perf_counter()
    assert cache2.hits == n and cache2.misses == 0, (cache2.hits, cache2.misses)
    m2 = cache.manifest.read()
    assert m2["hits"] - m1["hits"] == n, (m1, m2)
    assert m2["misses"] == m1["misses"], (m1, m2)
    for a, b in zip(first, second):
        assert a.to_json() == b.to_json()

    # cross-backend pass: re-trace (no cache) on the other backend and
    # require byte-identical profiles
    other = _other_backend(be)
    t_x0 = time.perf_counter()
    cross = run_experiment(
        spec, verbose=False, cache=None, executor="serial", backend=other,
        retry_log=rlog,
    )
    for a, b in zip(first, cross):
        assert a.to_json() == b.to_json(), (be, other)
    t_x1 = time.perf_counter()

    # one aggregated Thicket frame over the sweep's profile JSONs
    frame = Frame.from_profile_dir(out_dir)
    assert len(frame) >= n
    frame_path = os.path.join(out_dir, "thicket_frame.csv")
    with open(frame_path, "w") as f:
        f.write(frame.to_csv())

    # 8192-rank four-app sweep: struct payloads are generator fingerprints
    # materialized lazily per reduction, so rank counts 16x past the
    # paper's tables complete inside the smoke's budget.
    t3 = time.perf_counter()
    scale_profiles = []
    scale_seconds = {}
    for sname, sspec in SCALE_EXPERIMENTS.items():
        pts = tuple(p for p in sspec.points if p.n_ranks <= 8192)
        assert any(p.n_ranks == 8192 for p in pts), sname
        ts = time.perf_counter()
        scale_profiles += run_experiment(
            replace(sspec, points=pts),
            out_dir=out_dir,
            cache=cache,
            executor="process",
            backend=be,
            retry_log=rlog,
        )
        scale_seconds[sname] = time.perf_counter() - ts
    t4 = time.perf_counter()
    scale_frame = Frame.from_profiles(scale_profiles)
    assert len(scale_frame) >= len(scale_profiles)
    assert any(prof.n_ranks == 8192 for prof in scale_profiles)
    assert any(prof.meta.get("app") == "beatnik" for prof in scale_profiles)
    scale_path = os.path.join(out_dir, "scale_frame.csv")
    with open(scale_path, "w") as f:
        f.write(scale_frame.to_csv())
    _fault_free(first + second + cross + scale_profiles, rlog, "smoke")

    # fig8 network-layer artifacts at the same 8192-rank regime: binned
    # halo-exchange heatmap CSV/ASCII plus the modeled-fabric frame
    # (O(unique structs) asserted inside).
    t5 = time.perf_counter()
    fig8_info = fig8_halo_heatmap.smoke_artifacts(out_dir, backend=be)
    t6 = time.perf_counter()

    # Peak RSS of the whole smoke (ru_maxrss is KiB on Linux): recorded as
    # an artifact next to scale_frame.csv; the sweep's share is soft-gated
    # so a memory regression in the scale sweep fails loudly.
    # The peak may be the imports' own (it counts against the sweep).
    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    sweep_mb = peak_mb - start_mb
    rss_path = os.path.join(out_dir, "scale_peak_rss.txt")
    with open(rss_path, "w") as f:
        f.write(
            f"peak_rss_mb={peak_mb:.1f}\nstart_rss_mb={start_mb:.1f}\n"
            f"sweep_rss_mb={sweep_mb:.1f}\n"
        )
    soft_mb = float(os.environ.get("REPRO_SMOKE_RSS_SOFT_MB", "4096"))
    assert sweep_mb <= soft_mb, (
        f"scale smoke peak RSS {peak_mb:.0f} MiB is {sweep_mb:.0f} above the "
        f"{start_mb:.0f} it started with, past the soft threshold "
        f"{soft_mb:.0f} MiB (REPRO_SMOKE_RSS_SOFT_MB)"
    )
    m3 = cache.manifest.read()
    summary = {
        "backend": repr(be),
        "other_backend": repr(other),
        "points": n,
        "process_pass_s": t1 - t0,
        "cached_serial_pass_s": t2 - t1,
        "cross_backend_pass_s": t_x1 - t_x0,
        "first_pass_hits": served,
        "first_pass_misses": traced,
        "cached_pass_hits": cache2.hits,
        "cached_pass_misses": cache2.misses,
        "frame_rows": len(frame),
        "scale_points": len(scale_profiles),
        "scale_s": t4 - t3,
        "scale_seconds": scale_seconds,
        "fig8": fig8_info,
        "fig8_s": t6 - t5,
        "manifest": m3,
        "peak_rss_mb": peak_mb,
        "start_rss_mb": start_mb,
        "sweep_rss_mb": sweep_mb,
    }
    with open(os.path.join(out_dir, "smoke_summary.json"), "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
    print(
        f"smoke OK: {n} points in {out_dir}; "
        f"first pass {t1 - t0:.1f}s (executor=process, backend={be!r}, "
        f"manifest hits={served} misses={traced}), "
        f"second pass {t2 - t1:.1f}s (serial, served from cache); "
        f"cross-backend pass ({be!r} vs {other!r}) {t_x1 - t_x0:.1f}s, "
        f"byte-identical; "
        f"aggregated frame {len(frame)} rows x {len(frame.columns())} cols "
        f"-> {frame_path}; "
        f"scale sweep ({len(scale_profiles)} points up to 8192 ranks) "
        f"{t4 - t3:.1f}s -> {scale_path}; "
        f"fig8 network layer at 8192 ranks "
        f"({fig8_info['total_sends']} sends / {fig8_info['n_structs']} "
        f"structs); "
        f"peak RSS {peak_mb:.0f} MiB, {sweep_mb:.0f} above its start "
        f"(soft cap {soft_mb:.0f}) -> {rss_path}"
    )
    return summary


def run_live(out_dir: str, backend=None) -> dict:
    """Live smoke: streamed/merged profiles must equal batch, byte for byte.

    The paper's three apps (kripke/amg/laghos weak- and strong-scaling
    experiments) run twice: a batch serial reference pass (no cache), then
    a live process-pool pass (``live_dir`` mode) where every worker streams
    its trace through the incremental profiler and publishes mergeable
    summary shards.  A poller thread runs a ``SweepAggregator`` against the
    shard directory *while the sweep executes*, capturing a mid-flight
    partial frame (tagged with the ingest watermark) that lands in
    ``out_dir/live_partial_frame.csv``.  At the end, both the live pass's
    returned profiles and the aggregator's merged profiles must be
    byte-identical (``to_json()``) to the batch reference for every point,
    and neither pass may return a degraded point or log a retry.  If the
    sweep outruns the poller (every shard already published at first
    ingest), the partial frame is reconstructed deterministically by
    re-ingesting all shards but one into a fresh aggregator.  Returns the
    passes' seconds and counts.
    """
    import shutil
    import tempfile
    import threading
    import time

    from repro_torch.benchpark.aggregator import SweepAggregator
    from repro_torch.benchpark.runner import RetryLog, point_key, run_experiment
    from repro_torch.benchpark.spec import PAPER_EXPERIMENTS
    from repro_torch.core.backend import resolve_backend

    specs = [
        PAPER_EXPERIMENTS["kripke-weak-dane"],
        PAPER_EXPERIMENTS["amg-weak-dane"],
        PAPER_EXPERIMENTS["laghos-strong"],
    ]
    be = resolve_backend(backend)
    used = be.name
    rlog = RetryLog()
    os.makedirs(out_dir, exist_ok=True)

    t0 = time.perf_counter()
    batch = {}
    for spec in specs:
        for (pt, _), prof in zip(
            spec.configs(),
            run_experiment(
                spec, verbose=False, executor="serial", backend=be, retry_log=rlog
            ),
        ):
            batch[point_key(spec, pt)] = prof
    t1 = time.perf_counter()

    live_root = tempfile.mkdtemp(prefix="live-shards-")
    agg = SweepAggregator(live_root)
    partial_csv = None
    stop = threading.Event()

    def poll() -> None:
        nonlocal partial_csv
        while not stop.is_set():
            agg.ingest()
            points = agg.points()
            if points and not (
                agg.complete() and len(points) == len(batch)
            ):
                partial_csv = agg.frame(include_partial=True).to_csv()
            stop.wait(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        live = {}
        for spec in specs:
            for (pt, _), prof in zip(
                spec.configs(),
                run_experiment(
                    spec,
                    verbose=False,
                    executor="process",
                    backend=be,
                    live_dir=live_root,
                    retry_log=rlog,
                ),
            ):
                live[point_key(spec, pt)] = prof
    finally:
        stop.set()
        poller.join()
    t2 = time.perf_counter()

    agg.ingest()
    assert agg.complete(), agg.watermark()
    assert sorted(agg.points()) == sorted(batch), (agg.points(), sorted(batch))
    for key, ref in batch.items():
        assert live[key].to_json() == ref.to_json(), f"live != batch at {key}"
        assert agg.profile(key).to_json() == ref.to_json(), (
            f"aggregated != batch at {key}"
        )
    _fault_free(list(batch.values()) + list(live.values()), rlog, "live")

    if partial_csv is None:
        # Deterministic fallback: replay all shards but the last point's
        # final one into a fresh aggregator, so the artifact always shows a
        # genuine watermark-tagged partial view.
        names = sorted(os.listdir(live_root))
        replay_root = tempfile.mkdtemp(prefix="live-replay-")
        for fname in names[:-1]:
            shutil.copy(
                os.path.join(live_root, fname), os.path.join(replay_root, fname)
            )
        replay = SweepAggregator(replay_root)
        replay.ingest()
        assert not replay.complete()
        partial_csv = replay.frame(include_partial=True).to_csv()
        shutil.rmtree(replay_root, ignore_errors=True)
        partial_note = "reconstructed"
    else:
        partial_note = "mid-flight"
    partial_path = os.path.join(out_dir, "live_partial_frame.csv")
    with open(partial_path, "w") as f:
        f.write(partial_csv)
    final_path = os.path.join(out_dir, "live_final_frame.csv")
    with open(final_path, "w") as f:
        f.write(agg.frame().to_csv())
    n_shards = len([f for f in os.listdir(live_root) if f.endswith(".shard")])
    shutil.rmtree(live_root, ignore_errors=True)

    print(
        f"live smoke OK (backend={used}): {len(batch)} points across "
        f"{len(specs)} apps; "
        f"batch reference {t1 - t0:.1f}s (serial), "
        f"live pass {t2 - t1:.1f}s (process pool + aggregator); "
        f"streamed/merged profiles byte-identical to batch; "
        f"{partial_note} partial frame -> {partial_path}"
    )
    return {
        "backend": repr(be),
        "points": len(batch),
        "batch_serial_s": t1 - t0,
        "live_process_s": t2 - t1,
        "shards": n_shards,
        "partial": partial_note,
    }


def run_chaos(out_dir: str, backend=None) -> dict:
    """Chaos smoke: a fault-injected live sweep must converge or flag.

    The paper's three apps sweep their points up to 256 ranks under a
    *fixed* seeded fault schedule — one hard worker crash (SIGKILL-style
    ``os._exit`` in a pool worker, pinned to first attempts so the retry
    can heal it), one torn shard (the published file is truncated after
    its atomic rename), and one corrupt cache entry (hit on the warm
    pass) — driving every layer of the supervision stack: pool respawn +
    resubmit, bounded shard-load retries + quarantine, corrupt-entry
    quarantine + re-trace.

    The acceptance invariant is *convergence or flagged degradation*,
    never silence: every returned profile is byte-identical
    (``to_json()``) to the fault-free serial reference or carries
    ``meta["degraded"]`` with a nonzero retry count; every aggregator
    point is byte-identical or visibly partial (watermark short of its
    total) with the loss accounted in ``quarantine/``.  The retry log
    (JSONL) and both quarantine directories land in ``out_dir``.  Returns
    the passes' seconds and the fault, event and quarantine counts.
    """
    import shutil
    import tempfile
    import time
    from dataclasses import replace

    from repro_torch.benchpark.aggregator import SweepAggregator
    from repro_torch.benchpark.runner import (
        QUARANTINE_DIRNAME,
        ProfileCache,
        RetryLog,
        point_key,
        run_experiment,
    )
    from repro_torch.benchpark.spec import PAPER_EXPERIMENTS
    from repro_torch.core.backend import resolve_backend
    from repro_torch.core.faultinject import FaultPlan, install_plan

    specs = []
    for name in ("kripke-weak-dane", "amg-weak-dane", "laghos-strong"):
        spec = PAPER_EXPERIMENTS[name]
        pts = tuple(p for p in spec.points if p.n_ranks <= 256)
        assert pts, name
        specs.append(replace(spec, points=pts))
    be = resolve_backend(backend)
    used = be.name
    os.makedirs(out_dir, exist_ok=True)

    t0 = time.perf_counter()
    reference = {}
    ref_log = RetryLog()
    for spec in specs:
        profs = run_experiment(
            spec, verbose=False, executor="serial", backend=be, retry_log=ref_log
        )
        _fault_free(profs, ref_log, "chaos reference")
        for (pt, _), prof in zip(spec.configs(), profs):
            reference[point_key(spec, pt)] = prof
    t1 = time.perf_counter()

    # Exactly one of each fault, pinned to specific points (fault budgets
    # are per-process, so an unpinned rule would fire once per *worker*):
    # - a hard worker crash on kripke@64's first attempt (the ``#a0``
    #   context pin lets the respawned pool's retry heal it),
    # - a torn shard on amg@128 (its first live shard is truncated after
    #   publication -> the aggregator must quarantine, not wedge),
    # - a corrupt cache entry on laghos@32 (poisoned on the warm pass ->
    #   quarantined miss + re-trace, never served garbage).
    fault_spec = (
        "worker_crash@hard,key~kripke-weak-dane-00064#a0;"
        "shard_torn@key~amg-weak-dane-00128;"
        "cache_corrupt@key~laghos-strong-00032"
    )
    torn_point = "amg-weak-dane-00128"
    plan = FaultPlan.parse(fault_spec, seed=2023)
    retry_log = RetryLog(path=os.path.join(out_dir, "chaos_retry_log.jsonl"))
    cache_root = tempfile.mkdtemp(prefix="chaos-cache-")
    live_root = tempfile.mkdtemp(prefix="chaos-shards-")
    cache = ProfileCache(cache_root)

    degraded_keys: set = set()

    def check(profs, spec, label):
        for (pt, _), prof in zip(spec.configs(), profs):
            key = point_key(spec, pt)
            if prof.meta.get("degraded"):
                assert int(prof.meta.get("retries", 0)) > 0, (label, key)
                assert not prof.regions, (label, key)
                degraded_keys.add(key)
            else:
                assert prof.to_json() == reference[key].to_json(), (label, key)

    with install_plan(plan):
        # cold pass: supervised process pool, live shard publication
        for spec in specs:
            check(
                run_experiment(
                    spec,
                    verbose=False,
                    executor="process",
                    backend=be,
                    cache=cache,
                    live_dir=live_root,
                    retry_log=retry_log,
                ),
                spec,
                "cold",
            )
        t2 = time.perf_counter()
        # warm pass: serial over the poisoned cache — the corrupt entry
        # must quarantine and re-trace, never serve garbage
        for spec in specs:
            check(
                run_experiment(
                    spec,
                    verbose=False,
                    executor="serial",
                    backend=be,
                    cache=cache,
                    retry_log=retry_log,
                ),
                spec,
                "warm",
            )
    t3 = time.perf_counter()

    # the injected worker crash must be visible in the retry log
    assert retry_log.events, "fault schedule produced no supervision events"
    manifest = cache.manifest.read()

    # aggregator: ingest until the torn shard's bounded retries settle
    agg = SweepAggregator(live_root)
    for _ in range(agg.max_load_retries + 1):
        agg.ingest()
    partial = []
    for key, ref in reference.items():
        if key not in agg.points():
            partial.append(key)  # never published: must be degraded
            continue
        got, total = agg.watermark(key)
        if got >= total:
            assert agg.profile(key).to_json() == ref.to_json(), key
        else:
            partial.append(key)
    # convergence-or-flagged-degradation: the only points allowed to be
    # partial are the pinned torn-shard one (its loss quarantined) and
    # any the runner itself returned as flagged-degraded
    assert set(partial) <= {torn_point} | degraded_keys, (partial, degraded_keys)
    assert torn_point in partial, "the torn shard healed by accident?"
    assert agg.quarantined, "torn shard left unaccounted"
    assert any(torn_point in os.path.basename(q) for q in agg.quarantined), (
        agg.quarantined
    )

    # artifacts: frame + retry log + both quarantine directories
    frame_path = os.path.join(out_dir, "chaos_frame.csv")
    with open(frame_path, "w") as f:
        f.write(agg.frame(include_partial=True).to_csv())
    for label, root in (("aggregator", live_root), ("cache", cache_root)):
        qdir = os.path.join(root, QUARANTINE_DIRNAME)
        dest = os.path.join(out_dir, "chaos_quarantine", label)
        os.makedirs(dest, exist_ok=True)
        if os.path.isdir(qdir):
            for fname in os.listdir(qdir):
                shutil.copy(os.path.join(qdir, fname), os.path.join(dest, fname))
    n_quarantined = sum(
        len(files)
        for _, _, files in os.walk(os.path.join(out_dir, "chaos_quarantine"))
    )
    shutil.rmtree(live_root, ignore_errors=True)
    shutil.rmtree(cache_root, ignore_errors=True)

    print(
        f"chaos smoke OK (backend={used}, spec='{fault_spec}'): "
        f"{len(reference)} points across {len(specs)} apps; "
        f"reference {t1 - t0:.1f}s (serial), "
        f"cold chaos pass {t2 - t1:.1f}s (process pool + live shards), "
        f"warm chaos pass {t3 - t2:.1f}s (serial over poisoned cache); "
        f"{len(plan.events)} faults fired in the supervisor's process, "
        f"{len(retry_log.events)} supervision events, "
        f"{len(degraded_keys)} degraded points (all flagged), "
        f"{len(partial)} partial aggregator points, "
        f"{n_quarantined} quarantined files, "
        f"manifest corrupt={manifest['corrupt']} "
        f"takeovers={manifest['lock_takeovers']}; "
        f"artifacts -> {out_dir}"
    )
    return {
        "backend": repr(be),
        "points": len(reference),
        "reference_serial_s": t1 - t0,
        "cold_process_s": t2 - t1,
        "warm_serial_s": t3 - t2,
        "supervision_events": len(retry_log.events),
        "event_kinds": sorted({e["kind"] for e in retry_log.events}),
        "degraded": sorted(degraded_keys),
        "partial": sorted(partial),
        "quarantined": n_quarantined,
        "manifest_corrupt": manifest["corrupt"],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description="paper figures / sweep smokes")
    parser.add_argument(
        "--smoke",
        action="store_true",
        help="run the cache/process-pool smoke sweep instead of the figures",
    )
    parser.add_argument(
        "--live",
        action="store_true",
        help="run the live streaming/aggregator smoke pass "
        "(streamed == batch byte-identity)",
    )
    parser.add_argument(
        "--chaos",
        action="store_true",
        help="run the fault-injected chaos smoke "
        "(convergence-or-flagged-degradation under a fixed fault spec)",
    )
    parser.add_argument(
        "--out",
        default=None,
        help="output directory of the smokes (default: RESULTS/smoke)",
    )
    parser.add_argument(
        "--results",
        default=paper_data.RESULTS,
        help="directory of the figures' markdown and CSV files "
        "(default: %(default)s)",
    )
    parser.add_argument(
        "--backend",
        choices=("torch", "numpy"),
        default=None,
        help="reduction backend for the sweeps and reports "
        "(default: REPRO_BACKEND, else torch on the CUDA card)",
    )
    args = parser.parse_args()
    out = args.out or os.path.join(args.results, "smoke")
    if args.chaos:
        run_chaos(out, backend=args.backend)
    elif args.live:
        run_live(out, backend=args.backend)
    elif args.smoke:
        run_smoke(out, backend=args.backend)
    else:
        run_figures(backend=args.backend, results=args.results)


if __name__ == "__main__":
    main()
