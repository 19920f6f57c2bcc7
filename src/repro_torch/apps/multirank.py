"""The apps and the collectives run across ranks: ``run_ranks`` targets.

Each function here is a per-rank program for
:func:`repro_torch.core.ranks.run_ranks` (or ``torchrun``, after
``init_process_group``): every rank calls it inside one default process
group and rank 0's return value is the run's result.  They live in the
package because spawned ranks import their target by name.

:func:`run_apps`
    kripke's ``distributed_sweep``, amg's ``solve``, laghos's and beatnik's
    ``run_steps`` on the group's ranks (on the card unless the caller asks
    for the CPU), each recorded while it runs; rank 0 returns the global
    outputs, the recorded profile and its meta trace's profile (both
    ``to_json()``), the single-domain oracle's outputs, and the seconds of
    a first (cold) and a second (warm) call of each.
:func:`run_collective_cases`
    Each instrumented collective on a mesh of CPU tensors (a gloo group),
    every rank's result gathered: the CPU tests' target.

Both return each rank's peak RSS and wall-clock entry and exit times under
``"ranks"``.

As a program it runs the four drivers and holds each to its oracle and its
meta trace (:func:`check`)::

    python -m repro_torch.apps.multirank --ranks 8 --device cpu
    torchrun --standalone --nproc-per-node 8 -m repro_torch.apps.multirank --device cpu

8 ranks take :data:`PARITY_PARAMS`, 1 rank :data:`ONE_RANK_PARAMS`; the
device defaults to the CUDA card (NCCL), ``--device cpu`` runs gloo on the
host.  Without ``torchrun`` the ranks are spawned by ``run_ranks``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.apps import amg, beatnik, kripke, laghos
from repro_torch.apps.stencil import Decomp3D
from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.backend import TorchBackend
from repro_torch.core.profiler import CommPatternProfiler
from repro_torch.core.regions import recording

#: The 8-rank parity configs of ``tests/test_apps.py`` (decomposition and
#: the config's other fields).
PARITY_PARAMS = {
    "kripke": dict(decomp=(2, 2, 2), nx=4, ny=4, nz=4, n_dirsets=2, n_groupsets=2,
                   dirs_per_set=2, groups_per_set=2, n_octants=3),
    "amg": dict(decomp=(2, 2, 2), nx=8, ny=8, nz=8),
    "laghos": dict(decomp=(4, 2, 1), nx=32, ny=32, n_steps=3),
    "beatnik": dict(decomp=(4, 2, 1), nx=8, ny=8, far_subsample=8, n_steps=3),
}

#: One rank of each app at its paper per-rank size
#: (``repro_torch/benchpark/spec.py``: kripke-weak-dane, amg-weak-dane,
#: laghos-strong, beatnik-weak-scale).
ONE_RANK_PARAMS = {
    "kripke": dict(decomp=(1, 1, 1), nx=16, ny=32, nz=32, n_octants=2,
                   fuse_messages=False),
    "amg": dict(decomp=(1, 1, 1), nx=32, ny=32, nz=16),
    "laghos": dict(decomp=(1, 1, 1), nx=512, ny=512, n_steps=2),
    "beatnik": dict(decomp=(1, 1, 1), nx=32, ny=32, n_steps=4),
}

#: (rtol, atol) of each output (:func:`flat_outputs` order) against the
#: oracle: ``tests/test_apps.py``'s 8-rank parity tolerances
TOLERANCES = {
    "kripke": [(2e-5, 2e-5)],
    "amg": [(2e-4, 2e-5), (1e-4, 0.0)],
    "laghos": [(5e-5, 5e-6)] * 4 + [(1e-5, 0.0)],
    "beatnik": [(5e-5, 5e-6)] * 2 + [(1e-4, 0.0)],
}

_CONFIGS = {
    "kripke": kripke.KripkeConfig,
    "amg": amg.AMGConfig,
    "laghos": laghos.LaghosConfig,
    "beatnik": beatnik.BeatnikConfig,
}


def app_config(app: str, params: dict):
    """The app's config from ``params`` (``decomp`` as a 3-tuple)."""
    p = dict(params)
    return _CONFIGS[app](decomp=Decomp3D(*p.pop("decomp")), **p)


def app_inputs(app: str, cfg, device):
    if app == "kripke":
        return kripke.make_source(cfg, global_shape=True, device=device)
    if app == "amg":
        return amg.make_rhs(cfg, device=device)
    return {"laghos": laghos, "beatnik": beatnik}[app].make_state(cfg, device=device)


def app_driver(app: str, cfg):
    mesh = cfg.decomp.make_mesh()
    return {
        "kripke": kripke.distributed_sweep,
        "amg": amg.solve,
        "laghos": laghos.run_steps,
        "beatnik": beatnik.run_steps,
    }[app](cfg, mesh)


def app_oracle(app: str, cfg):
    if app == "kripke":
        return kripke.reference_sweep(cfg)
    if app == "amg":
        return amg.reference_solve(cfg)[0]
    return {"laghos": laghos, "beatnik": beatnik}[app].reference_steps(cfg)


def flat_outputs(out) -> list:
    """The tensors of a driver's or oracle's result, in a fixed order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in flat_outputs(out[k])]
    return [t for v in out for t in flat_outputs(v)]


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t


def _host(tensors) -> list:
    return [t.detach().cpu().numpy() for t in tensors]


def _rss_mb():
    """This process's resident set now (``VmRSS``) in MiB, or None where
    /proc does not give it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return None


def _rank_stats(t_enter: float, rss_samples: list) -> list:
    """Every rank's peak RSS (MiB) and wall-clock entry / exit, on rank 0.

    The peak is the largest ``VmRSS`` sampled: at entry, after each run and
    at exit.  Not ``ru_maxrss``, which Linux keeps across ``exec``: a
    spawned rank would report the RSS of the process it was forked from.
    """
    seen = [s for s in [*rss_samples, _rss_mb()] if s is not None]
    mine = {
        "rank": dist.get_rank(),
        "peak_rss_mb": max(seen, default=None),
        "t_enter": t_enter,
        "t_exit": time.time(),
    }
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def run_apps(params: dict, device: str = "cuda") -> dict:
    """Each app of ``params`` (app -> :func:`app_config` params) through its
    distributed driver on this group's ranks, on ``device``: this rank's
    card (NCCL) unless the caller passes ``"cpu"`` (gloo).

    Each driver is called twice: the first call is timed cold (it pays the
    group's first collectives and the first kernel launches), the second
    warm, under the app's topology and recorded.  Rank 0 reduces the
    recording and the app's meta trace on ``TorchBackend(device)`` and
    runs the single-domain oracle on the same inputs, cold and warm too.
    Returns (on rank 0) ``{app: {"out", "oracle", "profile",
    "trace_profile", "seconds", "cold_seconds", "oracle_seconds",
    "oracle_cold_seconds"}, "ranks": [...]}`` with outputs as NumPy arrays
    in :func:`flat_outputs` order.
    """
    t_enter = time.time()
    rss = [_rss_mb()]
    backend = TorchBackend(device=device)  # without a card: BackendUnavailable
    dev = backend.device
    if dev.type == "cuda":
        dev = backend.device = torch.device("cuda", torch.cuda.current_device())
    rank0 = dist.get_rank() == 0
    modules = {"kripke": kripke, "amg": amg, "laghos": laghos, "beatnik": beatnik}
    result = {}
    for app, p in params.items():
        cfg = app_config(app, p)
        x = app_inputs(app, cfg, dev)
        run = app_driver(app, cfg)
        name = f"{app}-{cfg.decomp.n_ranks}"
        meta = dict(app=app, decomp=cfg.decomp.shape)
        with cfg.decomp.topology():
            cold = _timed(lambda: run(x), dev)[1]
            with recording() as rec:
                out, seconds = _timed(lambda: run(x), dev)
        rss.append(_rss_mb())
        if not rank0:
            continue
        oracle = app_oracle(app, cfg)
        oracle_cold = _timed(lambda: oracle(x), dev)[1]
        ref, oracle_seconds = _timed(lambda: oracle(x), dev)
        result[app] = {
            "out": _host(flat_outputs(out)),
            "oracle": _host(flat_outputs(ref)),
            "seconds": seconds,
            "cold_seconds": cold,
            "oracle_seconds": oracle_seconds,
            "oracle_cold_seconds": oracle_cold,
            "profile": CommPatternProfiler.from_recorder(
                rec, name=name, meta=meta, backend=backend).to_json(),
            "trace_profile": modules[app].profile(
                cfg, name=name, device=dev).to_json(),
        }
    result["ranks"] = _rank_stats(t_enter, rss)
    return result


def check(app: str, row: dict) -> dict:
    """A :func:`run_apps` row held to :data:`TOLERANCES`: the largest
    absolute error, whether every output is finite and within them, and
    whether the profile recorded in the run equals the meta trace's; with
    the warm and cold seconds of the driver and of the oracle."""
    tol = TOLERANCES[app]
    ok = len(row["out"]) == len(row["oracle"]) == len(tol)
    err = 0.0
    for got, want, (rtol, atol) in zip(row["out"], row["oracle"], tol):
        if got.shape != want.shape:
            ok = False
            continue
        err = max(err, float(np.abs(got - want).max(initial=0.0)))
        ok = ok and bool(np.isfinite(want).all()) and bool(
            np.allclose(got, want, rtol=rtol, atol=atol))
    return {
        "app": app,
        "within_tolerance": ok,
        "profile_equal": row["profile"] == row["trace_profile"],
        "max_abs_err": err,
        "driver_s": row["seconds"],
        "driver_cold_s": row["cold_seconds"],
        "oracle_s": row["oracle_seconds"],
        "oracle_cold_s": row["oracle_cold_seconds"],
    }


def run_collective_cases(cases: list, inputs: dict) -> dict:
    """Each case on a 2×2×2 mesh over axes x, y, z, on CPU tensors: a
    target for 8 gloo ranks (the CPU tests' per-collective parity).

    A case is ``{"name", "op", "axis", "kwargs"}``: ``op`` names a wrapper
    of :mod:`repro_torch.core.collectives`, ``axis`` an axis name or a list
    of them, ``inputs[name]`` the global input, split over every rank along
    dim 0.  Each rank's result comes back stacked in rank order: the
    global output has one leading entry a rank.
    """
    t_enter = time.time()
    rss = [_rss_mb()]
    mesh = compat.make_mesh((2, 2, 2), ("x", "y", "z"))
    every = compat.PartitionSpec(("x", "y", "z"))
    out = {}
    for case in cases:
        axis = case["axis"] if isinstance(case["axis"], str) else tuple(case["axis"])
        op = getattr(coll, case["op"])
        kwargs = dict(case["kwargs"])
        if "perm" in kwargs:
            kwargs["perm"] = [tuple(p) for p in kwargs["perm"]]

        def body(x, op=op, axis=axis, kwargs=kwargs):
            return op(x, axis, **kwargs)[None]

        got = compat.shard_map(body, mesh=mesh, in_specs=every, out_specs=every)(
            torch.from_numpy(np.asarray(inputs[case["name"]]))
        )
        out[case["name"]] = got.numpy()
    out["ranks"] = _rank_stats(t_enter, rss)
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import os

    from repro_torch.core.ranks import run_ranks

    ap = argparse.ArgumentParser(
        description="Run the four apps' distributed drivers across ranks and hold "
        "each to its oracle and its meta trace.")
    ap.add_argument("--ranks", type=int, choices=(1, 8), default=1,
                    help="ranks to spawn (ignored under torchrun)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card, over NCCL; cpu: the host, over gloo")
    ap.add_argument("--apps", default=",".join(PARITY_PARAMS))
    args = ap.parse_args(argv)
    backend = "nccl" if args.device == "cuda" else "gloo"
    apps = args.apps.split(",")
    table = {1: ONE_RANK_PARAMS, 8: PARITY_PARAMS}
    if "RANK" in os.environ:  # torchrun: join its env:// group on this rank
        world = int(os.environ["WORLD_SIZE"])
        if world not in table:
            ap.error(f"the apps' configs take 1 or 8 ranks, not {world}")
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
        rank = dist.get_rank()
        try:
            res = run_apps({a: table[world][a] for a in apps}, args.device)
        finally:
            dist.destroy_process_group()
        if rank:
            return 0
    else:
        params = {a: table[args.ranks][a] for a in apps}
        res = run_ranks(run_apps, args.ranks, backend=backend,
                        args=(params, args.device))
    rows = [check(app, res[app]) for app in apps]
    for row in rows:
        print(json.dumps(row))
    return 0 if all(r["within_tolerance"] and r["profile_equal"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
