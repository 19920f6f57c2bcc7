"""Spawn N local ranks of a per-rank program over ``torch.distributed``.

The JAX package runs its SPMD apps on N host devices by forcing XLA's
host-platform device count.  The port runs them as N processes instead:
:func:`run_ranks` starts one process per rank with the ``spawn`` start
method, joins them into one default process group, calls ``target`` on
every rank and returns rank 0's result::

    from repro_torch.core.ranks import run_ranks
    out = run_ranks(some_module.per_rank_fn, 8, args=(cfg,))        # NCCL
    out = run_ranks(some_module.per_rank_fn, 8, backend="gloo", args=(cfg,))

``target`` must be importable by name (a module-level function of an
installed package): spawned children import it afresh and cannot import
test modules.  The rendezvous is a ``file://`` store in a fresh temporary
directory, so concurrent runs (test workers) never race for a TCP port.
Every wait is bounded: the process group's own timeout covers a rank that
waits on a collective its peers skipped, and the parent kills every child
and raises :class:`TimeoutError` when the run outlasts ``timeout_s``.

The per-rank programs need only an initialized default process group, so
they also run under ``torchrun`` (which sets ``RANK`` / ``WORLD_SIZE``):
call ``torch.distributed.init_process_group(backend)`` and then the
program.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch.multiprocessing as mp

#: Seconds a run may take before its ranks are killed.
DEFAULT_TIMEOUT_S = 300.0


def _child(rank, world_size, backend, init_file, timeout_s, target, args, results):
    """One rank: join the group, run ``target``, report, leave the group."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend,
            init_method=f"file://{init_file}",
            rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            out = target(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(
    target,
    world_size: int,
    *,
    backend: str = "nccl",
    timeout_s: float = DEFAULT_TIMEOUT_S,
    args: tuple = (),
):
    """Run ``target(*args)`` on ``world_size`` spawned ranks; rank 0's result.

    The group runs on the cards (``backend="nccl"``, each child selecting
    the card ``rank % device_count``) unless the caller passes
    ``backend="gloo"`` for the CPU.  Each child sets ``OMP_NUM_THREADS=1``
    and one torch thread.  A rank
    that raises makes the run raise ``RuntimeError`` with its traceback; a
    run that is not over after ``timeout_s`` seconds has every child
    killed and raises ``TimeoutError``.  ``target``'s result (rank 0's)
    and ``args`` are pickled across the process boundary.
    """
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    init_file = os.path.join(tmp, "rendezvous")
    # the group's own timeout fires first, so a rank stuck on a collective
    # reports its error before the parent's deadline kills it
    group_timeout = max(1.0, 0.8 * timeout_s)
    procs = []
    prev = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # children inherit it at start
    try:
        for rank in range(world_size):
            p = ctx.Process(
                target=_child,
                args=(rank, world_size, backend, init_file, group_timeout, target,
                      args, results),
                daemon=True,
            )
            p.start()
            procs.append(p)
    finally:
        if prev is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prev
    deadline = time.monotonic() + timeout_s
    reports, failures = {}, []
    try:
        # drain the queue before joining: a child blocks on exit until its
        # queued result is read
        while len(reports) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                missing = [i for i in range(world_size) if i not in reports]
                if dead and all(procs[i].exitcode is not None for i in missing):
                    break  # the ranks still owed died without reporting
                continue
            reports[rank] = (ok, payload)
            if not ok:
                failures.append(f"rank {rank}:\n{payload}")
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise RuntimeError(f"{len(failures)} of {world_size} ranks failed:\n"
                           + "\n".join(failures))
    if len(reports) < world_size:
        missing = sorted(set(range(world_size)) - set(reports))
        codes = {i: procs[i].exitcode for i in missing}
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"run_ranks: ranks {missing} did not finish within {timeout_s} s "
                "and were killed"
            )
        raise RuntimeError(f"run_ranks: ranks {missing} exited without a result "
                           f"(exit codes {codes})")
    return reports[0][1]
