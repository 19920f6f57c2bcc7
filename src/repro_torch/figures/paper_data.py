"""Shared data for the figure drivers: run the paper's experiments once."""

from __future__ import annotations

import functools
import os

from repro_torch.benchpark.runner import RetryLog, default_cache_dir, run_experiment
from repro_torch.benchpark.spec import PAPER_EXPERIMENTS

#: Where the figure drivers write their markdown and CSV files (``--results``).
RESULTS = os.path.join("build", "figure_results")
#: The sweeps' supervision events (a fault-free run must log none).
RETRY_LOG = RetryLog()


@functools.lru_cache(maxsize=None)
def profiles(exp_name: str) -> tuple:
    spec = PAPER_EXPERIMENTS[exp_name]
    out_dir = os.path.join(RESULTS, "profiles")
    # content-addressed on-disk cache, shared with the benchpark runner and
    # the smoke sweep (REPRO_PROFILE_CACHE_DIR overrides the location):
    # regenerating figures re-traces nothing unless configs or profiling
    # code changed
    return tuple(run_experiment(spec, out_dir=out_dir, verbose=False,
                                cache_dir=default_cache_dir(),
                                retry_log=RETRY_LOG))


def write(name: str, text: str) -> str:
    os.makedirs(RESULTS, exist_ok=True)
    path = os.path.join(RESULTS, name)
    with open(path, "w") as f:
        f.write(text)
    return path
