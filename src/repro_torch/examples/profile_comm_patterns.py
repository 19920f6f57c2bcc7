"""Reproduce the paper's scaling studies (Benchpark-style) and emit the
figures as markdown + ASCII plots.

    python -m repro_torch.examples.profile_comm_patterns [--device cpu]
        [--backend numpy]

The reductions run on the CUDA card unless the command line asks for the
host.
"""

from repro_torch.benchpark.runner import run_experiment
from repro_torch.benchpark.spec import PAPER_EXPERIMENTS
from repro_torch.core.reports import (ascii_scaling_plot, per_level_report,
                                      table4_metrics)
from repro_torch.examples._args import parse_backend


def main() -> None:
    backend = parse_backend(__doc__.split("\n\n")[0])
    profs = {}
    for name in ("kripke-weak-dane", "amg-weak-dane", "laghos-strong"):
        print(f"running {name} ...")
        profs[name] = run_experiment(PAPER_EXPERIMENTS[name], backend=backend)

    print("\n" + table4_metrics(
        [p for ps in profs.values() for p in ps], backend=backend))

    print("\n" + per_level_report(profs["amg-weak-dane"],
                                  metric="bytes_sent_max", backend=backend))

    ks = profs["kripke-weak-dane"]
    xs = [p.n_ranks for p in ks]
    ys = [p.regions["sweep_comm"].total_bytes_sent for p in ks]
    print("\n" + ascii_scaling_plot(
        xs, ys, title="Kripke total sweep bytes vs ranks (weak scaling)"))

    ls = profs["laghos-strong"]
    ys = [p.regions["halo_exchange"].bytes_sent[1] for p in ls]
    print("\n" + ascii_scaling_plot(
        [p.n_ranks for p in ls], ys,
        title="Laghos halo bytes per rank vs ranks (strong scaling)"))


if __name__ == "__main__":
    main()
