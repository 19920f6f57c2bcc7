"""The examples' shared ``--backend`` / ``--device`` options."""

from __future__ import annotations

import argparse

from repro_torch.core.backend import NumpyBackend, ReduceBackend, TorchBackend


def parse_backend(description: str) -> ReduceBackend:
    """The reduction backend the command line asks for: torch on the CUDA
    card by default (``BackendUnavailable`` without one), ``--device cpu``
    for torch on the host, ``--backend numpy`` for NumPy."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument(
        "--backend", choices=("torch", "numpy"), default="torch",
        help="reduction backend (default: %(default)s)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the torch backend (default: %(default)s)",
    )
    args = parser.parse_args()
    if args.backend == "numpy":
        return NumpyBackend()
    return TorchBackend(device=args.device)
