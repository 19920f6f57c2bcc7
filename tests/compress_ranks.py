"""The ``run_ranks`` target of ``test_torch_optim.py``'s compression test,
in a module of its own so that the spawned ranks import it without the
test module (the ranks inherit the parent's ``sys.path``)."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import compat
from repro_torch.optim.compress import compressed_psum, init_error_state


def run_sharded(grads: dict) -> dict:
    """:func:`compressed_psum` of each rank's block of every leaf (split
    along dim 0 over a 1-D ``data`` mesh of the world size), from a zero
    error state, as NumPy arrays gathered in rank order:
    ``{"mean": {...}, "err": {...}}``."""
    mesh = compat.make_mesh((dist.get_world_size(),), ("data",))
    spec = compat.PartitionSpec("data")
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in grads.items()}
    specs = {k: spec for k in tensors}
    mean, err = compat.shard_map(
        lambda g, e: compressed_psum(g, e, "data"),
        mesh=mesh,
        in_specs=(specs, specs),
        out_specs=(specs, specs),
    )(tensors, init_error_state(tensors))
    return {
        "mean": {k: t.numpy() for k, t in mean.items()},
        "err": {k: t.numpy() for k, t in err.items()},
    }
