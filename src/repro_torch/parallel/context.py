"""Ambient (mesh, plan) context for activation sharding constraints.

The port of ``repro/parallel/context.py``.  Model code calls
``shard_act(x, ("batch", "seq", "embed"))`` at layer boundaries; when a
parallel context is installed (the launcher's mesh path) and ``x`` is a
DTensor, this redistributes ``x`` to the plan's placements on its device
mesh (DTensor inserts the collectives, as GSPMD inserts them for
``with_sharding_constraint``); otherwise it returns ``x`` unchanged
(single-device runs never see a mesh).

Tensors the models make from nothing (RoPE's angles, the loss's vocab
iota, a zero aux loss) are plain tensors; :func:`replicate` makes them
replicated DTensors on the context's mesh, so DTensor ops accept them.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Iterator

#: process-wide, not thread-local (the reference's is): on the card the
#: autograd engine runs the backward, and so the recompute of a
#: checkpointed layer, on threads of its own, which must see the plan too
_CTX = SimpleNamespace(mesh=None, plan=None)


@contextlib.contextmanager
def parallel_context(mesh, plan) -> Iterator[None]:
    """Install ``mesh`` (a ``torch.distributed`` DeviceMesh) and ``plan`` (a
    :class:`~repro_torch.parallel.sharding.ShardingPlan`) for the block."""
    prev = (_CTX.mesh, _CTX.plan)
    _CTX.mesh, _CTX.plan = mesh, plan
    try:
        yield
    finally:
        _CTX.mesh, _CTX.plan = prev


def current_plan():
    return _CTX.plan


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_act(x, logical_axes: tuple):
    """Constrain an activation's sharding by logical axes (no-op without a
    context, or for a plain tensor)."""
    if _CTX.mesh is None or _CTX.plan is None or not _is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _CTX.plan.placements(x.device_mesh,
                                                              *logical_axes))


def replicate(x):
    """``x`` as a DTensor replicated over the context's mesh, when a context
    is installed and ``x`` is a plain tensor; otherwise ``x``.  Every rank
    holds the same value, so this moves no bytes."""
    if _CTX.mesh is None or x is None or _is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _CTX.mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` runs on the
    local shards (a partial sum made whole first), for an op DTensor has
    no sharding rule for (``F.logsigmoid``'s backward)."""
    if not _is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    placements = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(fn, out_placements=placements, in_placements=(placements,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)
