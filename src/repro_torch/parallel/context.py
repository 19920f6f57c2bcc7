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


def _seq_split(x) -> bool:
    """Whether ``x`` is a DTensor split along dim 1, the sequence of a
    (batch, seq, ...) activation."""
    from torch.distributed.tensor import Shard

    return _is_dtensor(x) and any(isinstance(p, Shard) and p.dim == 1
                                  for p in x.placements)


def rows_product(x, w):
    """``x @ w`` for x (batch, seq, K); where x is a DTensor split along its
    sequence, each rank multiplies its own rows by the whole weight (the
    weight gathered), as GSPMD does for rows split along the sequence, and
    the product keeps x's placements.  The weight's gradient is a partial
    sum over every mesh dim that splits the rows, reduced as the gather's
    backward returns it to the weight's placements.  A DTensor cannot fold
    a split sequence dim into the batch, as ``matmul`` does."""
    if not _seq_split(x):
        return x @ w
    import torch
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rows = list(x.placements)
    w_grad = [Partial() if p.is_shard() else Replicate() for p in rows]
    return local_map(torch.matmul, out_placements=rows,
                     in_placements=(rows, [Replicate()] * mesh.ndim),
                     in_grad_placements=(rows, w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def splits_evenly(size: int, logical: str) -> bool:
    """Whether a dim of ``size`` splits evenly over the mesh axes the plan
    gives ``logical`` (always, without a context).  GSPMD pads an uneven
    split; a DTensor's cannot be reshaped, so a caller replicates such a
    dim instead (each device then holds what GSPMD's padded shard holds at
    most)."""
    if _CTX.mesh is None or _CTX.plan is None:
        return True
    axes = _CTX.plan.get(logical)
    names = (axes,) if isinstance(axes, str) else tuple(axes or ())
    dims = tuple(_CTX.mesh.mesh_dim_names or ())
    n = 1
    for a in names:
        n *= _CTX.mesh.size(dims.index(a))
    return size % n == 0


def replicate(x):
    """``x`` as a DTensor replicated over the context's mesh, when a context
    is installed and ``x`` is a plain tensor; otherwise ``x``.  Every rank
    holds the same value, so this moves no bytes."""
    if _CTX.mesh is None or x is None or _is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _CTX.mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def zero_pad(x, pad: tuple):
    """``F.pad(x, pad)`` with zeros; a DTensor none of whose padded dims is
    split is padded shard by shard, its placements kept (torch 2.11's
    DTensor rule for ``pad`` fails on a 2-D mesh)."""
    import torch.nn.functional as F

    if not _is_dtensor(x):
        return F.pad(x, pad)
    padded = {x.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
    if any(p.is_shard() and p.dim in padded for p in x.placements):
        return F.pad(x, pad)
    from torch.distributed.tensor.experimental import local_map

    placements = list(x.placements)
    return local_map(lambda t: F.pad(t, pad), out_placements=placements,
                     in_placements=(placements,), device_mesh=x.device_mesh)(x)


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
