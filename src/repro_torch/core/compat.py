"""SPMD shim: named mesh axes and a trace-only ``shard_map`` for PyTorch.

The JAX package writes its apps as per-rank programs under
``shard_map`` over a mesh of named axes, and profiles them by tracing once
with ``jax.eval_shape``.  PyTorch has no counterpart that traces a
per-rank program without ranks, so this module supplies the small part
the apps need:

``Mesh`` / :func:`make_mesh`
    Named axes and their sizes (no devices are attached).
``PartitionSpec``
    Which mesh axes split each dimension of a global array
    (``None`` = replicated).
:func:`shard_map`
    Runs the per-rank function **once**, on meta tensors of the local
    shape, inside an axis environment, and returns meta tensors of the
    global output shape.  Only meta tensors are accepted: real execution
    across ranks goes over ``torch.distributed`` in a later slice.
:func:`axis_index` / :func:`axis_size`
    Inside the environment, the rank's coordinate along an axis (a meta
    int64 scalar, so ``t == stage`` and ``torch.where`` trace as they do
    under JAX) and the axis length (a plain int).
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Iterator, Sequence

import torch


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes, row-major (the last axis varies fastest)."""

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    shapes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shapes) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} do not match sizes {shapes}")
    return Mesh(names, shapes)


class PartitionSpec(tuple):
    """Per-dimension mesh axis (a name, a tuple of names, or None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


class _Env(threading.local):
    def __init__(self) -> None:
        self.meshes: list = []


_ENV = _Env()


@contextlib.contextmanager
def axis_env(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh``'s axes visible to :func:`axis_index` / :func:`axis_size`."""
    _ENV.meshes.append(mesh)
    try:
        yield mesh
    finally:
        _ENV.meshes.pop()


def _axis_names(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def axis_size(axis_name) -> int:
    """Length of a mesh axis (product over a tuple of axes)."""
    if not _ENV.meshes:
        raise RuntimeError("axis_size is only defined inside shard_map")
    shape = _ENV.meshes[-1].shape
    out = 1
    for a in _axis_names(axis_name):
        if a not in shape:
            raise NameError(f"unbound axis name: {a!r}")
        out *= shape[a]
    return out


def axis_index(axis_name) -> torch.Tensor:
    """This rank's coordinate along ``axis_name``: a meta int64 scalar."""
    axis_size(axis_name)  # validates the name
    return torch.empty((), dtype=torch.int64, device="meta")


def _split(spec, ndim: int) -> list:
    parts = list(spec) + [None] * (ndim - len(spec))
    if len(parts) != ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return parts


def _factor(mesh: Mesh, part) -> int:
    if part is None:
        return 1
    return math.prod(mesh.shape[a] for a in _axis_names(part))


def _local(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    if x.device.type != "meta":
        raise NotImplementedError(
            "shard_map runs real tensors across ranks over torch.distributed, "
            "which is not ported yet (ROADMAP queue 1, item 6); trace with "
            "meta tensors"
        )
    shape = []
    for size, part in zip(x.shape, _split(spec, x.dim())):
        f = _factor(mesh, part)
        if size % f:
            raise ValueError(f"dim of size {size} does not split {f} ways")
        shape.append(size // f)
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _global(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    shape = [
        size * _factor(mesh, part) for size, part in zip(x.shape, _split(spec, x.dim()))
    ]
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _map(specs, values, fn):
    """``fn(leaf, spec)`` over a tree of values (tensor, tuple, list or
    dict) matched by a tree of specs of the same structure."""
    if isinstance(specs, PartitionSpec):
        return fn(values, specs)
    if isinstance(values, dict):
        return {k: _map(specs[k], v, fn) for k, v in values.items()}
    return type(values)(_map(s, v, fn) for v, s in zip(values, specs))


def shard_map(fn, *, mesh: Mesh, in_specs, out_specs):
    """Trace-only ``shard_map``: run ``fn`` once on one rank's meta shards.

    ``in_specs`` / ``out_specs`` are a :class:`PartitionSpec` each, or a
    tuple with one entry per argument / output, where an entry may itself
    be a tuple or dict of specs matching a tuple or dict argument.  The
    returned callable takes global meta tensors and returns global meta
    tensors.
    """

    def run(*args):
        specs = (in_specs,) if isinstance(in_specs, PartitionSpec) else in_specs
        local = [
            _map(s, a, lambda v, sp: _local(v, sp, mesh)) for a, s in zip(args, specs)
        ]
        with axis_env(mesh):
            out = fn(*local)
        return _map(out_specs, out, lambda v, s: _global(v, s, mesh))

    return run
