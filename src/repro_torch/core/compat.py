"""SPMD shim: named mesh axes and ``shard_map`` for PyTorch.

The JAX package writes its apps as per-rank programs under
``shard_map`` over a mesh of named axes, profiles them by tracing once
with ``jax.eval_shape``, and runs them across devices.  PyTorch has no
counterpart, so this module supplies the part the apps need:

``Mesh`` / :func:`make_mesh`
    Named axes and their sizes (no devices are attached).
``PartitionSpec``
    Which mesh axes split each dimension of a global array
    (``None`` = replicated; a tuple of names splits one dimension over
    several axes, the first one slowest).
:func:`shard_map`
    On meta tensors (the trace): runs the per-rank function **once**, on
    meta tensors of the local shape, inside an axis environment, and
    returns meta tensors of the global output shape.  On real tensors:
    runs it on this process's rank of an initialized default process group
    (``torch.distributed``) whose world size equals the mesh's rank count,
    on this rank's block of each input, and gathers each partitioned output
    back into the global array on every rank, as ``repro``'s result is a
    global array.  Global rank ``r`` is the mesh coordinate in row-major
    order (the last axis varies fastest), the order ``Topology`` and
    ``Decomp3D.make_mesh`` use.  Real tensors without such a group raise:
    there is no single-rank fallback.
:func:`axis_index` / :func:`axis_size`
    Inside the environment, the rank's coordinate along an axis (an int64
    scalar tensor on the run's device, a meta scalar in the trace, so
    ``t == stage`` and ``torch.where`` work as they do under JAX) and the
    axis length (a plain int).
:func:`axis_group`
    The process group of the ranks that share this rank's coordinates off
    an axis (or tuple of axes), with the map between the group's rank order
    and the axis index; created lazily, one per (mesh, axis key), in the
    same order on every rank.  The instrumented collectives run on it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.topology import Topology


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes, row-major (the last axis varies fastest)."""

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, rank: int) -> tuple:
        """Mesh coordinates of global rank ``rank`` (row-major)."""
        out = []
        for s in reversed(self.axis_sizes):
            rank, c = divmod(rank, s)
            out.append(c)
        return tuple(reversed(out))

    def rank(self, coords: Sequence[int]) -> int:
        r = 0
        for c, s in zip(coords, self.axis_sizes):
            r = r * s + int(c)
        return r


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    shapes, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shapes) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} do not match sizes {shapes}")
    return Mesh(names, shapes)


class PartitionSpec(tuple):
    """Per-dimension mesh axis (a name, a tuple of names, or None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


@dataclass(frozen=True)
class _Frame:
    """One ``shard_map`` level: the mesh, and for a real run this process's
    global rank and the device its tensors live on (None in the trace)."""

    mesh: Mesh
    rank: Optional[int] = None
    device: Optional[torch.device] = None


class _Env(threading.local):
    def __init__(self) -> None:
        self.frames: list = []


_ENV = _Env()


@contextlib.contextmanager
def _push(frame: _Frame) -> Iterator[_Frame]:
    _ENV.frames.append(frame)
    try:
        yield frame
    finally:
        _ENV.frames.pop()


def axis_env(mesh: Mesh):
    """Make ``mesh``'s axes visible to :func:`axis_index` / :func:`axis_size`
    for a trace (meta tensors)."""
    return _push(_Frame(mesh))


def _axis_names(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def _top() -> _Frame:
    if not _ENV.frames:
        raise RuntimeError("mesh axes are only defined inside shard_map")
    return _ENV.frames[-1]


def axis_size(axis_name) -> int:
    """Length of a mesh axis (product over a tuple of axes)."""
    shape = _top().mesh.shape
    out = 1
    for a in _axis_names(axis_name):
        if a not in shape:
            raise NameError(f"unbound axis name: {a!r}")
        out *= shape[a]
    return out


def _linear(mesh: Mesh, coords: Sequence[int], names: tuple) -> int:
    """Index over ``names`` in their order (the first one slowest)."""
    shape, pos = mesh.shape, {a: i for i, a in enumerate(mesh.axis_names)}
    idx = 0
    for a in names:
        idx = idx * shape[a] + coords[pos[a]]
    return idx


def axis_index(axis_name) -> torch.Tensor:
    """This rank's coordinate along ``axis_name`` (linear over a tuple):
    an int64 scalar on the run's device, or a meta scalar in the trace."""
    axis_size(axis_name)  # validates the name
    frame = _top()
    if frame.rank is None:
        return torch.empty((), dtype=torch.int64, device="meta")
    idx = _linear(frame.mesh, frame.mesh.coords(frame.rank), _axis_names(axis_name))
    return torch.tensor(idx, dtype=torch.int64, device=frame.device)


def axis_key(axis_name) -> str:
    """The collectives' spelling of an axis or tuple of axes: ``"x,y"``."""
    names = _axis_names(axis_name)
    if any("," in a for a in names):
        raise ValueError(f"axis names may not contain ',': {names}")
    return ",".join(names)


# ---------------------------------------------------------------------------
# Real execution: ranks, process groups
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AxisGroup:
    """The ranks along an axis key that share this rank's other coordinates.

    ``group`` is their process group; its rank order is ascending global
    rank, which equals the axis index order only for axes in mesh order, so
    ``group_rank_of_index[j]`` is the group rank of axis index ``j`` and
    ``index_of_group_rank[k]`` the axis index of group rank ``k``.
    ``members[j]`` is the global rank of axis index ``j``.
    """

    group: object
    members: tuple
    group_rank_of_index: tuple
    index_of_group_rank: tuple

    @property
    def size(self) -> int:
        return len(self.members)


#: ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` under their
#: newer names where torch has them (same arguments; the old ones warn).
all_gather_flat = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
reduce_scatter_flat = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)

#: ``{"world": default group, "groups": {(mesh, key): AxisGroup}}``; reset
#: when the default group changes (a new ``init_process_group``).
_GROUPS: dict = {"world": None, "groups": {}}
_GROUPS_LOCK = threading.Lock()


def _real_frame(what: str) -> _Frame:
    if not _ENV.frames or _ENV.frames[-1].rank is None:
        raise RuntimeError(
            f"{what} on real tensors runs inside shard_map over an initialized "
            "torch.distributed process group; trace with meta tensors otherwise"
        )
    return _ENV.frames[-1]


def axis_group(axis_name) -> AxisGroup:
    """The :class:`AxisGroup` of ``axis_name`` on the running mesh.

    Every rank must ask for the same keys in the same order (they run one
    SPMD program): the first request of a key creates the groups of every
    row of ``Topology.groups(axis)`` with ``new_subgroups_by_enumeration``.
    """
    frame = _real_frame("a collective")
    names = _axis_names(axis_name)
    axis_size(names)  # validates the names
    mesh = frame.mesh
    with _GROUPS_LOCK:
        world = dist.group.WORLD
        if _GROUPS["world"] is not world:
            _GROUPS["world"], _GROUPS["groups"] = world, {}
        key = (mesh, names)
        hit = _GROUPS["groups"].get(key)
        if hit is not None:
            return hit
        rows = Topology(list(zip(mesh.axis_names, mesh.axis_sizes))).groups(names)
        group, _ = dist.new_subgroups_by_enumeration(
            [[int(r) for r in row] for row in rows]
        )
        mine = next(row for row in rows if frame.rank in row)
        order = np.argsort(mine, kind="stable")  # group rank -> axis index
        hit = AxisGroup(
            group=group,
            members=tuple(int(r) for r in mine),
            group_rank_of_index=tuple(int(k) for k in np.argsort(order)),
            index_of_group_rank=tuple(int(j) for j in order),
        )
        _GROUPS["groups"][key] = hit
        return hit


def axis_position(axis_name) -> int:
    """This rank's index along ``axis_name`` (linear over a tuple) in a
    real run, as a host int."""
    frame = _real_frame("a collective")
    return _linear(frame.mesh, frame.mesh.coords(frame.rank), _axis_names(axis_name))


def axis_peer(axis_name, index: int) -> int:
    """Global rank of axis index ``index`` along ``axis_name`` with this
    rank's other coordinates."""
    frame = _real_frame("a collective")
    mesh, names = frame.mesh, _axis_names(axis_name)
    coords = list(mesh.coords(frame.rank))
    pos = {a: i for i, a in enumerate(mesh.axis_names)}
    for a in reversed(names):
        index, coords[pos[a]] = divmod(index, mesh.shape[a])
    return mesh.rank(coords)


def _process_rank(mesh: Mesh) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"shard_map over mesh {mesh.shape} got real tensors, but no "
            "torch.distributed process group is initialized (start the ranks "
            "with repro_torch.core.ranks.run_ranks or torchrun); trace with "
            "meta tensors otherwise"
        )
    world = dist.get_world_size()
    if world != mesh.size:
        raise RuntimeError(
            f"shard_map over mesh {mesh.shape} needs {mesh.size} ranks, but the "
            f"process group's world size is {world}"
        )
    return dist.get_rank()


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _split(spec, ndim: int) -> list:
    parts = list(spec) + [None] * (ndim - len(spec))
    if len(parts) != ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return parts


def _factor(mesh: Mesh, part) -> int:
    if part is None:
        return 1
    return math.prod(mesh.shape[a] for a in _axis_names(part))


def _local_shape(x: torch.Tensor, spec, mesh: Mesh) -> list:
    shape = []
    for size, part in zip(x.shape, _split(spec, x.dim())):
        f = _factor(mesh, part)
        if size % f:
            raise ValueError(f"dim of size {size} does not split {f} ways")
        shape.append(size // f)
    return shape


def _local(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    return torch.empty(_local_shape(x, spec, mesh), dtype=x.dtype, device="meta")


def _block(x: torch.Tensor, spec, mesh: Mesh, rank: int) -> torch.Tensor:
    """Global rank ``rank``'s block of the global array ``x``."""
    shape = _local_shape(x, spec, mesh)
    coords = mesh.coords(rank)
    for dim, part in enumerate(_split(spec, x.dim())):
        if part is not None:
            b = _linear(mesh, coords, _axis_names(part))
            x = x.narrow(dim, b * shape[dim], shape[dim])
    return x


def _global(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    shape = [
        size * _factor(mesh, part) for size, part in zip(x.shape, _split(spec, x.dim()))
    ]
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _gathered(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """Every rank's block of a partitioned output, assembled into the global
    array on every rank.  Straight ``torch.distributed``: this gather is
    the harness's, not the app's communication, so nothing records it."""
    parts = _split(spec, x.dim())
    if all(p is None for p in parts):
        return x  # replicated: every rank holds the global value
    world = mesh.size
    blocks = torch.empty((world, *x.shape), dtype=x.dtype, device=x.device)
    all_gather_flat(blocks.view(-1), x.contiguous().view(-1))
    out = torch.empty(
        [s * _factor(mesh, p) for s, p in zip(x.shape, parts)],
        dtype=x.dtype,
        device=x.device,
    )
    for r in range(world):
        _block(out, spec, mesh, r).copy_(blocks[r])
    return out


def _map(specs, values, fn):
    """``fn(leaf, spec)`` over a tree of values (tensor, tuple, list or
    dict) matched by a tree of specs of the same structure."""
    if isinstance(specs, PartitionSpec):
        return fn(values, specs)
    if isinstance(values, dict):
        return {k: _map(specs[k], v, fn) for k, v in values.items()}
    return type(values)(_map(s, v, fn) for v, s in zip(values, specs))


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return []


def shard_map(fn, *, mesh: Mesh, in_specs, out_specs):
    """``shard_map`` over ``mesh``: a trace on meta tensors, or a real run on
    this process's rank (see the module docstring).

    ``in_specs`` / ``out_specs`` are a :class:`PartitionSpec` each, or a
    tuple with one entry per argument / output, where an entry may itself
    be a tuple or dict of specs matching a tuple or dict argument.  The
    returned callable takes global tensors and returns global tensors.
    """

    def run(*args):
        specs = (in_specs,) if isinstance(in_specs, PartitionSpec) else in_specs
        devices = {leaf.device.type == "meta" for leaf in _leaves(args)}
        if devices == {False, True}:
            raise ValueError("shard_map got meta and real tensors together")
        if devices != {False}:
            local = [
                _map(s, a, lambda v, sp: _local(v, sp, mesh))
                for a, s in zip(args, specs)
            ]
            with axis_env(mesh):
                out = fn(*local)
            return _map(out_specs, out, lambda v, s: _global(v, s, mesh))
        rank = _process_rank(mesh)
        device = _leaves(args)[0].device
        local = [
            _map(s, a, lambda v, sp: _block(v, sp, mesh, rank))
            for a, s in zip(args, specs)
        ]
        with _push(_Frame(mesh, rank, device)):
            out = fn(*local)
        return _map(out_specs, out, lambda v, s: _gathered(v, s, mesh))

    return run
