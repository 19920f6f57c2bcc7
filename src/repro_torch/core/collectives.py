"""Instrumented collectives — the PMPI/GOTCHA interception analog.

The paper intercepts MPI calls (via PMPI or GOTCHA) and inspects their
parameters to record per-region statistics.  Here the per-rank SPMD program
calls these wrappers inside ``compat.shard_map``; each one — if a profiling
recorder is active (``repro_torch.core.regions.recording``) — reports the
*static* communication structure of the call to the innermost region.

Each wrapper then calls one ``torch.library`` custom op per tensor leaf,
``torch.ops.repro_torch.<name>``, whose arguments are the tensor, the axis
key (``"x,y"``), the call's static parameters (``perm``, ``axis`` /
``tiled``, ``root``, ...) and the region path (``"main/sweep_comm"``):

* on meta tensors (the trace of ``profile_traced``) the op's fake
  implementation returns a meta result of the right shape;
* on real tensors (inside ``compat.shard_map`` over an initialized process
  group) it runs ``torch.distributed`` on the axis's group
  (:func:`repro_torch.core.compat.axis_group`): ``batch_isend_irecv``
  for ``ppermute``, ``all_reduce`` for ``psum`` / ``pmean`` / ``pmax`` /
  ``pmin`` and, masked, for ``pbroadcast`` (as ``repro`` realizes it),
  ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
  ``all_to_all_single``, with the blocks reordered from the group's rank
  order to the axis index order;
* in a captured graph (``make_fx``, a ``torch.compile`` backend) each op is
  a node that carries its region path, which
  :func:`repro_torch.core.hlo.scan_graph_collectives` reads as the compiled
  collective layer.

Recording does not depend on the tensors: every rank records the same
global structure, so a profile recorded during a real run equals the meta
trace's.  ``ppermute`` executes ``perm``; ``record_pairs`` only changes
what is recorded.

Because the communication is fully determined by the trace (shapes, dtypes,
permutations, axis sizes are all static), the recorded statistics are exact.
``min``/``max`` over ranks in the profiler therefore reproduce exactly what
Caliper aggregates empirically at runtime.

Byte-accounting conventions (documented, used consistently by the profiler
and the HLO analyzer):

  ppermute        point-to-point: each (src, dst) pair moves ``nbytes``.
  all_gather      each rank sends its shard to the group: ``(n-1) * nbytes``
                  sent and received per rank (ring-equivalent total traffic).
  psum            ring all-reduce: ``2 * (n-1)/n * nbytes`` per rank.
  reduce_scatter  ``(n-1)/n * nbytes`` per rank.
  all_to_all      ``(n-1)/n * nbytes`` per rank.

Following Caliper's schema (paper Table I), point-to-point-like patterns
(ppermute) populate Sends/Recvs/Dest-ranks/Src-ranks/Bytes; true collectives
increment the region's collective-call count ("Coll") and a collective-bytes
extension field.

Profiling data model (memoized recording)
-----------------------------------------

Event capture is **columnar and structure-interned** (see
:mod:`repro_torch.core.regions` for the :class:`TraceBuffer` / ``StructTable``
schema): when a recorder is active, each wrapper calls
``regions.record_p2p`` / ``regions.record_collective``, which fingerprint
the call's pair/group arrays and append one scalar row into the recorder's
buffer.  No per-event Python object exists anywhere on the recording path,
and the whole chain is memoized end to end:

* ``topology.expand_pairs`` / ``topology.groups`` cache their global-rank
  broadcasts per (axis, permutation) / axis-set key — apps re-issue the
  same patterns every stage, step, and cycle, so each distinct expansion
  is built once per topology;
* the buffer's struct table fingerprints the expanded arrays and stores
  the O(n_ranks) structure — dense send/recv count and byte-unit vectors
  from one ``np.add.at`` scatter each, destination/source peer-*set* pair
  columns from uniquing ``src * n + dst`` pair codes — **once per unique
  structure**, so a repeat call costs O(pairs) fingerprint bytes instead
  of O(n_ranks) recompute and storage;
* identical consecutive calls (kripke's 36 per-(dirset, groupset) messages
  of one phase) collapse into a single row with a multiplicity count.

Byte vectors preserve the conventions above: every ppermute pair moves the
full ``nbytes`` of the permuted operand, and collective capture broadcasts
the per-rank ring-equivalent cost (the ``bytes_factor`` column of the
table, evaluated at the communicator-group size) over the group members —
collective peer sets are implicit (complete graph within each group) and
never materialized.

:func:`build_p2p_event` / :func:`build_collective_event` remain as
compatibility constructors that materialize a single :class:`RegionEvent`
view with the same accounting (adapters and tests only).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.core import compat
from repro_torch.core import regions as _regions
from repro_torch.core.topology import active_topology


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _axis_size(axis_name) -> int:
    topo = active_topology()
    if topo is not None:
        try:
            return topo.axis_size(axis_name)
        except ValueError:
            pass
    return compat.axis_size(axis_name)


def _flatten(tree) -> list:
    """Tensor leaves of a tensor / list / tuple / dict tree."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flatten(v)]
    raise TypeError(f"collective operand must be tensors, got {type(tree)}")


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return {k: _tree_map(fn, v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# RegionEvent view constructors (compatibility/adapters; the recording path
# appends into the recorder's interned TraceBuffer without building these)
# ---------------------------------------------------------------------------


def build_p2p_event(
    kind: str, axis_name, pairs, n: int, nbytes: int
) -> _regions.RegionEvent:
    """Array-native point-to-point RegionEvent from global (src, dst) pairs.

    ``pairs`` is any ``(P, 2)``-shaped sequence/array of global rank pairs;
    every pair moves ``nbytes``.  All ``n`` ranks participate (matching the
    SPMD execution model: the permute runs on every rank, including ranks
    with no active pair this call).
    """
    sends, recvs, drows, dpeers, srows, speers = _regions.p2p_structure(pairs, n)
    dptr, dind = _regions._rows_to_csr(drows, dpeers, n)
    sptr, sind = _regions._rows_to_csr(srows, speers, n)
    return _regions.RegionEvent(
        region=_regions.current_region() or _regions.UNANNOTATED_REGION,
        region_path=_regions.current_region_path(),
        kind=kind,
        n_ranks=n,
        sends=sends,
        recvs=recvs,
        bytes_sent=sends * nbytes,
        bytes_recv=recvs * nbytes,
        dest_indptr=dptr,
        dest_indices=dind,
        src_indptr=sptr,
        src_indices=sind,
        participants=np.ones(n, bool),
        is_collective=0,
        axis_name=str(axis_name),
    )


def build_collective_event(
    kind: str, axis_name, groups: np.ndarray, n: int, per_rank_bytes: int
) -> _regions.RegionEvent:
    """Array-native collective RegionEvent.

    ``groups`` is the ``(n_groups, group_size)`` global-rank array from
    ``topology.groups`` (or ``arange(n)[None, :]`` for a flat axis); each
    member rank sends/receives ``per_rank_bytes`` ring-equivalent bytes.
    """
    members = np.asarray(groups, np.int64).reshape(-1)
    bytes_vec = np.zeros(n, np.int64)
    bytes_vec[members] = per_rank_bytes
    participants = np.zeros(n, bool)
    participants[members] = True
    zero = np.zeros(n, np.int64)
    dptr, dind = _regions._empty_csr(n)
    sptr, sind = _regions._empty_csr(n)
    return _regions.RegionEvent(
        region=_regions.current_region() or _regions.UNANNOTATED_REGION,
        region_path=_regions.current_region_path(),
        kind=kind,
        n_ranks=n,
        sends=zero,
        recvs=zero.copy(),
        bytes_sent=bytes_vec,
        bytes_recv=bytes_vec.copy(),
        dest_indptr=dptr,
        dest_indices=dind,
        src_indptr=sptr,
        src_indices=sind,
        participants=participants,
        is_collective=1,
        axis_name=str(axis_name),
    )


# ---------------------------------------------------------------------------
# The custom ops: fake (shape) implementations for the trace and captured
# graphs, torch.distributed bodies for real tensors
# ---------------------------------------------------------------------------


def _names(axes: str) -> tuple:
    return tuple(axes.split(","))


@torch.library.custom_op("repro_torch::ppermute", mutates_args=())
def _ppermute_op(
    x: torch.Tensor, axes: str, perm: list[int], region_path: str
) -> torch.Tensor:
    """``perm`` holds the (src, dst) axis-index pairs flattened."""
    names = _names(axes)
    me = compat.axis_position(names)
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    send = x.contiguous()
    ops = []
    for src, dst in zip(perm[0::2], perm[1::2]):
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, send, compat.axis_peer(names, dst)))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, compat.axis_peer(names, src)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _reduced(x: torch.Tensor, axes: str, op) -> torch.Tensor:
    grp = compat.axis_group(_names(axes))
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=grp.group)
    return out


@torch.library.custom_op("repro_torch::psum", mutates_args=())
def _psum_op(x: torch.Tensor, axes: str, region_path: str) -> torch.Tensor:
    return _reduced(x, axes, dist.ReduceOp.SUM)


@torch.library.custom_op("repro_torch::pmean", mutates_args=())
def _pmean_op(x: torch.Tensor, axes: str, region_path: str) -> torch.Tensor:
    return _reduced(x, axes, dist.ReduceOp.SUM) / compat.axis_size(_names(axes))


@torch.library.custom_op("repro_torch::pmax", mutates_args=())
def _pmax_op(x: torch.Tensor, axes: str, region_path: str) -> torch.Tensor:
    return _reduced(x, axes, dist.ReduceOp.MAX)


@torch.library.custom_op("repro_torch::pmin", mutates_args=())
def _pmin_op(x: torch.Tensor, axes: str, region_path: str) -> torch.Tensor:
    return _reduced(x, axes, dist.ReduceOp.MIN)


@torch.library.custom_op("repro_torch::pbroadcast", mutates_args=())
def _pbroadcast_op(
    x: torch.Tensor, axes: str, root: int, region_path: str
) -> torch.Tensor:
    """``root``'s value on every rank as ``repro`` computes it: a psum of
    ``x`` masked to zero off the root."""
    mask = float(compat.axis_position(_names(axes)) == root)
    return _reduced(x * torch.tensor(mask, device=x.device).to(x.dtype), axes,
                    dist.ReduceOp.SUM)


@torch.library.custom_op("repro_torch::all_gather", mutates_args=())
def _all_gather_op(
    x: torch.Tensor, axes: str, axis_size: int, axis: int, tiled: bool, region_path: str
) -> torch.Tensor:
    grp = compat.axis_group(_names(axes))
    blocks = torch.empty((grp.size, *x.shape), dtype=x.dtype, device=x.device)
    compat.all_gather_flat(
        blocks.view(-1), x.contiguous().view(-1), group=grp.group
    )
    out = blocks[list(grp.group_rank_of_index)].movedim(0, axis)
    return (out.flatten(axis, axis + 1) if tiled else out).contiguous()


def _chunks(x: torch.Tensor, dim: int, n: int, tiled: bool) -> torch.Tensor:
    """``x`` split ``n`` ways along ``dim`` as an ``(n, ...)`` stack: tiled
    keeps the dim in each chunk, untiled (``x.shape[dim] == n``) drops it."""
    y = x.movedim(dim, 0)
    if tiled:
        return y.reshape(n, y.shape[0] // n, *y.shape[1:]).movedim(1, dim + 1)
    return y


@torch.library.custom_op("repro_torch::psum_scatter", mutates_args=())
def _psum_scatter_op(
    x: torch.Tensor,
    axes: str,
    axis_size: int,
    scatter_dimension: int,
    tiled: bool,
    region_path: str,
) -> torch.Tensor:
    grp = compat.axis_group(_names(axes))
    chunks = _chunks(x, scatter_dimension, grp.size, tiled)
    send = chunks[list(grp.index_of_group_rank)].contiguous()
    out = torch.empty(chunks.shape[1:], dtype=x.dtype, device=x.device)
    compat.reduce_scatter_flat(out.view(-1), send.view(-1), group=grp.group)
    return out


@torch.library.custom_op("repro_torch::all_to_all", mutates_args=())
def _all_to_all_op(
    x: torch.Tensor,
    axes: str,
    axis_size: int,
    split_axis: int,
    concat_axis: int,
    tiled: bool,
    region_path: str,
) -> torch.Tensor:
    grp = compat.axis_group(_names(axes))
    chunks = _chunks(x, split_axis, grp.size, tiled)
    send = chunks[list(grp.index_of_group_rank)].contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv.view(-1), send.view(-1), group=grp.group)
    out = recv[list(grp.group_rank_of_index)].movedim(0, concat_axis)
    return (out.flatten(concat_axis, concat_axis + 1) if tiled else out).contiguous()


#: each op's fake implementation, by op name (the meta trace's fast path)
_FAKES = {}


def _fake(op):
    def register(fn):
        op.register_fake(fn)
        _FAKES[op._name] = fn
        return fn

    return register


def _empty(x: torch.Tensor, shape) -> torch.Tensor:
    # several times cheaper on meta tensors than empty_like / new_empty
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def _same(x: torch.Tensor, *_args) -> torch.Tensor:
    return _empty(x, x.shape)


for _op in (_ppermute_op, _psum_op, _pmean_op, _pmax_op, _pmin_op, _pbroadcast_op):
    _fake(_op)(_same)


def _resized(shape, dim: int, factor: int, tiled: bool, grow: bool) -> list:
    """Shape after gathering (``grow``) or scattering ``factor`` ways along
    ``dim``: tiled changes the dim's size, untiled adds / removes the dim."""
    shape = list(shape)
    if tiled:
        shape[dim] = shape[dim] * factor if grow else shape[dim] // factor
    elif grow:
        shape.insert(dim, factor)
    else:
        del shape[dim]
    return shape


@_fake(_all_gather_op)
def _(x, axes, axis_size, axis, tiled, region_path):
    return _empty(x, _resized(x.shape, axis, axis_size, tiled, grow=True))


@_fake(_psum_scatter_op)
def _(x, axes, axis_size, scatter_dimension, tiled, region_path):
    shape = _resized(x.shape, scatter_dimension, axis_size, tiled, grow=False)
    return _empty(x, shape)


@_fake(_all_to_all_op)
def _(x, axes, axis_size, split_axis, concat_axis, tiled, region_path):
    shape = _resized(x.shape, split_axis, axis_size, tiled, grow=False)
    return _empty(x, _resized(shape, concat_axis, axis_size, tiled, grow=True))


def _uncaptured_meta(leaf) -> bool:
    """A plain meta tensor with no graph being captured (no ``make_fx``
    mode, no Dynamo trace): the op's node would reach no graph, so its fake
    result is all a call needs."""
    return (
        not torch.compiler.is_compiling()
        and type(leaf) is torch.Tensor
        and leaf.is_meta
        and _get_current_dispatch_mode() is None
    )


def _per_leaf(name: str, x, axis_name, *static):
    """``torch.ops.repro_torch.<name>`` on every tensor leaf of ``x``, with
    the axis key, the static parameters and the current region path.

    The meta trace skips the dispatcher: an uncaptured meta leaf takes the
    op's fake implementation directly (the custom op's dispatch costs
    several times that a call, and the trace makes thousands of calls).
    """
    key = compat.axis_key(axis_name)
    path = "/".join(_regions.current_region_path())
    op, fake = getattr(torch.ops.repro_torch, name), _FAKES[name]

    def one(leaf):
        if _uncaptured_meta(leaf):
            return fake(leaf, key, *static, path)
        return op(leaf, key, *static, path)

    return _tree_map(one, x)


# ---------------------------------------------------------------------------
# Point-to-point-like pattern: ppermute (TPU-native halo exchange primitive)
# ---------------------------------------------------------------------------


#: (perm, axis size) pairs already checked: the apps repeat a few perms
_CHECKED_PERMS: set = set()


def _check_perm(perm: tuple, n: int) -> None:
    if (perm, n) in _CHECKED_PERMS:
        return
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute perm is not a permutation: {perm}")
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute perm {perm} indexes outside an axis of {n}")
    _CHECKED_PERMS.add((perm, n))


def ppermute(
    x, axis_name, perm: Sequence[tuple], record_pairs: Sequence[tuple] | None = None
):
    """Instrumented ``ppermute`` (the JAX package's ``lax.ppermute``).

    ``perm`` is a sequence of ``(src, dst)`` index pairs along ``axis_name``.
    Each pair is one point-to-point message of ``nbytes(x)`` — this is the
    halo-exchange building block, the pattern the paper's communication
    regions were designed to capture.  A rank that is no pair's destination
    gets zeros, as under ``lax.ppermute``.

    ``record_pairs``: optional *global-rank* (src, dst) pairs to record
    instead of the executed permutation.  SPMD collectives run on every rank
    every step; when the logical pattern is data-dependent-sparse (e.g. only
    the active wavefront diagonal of a KBA sweep carries real data), the
    caller can pass the logically-active pairs so statistics match what an
    MPI implementation would send (see DESIGN.md §2).  The op always
    executes ``perm``.
    """
    perm = tuple((int(s), int(d)) for s, d in perm)
    _check_perm(perm, _axis_size(axis_name))
    if _regions.active_recorder() is not None:
        topo = active_topology()
        total = sum(_nbytes(leaf) for leaf in _flatten(x))
        if record_pairs is not None:
            pairs = record_pairs
            n = topo.n_ranks if topo is not None else _axis_size(axis_name)
        elif (
            topo is not None and isinstance(axis_name, str) and axis_name in topo.names
        ):
            pairs = topo.expand_pairs(axis_name, perm)  # memoized per topology
            n = topo.n_ranks
        else:
            pairs = perm
            n = _axis_size(axis_name)
        _regions.record_p2p("ppermute", axis_name, pairs, n, total)
    flat = [i for pair in perm for i in pair]
    return _per_leaf("ppermute", x, axis_name, flat)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _record_collective(kind, x, axis_name, bytes_factor) -> None:
    if _regions.active_recorder() is None:
        return
    topo = active_topology()
    total = sum(_nbytes(leaf) for leaf in _flatten(x))
    names_ok = topo is not None and all(
        n in topo.names
        for n in ([axis_name] if isinstance(axis_name, str) else list(axis_name))
    )
    if names_ok:
        groups = topo.groups(axis_name)  # memoized per topology
        n_total = topo.n_ranks
        gsize = int(groups.shape[1]) if groups.size else 1
        per_rank = int(total * bytes_factor(max(1, gsize)))
    else:
        n_total = _axis_size(axis_name)
        groups = np.arange(n_total, dtype=np.int64)[None, :]
        per_rank = int(total * bytes_factor(max(1, n_total)))
    _regions.record_collective(kind, axis_name, groups, n_total, per_rank)


def psum(x, axis_name):
    _record_collective("psum", x, axis_name, lambda n: 2 * (n - 1) / n)
    return _per_leaf("psum", x, axis_name)


def pmean(x, axis_name):
    _record_collective("pmean", x, axis_name, lambda n: 2 * (n - 1) / n)
    return _per_leaf("pmean", x, axis_name)


def pmax(x, axis_name):
    _record_collective("pmax", x, axis_name, lambda n: 2 * (n - 1) / n)
    return _per_leaf("pmax", x, axis_name)


def pmin(x, axis_name):
    _record_collective("pmin", x, axis_name, lambda n: 2 * (n - 1) / n)
    return _per_leaf("pmin", x, axis_name)


def all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False):
    _record_collective("all_gather", x, axis_name, lambda n: (n - 1))
    n = _axis_size(axis_name)
    return _per_leaf("all_gather", x, axis_name, n, axis, tiled)


def psum_scatter(x, axis_name, *, scatter_dimension: int = 0, tiled: bool = False):
    _record_collective("reduce_scatter", x, axis_name, lambda n: (n - 1) / n)
    n = _axis_size(axis_name)
    return _per_leaf(
        "psum_scatter", x, axis_name, n, scatter_dimension, tiled
    )


def all_to_all(x, axis_name, split_axis: int, concat_axis: int, *, tiled: bool = False):
    _record_collective("all_to_all", x, axis_name, lambda n: (n - 1) / n)
    n = _axis_size(axis_name)
    return _per_leaf(
        "all_to_all",
        x,
        axis_name,
        n,
        split_axis,
        concat_axis,
        tiled,
    )


def pbroadcast(x, axis_name, root: int = 0):
    """Broadcast from ``root`` along ``axis_name``.

    Realized as ``repro`` realizes it: ``x`` masked to zero off the root,
    then a psum.  Counted as one collective; ``(n-1)/n`` bytes per rank.
    """
    _record_collective("broadcast", x, axis_name, lambda n: (n - 1) / n)
    return _per_leaf("pbroadcast", x, axis_name, int(root))
