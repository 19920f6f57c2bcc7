"""Instrumented collectives — the PMPI/GOTCHA interception analog.

The paper intercepts MPI calls (via PMPI or GOTCHA) and inspects their
parameters to record per-region statistics.  Here the per-rank SPMD program
calls these wrappers inside ``compat.shard_map``; each one — if a profiling
recorder is active (``repro_torch.core.regions.recording``) — reports the
*static* communication structure of the call to the innermost region.

On meta tensors (the trace-only path of ``profile_traced``) each wrapper
records and returns a meta result of the right shape.  Real execution over
``torch.distributed`` is a later slice of the port; until then a real
tensor raises ``NotImplementedError``.

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


def _meta_result(x, shape_fn=tuple):
    """Meta tensor(s) shaped by ``shape_fn(leaf.shape)``, or raise for real
    tensors (execution over torch.distributed is not ported yet)."""

    def one(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.device.type != "meta":
            raise NotImplementedError(
                "instrumented collectives execute over torch.distributed in a "
                "later slice (ROADMAP queue 1, step 4); trace with meta tensors"
            )
        return torch.empty(shape_fn(leaf.shape), dtype=leaf.dtype, device="meta")

    return _tree_map(one, x)


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
# Point-to-point-like pattern: ppermute (TPU-native halo exchange primitive)
# ---------------------------------------------------------------------------


def ppermute(
    x, axis_name, perm: Sequence[tuple], record_pairs: Sequence[tuple] | None = None
):
    """Instrumented ``ppermute`` (the JAX package's ``lax.ppermute``).

    ``perm`` is a sequence of ``(src, dst)`` index pairs along ``axis_name``.
    Each pair is one point-to-point message of ``nbytes(x)`` — this is the
    halo-exchange building block, the pattern the paper's communication
    regions were designed to capture.

    ``record_pairs``: optional *global-rank* (src, dst) pairs to record
    instead of the executed permutation.  SPMD collectives run on every rank
    every step; when the logical pattern is data-dependent-sparse (e.g. only
    the active wavefront diagonal of a KBA sweep carries real data), the
    caller can pass the logically-active pairs so statistics match what an
    MPI implementation would send (see DESIGN.md §2).
    """
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
    return _meta_result(x)


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
    return _meta_result(x)


def pmean(x, axis_name):
    _record_collective("pmean", x, axis_name, lambda n: 2 * (n - 1) / n)
    return _meta_result(x)


def pmax(x, axis_name):
    _record_collective("pmax", x, axis_name, lambda n: 2 * (n - 1) / n)
    return _meta_result(x)


def pmin(x, axis_name):
    _record_collective("pmin", x, axis_name, lambda n: 2 * (n - 1) / n)
    return _meta_result(x)


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


def all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False):
    _record_collective("all_gather", x, axis_name, lambda n: (n - 1))
    n = _axis_size(axis_name)
    return _meta_result(x, lambda s: _resized(s, axis, n, tiled, grow=True))


def psum_scatter(x, axis_name, *, scatter_dimension: int = 0, tiled: bool = False):
    _record_collective("reduce_scatter", x, axis_name, lambda n: (n - 1) / n)
    n = _axis_size(axis_name)
    return _meta_result(
        x, lambda s: _resized(s, scatter_dimension, n, tiled, grow=False)
    )


def all_to_all(x, axis_name, split_axis: int, concat_axis: int, *, tiled: bool = False):
    _record_collective("all_to_all", x, axis_name, lambda n: (n - 1) / n)
    n = _axis_size(axis_name)

    def shape(s):
        return _resized(
            _resized(s, split_axis, n, tiled, grow=False), concat_axis, n, tiled, True
        )

    return _meta_result(x, shape)


def pbroadcast(x, axis_name, root: int = 0):
    """Broadcast from ``root`` along ``axis_name``.

    Counted as one collective; ``(n-1)/n`` bytes per rank.
    """
    _record_collective("broadcast", x, axis_name, lambda n: (n - 1) / n)
    return _meta_result(x)
