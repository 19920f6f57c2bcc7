"""Process-topology context for global-rank attribution.

The paper's statistics are per MPI *rank*.  A ppermute along one mesh axis of
a multi-axis decomposition only names axis-local indices; to reproduce
rank-level findings (e.g. Kripke's corner ranks having 3 communication
partners vs 6 in the interior — paper §IV-A) the profiler must expand
axis-local permutations into global rank pairs.

Apps declare their decomposition once::

    with topology(("x", px), ("y", py), ("z", pz)):
        ...   # instrumented collectives inside shard_map

Global rank = mixed-radix index over the declared axes, in declared order
(the device ordering of a row-major mesh).

``expand_pairs`` and ``groups`` return **NumPy arrays** (shape ``(P, 2)``
rank pairs and ``(n_groups, group_size)`` communicator groups) built by
broadcasting axis offsets — no Python loop over ranks — so the instrumented
collectives can record array-native structures straight from them.
Element order matches the historical list-of-tuples implementation
(row-major over the non-participating axes, then the permutation/group).

Both expansions are **memoized per topology**: apps re-issue the same
axis permutation / communicator group every stage, step, and cycle (a
kripke sweep re-visits each axis direction across octants; laghos repeats
the identical halo and timestep patterns every step), so each distinct
``(axis, perm)`` / axis-set key broadcasts once and every later call is a
dict hit.  The cached arrays are shared — callers must treat them as
read-only (the recording paths only fingerprint and reduce them).

Each memoized array is also **tagged** with its rank-extent-normalized
generator fingerprint (:func:`repro_torch.core.regions.tag_structure`): the
generator names the logical pattern (axis + permutation shape, or the
communicator axis set) and the extent pins the topology's named sizes, so
the trace store's :class:`~repro_torch.core.regions.StructTable` interns repeat
appends with an O(1) identity probe instead of hashing O(n_ranks) payload
bytes — and the *key* stays the same structure at every scale, which is
what the generator form normalizes.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.regions import tag_structure


class Topology:
    def __init__(self, axes: Sequence[tuple]):
        self.names = [a for a, _ in axes]
        self.sizes = [int(s) for _, s in axes]
        self.n_ranks = math.prod(self.sizes)
        # strides for mixed-radix (row-major, first axis slowest)
        self.strides = []
        acc = 1
        for s in reversed(self.sizes):
            self.strides.append(acc)
            acc *= s
        self.strides.reverse()
        # (axis, perm) / axis-set expansion memos (see module docstring)
        self._pairs_memo: dict = {}
        self._groups_memo: dict = {}
        # Generator-tag extent: names + sizes pin the rank space exactly
        # (the same axis name at a different position or size is a
        # different structure), so equal keys imply equal arrays.
        self._extent = (tuple(self.names), tuple(self.sizes))

    def rank(self, coords: Sequence[int]) -> int:
        return sum(c * s for c, s in zip(coords, self.strides))

    def axis_pos(self, name: str) -> int:
        return self.names.index(name)

    def axis_size(self, name) -> int:
        if isinstance(name, (tuple, list)):
            return math.prod(self.axis_size(n) for n in name)
        return self.sizes[self.axis_pos(name)]

    def _axis_offsets(self, positions: Sequence[int]) -> np.ndarray:
        """Global-rank contribution of every index combination over the
        given axes (row-major over ``positions`` order), as a 1-D array."""
        if not positions:
            return np.zeros(1, np.int64)
        grids = np.meshgrid(
            *[
                np.arange(self.sizes[i], dtype=np.int64) * self.strides[i]
                for i in positions
            ],
            indexing="ij",
        )
        out = grids[0]
        for g in grids[1:]:
            out = out + g
        return out.reshape(-1)

    def expand_pairs(self, axis_name: str, perm: Sequence[tuple]) -> np.ndarray:
        """Axis-local (src, dst) pairs -> global-rank pairs, for every
        combination of the other axes' indices; shape ``(P, 2)`` int64.

        Memoized on ``(axis_name, perm)`` — treat the result as read-only.
        """
        key = (axis_name, tuple((int(s), int(d)) for s, d in perm))
        hit = self._pairs_memo.get(key)
        if hit is not None:
            return hit
        pos = self.axis_pos(axis_name)
        others = [i for i in range(len(self.sizes)) if i != pos]
        perm_arr = np.asarray(list(perm), np.int64).reshape(-1, 2)
        base = self._axis_offsets(others)  # (B,)
        stride = self.strides[pos]
        # (B, P, 2): every other-axes combo x every permutation pair.
        out = base[:, None, None] + perm_arr[None, :, :] * stride
        out = np.ascontiguousarray(out.reshape(-1, 2))
        out = tag_structure(out, ("axis-perm",) + key, self._extent)
        self._pairs_memo[key] = out
        return out

    def groups(self, axis_name) -> np.ndarray:
        """Communicator groups for a collective over axis_name (possibly a
        tuple of axes): ``(n_groups, group_size)`` int64 global ranks.

        Memoized on the axis set — treat the result as read-only.
        """
        names = [axis_name] if isinstance(axis_name, str) else list(axis_name)
        key = tuple(names)
        hit = self._groups_memo.get(key)
        if hit is not None:
            return hit
        pos = [self.axis_pos(n) for n in names]
        others = [i for i in range(len(self.sizes)) if i not in pos]
        outer = self._axis_offsets(others)  # (n_groups,)
        inner = self._axis_offsets(pos)  # (group_size,)
        out = np.ascontiguousarray(outer[:, None] + inner[None, :])
        out = tag_structure(out, ("axis-groups", key), self._extent)
        self._groups_memo[key] = out
        return out


class _TopoState(threading.local):
    def __init__(self) -> None:
        self.topo: Optional[Topology] = None


_STATE = _TopoState()


def active_topology() -> Optional[Topology]:
    return _STATE.topo


@contextlib.contextmanager
def topology(*axes: tuple) -> Iterator[Topology]:
    """Declare the process decomposition for global-rank profiling."""
    prev = _STATE.topo
    _STATE.topo = Topology(axes)
    try:
        yield _STATE.topo
    finally:
        _STATE.topo = prev
