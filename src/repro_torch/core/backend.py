"""Backend-abstracted reduction substrate shared by every analysis layer.

The profilers (traced-layer
:class:`~repro_torch.core.profiler.CommPatternProfiler`, compiled-layer
:class:`~repro_torch.core.profiler.HloCollectiveProfiler`) and the
vectorized :class:`~repro_torch.core.thicket.Frame` reductions all bottom
out in a small set of kernels:

* :func:`segment_spans` — ordering + contiguous block boundaries for
  grouped segment reductions (host-side NumPy; shared by every backend);
* ``block_reduce`` / ``segment_reduce`` — per-segment reductions over 2-D
  grids / 1-D columns;
* ``matmul`` — the (region x struct) multiplicity-weighted **exact int64**
  weight matmuls against the StructTable's dense (struct x rank) slabs;
* ``pair_counts`` — the distinct-peer-set dedup over encoded
  (region, rank, peer) codes;
* ``factorize`` — ``np.unique(return_index, return_inverse)`` semantics for
  Frame group codes.

Two interchangeable implementations with **bit-identical** outputs:

``NumpyBackend``
    The reference: plain NumPy.  ``pair_counts`` picks between one dense
    bitmap scatter, a *chunked* bitmap scatter over region groups (bounding
    peak allocation to :data:`_BITMAP_CELLS_CAP` cells at high rank
    counts), and a sort-based ``np.unique`` pass when the code space is
    sparse relative to the pair count — see :func:`_dedup_strategy`.

``TorchBackend``
    Runs on a torch device, the CUDA card unless ``device="cpu"`` is given.
    Exact int64 matmuls run as float64 ``torch.matmul`` products: a single
    f64 product is exact whenever ``max|w| * max|slab| * S < 2**53``, and
    larger values split into limb-decomposed partial products recombined
    by int64 shifts (still exact — every partial product and partial sum is
    an integer below 2**53; CUDA has no int64 GEMM).  The peer-set dedup
    is a device ``torch.unique`` up to :data:`_SKETCH_RANK_EXTENT` ranks and
    the host hybrid past it.  ``block_reduce`` / ``segment_reduce`` run the
    hand-written CUDA segmented-reduce kernel
    (:mod:`repro_torch.kernels.segment_reduce`) for sum / max / min, after
    widening as NumPy does (``np.add`` sums small ints in int64); the
    kernel takes int32, int64, float32 and float64 and raises ``TypeError``
    on any other dtype.  Other ufuncs and shapes take the NumPy path on the
    host, as the JAX package routed them.

Boundary contract (what the profilers rely on):

* NumPy in, NumPy out — every method accepts and returns ``np.ndarray``;
  device residency is a backend-internal detail.
* int64 count/byte paths are **exact**, never rounded: results are
  bit-identical across backends whenever the true values fit in int64.
* Small scatters (``np.add.at`` weight accumulation) and argsorts stay
  host-side under every backend; the backend owns the O(G*S*Rmax)
  weight-grid matmuls, the dedup and the segmented reductions.

Selection: :func:`resolve_backend` resolves, in priority order, an explicit
``backend=`` argument (name or instance), a :func:`use_backend` thread-local
override, the ``REPRO_BACKEND`` environment variable, and finally
``"torch"``.  An unknown *explicit* name raises ``ValueError`` while an
unknown environment value warns and takes the default.

This is the one place where the port departs from the JAX package's
rules: there, asking for the device backend where it could not run warned
and fell back to NumPy.  Here ``"torch"`` with no CUDA device **raises**
:class:`BackendUnavailable`, and never falls back; a caller that wants the
host builds ``TorchBackend(device="cpu")`` (or asks for ``"numpy"``).  A
device path that quietly ran on the host would pass for a device result.
"""

from __future__ import annotations

import os
import threading
import warnings
from contextlib import contextmanager
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.kernels import segment_reduce as _seg_kernel

#: Environment variable naming the default reduction backend.
BACKEND_ENV = "REPRO_BACKEND"

#: Backend used when nothing names one.
DEFAULT_BACKEND = "torch"

#: f64 integer-exactness bound: every integer with |v| < 2**53 is exact.
_F64_EXACT = 1 << 53

#: Dense dedup bitmaps never allocate more than this many boolean cells at
#: once; past it the scatter chunks over region groups (or falls back to the
#: sort-based path) — see :func:`_dedup_strategy`.
_BITMAP_CELLS_CAP = 1 << 26

#: Dense bitmaps touch every cell; past this work factor relative to the
#: pair count, one sort of the pair codes is cheaper than zeroing+summing
#: the full (group, rank, peer) code space.
_BITMAP_WORK_FACTOR = 64

#: Past this rank extent the sort-based fallback first *compacts* the rank
#: and peer id spaces (``np.unique`` sketch of the ids actually present) and
#: re-decides the strategy on the compacted extents: structured traces touch
#: a thin slice of the rank space per struct (a kripke plane, a halo face),
#: so the dense scatter paths usually re-engage where the raw code space was
#: hopelessly sparse — see the ``("hybrid", 0)`` branch of
#: :func:`_dedup_strategy`.
_SKETCH_RANK_EXTENT = 1 << 16

#: Low PAIR_CODE_SHIFT bits of a fixed pair code (the peer field).
_PAIR_CODE_MASK = (1 << 32) - 1


# ---------------------------------------------------------------------------
# Shared host-side kernels (every backend uses these)
# ---------------------------------------------------------------------------


def segment_spans(key: np.ndarray) -> tuple:
    """Ordering + contiguous block boundaries for segment reductions.

    ``key`` holds one composite int group code per element.  Returns
    ``(order, sorted_key, starts, ends)``: ``order`` is None when the input
    is already non-decreasing (the common, pre-grouped trace shape — the
    permutation is skipped entirely), otherwise a stable argsort; block
    ``i`` of the sorted data spans ``starts[i]:ends[i]`` and carries key
    ``sorted_key[starts[i]]``.
    """
    n = len(key)
    if n == 0:
        z = np.zeros(0, np.int64)
        return None, np.asarray(key), z, z
    if np.any(np.diff(key) < 0):
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
    else:
        order = None
        sorted_key = key
    starts = np.concatenate(([0], np.flatnonzero(np.diff(sorted_key)) + 1))
    ends = np.append(starts[1:], n)
    return order, sorted_key, starts, ends


def block_reduce(
    grid: np.ndarray, starts: np.ndarray, ends: np.ndarray, ufunc: np.ufunc
) -> np.ndarray:
    """One contiguous block reduction per segment over a 2-D grid's rows.

    ``ufunc.reduce`` over a contiguous block vectorizes along the inner
    axis where generic ``reduceat`` falls back to a scalar inner loop; the
    block count is O(groups), not O(rows).  This is the NumPy reference —
    backends may route it elsewhere (see :meth:`TorchBackend.block_reduce`).
    """
    return np.stack([ufunc.reduce(grid[s:e], axis=0) for s, e in zip(starts, ends)])


def segment_reduce(
    col: np.ndarray, order, starts: np.ndarray, ufunc: np.ufunc = np.add
) -> np.ndarray:
    """Per-segment reduction of a 1-D column in one ``reduceat`` pass.

    ``order`` / ``starts`` come from :func:`segment_spans` over the
    column's group codes.  NumPy reference implementation.
    """
    if not len(starts):
        return np.zeros(0, col.dtype)
    vals = col if order is None else col[order]
    return ufunc.reduceat(vals, starts)


# ---------------------------------------------------------------------------
# Peer-set dedup strategy (satellite of the backend refactor: the dense
# G * Rmax * stride bitmap went quadratic-ish at high rank counts)
# ---------------------------------------------------------------------------


def _dedup_strategy(n_groups: int, rank_extent: int, stride: int, m: int) -> tuple:
    """Pick the distinct-peer dedup path for ``m`` encoded pairs.

    Returns ``("bitmap", n_groups)`` for one dense scatter over the whole
    (group, rank, peer) code space, ``("chunked", groups_per_chunk)`` for
    dense scatters over group chunks whose bitmaps stay under
    :data:`_BITMAP_CELLS_CAP` cells, ``("hybrid", 0)`` to compact the
    rank/peer id spaces first and re-decide on the compacted extents
    (engages past :data:`_SKETCH_RANK_EXTENT` ranks, where the raw code
    space is hopelessly sparse but the ids actually present are usually a
    thin structured slice), or ``("unique", 0)`` for the sort-based path.
    Dense scatters touch every cell, so they only run when the code space
    is within :data:`_BITMAP_WORK_FACTOR` cells per pair; the chunking
    keeps peak allocation bounded at rank counts where the historical
    single bitmap (``cells = G * Rmax * stride``, with ``stride ~ Rmax``)
    grew quadratically.  All paths produce identical counts.
    """
    per_group = int(rank_extent) * int(stride)
    cells = int(n_groups) * per_group
    if m == 0 or cells == 0:
        return ("unique", 0)
    sparse_fallback = (
        ("hybrid", 0) if rank_extent > _SKETCH_RANK_EXTENT else ("unique", 0)
    )
    if cells > _BITMAP_WORK_FACTOR * m:
        return sparse_fallback
    if cells <= _BITMAP_CELLS_CAP:
        return ("bitmap", int(n_groups))
    if per_group <= _BITMAP_CELLS_CAP:
        return ("chunked", max(1, _BITMAP_CELLS_CAP // per_group))
    return sparse_fallback


def _compact_ids(col: np.ndarray) -> tuple:
    """Presence-mask id compaction: ``(uniq, compacted)``, no sort.

    One boolean scatter over the id range plus a lookup-table gather —
    O(m + extent) where ``np.unique`` would sort in O(m log m); the extent
    term is a byte per id, trivial even at millions of ranks.  ``uniq`` is
    ascending and ``uniq[compacted] == col`` elementwise, so codes built
    from the compacted ids stay monotone in the original ids and dedup
    results translate back by a gather without re-sorting.
    """
    mask = np.zeros(int(col.max()) + 1, bool)
    mask[col] = True
    uniq = np.flatnonzero(mask)
    lut = np.zeros(len(mask), np.int64)
    lut[uniq] = np.arange(len(uniq), dtype=np.int64)
    return uniq, lut[col]


def _compact_pairs(rows: np.ndarray, peers: np.ndarray) -> tuple:
    """Id-space sketch of both pair columns: unique ids + compacted cols."""
    urows, rows_c = _compact_ids(rows)
    upeers, peers_c = _compact_ids(peers)
    return urows, rows_c, upeers, peers_c


def _pair_counts_numpy(
    group_ids: np.ndarray,
    rows: np.ndarray,
    peers: np.ndarray,
    n_groups: int,
    rank_extent: int,
    strategy: Optional[tuple] = None,
) -> np.ndarray:
    """|distinct peers| per (group, rank) over encoded pairs (NumPy).

    ``group_ids`` must be non-decreasing (the profiler's unique
    (region, struct) combinations are emitted group-major), which lets the
    chunked path slice pair runs per group with one ``searchsorted``.
    ``strategy`` forces a :func:`_dedup_strategy` decision (tests only).
    """
    m = len(rows)
    counts = np.zeros(n_groups * rank_extent, np.int64)
    if m == 0 or rank_extent == 0 or n_groups == 0:
        return counts.reshape(n_groups, rank_extent)
    stride = np.int64(int(peers.max()) + 1)
    if strategy is None:
        strategy = _dedup_strategy(n_groups, rank_extent, int(stride), m)
    kind, chunk = strategy
    if kind == "hybrid":
        urows, rows_c, upeers, peers_c = _compact_pairs(rows, peers)
        sub = _dedup_strategy(n_groups, len(urows), len(upeers), m)
        if sub[0] == "hybrid":  # compaction exhausted — sort the small codes
            sub = ("unique", 0)
        compact = _pair_counts_numpy(
            group_ids, rows_c, peers_c, n_groups, len(urows), strategy=sub
        )
        counts = np.zeros((n_groups, rank_extent), np.int64)
        counts[:, urows] = compact
        return counts
    if kind == "unique":
        codes = (group_ids * rank_extent + rows) * stride + peers
        uniq = np.unique(codes)
        counts = np.bincount(uniq // stride, minlength=n_groups * rank_extent)
    elif kind == "bitmap":
        codes = (group_ids * rank_extent + rows) * stride + peers
        bitmap = np.zeros(n_groups * rank_extent * int(stride), bool)
        bitmap[codes] = True
        counts = bitmap.reshape(n_groups * rank_extent, int(stride)).sum(axis=1)
    else:  # chunked: dense scatter per run of groups, bounded peak memory
        bounds = np.searchsorted(group_ids, np.arange(n_groups + 1))
        for g0 in range(0, n_groups, chunk):
            g1 = min(g0 + chunk, n_groups)
            lo, hi = int(bounds[g0]), int(bounds[g1])
            if lo == hi:
                continue
            local = (
                (group_ids[lo:hi] - g0) * rank_extent + rows[lo:hi]
            ) * stride + peers[lo:hi]
            bitmap = np.zeros((g1 - g0) * rank_extent * int(stride), bool)
            bitmap[local] = True
            counts[g0 * rank_extent : g1 * rank_extent] = bitmap.reshape(
                (g1 - g0) * rank_extent, int(stride)
            ).sum(axis=1)
    return counts.reshape(n_groups, rank_extent).astype(np.int64, copy=False)


#: Bit position of the rank in a fixed ``(rank << 32) | peer`` pair code.
PAIR_CODE_SHIFT = 32


def _decode_pair_codes(
    uniq: np.ndarray, n_groups: int, rank_extent: int, stride: int
) -> tuple:
    """Split sorted unique compound codes into per-group fixed pair codes.

    ``uniq`` holds sorted ``(group * rank_extent + rank) * stride + peer``
    codes.  The compound encoding is monotone in (group, rank, peer) and
    the fixed ``(rank << PAIR_CODE_SHIFT) | peer`` encoding is monotone in
    (rank, peer), so within each group the converted codes stay sorted —
    no re-sort needed.  Returns ``(indptr, codes)`` CSR over groups.
    """
    per_group = np.int64(rank_extent) * np.int64(stride)
    g = uniq // per_group
    local = uniq - g * per_group
    codes = ((local // stride) << PAIR_CODE_SHIFT) | (local % stride)
    indptr = np.searchsorted(g, np.arange(n_groups + 1)).astype(np.int64)
    return indptr, codes.astype(np.int64, copy=False)


def _pair_codes_numpy(
    group_ids: np.ndarray,
    rows: np.ndarray,
    peers: np.ndarray,
    n_groups: int,
    strategy: Optional[tuple] = None,
) -> tuple:
    """Distinct (rank, peer) sets per group as sorted unique fixed codes.

    The mergeable twin of :func:`_pair_counts_numpy`: same non-decreasing
    ``group_ids`` contract, same :func:`_dedup_strategy` split (dense
    bitmap / chunked bitmap / sort-based unique), but instead of
    collapsing to per-rank counts it returns ``(indptr, codes)`` — a CSR
    over groups of sorted unique ``(rank << PAIR_CODE_SHIFT) | peer``
    int64 codes.  The encoding is *fixed* (no data-dependent stride), so
    code sets from different deltas/shards union directly
    (the streaming layer merges them with ``np.union1d``).
    """
    m = len(rows)
    if m == 0 or n_groups == 0:
        return np.zeros(n_groups + 1, np.int64), np.zeros(0, np.int64)
    rank_extent = int(rows.max()) + 1
    stride = int(peers.max()) + 1
    if rank_extent > (1 << 31) or stride > (1 << PAIR_CODE_SHIFT):
        raise ValueError(
            f"rank/peer ids ({rank_extent}, {stride}) exceed the fixed "
            f"pair-code encoding"
        )
    if strategy is None:
        strategy = _dedup_strategy(n_groups, rank_extent, stride, m)
    kind, chunk = strategy
    if kind == "hybrid":
        urows, rows_c, upeers, peers_c = _compact_pairs(rows, peers)
        sub = _dedup_strategy(n_groups, len(urows), len(upeers), m)
        if sub[0] == "hybrid":  # compaction exhausted — sort the small codes
            sub = ("unique", 0)
        indptr, codes_c = _pair_codes_numpy(
            group_ids, rows_c, peers_c, n_groups, strategy=sub
        )
        # Gather through the sorted id tables: monotone in (rank, peer), so
        # per-group code order survives the translation un-sorted.
        codes = (urows[codes_c >> PAIR_CODE_SHIFT] << PAIR_CODE_SHIFT) | (
            upeers[codes_c & _PAIR_CODE_MASK]
        )
        return indptr, codes
    if kind == "unique":
        comp = (group_ids * rank_extent + rows) * stride + peers
        uniq = np.unique(comp)
    elif kind == "bitmap":
        comp = (group_ids * rank_extent + rows) * stride + peers
        bitmap = np.zeros(n_groups * rank_extent * stride, bool)
        bitmap[comp] = True
        uniq = np.flatnonzero(bitmap)
    else:  # chunked: dense scatter per run of groups, bounded peak memory
        bounds = np.searchsorted(group_ids, np.arange(n_groups + 1))
        parts = []
        base = np.int64(rank_extent) * np.int64(stride)
        for g0 in range(0, n_groups, chunk):
            g1 = min(g0 + chunk, n_groups)
            lo, hi = int(bounds[g0]), int(bounds[g1])
            if lo == hi:
                continue
            local = (
                (group_ids[lo:hi] - g0) * rank_extent + rows[lo:hi]
            ) * stride + peers[lo:hi]
            bitmap = np.zeros((g1 - g0) * rank_extent * stride, bool)
            bitmap[local] = True
            parts.append(np.flatnonzero(bitmap) + g0 * base)
        uniq = (
            np.concatenate(parts) if parts else np.zeros(0, np.int64)
        )  # chunks are group-major, so the concatenation is already sorted
    return _decode_pair_codes(uniq, n_groups, rank_extent, stride)


# ---------------------------------------------------------------------------
# Backend interface + NumPy reference
# ---------------------------------------------------------------------------


class ReduceBackend:
    """Interface every reduction backend implements (NumPy in, NumPy out)."""

    name = "abstract"

    def matmul(self, w: np.ndarray, grid: np.ndarray) -> np.ndarray:
        """Exact int64 (G, S) @ (S, R) — never rounded."""
        raise NotImplementedError

    def block_reduce(self, grid, starts, ends, ufunc: np.ufunc) -> np.ndarray:
        raise NotImplementedError

    def segment_reduce(self, col, order, starts, ufunc: np.ufunc = np.add):
        raise NotImplementedError

    def factorize(self, col: np.ndarray) -> tuple:
        """``(uniq, first_index, inverse)`` with np.unique semantics."""
        raise NotImplementedError

    def pair_counts(self, group_ids, rows, peers, n_groups, rank_extent):
        """|distinct peers| per (group, rank); group_ids non-decreasing."""
        raise NotImplementedError

    def pair_codes(self, group_ids, rows, peers, n_groups) -> tuple:
        """Distinct (rank, peer) sets per group as sorted unique fixed
        ``(rank << PAIR_CODE_SHIFT) | peer`` codes — ``(indptr, codes)``
        CSR over groups; group_ids non-decreasing.  The mergeable form of
        :meth:`pair_counts` (the streaming layer's merge form)."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} name={self.name!r}>"


class NumpyBackend(ReduceBackend):
    """The reference backend: plain NumPy, bit-exact by construction."""

    name = "numpy"

    def matmul(self, w: np.ndarray, grid: np.ndarray) -> np.ndarray:
        return w @ grid

    def block_reduce(self, grid, starts, ends, ufunc: np.ufunc) -> np.ndarray:
        return block_reduce(grid, starts, ends, ufunc)

    def segment_reduce(self, col, order, starts, ufunc: np.ufunc = np.add):
        return segment_reduce(col, order, starts, ufunc)

    def factorize(self, col: np.ndarray) -> tuple:
        uniq, first, inv = np.unique(col, return_index=True, return_inverse=True)
        return uniq, first.astype(np.int64), inv.reshape(-1).astype(np.int64)

    def pair_counts(self, group_ids, rows, peers, n_groups, rank_extent):
        return _pair_counts_numpy(group_ids, rows, peers, n_groups, rank_extent)

    def pair_codes(self, group_ids, rows, peers, n_groups) -> tuple:
        return _pair_codes_numpy(group_ids, rows, peers, n_groups)



# ---------------------------------------------------------------------------
# torch backend: exact f64/limb matmuls, device dedup, CUDA segmented reduce
# ---------------------------------------------------------------------------


class BackendUnavailable(RuntimeError):
    """Raised when the torch backend is asked for a CUDA device that is absent."""


def _nlimbs(vmax: int, t: int) -> int:
    return max(1, -(-max(vmax, 1).bit_length() // t))


def _limb_width(other_max: int, s: int) -> int:
    """Widest limb t with (2**t - 1) * other_max * s < 2**53."""
    om, sm = max(other_max, 1), max(s, 1)
    t = 0
    while t < 63 and ((1 << (t + 1)) - 1) * om * sm < _F64_EXACT:
        t += 1
    return t


def _limb_plan(amax: int, bmax: int, s: int) -> Optional[tuple]:
    """(ta, ka, tb, kb) limb widths/counts making every partial f64 dot
    exact, or None when even 1-bit limbs overflow (true int64 results
    cannot reach that regime; callers fall back to the NumPy matmul)."""
    if amax * bmax * max(s, 1) < _F64_EXACT:
        return (64, 1, 64, 1)
    ta = _limb_width(bmax, s)
    if ta >= 1:
        return (ta, _nlimbs(amax, ta), 64, 1)
    tb = 0  # split both sides: grow symmetric widths while exact
    while ((1 << (tb + 1)) - 1) ** 2 * max(s, 1) < _F64_EXACT:
        tb += 1
    if tb < 1:
        return None
    ta = _limb_width((1 << tb) - 1, s)
    if ta < 1:
        return None
    return (ta, _nlimbs(amax, ta), tb, _nlimbs(bmax, tb))


def _limbs(x: torch.Tensor, t: int, k: int) -> list:
    """``k`` little-endian limbs of width ``t`` bits, each as float64."""
    if k == 1 and t >= 64:
        return [x.to(torch.float64)]
    mask = (1 << t) - 1
    return [((x >> (t * i)) & mask).to(torch.float64) for i in range(k)]


def _limb_matmul(a: torch.Tensor, b: torch.Tensor, plan: tuple) -> torch.Tensor:
    """Exact int64 ``a @ b`` from f64 limb products (``plan`` from
    :func:`_limb_plan`): each partial product is rounded to the nearest
    integer and recombined by int64 shift-and-add."""
    ta, ka, tb, kb = plan
    b_limbs = _limbs(b, tb, kb)
    out = None
    for i, af in enumerate(_limbs(a, ta, ka)):
        for j, bf in enumerate(b_limbs):
            p = torch.round(af @ bf).to(torch.int64)
            shift = ta * i + tb * j
            if shift:
                p = p << shift
            out = p if out is None else out + p
    return out


_SEG_OPS = {np.add: "sum", np.maximum: "max", np.minimum: "min"}


def _result_dtype(ufunc: np.ufunc, dtype) -> np.dtype:
    """dtype NumPy reduces ``dtype`` into (``np.add`` widens small ints)."""
    return ufunc.reduce(np.zeros(1, dtype)).dtype


class TorchBackend(ReduceBackend):
    """Reductions on a torch device; NumPy at the boundary.

    ``device=None`` means ``"cuda"``.  Construction raises
    :class:`BackendUnavailable` when a CUDA device is asked for and none is
    present; there is no fallback to the host (see the module docstring).
    On ``device="cpu"`` every method runs the same code on host tensors,
    and the segmented reductions run the kernel's plain PyTorch version.
    """

    name = "torch"

    def __init__(self, device: Union[str, torch.device, None] = None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise BackendUnavailable(
                "the torch reduction backend runs on a CUDA device and none "
                "is available; pass device='cpu' to run it on the host"
            )
        self.device = device

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<TorchBackend device={str(self.device)!r}>"

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the backend's device."""
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    @staticmethod
    def _get(t: torch.Tensor) -> np.ndarray:
        """Tensor -> host array (waits for the device)."""
        return t.cpu().numpy()

    # -- exact int64 matmul -------------------------------------------------
    def matmul(self, w: np.ndarray, grid: np.ndarray) -> np.ndarray:
        w = np.ascontiguousarray(w, np.int64)
        grid = np.ascontiguousarray(grid, np.int64)
        g, s = w.shape
        r = grid.shape[1]
        if g == 0 or s == 0 or r == 0:
            return np.zeros((g, r), np.int64)
        if int(w.min()) < 0 or int(grid.min()) < 0:
            return w @ grid  # profiler weights are non-negative by contract
        plan = _limb_plan(int(w.max()), int(grid.max()), s)
        if plan is None:  # pragma: no cover - beyond any int64-valid input
            return w @ grid
        return self._get(_limb_matmul(self._put(w), self._put(grid), plan))

    # -- segmented reductions -----------------------------------------------
    def block_reduce(self, grid, starts, ends, ufunc: np.ufunc) -> np.ndarray:
        op = _SEG_OPS.get(ufunc)
        if op is None or getattr(grid, "ndim", 0) != 2:
            return block_reduce(grid, starts, ends, ufunc)
        grid = grid.astype(_result_dtype(ufunc, grid.dtype), copy=False)
        if len(starts) == 0:
            return np.zeros((0,) + grid.shape[1:], grid.dtype)
        out = _seg_kernel.segment_reduce(
            self._put(grid),
            self._put(np.asarray(starts, np.int64)),
            self._put(np.asarray(ends, np.int64)),
            op,
        )
        return self._get(out)

    def segment_reduce(self, col, order, starts, ufunc: np.ufunc = np.add):
        if not len(starts):
            return np.zeros(0, col.dtype)
        op = _SEG_OPS.get(ufunc)
        if op is None or col.ndim != 1:
            return segment_reduce(col, order, starts, ufunc)
        col = col.astype(_result_dtype(ufunc, col.dtype), copy=False)
        vals = self._put(col)
        if order is not None:  # gather into segment order on the device
            vals = vals[self._put(np.asarray(order, np.int64))]
        starts = np.asarray(starts, np.int64)
        ends = np.append(starts[1:], len(col))
        out = _seg_kernel.segment_reduce(
            vals.reshape(-1, 1), self._put(starts), self._put(ends), op
        )
        return self._get(out[:, 0])

    # -- factorize / dedup ----------------------------------------------------
    def factorize(self, col: np.ndarray) -> tuple:
        col = np.asarray(col)
        if (
            col.dtype.kind not in "biuf"
            or col.dtype == np.uint64
            or (col.dtype.kind == "f" and np.isnan(col).any())
        ):
            # no torch dtype holds uint64, and np.unique merges NaNs where
            # torch.unique keeps them apart: the host keeps the semantics
            return NumpyBackend().factorize(col)
        vals = col.astype(np.int64) if col.dtype.kind == "u" else col
        uniq, inv = torch.unique(self._put(vals), sorted=True, return_inverse=True)
        inv = inv.reshape(-1)
        # first-occurrence indices derived from the inverse (np.unique's
        # return_index contract), independent of torch.unique's tie-breaking
        n = inv.shape[0]
        first = torch.full((uniq.shape[0],), n, dtype=torch.int64, device=self.device)
        first.scatter_reduce_(
            0, inv, torch.arange(n, device=self.device), reduce="amin"
        )
        return (
            self._get(uniq).astype(col.dtype, copy=False),
            self._get(first),
            self._get(inv).astype(np.int64, copy=False),
        )

    def pair_counts(self, group_ids, rows, peers, n_groups, rank_extent):
        m = len(rows)
        if m == 0 or rank_extent == 0 or n_groups == 0:
            return np.zeros((n_groups, rank_extent), np.int64)
        if rank_extent > _SKETCH_RANK_EXTENT:
            # Host-side sketch/chunked hybrid: at this extent the id
            # compaction + dense scatter beats a device sort of the raw
            # codes (and is bit-identical by the backend contract).
            return _pair_counts_numpy(
                group_ids, rows, peers, n_groups, rank_extent, strategy=("hybrid", 0)
            )
        stride = int(peers.max()) + 1
        codes = (group_ids * rank_extent + rows) * stride + peers
        uniq = torch.unique(self._put(codes))
        counts = torch.bincount(uniq // stride, minlength=n_groups * rank_extent)
        return self._get(counts).reshape(n_groups, rank_extent).astype(np.int64)

    def pair_codes(self, group_ids, rows, peers, n_groups) -> tuple:
        m = len(rows)
        if m == 0 or n_groups == 0:
            return np.zeros(n_groups + 1, np.int64), np.zeros(0, np.int64)
        rank_extent = int(rows.max()) + 1
        stride = int(peers.max()) + 1
        if rank_extent > (1 << 31) or stride > (1 << PAIR_CODE_SHIFT):
            raise ValueError(
                f"rank/peer ids ({rank_extent}, {stride}) exceed the fixed "
                f"pair-code encoding"
            )
        if rank_extent > _SKETCH_RANK_EXTENT:
            return _pair_codes_numpy(
                group_ids, rows, peers, n_groups, strategy=("hybrid", 0)
            )
        comp = (group_ids * rank_extent + rows) * stride + peers
        uniq = self._get(torch.unique(self._put(comp)))
        return _decode_pair_codes(uniq, n_groups, rank_extent, stride)


# ---------------------------------------------------------------------------
# Selection: explicit arg > use_backend() override > REPRO_BACKEND > torch
# ---------------------------------------------------------------------------

_instances: dict = {}
_instances_lock = threading.Lock()
_tls = threading.local()


def available_backends() -> tuple:
    return ("numpy", "torch")


def _instance(name: str) -> ReduceBackend:
    with _instances_lock:
        inst = _instances.get(name)
        if inst is None:
            inst = NumpyBackend() if name == "numpy" else TorchBackend()
            _instances[name] = inst
        return inst


def resolve_backend(
    backend: Union[ReduceBackend, str, None] = None,
) -> ReduceBackend:
    """Resolve a backend name/instance to a :class:`ReduceBackend`.

    Priority: explicit ``backend`` argument, then a :func:`use_backend`
    thread-local override, then the ``REPRO_BACKEND`` environment variable,
    then ``"torch"`` (on the CUDA card).  ``"torch"`` raises
    :class:`BackendUnavailable` when there is no CUDA device — it never
    falls back to NumPy.  An unknown explicit name raises ``ValueError``;
    an unknown environment/override value warns and takes the default.
    """
    if isinstance(backend, ReduceBackend):
        return backend
    explicit = backend is not None
    name = backend
    if name is None:
        override = getattr(_tls, "override", None)
        if isinstance(override, ReduceBackend):
            return override
        name = override
    if name is None:
        name = os.environ.get(BACKEND_ENV)
    if name is None:
        return _instance(DEFAULT_BACKEND)
    name = str(name).strip().lower()
    if name not in available_backends():
        if explicit:
            raise ValueError(
                f"unknown reduction backend: {backend!r} "
                f"(expected one of {available_backends()})"
            )
        warnings.warn(
            f"{BACKEND_ENV}={name!r} is not a known reduction backend "
            f"{available_backends()}; using {DEFAULT_BACKEND!r}",
            stacklevel=2,
        )
        return _instance(DEFAULT_BACKEND)
    return _instance(name)


@contextmanager
def use_backend(backend: Union[ReduceBackend, str, None]):
    """Thread-local default backend for the scope (sweep runners use this
    so app ``profile()`` entry points need no signature change)."""
    if isinstance(backend, str):
        if backend.strip().lower() not in available_backends():
            raise ValueError(
                f"unknown reduction backend: {backend!r} "
                f"(expected one of {available_backends()})"
            )
    prev = getattr(_tls, "override", None)
    _tls.override = backend
    try:
        yield
    finally:
        _tls.override = prev
