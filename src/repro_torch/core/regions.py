"""Communication regions — the paper's core contribution, on PyTorch.

The paper adds two markers to Caliper, ``CALI_MARK_COMM_REGION_BEGIN`` /
``CALI_MARK_COMM_REGION_END``, which bracket a group of MPI calls forming one
logical communication pattern instance (a halo exchange, a sweep, hypre's
MatVecComm).  Here the same concept is a context manager, ``comm_region``:

    with comm_region("sweep_comm"):
        field = coll.ppermute(field, axis_name="x", perm=right_perm)

Two things happen inside a region:

1. Every instrumented collective issued within the region (see
   ``repro_torch.core.collectives``) reports itself to the active
   :class:`RegionRecorder`, which forwards the *static* communication
   structure (bytes, per-rank source/destination sets, collective kind) to the
   profiler.  This is the PMPI-interception analog — except that the SPMD
   per-rank program is traced once on meta tensors, so its communication is
   statically known and the recorded statistics are exact rather than
   sampled.

2. A ``torch.profiler.record_function`` scope with a reserved prefix
   (``commr::<name>``) is entered, so the region name reaches torch
   profiler traces the way it reached HLO op metadata in the JAX package;
   the HLO-level analyzer (``repro_torch.core.hlo``) attributes collectives
   to regions by the same prefix.

3. While a graph is captured (:func:`annotating`, entered by
   ``hlo.capture_graph_collectives``), the region path (``"grad/fwd/attn"``)
   is set as the ``comm_region`` annotation of
   ``torch.fx.traceback.annotate``, so the nodes captured inside the region
   carry it in ``node.meta["custom"]``: the collectives that DTensor
   inserts (``_c10d_functional`` ops, which take no region argument) are
   attributed by it in the compiled layer.

Regions nest; statistics are attributed to the innermost region, matching
Caliper's stack semantics.

Recorder and region-stack state are **thread-local**: concurrent traces
(e.g. the benchpark runner profiling independent scaling points in a
thread pool) each see their own recorder and cannot cross-attribute
events.  The mesh / ``shard_map`` machinery the instrumented collectives
run under is provided by :mod:`repro_torch.core.compat`, the port's SPMD
shim (named axes, one meta-tensor trace of the per-rank program).

Structure-interned columnar trace store (profiling data model)
--------------------------------------------------------------

Event capture is **structure-of-arrays** and **structure-interned**: the
recorder owns a :class:`TraceBuffer` and the instrumented collectives
append straight into its columns — no per-event Python object is built on
the hot recording path, and no per-event O(n_ranks) state is stored.

Applications replay a tiny set of unique communication structures (kripke
emits the same wavefront-diagonal pairs for all 36 dirset x groupset
messages of a phase and revisits stages across octants; laghos repeats
identical halo/CG structures every step; amg repeats per-level structures
every cycle), so the O(n_ranks) payload of an event — dense per-rank
count/byte vectors, participant mask, CSR peer-set pairs — is stored
**once per unique structure** in a content-fingerprinted
:class:`StructTable`, and events shrink to scalar rows that reference a
``struct_id``.  Memory is O(unique_structs x n_ranks + events) instead of
O(events x n_ranks), and recording skips :func:`p2p_structure` entirely on
a fingerprint hit.

Row schema (per-event scalar columns; consecutive identical events
collapse into one row at record time, so ``n_rows <= n_events``):

* ``region_ids`` / ``path_ids`` / ``kind_ids`` / ``axis_ids`` — **interned**
  int32 codes into ``region_names`` / ``region_paths`` / ``kind_names`` /
  ``axis_names`` (each distinct string/tuple stored once);
* ``is_collective`` — uint8 flag (1 = all-reduce-like, 0 = point-to-point);
* ``struct_ids`` — int64 id into the buffer's :class:`StructTable`;
* ``nbytes`` — int64 byte scale of the event (per-message bytes for
  point-to-point events, per-rank ring-equivalent bytes for collectives,
  1 for adapter-appended raw events whose byte vectors are stored
  explicitly in the struct);
* ``multiplicity`` — int64 number of identical consecutive events this
  row stands for (>= 1; the profiler weights its reductions by it);
* ``largest`` — int64 largest single message of the event (bytes); for
  point-to-point appends this is simply ``nbytes`` when the event has any
  pair and 0 otherwise.

Struct-table schema (``S`` unique structures).  The table has two modes:

* **eager** (``TraceBuffer(intern=False)`` reference layout, and
  ``materialize=True``): every struct's dense slabs and CSR pair columns
  are materialized at append time — struct ``s`` spans
  ``rank_indptr()[s]:rank_indptr()[s + 1]`` of the dense slabs and
  ``dest_indptr()`` / ``src_indptr()`` runs of the CSR pair columns;
* **lazy** (the default interned layout): the table stores only the
  per-struct scalars plus the struct's *generating payload* (the
  canonical pair array for point-to-point structures, the flattened
  member array for collectives, the explicit vectors for raw adapter
  events), and the dense ``(S, Rmax)`` slab grids are **materialized per
  reduction** via :meth:`StructTable.reduction_view` — built once,
  cached, and invalidated by the next append.  The flat column
  properties below (``sends`` .. ``src_peers``) transparently read
  through the cached view, so every consumer sees the same layout in
  both modes.

Interning is **rank-extent-normalized** where the producer cooperates:
arrays tagged with :func:`tag_structure` (topology pair/group expansions,
kripke's wavefront planes) fingerprint by their ``(generator, extent)``
key — an O(1) dict probe — instead of hashing the raw payload bytes, so
the same halo stencil at 512 and 65536 ranks costs one key comparison per
event rather than O(pairs) fingerprint bytes.  Untagged arrays fall back
to the content fingerprint (``tobytes``) unchanged.

Flat (eager/materialized) column schema:

* ``rank_lens`` — int64 extent of the dense per-rank slab (the event's
  ``n_ranks``);
* ``sends`` / ``recvs`` — int64 message counts per rank (zero slabs for
  collective structures);
* ``bsent_units`` / ``brecv_units`` — int64 **unit** byte vectors; an
  event's per-rank bytes are ``unit * nbytes``.  For point-to-point
  structures the units equal the count vectors, for collective structures
  they are the 0/1 participant indicator, and for raw adapter events they
  hold the explicit byte vectors (scale 1);
* ``participants`` — bool mask of ranks taking part in the call (dense
  values are zero and peer rows empty outside the mask — the *canonical
  form*; :meth:`RegionEvent.from_dicts` canonicalizes legacy dicts);
* ``dest_rows`` / ``dest_peers`` and ``src_rows`` / ``src_peers`` —
  duplicate-free (rank, peer) pair columns of the destination/source peer
  sets, row-major with sorted unique peers per row, with per-struct pair
  counts in ``dest_lens`` / ``src_lens``.

For point-to-point events the participants are the ranks of the permutation's
axis groups; for collective events they are the communicator-group members,
and only the byte units carry information — the peer structure of a
collective is implicit (complete graph within each group) and is not
materialized.  Byte accounting follows the conventions documented in
:mod:`repro_torch.core.collectives` (ring-equivalent traffic per rank).

:class:`RegionEvent` survives as a *view/adapter*: ``buffer.event(i)``
materializes the i-th **logical** event on demand (multiplicity-expanded
indexing; array slices of the struct slabs scaled by the row's ``nbytes``),
and ``RegionEvent.from_dicts`` / ``to_dicts`` adapt the legacy
dict-of-dicts form for the reference profiler and for parity tests.
``TraceBuffer(intern=False)`` disables fingerprinting and multiplicity
collapse (one struct row per event) — the pre-interning reference layout
the perf suite compares against; both modes produce identical logical
event streams and bit-identical profiles.

The buffer is plain ``str``/``int``/ndarray state (the fingerprint table
pickles alongside it), so it pickles cheaply — this is what allows the
benchpark runner to trace scaling points in a *process* pool and ship
profiles between workers.  The profiler (:mod:`repro_torch.core.profiler`)
consumes the columns directly with multiplicity-weighted segment
reductions over the unique structures; it never materializes per-event
objects.

Backend contract (how these columns meet :mod:`repro_torch.core.backend`)
--------------------------------------------------------------------

The dense slabs and CSR pair columns above are exactly what the
swappable reduction backend consumes: the profiler reshapes the struct
slabs into ``(S, Rmax)`` int64 grids and hands the backend int64
multiplicity-weight matrices to multiply against them, plus the
``(rows, peers)`` pair columns for peer-set dedup.  Every array crossing
that boundary is a NumPy ndarray with the dtypes listed in the schemas
above (int64 slabs/counts/bytes, bool participants, int64 pair columns),
and every backend — NumPy reference, torch on the card with its CUDA
segmented-reduce kernel — must return bit-identical int64 results; the
store itself never depends on which backend reduces it.  See the backend
module docstring for the exactness guarantees (f64-exact /
limb-decomposed matmuls).

Spill-to-mmap (``REPRO_TRACE_SPILL_BYTES``)
-------------------------------------------

Row columns grow without bound on long traces.  When a spill threshold is
set (``TraceBuffer(spill_bytes=...)`` or the ``REPRO_TRACE_SPILL_BYTES``
environment variable), the buffer's nine row columns share a
:class:`_SpillPool`: the first growth that would push their combined
in-RAM capacity past the threshold reallocates that column as an
``np.memmap`` over a private temp file (amortized doubling growth via
``truncate``), and the column stays file-backed from then on.  Appends,
multiplicity bumps (``add_last``), watermarks, and streaming deltas are
unchanged — a memmap is an ndarray.  Pickles copy the live prefix back
into plain arrays (spill state is process-local; the receiving process
re-spills on its own growth), and the temp directory is removed when the
buffer is garbage collected.

Live monitoring: watermark semantics
------------------------------------

The buffer is append-only, but the multiplicity collapse means the *last*
row can still grow after it is read, so streaming consumers
(:mod:`repro_torch.core.streaming`) cursor with :meth:`TraceBuffer.watermark` —
a ``(row, multiplicity)`` pair, not a bare row count: every row below
``row`` is fully consumed and ``multiplicity`` events of row ``row``
itself are.  Deltas taken against successive watermarks partition the
logical event stream exactly (no overlap, no gap), which is what makes
the incremental profiler's merged shards bit-identical to the batch
reduction.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import threading
import weakref
from dataclasses import dataclass
from typing import Iterator, Mapping, Optional

import numpy as np
import torch
import torch.fx.traceback as fx_traceback

from repro_torch.core.faultinject import maybe_fault

#: Environment knob: row columns of a :class:`TraceBuffer` spill to
#: file-backed (np.memmap) storage once their combined in-RAM footprint
#: would exceed this many bytes (0 / unset disables spilling).
TRACE_SPILL_ENV = "REPRO_TRACE_SPILL_BYTES"

#: Prefix of the profiler scope a region enters, so traces and HLO metadata
#: can recognize a communication region (rather than an ordinary scope).
COMM_REGION_SCOPE_PREFIX = "commr::"

#: Region name attributed to collectives issued outside any comm_region.
UNANNOTATED_REGION = "<unannotated>"


def _empty_csr(n_ranks: int) -> tuple:
    return (np.zeros(n_ranks + 1, np.int64), np.zeros(0, np.int64))


def _csr_rows_to_dicts(indptr, indices, ranks) -> dict:
    """CSR rows -> {rank: set(peers)} for the given rank ids."""
    return {int(r): {int(p) for p in indices[indptr[r] : indptr[r + 1]]} for r in ranks}


def _rows_to_csr(rows: np.ndarray, indices: np.ndarray, n: int) -> tuple:
    """(row, peer) pair columns -> explicit CSR (indptr, indices)."""
    indptr = np.zeros(n + 1, np.int64)
    if len(rows):
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, np.asarray(indices, np.int64)


def _as_pair_array(pairs) -> np.ndarray:
    """Canonical contiguous (P, 2) int64 pair array (fingerprintable)."""
    if not isinstance(pairs, np.ndarray):
        pairs = np.asarray(list(pairs), np.int64)
    return np.ascontiguousarray(pairs.astype(np.int64, copy=False)).reshape(-1, 2)


# ---------------------------------------------------------------------------
# Generator tags — rank-extent-normalized structure fingerprints
# ---------------------------------------------------------------------------

#: id(array) -> (generator, extent, weakref).  Weak so the registry never
#: extends an array's lifetime (producer memos own their arrays); the dead
#: entry is dropped by the weakref callback, and the identity check in
#: :func:`structure_tag` guards the id()-reuse race besides.
_TAGS: dict = {}


def _drop_tag(key: int):
    _TAGS.pop(key, None)


def tag_structure(arr: np.ndarray, generator: tuple, extent: tuple) -> np.ndarray:
    """Register a structure array's ``(generator, extent)`` fingerprint.

    ``generator`` names *how* the array was produced (e.g. ``("axis-perm",
    axis, perm_key)`` for a topology pair expansion, ``("kripke-plane",
    stage, axis, sign)`` for a sweep wavefront) and ``extent`` pins the
    rank-space it was produced *for* (topology sizes, decomp shape).
    Together they must determine the array contents exactly — two arrays
    carrying the same key are interned to the same struct without their
    bytes ever being compared.  Producers call this once per memoized
    array; :class:`StructTable` then fingerprints repeat appends with an
    O(1) identity probe instead of an O(payload) ``tobytes`` hash.

    Returns ``arr`` unchanged (tag-and-return convenience).
    """
    key = id(arr)
    _TAGS[key] = (generator, extent, weakref.ref(arr, lambda _r: _drop_tag(key)))
    return arr


def structure_tag(arr: np.ndarray) -> Optional[tuple]:
    """The ``(generator, extent)`` key of a tagged array, or None."""
    hit = _TAGS.get(id(arr))
    if hit is not None and hit[2]() is arr:
        return (hit[0], hit[1])
    return None


def p2p_structure(pairs, n: int) -> tuple:
    """Dense count vectors + distinct peer-pair columns from (src, dst) pairs.

    ``pairs`` is any ``(P, 2)``-shaped sequence/array of global rank pairs.
    Returns ``(sends, recvs, dest_rows, dest_peers, src_rows, src_peers)``:
    int64 message-count vectors of length ``n`` plus the duplicate-free
    (rank, peer) pair columns of the destination/source peer *sets*, row-major
    with sorted unique peers per row (one ``np.unique`` over encoded pair
    codes per side — no Python loop over ranks or pairs).
    """
    pairs = _as_pair_array(pairs)
    src, dst = pairs[:, 0], pairs[:, 1]
    sends = np.zeros(n, np.int64)
    recvs = np.zeros(n, np.int64)
    np.add.at(sends, src, 1)
    np.add.at(recvs, dst, 1)
    if len(src):
        stride = np.int64(max(n, 1))
        dcodes = np.unique(src * stride + dst)
        scodes = np.unique(dst * stride + src)
        return (
            sends,
            recvs,
            dcodes // stride,
            dcodes % stride,
            scodes // stride,
            scodes % stride,
        )
    empty = np.zeros(0, np.int64)
    return sends, recvs, empty, empty, empty.copy(), empty.copy()


class Column:
    """Append-only 1-D array with amortized-growth (capacity-doubling) backing.

    Shared building block of the columnar stores: the traced-layer
    :class:`TraceBuffer` below and the compiled-layer
    ``repro_torch.core.hlo.HloCollectiveBuffer`` both lay their per-event /
    per-op columns out of these.

    A column registered with a :class:`_SpillPool` reallocates its backing
    onto an ``np.memmap`` (amortized file growth via ``truncate``) once the
    pool's in-RAM budget is exhausted, and stays file-backed from then on;
    unregistered columns (the default) never touch the filesystem.
    """

    __slots__ = ("_data", "_n", "_pool", "_spill_path")

    def __init__(self, dtype, capacity: int = 64):
        self._data = np.zeros(capacity, dtype)
        self._n = 0
        self._pool = None
        self._spill_path = None

    def __len__(self) -> int:
        return self._n

    @property
    def spilled(self) -> bool:
        """Whether the backing currently lives in a spill file."""
        return isinstance(self._data, np.memmap)

    def capacity_nbytes(self) -> int:
        """Allocated capacity bytes (live prefix + growth headroom)."""
        return self._data.size * self._data.dtype.itemsize

    def _grow_to(self, need: int) -> None:
        if need > self._data.size:
            cap = max(need, self._data.size * 2)
            pool = self._pool
            if pool is not None and pool.should_spill(
                self, cap * self._data.dtype.itemsize
            ):
                try:
                    grown = pool.allocate(self, cap, self._data.dtype)
                except OSError:
                    # failing spill disk (ENOSPC, injected spill_torn, a
                    # vanished tmpdir): fall back to RAM — the trace must
                    # survive even if the RAM budget is blown.  The pool
                    # counts the failure and disables itself after a few,
                    # so a dead disk is not re-probed on every growth.
                    pool.note_failure()
                    grown = np.zeros(cap, self._data.dtype)
            else:
                grown = np.zeros(cap, self._data.dtype)
            grown[: self._n] = self._data[: self._n]
            self._data = grown

    def push(self, value) -> None:
        self._grow_to(self._n + 1)
        self._data[self._n] = value
        self._n += 1

    def extend(self, values: np.ndarray) -> None:
        values = np.asarray(values, self._data.dtype)
        need = self._n + values.size
        self._grow_to(need)
        self._data[self._n : need] = values
        self._n = need

    def add_last(self, delta) -> None:
        """In-place bump of the most recent value (multiplicity collapse)."""
        self._data[self._n - 1] += delta

    def view(self) -> np.ndarray:
        """The live prefix (no copy; treat as read-only)."""
        return self._data[: self._n]

    def storage_nbytes(self) -> int:
        """Live-prefix storage bytes (growth headroom excluded)."""
        return self._n * self._data.dtype.itemsize

    # compact pickles: drop the unused growth capacity.  A spilled column
    # round-trips as a plain in-RAM array (np.asarray collapses the memmap);
    # spill state is process-local and rebuilt by the owning buffer.
    def __getstate__(self) -> tuple:
        return (np.asarray(self._data[: self._n]).copy(),)

    def __setstate__(self, state) -> None:
        (data,) = state
        self._data = data
        self._n = data.size
        self._pool = None
        self._spill_path = None


#: Backwards-compatible private alias (the earlier name).
_Column = Column


class _SpillPool:
    """Shared spill budget for one buffer's row columns.

    Tracks the combined in-RAM capacity of its registered columns; the
    growth that would push it past ``threshold`` bytes moves that column to
    an ``np.memmap`` over a private temp file (see :meth:`Column._grow_to`).
    Once spilled a column keeps growing in its file — mixing a column's
    backing between RAM and disk would invalidate live views mid-append.
    The temp directory is created lazily on the first spill and removed by
    a ``weakref.finalize`` when the pool (i.e. its buffer) is collected.

    Pickles carry only the threshold: spill state is process-local, and the
    receiving buffer re-registers its columns (in-RAM after the round-trip)
    so they re-spill on their own growth.
    """

    #: Spill-file failures tolerated before the pool disables itself
    #: (columns then stay in RAM — degraded footprint, correct trace).
    MAX_FAILURES = 3

    def __init__(self, threshold: int) -> None:
        self.threshold = int(threshold)
        self._columns: list = []
        self._dir: Optional[str] = None
        self._seq = 0
        self._finalizer = None
        self._failures = 0

    def register(self, col: Column) -> None:
        col._pool = self
        self._columns.append(col)

    def note_failure(self) -> None:
        """Record a failed spill allocation (see :attr:`MAX_FAILURES`)."""
        self._failures = getattr(self, "_failures", 0) + 1

    def ram_nbytes(self) -> int:
        """Combined allocated capacity of the unspilled registered columns."""
        return sum(c.capacity_nbytes() for c in self._columns if not c.spilled)

    def spilled_nbytes(self) -> int:
        """Live bytes currently resident in spill files."""
        return sum(c.storage_nbytes() for c in self._columns if c.spilled)

    def should_spill(self, col: Column, new_nbytes: int) -> bool:
        if self.threshold <= 0:
            return False
        if getattr(self, "_failures", 0) >= self.MAX_FAILURES:
            return False  # spill disk given up on: stay in RAM
        if col.spilled:
            return True  # grow in place in the file
        return self.ram_nbytes() - col.capacity_nbytes() + new_nbytes > self.threshold

    def allocate(self, col: Column, count: int, dtype) -> np.ndarray:
        """Grow ``col``'s spill file to ``count`` items and map it."""
        if maybe_fault("spill_torn", col._spill_path or "") is not None:
            raise OSError("injected fault: spill_torn")
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix="repro-trace-spill-")
            self._finalizer = weakref.finalize(
                self, shutil.rmtree, self._dir, ignore_errors=True
            )
        if col._spill_path is None:
            col._spill_path = os.path.join(self._dir, f"col{self._seq}.bin")
            self._seq += 1
            with open(col._spill_path, "wb"):
                pass
        with open(col._spill_path, "r+b") as f:
            f.truncate(count * np.dtype(dtype).itemsize)
        return np.memmap(col._spill_path, dtype=dtype, mode="r+", shape=(count,))

    def __getstate__(self) -> dict:
        return {"threshold": self.threshold}

    def __setstate__(self, state) -> None:
        self.threshold = state["threshold"]
        self._columns = []
        self._dir = None
        self._seq = 0
        self._finalizer = None


class Interner:
    """Hashable value <-> dense int id table.

    Both columnar stores intern their repeated string/tuple fields through
    this (region names, nesting paths, collective kinds, axis names), so
    events/ops carry 4-byte ids and each distinct value is stored once.
    ``values`` is the id-ordered table; ``intern`` returns the existing id
    or assigns the next one.
    """

    __slots__ = ("values", "_ids")

    def __init__(self, values=()) -> None:
        self.values = list(values)
        self._ids = {v: i for i, v in enumerate(self.values)}

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, code: int):
        return self.values[code]

    def intern(self, value) -> int:
        code = self._ids.get(value)
        if code is None:
            code = len(self.values)
            self.values.append(value)
            self._ids[value] = code
        return code

    def memory_bytes(self) -> int:
        """Approximate live bytes: table + id dict + one copy of each value
        (the dict key and list entry are the same object)."""
        total = sys.getsizeof(self.values) + sys.getsizeof(self._ids)
        for v in self.values:
            total += sys.getsizeof(v)
        return total

    # compact pickles: the id dict rebuilds from the table.  The value
    # list is adopted as-is (not copied) so owners that alias it — the
    # buffers' ``region_names`` etc. — keep seeing appends after a
    # pickle round-trip.
    def __getstate__(self) -> tuple:
        return (self.values,)

    def __setstate__(self, state) -> None:
        (values,) = state
        self.values = values
        self._ids = {v: i for i, v in enumerate(values)}


#: Struct kinds (the lazy table's per-struct payload discriminator).
_KIND_P2P = 0
_KIND_COLL = 1
_KIND_RAW = 2

_EMPTY_I64 = np.zeros(0, np.int64)


def _as_member_array(groups) -> np.ndarray:
    """Canonical contiguous flat int64 member array (fingerprintable)."""
    return np.ascontiguousarray(np.asarray(groups, np.int64).reshape(-1))


def _cat(parts: list, dtype) -> np.ndarray:
    if not parts:
        return np.zeros(0, dtype)
    return np.concatenate(parts).astype(dtype, copy=False)


class StructView:
    """One materialized flat view of a :class:`StructTable`.

    Exposes exactly the eager column layout (see the module docstring's
    flat schema): struct ``s`` spans ``rank_indptr()[s]:rank_indptr()[s+1]``
    of the dense slabs and ``dest_indptr()`` / ``src_indptr()`` runs of the
    CSR pair columns.  For an eager table the arrays alias the live column
    prefixes (zero copy); for a lazy table they are expanded from the
    generating payloads and cached by the table until its next append.
    """

    _FIELDS = (
        "rank_lens",
        "dest_lens",
        "src_lens",
        "sends",
        "recvs",
        "bsent_units",
        "brecv_units",
        "participants",
        "dest_rows",
        "dest_peers",
        "src_rows",
        "src_peers",
    )

    __slots__ = _FIELDS + ("_rank_indptr", "_dest_indptr", "_src_indptr")

    def __init__(self, **cols) -> None:
        for name in self._FIELDS:
            setattr(self, name, cols[name])
        self._rank_indptr = None
        self._dest_indptr = None
        self._src_indptr = None

    def rank_indptr(self) -> np.ndarray:
        """int64[S + 1] slab boundaries of the dense per-rank columns."""
        if self._rank_indptr is None:
            self._rank_indptr = _indptr(self.rank_lens)
        return self._rank_indptr

    def dest_indptr(self) -> np.ndarray:
        if self._dest_indptr is None:
            self._dest_indptr = _indptr(self.dest_lens)
        return self._dest_indptr

    def src_indptr(self) -> np.ndarray:
        if self._src_indptr is None:
            self._src_indptr = _indptr(self.src_lens)
        return self._src_indptr

    def storage_nbytes(self) -> int:
        return sum(getattr(self, name).nbytes for name in self._FIELDS)


class StructTable:
    """Fingerprinted store of unique communication structures.

    Each unique ``(pairs, n)`` point-to-point structure / ``(groups, n)``
    communicator structure / raw adapter event payload is stored **once**;
    :class:`TraceBuffer` rows reference structs by id.  ``intern_*``
    fingerprint the incoming structure — by ``(generator, extent)`` key
    for arrays tagged via :func:`tag_structure` (O(1) identity probe on
    repeats), by raw payload bytes otherwise — and skip
    :func:`p2p_structure` (and the dense scatters) entirely on a hit;
    ``insert_*`` bypass the fingerprint table (the ``intern=False``
    reference layout, one struct per event).

    ``lazy=True`` (the interned :class:`TraceBuffer` default) stores only
    each struct's generating payload and expands the flat slab/pair-column
    layout on demand through :meth:`reduction_view` — see the module
    docstring's two-mode schema.  ``lazy=False`` materializes at append
    time (the reference layout, byte-compatible with the pre-lazy store).
    """

    def __init__(self, lazy: bool = False) -> None:
        self._lazy = bool(lazy)
        self._fp: dict = {}
        # Process-local (id(array), n) -> struct id fast path for tagged
        # producer arrays (dropped from pickles; ids don't travel).
        self._id_memo: dict = {}
        self._version = 0
        self._view_cache: Optional[tuple] = None  # (version, StructView)
        # Per-struct scalar columns.
        self._rank_len = Column(np.int64)
        self._struct_kind = Column(np.int8)
        # Generating payloads, one entry per struct (None when eager).
        self._payload: list = []
        # Eagerly-materialized columns (empty in lazy mode).
        self._dest_len = Column(np.int64)
        self._src_len = Column(np.int64)
        # Dense per-rank slabs (struct-major).
        self._sends = Column(np.int64)
        self._recvs = Column(np.int64)
        self._bsent_unit = Column(np.int64)
        self._brecv_unit = Column(np.int64)
        self._participants = Column(bool)
        # CSR peer-set pair columns (runs of dest_lens[s] / src_lens[s]).
        self._dest_rows = Column(np.int64)
        self._dest_peers = Column(np.int64)
        self._src_rows = Column(np.int64)
        self._src_peers = Column(np.int64)

    # -- flat views ----------------------------------------------------------
    #
    # Every consumer-facing column reads through reduction_view(), so lazy
    # and eager tables expose one identical layout; in eager mode the view
    # aliases the live column prefixes (no copy).

    @property
    def n_structs(self) -> int:
        return len(self._rank_len)

    @property
    def rank_lens(self) -> np.ndarray:
        return self._rank_len.view()

    @property
    def dest_lens(self) -> np.ndarray:
        return self.reduction_view().dest_lens

    @property
    def src_lens(self) -> np.ndarray:
        return self.reduction_view().src_lens

    @property
    def sends(self) -> np.ndarray:
        return self.reduction_view().sends

    @property
    def recvs(self) -> np.ndarray:
        return self.reduction_view().recvs

    @property
    def bsent_units(self) -> np.ndarray:
        return self.reduction_view().bsent_units

    @property
    def brecv_units(self) -> np.ndarray:
        return self.reduction_view().brecv_units

    @property
    def participants(self) -> np.ndarray:
        return self.reduction_view().participants

    @property
    def dest_rows(self) -> np.ndarray:
        return self.reduction_view().dest_rows

    @property
    def dest_peers(self) -> np.ndarray:
        return self.reduction_view().dest_peers

    @property
    def src_rows(self) -> np.ndarray:
        return self.reduction_view().src_rows

    @property
    def src_peers(self) -> np.ndarray:
        return self.reduction_view().src_peers

    def rank_indptr(self) -> np.ndarray:
        """int64[S + 1] slab boundaries of the dense per-rank columns."""
        return self.reduction_view().rank_indptr()

    def dest_indptr(self) -> np.ndarray:
        return self.reduction_view().dest_indptr()

    def src_indptr(self) -> np.ndarray:
        return self.reduction_view().src_indptr()

    def reduction_view(self) -> StructView:
        """The flat eager layout of this table, cached per append version.

        Lazy tables expand their generating payloads (one
        :func:`p2p_structure` / member scatter per unique struct — O(unique
        structs x n_ranks) work and memory, paid once per reduction, not
        per event); eager tables wrap their live columns with no copy.
        """
        hit = self._view_cache
        if hit is not None and hit[0] == self._version:
            return hit[1]
        if self._lazy:
            view = self._materialize()
        else:
            view = StructView(
                rank_lens=self._rank_len.view(),
                dest_lens=self._dest_len.view(),
                src_lens=self._src_len.view(),
                sends=self._sends.view(),
                recvs=self._recvs.view(),
                bsent_units=self._bsent_unit.view(),
                brecv_units=self._brecv_unit.view(),
                participants=self._participants.view(),
                dest_rows=self._dest_rows.view(),
                dest_peers=self._dest_peers.view(),
                src_rows=self._src_rows.view(),
                src_peers=self._src_peers.view(),
            )
        self._view_cache = (self._version, view)
        return view

    def _materialize(self) -> StructView:
        """Expand the generating payloads into the flat eager layout.

        Bit-identical to the eager append path by construction: p2p
        payloads run the same :func:`p2p_structure`, collective payloads
        the same member scatter, raw payloads are stored pre-expanded.
        """
        sends, recvs, bsent, brecv, parts = [], [], [], [], []
        drows, dpeers, srows, speers = [], [], [], []
        kinds = self._struct_kind.view()
        lens = self._rank_len.view()
        n_structs = len(lens)
        dlen = np.zeros(n_structs, np.int64)
        slen = np.zeros(n_structs, np.int64)
        for s in range(n_structs):
            n = int(lens[s])
            payload = self._payload[s]
            kind = int(kinds[s])
            if kind == _KIND_P2P:
                sv, rv, dr, dp, sr, sp = p2p_structure(payload, n)
                bs, br = sv, rv
                pt = np.ones(n, bool)
            elif kind == _KIND_COLL:
                unit = np.zeros(n, np.int64)
                unit[payload] = 1
                sv = rv = np.zeros(n, np.int64)
                bs = br = unit
                pt = unit.astype(bool)
                dr = dp = sr = sp = _EMPTY_I64
            else:  # _KIND_RAW: explicit vectors, stored pre-expanded
                sv, rv, bs, br, pt, dr, dp, sr, sp = payload
            sends.append(sv)
            recvs.append(rv)
            bsent.append(bs)
            brecv.append(br)
            parts.append(pt)
            drows.append(dr)
            dpeers.append(dp)
            srows.append(sr)
            speers.append(sp)
            dlen[s] = len(dr)
            slen[s] = len(sr)
        return StructView(
            rank_lens=lens,
            dest_lens=dlen,
            src_lens=slen,
            sends=_cat(sends, np.int64),
            recvs=_cat(recvs, np.int64),
            bsent_units=_cat(bsent, np.int64),
            brecv_units=_cat(brecv, np.int64),
            participants=_cat(parts, bool),
            dest_rows=_cat(drows, np.int64),
            dest_peers=_cat(dpeers, np.int64),
            src_rows=_cat(srows, np.int64),
            src_peers=_cat(speers, np.int64),
        )

    def storage_nbytes(self) -> int:
        """Live storage bytes: scalar columns, eager slabs/pair columns, and
        lazy generating payloads (fingerprint keys and the cached reduction
        view excluded — see :meth:`memory_bytes` for full accounting)."""
        cols = (
            self._rank_len,
            self._struct_kind,
            self._dest_len,
            self._src_len,
            self._sends,
            self._recvs,
            self._bsent_unit,
            self._brecv_unit,
            self._participants,
            self._dest_rows,
            self._dest_peers,
            self._src_rows,
            self._src_peers,
        )
        return sum(c.storage_nbytes() for c in cols) + self._payload_nbytes()

    def _payload_nbytes(self) -> int:
        total = 0
        for p in self._payload:
            if p is None:
                continue
            if isinstance(p, np.ndarray):
                total += p.nbytes
            else:
                total += sum(a.nbytes for a in p)
        return total

    def memory_bytes(self) -> int:
        """In-RAM bytes actually allocated by this table: full column
        capacities (growth headroom included), generating payloads, the
        fingerprint / id-memo tables, and the cached reduction view."""
        cols = (
            self._rank_len,
            self._struct_kind,
            self._dest_len,
            self._src_len,
            self._sends,
            self._recvs,
            self._bsent_unit,
            self._brecv_unit,
            self._participants,
            self._dest_rows,
            self._dest_peers,
            self._src_rows,
            self._src_peers,
        )
        total = sum(c.capacity_nbytes() for c in cols)
        total += self._payload_nbytes()
        total += sys.getsizeof(self._fp) + sys.getsizeof(self._id_memo)
        for key in self._fp:
            total += sys.getsizeof(key)
            total += sum(sys.getsizeof(p) for p in key if isinstance(p, bytes))
        hit = self._view_cache
        if self._lazy and hit is not None:
            total += hit[1].storage_nbytes()
        return total

    # -- pickling ------------------------------------------------------------
    # The id-memo (process-local array identities) and the materialization
    # cache drop from pickles; the fingerprint table — its (generator,
    # extent) keys are plain tuples — and the payloads travel, so a
    # round-tripped table keeps memoizing.

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        state["_id_memo"] = {}
        state["_view_cache"] = None
        return state

    def __setstate__(self, state) -> None:
        self.__dict__.update(state)

    # -- interning / insertion ----------------------------------------------

    def intern_p2p(self, pairs, n: int) -> int:
        """Struct id of a (pairs, n) point-to-point structure (memoized).

        Arrays tagged via :func:`tag_structure` fingerprint by their
        ``(generator, extent)`` key — repeats cost one id() probe, and the
        payload bytes are never hashed; untagged input is canonicalized
        and content-fingerprinted (``tobytes``).  On any fingerprint hit
        no structure is recomputed and no slab is appended.
        """
        tag = structure_tag(pairs) if isinstance(pairs, np.ndarray) else None
        if tag is not None:
            mkey = (id(pairs), int(n))
            hit = self._id_memo.get(mkey)
            if hit is not None and hit[1] is pairs:
                return hit[0]
            key = (0, int(n), tag)
        else:
            pairs = _as_pair_array(pairs)
            key = (0, int(n), pairs.tobytes())
            mkey = None
        sid = self._fp.get(key)
        if sid is None:
            pairs = _as_pair_array(pairs)
            if self._lazy:
                sid = self._append_lazy(n=n, kind=_KIND_P2P, payload=pairs)
            else:
                sid = self.insert_p2p(pairs, n)
            self._fp[key] = sid
        if mkey is not None:
            self._id_memo[mkey] = (sid, pairs)
        return sid

    def intern_collective(self, members, n: int) -> int:
        """Struct id of a (group members, n) collective structure (memoized).

        Accepts the producer's group array as-is — ``(n_groups,
        group_size)`` from ``topology.groups`` or an already-flat member
        array; tagged group arrays take the ``(generator, extent)`` fast
        path like p2p pairs.
        """
        tag = structure_tag(members) if isinstance(members, np.ndarray) else None
        if tag is not None:
            mkey = (id(members), int(n))
            hit = self._id_memo.get(mkey)
            if hit is not None and hit[1] is members:
                return hit[0]
            key = (1, int(n), tag)
        else:
            members = _as_member_array(members)
            key = (1, int(n), members.tobytes())
            mkey = None
        sid = self._fp.get(key)
        if sid is None:
            members = _as_member_array(members)
            if self._lazy:
                sid = self._append_lazy(n=n, kind=_KIND_COLL, payload=members)
            else:
                sid = self.insert_collective(members, n)
            self._fp[key] = sid
        if mkey is not None:
            self._id_memo[mkey] = (sid, members)
        return sid

    def intern_event(self, ev: "RegionEvent") -> int:
        """Struct id of a raw adapter event's payload (memoized)."""
        key = (
            2,
            int(ev.n_ranks),
            np.asarray(ev.sends, np.int64).tobytes(),
            np.asarray(ev.recvs, np.int64).tobytes(),
            np.asarray(ev.bytes_sent, np.int64).tobytes(),
            np.asarray(ev.bytes_recv, np.int64).tobytes(),
            np.asarray(ev.participants, bool).tobytes(),
            np.asarray(ev.dest_indptr, np.int64).tobytes(),
            np.asarray(ev.dest_indices, np.int64).tobytes(),
            np.asarray(ev.src_indptr, np.int64).tobytes(),
            np.asarray(ev.src_indices, np.int64).tobytes(),
        )
        sid = self._fp.get(key)
        if sid is None:
            if self._lazy:
                ranks = np.arange(ev.n_ranks, dtype=np.int64)
                payload = (
                    np.asarray(ev.sends, np.int64),
                    np.asarray(ev.recvs, np.int64),
                    np.asarray(ev.bytes_sent, np.int64),
                    np.asarray(ev.bytes_recv, np.int64),
                    np.asarray(ev.participants, bool),
                    np.repeat(ranks, np.diff(ev.dest_indptr)),
                    np.asarray(ev.dest_indices, np.int64),
                    np.repeat(ranks, np.diff(ev.src_indptr)),
                    np.asarray(ev.src_indices, np.int64),
                )
                sid = self._append_lazy(n=ev.n_ranks, kind=_KIND_RAW, payload=payload)
            else:
                sid = self.insert_event(ev)
            self._fp[key] = sid
        return sid

    def insert_p2p(self, pairs: np.ndarray, n: int) -> int:
        sends, recvs, drows, dpeers, srows, speers = p2p_structure(pairs, n)
        return self._append(
            n=n,
            kind=_KIND_P2P,
            sends=sends,
            recvs=recvs,
            bsent_unit=sends,
            brecv_unit=recvs,
            participants=np.ones(n, bool),
            dest_rows=drows,
            dest_peers=dpeers,
            src_rows=srows,
            src_peers=speers,
        )

    def insert_collective(self, members: np.ndarray, n: int) -> int:
        members = _as_member_array(members)
        unit = np.zeros(n, np.int64)
        unit[members] = 1
        zero = np.zeros(n, np.int64)
        empty = np.zeros(0, np.int64)
        return self._append(
            n=n,
            kind=_KIND_COLL,
            sends=zero,
            recvs=zero,
            bsent_unit=unit,
            brecv_unit=unit,
            participants=unit.astype(bool),
            dest_rows=empty,
            dest_peers=empty,
            src_rows=empty,
            src_peers=empty,
        )

    def insert_event(self, ev: "RegionEvent") -> int:
        ranks = np.arange(ev.n_ranks, dtype=np.int64)
        return self._append(
            n=ev.n_ranks,
            kind=_KIND_RAW,
            sends=ev.sends,
            recvs=ev.recvs,
            bsent_unit=ev.bytes_sent,
            brecv_unit=ev.bytes_recv,
            participants=ev.participants,
            dest_rows=np.repeat(ranks, np.diff(ev.dest_indptr)),
            dest_peers=ev.dest_indices,
            src_rows=np.repeat(ranks, np.diff(ev.src_indptr)),
            src_peers=ev.src_indices,
        )

    def _append_lazy(self, *, n: int, kind: int, payload) -> int:
        sid = len(self._rank_len)
        self._rank_len.push(n)
        self._struct_kind.push(kind)
        self._payload.append(payload)
        self._version += 1
        return sid

    def _append(
        self,
        *,
        n: int,
        kind: int,
        sends: np.ndarray,
        recvs: np.ndarray,
        bsent_unit: np.ndarray,
        brecv_unit: np.ndarray,
        participants: np.ndarray,
        dest_rows: np.ndarray,
        dest_peers: np.ndarray,
        src_rows: np.ndarray,
        src_peers: np.ndarray,
    ) -> int:
        if self._lazy:
            raise ValueError(
                "insert_* appends the materialized layout; this StructTable "
                "is lazy (generator payloads) — use intern_* instead"
            )
        sid = len(self._rank_len)
        self._rank_len.push(n)
        self._struct_kind.push(kind)
        self._payload.append(None)
        self._dest_len.push(len(dest_rows))
        self._src_len.push(len(src_rows))
        self._sends.extend(sends)
        self._recvs.extend(recvs)
        self._bsent_unit.extend(bsent_unit)
        self._brecv_unit.extend(brecv_unit)
        self._participants.extend(participants)
        self._dest_rows.extend(dest_rows)
        self._dest_peers.extend(dest_peers)
        self._src_rows.extend(src_rows)
        self._src_peers.extend(src_peers)
        self._version += 1
        return sid


def _indptr(lens: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=out[1:])
    return out


class TraceBuffer:
    """Structure-interned columnar store of recorded collective calls.

    See the module docstring for the row and struct-table schemas.  One
    buffer belongs to one :class:`RegionRecorder`; the instrumented
    collectives append via :func:`record_p2p` / :func:`record_collective`,
    and the profiler reduces the columns directly with
    multiplicity-weighted segment reductions.  ``event(i)`` /
    ``to_events()`` materialize :class:`RegionEvent` views for adapters
    and the reference profiler (logical, multiplicity-expanded indexing).

    ``intern=False`` reproduces the pre-interning reference layout: every
    append inserts a fresh struct row (no fingerprint lookup, no
    multiplicity collapse) — same logical stream, O(events x n_ranks)
    memory; the perf suite measures interned against it.

    ``materialize`` controls the struct table's slab layout when interning:
    the default (False) stores generating payloads and expands dense slabs
    lazily per reduction; ``materialize=True`` restores the eager interned
    layout (the eager baseline the scale perf suite measures against).
    ``spill_bytes`` (default from ``REPRO_TRACE_SPILL_BYTES``; 0 disables)
    caps the row columns' in-RAM footprint — growth past it spills to
    file-backed arrays (see the module docstring's spill section).
    """

    def __init__(
        self,
        intern: bool = True,
        *,
        materialize: Optional[bool] = None,
        spill_bytes: Optional[int] = None,
    ) -> None:
        self._intern = bool(intern)
        if materialize is None:
            materialize = not self._intern
        # The insert_* reference path appends materialized slabs, so an
        # intern=False buffer is always eager regardless of materialize.
        self._materialize = bool(materialize) or not self._intern
        self.structs = StructTable(lazy=not self._materialize)
        if spill_bytes is None:
            try:
                spill_bytes = int(os.environ.get(TRACE_SPILL_ENV) or 0)
            except ValueError:
                spill_bytes = 0
        self._spill = _SpillPool(int(spill_bytes)) if int(spill_bytes) > 0 else None
        # Interning tables (shared Interner); the *_names attributes alias
        # the interners' id-ordered value tables, so existing consumers
        # keep indexing plain lists.
        self._regions = Interner()
        self._paths = Interner()
        self._kinds = Interner()
        self._axes = Interner()
        self.region_names: list = self._regions.values
        self.region_paths: list = self._paths.values
        self.kind_names: list = self._kinds.values
        self.axis_names: list = self._axes.values
        # Per-row scalar columns (one row per run of identical events).
        self._region = Column(np.int32)
        self._path = Column(np.int32)
        self._kind = Column(np.int32)
        self._axis = Column(np.int32)
        self._is_coll = Column(np.uint8)
        self._struct = Column(np.int64)
        self._nbytes = Column(np.int64)
        self._mult = Column(np.int64)
        self._largest = Column(np.int64)
        self._n_events = 0
        if self._spill is not None:
            for col in self._row_columns():
                self._spill.register(col)

    def _row_columns(self) -> tuple:
        return (
            self._region,
            self._path,
            self._kind,
            self._axis,
            self._is_coll,
            self._struct,
            self._nbytes,
            self._mult,
            self._largest,
        )

    # Spill state is process-local: unpickled columns arrive in-RAM, so the
    # pool (which travels threshold-only) re-adopts them here and they
    # re-spill on their own growth.
    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        pool = self.__dict__.get("_spill")
        if pool is not None:
            for col in self._row_columns():
                pool.register(col)

    # -- interning ----------------------------------------------------------

    def region_id(self, name: str) -> int:
        return self._regions.intern(name)

    # -- column views (live prefixes, read-only) ----------------------------

    @property
    def n_events(self) -> int:
        """Logical event count (sum of multiplicities)."""
        return self._n_events

    @property
    def n_rows(self) -> int:
        """Physical row count (consecutive identical events collapsed)."""
        return len(self._region)

    @property
    def region_ids(self) -> np.ndarray:
        return self._region.view()

    @property
    def path_ids(self) -> np.ndarray:
        return self._path.view()

    @property
    def kind_ids(self) -> np.ndarray:
        return self._kind.view()

    @property
    def axis_ids(self) -> np.ndarray:
        return self._axis.view()

    @property
    def is_collective(self) -> np.ndarray:
        return self._is_coll.view()

    @property
    def struct_ids(self) -> np.ndarray:
        return self._struct.view()

    @property
    def nbytes(self) -> np.ndarray:
        """Per-row byte scale (per-message / per-rank; 1 for raw events)."""
        return self._nbytes.view()

    @property
    def multiplicity(self) -> np.ndarray:
        return self._mult.view()

    @property
    def largest(self) -> np.ndarray:
        return self._largest.view()

    def watermark(self) -> tuple:
        """Current ``(row, multiplicity)`` high-water mark for streaming.

        Identical consecutive events collapse into the **last** row by
        bumping its multiplicity, so a bare row count is not a stable
        cursor — the last row may grow after being read.  Incremental
        consumers (:mod:`repro_torch.core.streaming`) therefore track the pair:
        everything below ``row`` plus ``multiplicity`` events of row
        ``row`` itself has been consumed.  For an empty buffer this is
        ``(0, 0)``; otherwise ``(n_rows - 1, multiplicity[-1])``.
        """
        n = self.n_rows
        if n == 0:
            return (0, 0)
        return (n - 1, int(self._mult._data[n - 1]))

    def storage_nbytes(self) -> int:
        """Live buffer memory: row columns + the struct table's storage.

        Counts live-prefix bytes wherever they reside (RAM or spill file);
        see :meth:`memory_bytes` for the in-RAM-allocation view and
        :meth:`spilled_nbytes` for the file-backed share.  (Distinct from
        the :attr:`nbytes` *column* — the per-row byte scale of the row
        schema; storage accounting is always the ``storage_nbytes``
        spelling on Column/StructTable/TraceBuffer.)
        """
        cols = self._row_columns()
        return sum(c.storage_nbytes() for c in cols) + self.structs.storage_nbytes()

    def spilled_nbytes(self) -> int:
        """Live row-column bytes currently resident in spill files (0 when
        spilling is disabled or the threshold was never crossed)."""
        return self._spill.spilled_nbytes() if self._spill is not None else 0

    def memory_bytes(self) -> int:
        """In-RAM bytes actually allocated by this buffer.

        Unlike :meth:`storage_nbytes` (live-prefix data bytes), this
        accounts what the process is really holding: full row-column
        capacities (growth headroom included, spilled columns excluded —
        their bytes are on disk, see :meth:`spilled_nbytes`), the struct
        table's columns / generating payloads / fingerprint + memo tables /
        cached reduction view, and the string-interning tables.
        """
        total = 0
        for col in self._row_columns():
            if not col.spilled:
                total += col.capacity_nbytes()
        total += self.structs.memory_bytes()
        for interner in (self._regions, self._paths, self._kinds, self._axes):
            total += interner.memory_bytes()
        return total

    # -- appends (the hot recording path; no per-rank/per-event Python) -----

    def _append_row(
        self,
        *,
        region: str,
        region_path: tuple,
        kind: str,
        axis_name: str,
        is_collective: int,
        largest: int,
        struct_id: int,
        nbytes: int,
    ) -> None:
        rid = self._regions.intern(region)
        pid = self._paths.intern(tuple(region_path))
        kid = self._kinds.intern(kind)
        aid = self._axes.intern(str(axis_name))
        ic = 1 if is_collective else 0
        self._n_events += 1
        j = len(self._region) - 1
        if (
            self._intern
            and j >= 0
            and self._struct._data[j] == struct_id
            and self._nbytes._data[j] == nbytes
            and self._region._data[j] == rid
            and self._path._data[j] == pid
            and self._kind._data[j] == kid
            and self._axis._data[j] == aid
            and self._is_coll._data[j] == ic
        ):
            # identical consecutive event: collapse into the last row
            # (largest is a function of struct + nbytes, so it matches too)
            self._mult.add_last(1)
            return
        self._region.push(rid)
        self._path.push(pid)
        self._kind.push(kid)
        self._axis.push(aid)
        self._is_coll.push(ic)
        self._struct.push(struct_id)
        self._nbytes.push(nbytes)
        self._mult.push(1)
        self._largest.push(largest)

    def append_p2p(
        self,
        *,
        region: str,
        region_path: tuple,
        kind: str,
        axis_name: str,
        pairs,
        n: int,
        nbytes: int,
    ) -> None:
        """Append a point-to-point event from global (src, dst) pairs.

        Every pair moves ``nbytes``; all ``n`` ranks participate (matching the
        SPMD execution model: the permute runs on every rank, including ranks
        with no active pair this call).  The pair array is fingerprinted:
        repeated structures intern to one :class:`StructTable` entry and
        skip :func:`p2p_structure` entirely.  Canonical (P, 2) ndarrays are
        passed through untouched so tagged producer arrays keep their
        identity (the O(1) fingerprint fast path).
        """
        if not (
            isinstance(pairs, np.ndarray) and pairs.ndim == 2 and pairs.shape[1] == 2
        ):
            pairs = _as_pair_array(pairs)
        if self._intern:
            sid = self.structs.intern_p2p(pairs, n)
        else:
            sid = self.structs.insert_p2p(_as_pair_array(pairs), n)
        # Every message of the event is nbytes, so the largest single
        # message is nbytes exactly whenever any pair exists.
        self._append_row(
            region=region,
            region_path=region_path,
            kind=kind,
            axis_name=axis_name,
            is_collective=0,
            largest=int(nbytes) if len(pairs) else 0,
            struct_id=sid,
            nbytes=int(nbytes),
        )

    def append_collective(
        self,
        *,
        region: str,
        region_path: tuple,
        kind: str,
        axis_name: str,
        groups: np.ndarray,
        n: int,
        per_rank_bytes: int,
    ) -> None:
        """Append a collective event over communicator ``groups``.

        ``groups`` is the ``(n_groups, group_size)`` global-rank array from
        ``topology.groups`` (or ``arange(n)[None, :]`` for a flat axis); each
        member rank sends/receives ``per_rank_bytes`` ring-equivalent bytes.
        The member array is fingerprinted like the p2p pairs — by
        ``(generator, extent)`` key when the group array is tagged, by the
        flattened member bytes otherwise.
        """
        if self._intern:
            sid = self.structs.intern_collective(groups, n)
        else:
            sid = self.structs.insert_collective(_as_member_array(groups), n)
        self._append_row(
            region=region,
            region_path=region_path,
            kind=kind,
            axis_name=axis_name,
            is_collective=1,
            largest=0,
            struct_id=sid,
            nbytes=int(per_rank_bytes),
        )

    def append_event(self, ev: "RegionEvent") -> None:
        """Adapter: append an already-materialized :class:`RegionEvent`.

        The event's byte vectors are arbitrary (not a struct x scalar
        product), so the struct stores them explicitly and the row's byte
        scale is 1.
        """
        largest = 0
        if not ev.is_collective and ev.participants.any():
            pv = ev.sends[ev.participants]
            pb = ev.bytes_sent[ev.participants]
            largest = int(pb.max()) // max(1, int(pv.max()))
        if self._intern:
            sid = self.structs.intern_event(ev)
        else:
            sid = self.structs.insert_event(ev)
        self._append_row(
            region=ev.region,
            region_path=tuple(ev.region_path),
            kind=ev.kind,
            axis_name=ev.axis_name,
            is_collective=int(ev.is_collective),
            largest=largest,
            struct_id=sid,
            nbytes=1,
        )

    # -- views --------------------------------------------------------------

    def event(self, i: int) -> "RegionEvent":
        """Materialize the i-th **logical** event as a :class:`RegionEvent`.

        Logical indices expand multiplicities: row ``r`` covers logical
        events ``cum_mult[r - 1]:cum_mult[r]`` (all identical).
        """
        if not 0 <= i < self._n_events:
            raise IndexError(i)
        cum = np.cumsum(self.multiplicity)
        r = int(np.searchsorted(cum, i, side="right"))
        st = self.structs
        return self._event_row(r, st.rank_indptr(), st.dest_indptr(), st.src_indptr())

    def _event_row(
        self, r: int, rptr: np.ndarray, dptr: np.ndarray, sptr: np.ndarray
    ) -> "RegionEvent":
        st = self.structs
        s = int(self.struct_ids[r])
        n = int(st.rank_lens[s])
        slab = slice(rptr[s], rptr[s + 1])
        d = slice(dptr[s], dptr[s + 1])
        sp = slice(sptr[s], sptr[s + 1])
        scale = int(self.nbytes[r])
        dest_indptr, dest_indices = _rows_to_csr(st.dest_rows[d], st.dest_peers[d], n)
        src_indptr, src_indices = _rows_to_csr(st.src_rows[sp], st.src_peers[sp], n)
        return RegionEvent(
            region=self.region_names[self.region_ids[r]],
            region_path=self.region_paths[self.path_ids[r]],
            kind=self.kind_names[self.kind_ids[r]],
            n_ranks=n,
            sends=st.sends[slab],
            recvs=st.recvs[slab],
            bytes_sent=st.bsent_units[slab] * scale,
            bytes_recv=st.brecv_units[slab] * scale,
            dest_indptr=dest_indptr,
            dest_indices=dest_indices,
            src_indptr=src_indptr,
            src_indices=src_indices,
            participants=st.participants[slab],
            is_collective=int(self.is_collective[r]),
            axis_name=self.axis_names[self.axis_ids[r]],
        )

    def to_events(self) -> list:
        """All logical events as :class:`RegionEvent` views (adapters only).

        One view is built per physical row and repeated ``multiplicity``
        times (the repeated logical events are identical by construction),
        so materializing E events is O(rows x struct payload), not O(E).
        """
        st = self.structs
        rptr = st.rank_indptr()
        dptr = st.dest_indptr()
        sptr = st.src_indptr()
        mult = self.multiplicity
        out: list = []
        for r in range(self.n_rows):
            out.extend([self._event_row(r, rptr, dptr, sptr)] * int(mult[r]))
        return out


@dataclass
class RegionEvent:
    """One instrumented collective call observed inside a region.

    A *view/adapter* over the structure-interned :class:`TraceBuffer`
    store (see the module docstring): all fields describe the static
    structure of the collective, per participating rank (paper Table I is
    derived from these), in the array-native canonical form.  The default
    profiling path never materializes these — they exist for the reference
    profiler, the legacy dict adapters, and tests.
    """

    region: str  # innermost region name ("sweep_comm")
    region_path: tuple  # full nesting path ("main", "sweep_comm")
    kind: str  # ppermute | psum | all_gather | all_to_all | ...
    n_ranks: int  # extent of the dense per-rank vectors
    # Dense per-rank vectors, int64[n_ranks].
    sends: np.ndarray  # messages sent by each rank in this call
    recvs: np.ndarray  # messages received by each rank
    bytes_sent: np.ndarray  # bytes sent by each rank
    bytes_recv: np.ndarray  # bytes received by each rank
    # CSR per-rank peer sets: peers of rank r are indices[indptr[r]:indptr[r+1]].
    dest_indptr: np.ndarray  # int64[n_ranks + 1]
    dest_indices: np.ndarray  # int64[nnz], sorted unique per row
    src_indptr: np.ndarray
    src_indices: np.ndarray
    # Ranks taking part in this call, bool[n_ranks]; dense vectors are zero
    # and CSR rows empty outside this mask.
    participants: np.ndarray
    # 1 if this call is a collective (all-reduce/all-gather/...), 0 for
    # point-to-point-like patterns (ppermute).
    is_collective: int = 0
    axis_name: str = ""

    # -- adapters -----------------------------------------------------------

    @classmethod
    def from_dicts(
        cls,
        *,
        region: str,
        region_path: tuple,
        kind: str,
        sends_per_rank: Mapping,
        recvs_per_rank: Mapping,
        dest_ranks: Mapping,
        src_ranks: Mapping,
        bytes_sent: Mapping,
        bytes_recv: Mapping,
        is_collective: int = 0,
        axis_name: str = "",
        n_ranks: Optional[int] = None,
    ) -> "RegionEvent":
        """Build an array-native event from the legacy dict-of-dicts fields.

        Canonicalization matches the original dict accounting exactly:
        participants are ``keys(sends) | keys(recvs)`` for point-to-point
        events and ``keys(bytes_sent)`` for collectives; entries for ranks
        outside the participant set are dropped, missing entries default to
        zero / the empty set.
        """
        if is_collective:
            part = sorted(int(r) for r in bytes_sent)
        else:
            part = sorted(
                {int(r) for r in sends_per_rank} | {int(r) for r in recvs_per_rank}
            )
        peer_max = -1
        for d in (dest_ranks, src_ranks):
            for r in part:
                for p in d.get(r, ()):
                    peer_max = max(peer_max, int(p))
        n = max(part[-1] + 1 if part else 0, peer_max + 1, n_ranks or 0)

        def dense(d: Mapping) -> np.ndarray:
            out = np.zeros(n, np.int64)
            for r in part:
                out[r] = int(d.get(r, 0))
            return out

        def csr(d: Mapping) -> tuple:
            indptr = np.zeros(n + 1, np.int64)
            rows = []
            for r in part:
                peers = sorted(int(p) for p in set(d.get(r, ())))
                indptr[r + 1] = len(peers)
                rows.extend(peers)
            np.cumsum(indptr, out=indptr)
            return indptr, np.asarray(rows, np.int64)

        participants = np.zeros(n, bool)
        participants[part] = True
        if is_collective:
            dptr, dind = _empty_csr(n)
            sptr, sind = _empty_csr(n)
            zero = np.zeros(n, np.int64)
            return cls(
                region=region,
                region_path=region_path,
                kind=kind,
                n_ranks=n,
                sends=zero,
                recvs=zero.copy(),
                bytes_sent=dense(bytes_sent),
                bytes_recv=dense(bytes_recv),
                dest_indptr=dptr,
                dest_indices=dind,
                src_indptr=sptr,
                src_indices=sind,
                participants=participants,
                is_collective=1,
                axis_name=axis_name,
            )
        dptr, dind = csr(dest_ranks)
        sptr, sind = csr(src_ranks)
        return cls(
            region=region,
            region_path=region_path,
            kind=kind,
            n_ranks=n,
            sends=dense(sends_per_rank),
            recvs=dense(recvs_per_rank),
            bytes_sent=dense(bytes_sent),
            bytes_recv=dense(bytes_recv),
            dest_indptr=dptr,
            dest_indices=dind,
            src_indptr=sptr,
            src_indices=sind,
            participants=participants,
            is_collective=0,
            axis_name=axis_name,
        )

    def to_dicts(self) -> dict:
        """Legacy dict-of-dicts view (canonical form: participants only).

        Used by the reference profiler implementation — the executable
        specification the vectorized path is parity-tested against.
        """
        ranks = np.flatnonzero(self.participants)
        if self.is_collective:
            return dict(
                sends_per_rank={},
                recvs_per_rank={},
                dest_ranks={},
                src_ranks={},
                bytes_sent={int(r): int(self.bytes_sent[r]) for r in ranks},
                bytes_recv={int(r): int(self.bytes_recv[r]) for r in ranks},
            )
        return dict(
            sends_per_rank={int(r): int(self.sends[r]) for r in ranks},
            recvs_per_rank={int(r): int(self.recvs[r]) for r in ranks},
            dest_ranks=_csr_rows_to_dicts(self.dest_indptr, self.dest_indices, ranks),
            src_ranks=_csr_rows_to_dicts(self.src_indptr, self.src_indices, ranks),
            bytes_sent={int(r): int(self.bytes_sent[r]) for r in ranks},
            bytes_recv={int(r): int(self.bytes_recv[r]) for r in ranks},
        )

    def rank_extent(self) -> int:
        """1 + highest participating rank (0 when nobody participates)."""
        idx = np.flatnonzero(self.participants)
        return int(idx[-1]) + 1 if len(idx) else 0


class RegionRecorder:
    """Owns the structure-interned TraceBuffer for one profiling session.

    The instrumented collectives append straight into :attr:`buffer`;
    :attr:`events` materializes RegionEvent views on demand (adapter path —
    the default profiler reduces the buffer columns directly).
    """

    def __init__(self) -> None:
        self.buffer = TraceBuffer()
        # Number of times each region was entered (instance count — the paper
        # distinguishes pattern *instances* across iterations).
        self.instances: dict[str, int] = {}

    @property
    def events(self) -> list:
        """RegionEvent views of the buffer (built on access; adapters only)."""
        return self.buffer.to_events()

    def record(self, event: RegionEvent) -> None:
        """Adapter: append a materialized event into the columnar buffer."""
        self.buffer.append_event(event)

    def enter(self, name: str) -> None:
        self.instances[name] = self.instances.get(name, 0) + 1


class _State(threading.local):
    def __init__(self) -> None:
        self.stack: list[str] = []
        self.recorder: Optional[RegionRecorder] = None


_STATE = _State()

#: set while a graph is captured: only then does a region annotate the
#: nodes made inside it (process-wide, as the backward may run on another
#: thread)
_ANNOTATING = False


def current_region() -> Optional[str]:
    """Innermost active region name, or None outside any region."""
    return _STATE.stack[-1] if _STATE.stack else None


def current_region_path() -> tuple:
    return tuple(_STATE.stack)


def active_recorder() -> Optional[RegionRecorder]:
    return _STATE.recorder


@contextlib.contextmanager
def comm_region(name: str) -> Iterator[None]:
    """Mark a communication region (CALI_MARK_COMM_REGION_BEGIN/END analog).

    Enters a ``torch.profiler.record_function`` scope so the name is
    visible in profiler traces, pushes onto the region stack consulted by
    instrumented collectives, and, within :func:`annotating`, annotates
    captured graph nodes with the region path.
    """
    if not name or "/" in name:
        raise ValueError(f"invalid comm region name: {name!r}")
    _STATE.stack.append(name)
    if _STATE.recorder is not None:
        _STATE.recorder.enter(name)
    try:
        annotation = (fx_traceback.annotate({"comm_region": "/".join(_STATE.stack)})
                      if _ANNOTATING else contextlib.nullcontext())
        with torch.profiler.record_function(COMM_REGION_SCOPE_PREFIX + name), annotation:
            yield
    finally:
        popped = _STATE.stack.pop()
        assert popped == name, "comm_region stack corrupted"


@contextlib.contextmanager
def annotating() -> Iterator[None]:
    """Within it, each :func:`comm_region` entered annotates the graph nodes
    made inside it with its path (a graph capture's scope)."""
    global _ANNOTATING
    previous, _ANNOTATING = _ANNOTATING, True
    try:
        yield
    finally:
        _ANNOTATING = previous


@contextlib.contextmanager
def recording() -> Iterator[RegionRecorder]:
    """Install a fresh RegionRecorder for the duration of a trace.

    Typical use::

        with recording() as rec:
            step(meta_input)   # per-rank program on meta tensors
        profile = CommPatternProfiler.from_recorder(rec, n_ranks)
    """
    prev = _STATE.recorder
    rec = RegionRecorder()
    _STATE.recorder = rec
    try:
        yield rec
    finally:
        _STATE.recorder = prev


def record_event(event: RegionEvent) -> None:
    """Adapter entry point: append a materialized event (tests, tools)."""
    rec = _STATE.recorder
    if rec is not None:
        rec.buffer.append_event(event)


def record_p2p(kind: str, axis_name, pairs, n: int, nbytes: int) -> None:
    """Hot path for instrumented point-to-point patterns.

    Appends straight into the active recorder's columnar buffer — no
    RegionEvent object is constructed, and repeated pair structures are
    memoized (fingerprint hit skips :func:`p2p_structure`).
    """
    rec = _STATE.recorder
    if rec is not None:
        rec.buffer.append_p2p(
            region=current_region() or UNANNOTATED_REGION,
            region_path=current_region_path(),
            kind=kind,
            axis_name=str(axis_name),
            pairs=pairs,
            n=n,
            nbytes=nbytes,
        )


def record_collective(
    kind: str, axis_name, groups: np.ndarray, n: int, per_rank_bytes: int
) -> None:
    """Hot path for instrumented collectives (memoized columnar append)."""
    rec = _STATE.recorder
    if rec is not None:
        rec.buffer.append_collective(
            region=current_region() or UNANNOTATED_REGION,
            region_path=current_region_path(),
            kind=kind,
            axis_name=str(axis_name),
            groups=groups,
            n=n,
            per_rank_bytes=per_rank_bytes,
        )
