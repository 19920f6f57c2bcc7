"""Streaming, mergeable communication profiles (live monitoring layer).

The batch pipeline is trace-fully-then-reduce:
:meth:`~repro_torch.core.profiler.CommPatternProfiler.from_recorder` consumes a
finished :class:`~repro_torch.core.regions.TraceBuffer` in one pass.  At high
concurrency that stops being viable (the exascale-diagnostics framework,
PAPERS.md) — fleets need profiles that can be *merged* and *inspected
while runs are in flight* (ucTrace).  This module supplies the two
primitives the live layer is built from:

:class:`RegionSummary` / :class:`ProfileSummary`
    The **mergeable summary form** of
    :class:`~repro_torch.core.profiler.RegionStats`: instead of the collapsed
    (min, max) tuples it carries the exact per-rank int64 count/byte
    vectors, participant masks, and the distinct peer *sets* as sorted
    unique ``(rank << 32) | peer`` codes.  ``merge`` is **associative and
    commutative** by construction — counts/bytes add elementwise, masks
    OR, peer-code sets union (vectorized ``np.union1d`` over the sorted
    code arrays), ``largest`` takes the max, instance/kind counts add —
    so any shard ordering and any aggregation-tree shape reduce to the
    same summary, and :meth:`ProfileSummary.finalize` collapses it into a
    :class:`~repro_torch.core.profiler.CommProfile` **byte-identical**
    (``to_json()``) to the batch ``from_recorder`` reduction over the
    same events (asserted on random streams and the four apps' paths in
    ``tests/test_torch_streaming.py``).

:class:`StreamingProfiler`
    The **incremental mode** of ``CommPatternProfiler`` (constructed via
    :meth:`CommPatternProfiler.incremental
    <repro_torch.core.profiler.CommPatternProfiler.incremental>`): it holds a
    row **watermark** into the recorder's TraceBuffer and each
    :meth:`~StreamingProfiler.update` re-reduces only the new
    ``(struct_id, weight)`` rows — through the same backend matmul /
    dedup kernels as the batch path (by default torch on the CUDA card:
    f64-limb ``torch.matmul`` and ``torch.unique``) — returning the delta
    as a mergeable :class:`ProfileSummary` shard and folding it into the
    running summary.

Watermark semantics
-------------------

A TraceBuffer collapses identical consecutive events into one row by
bumping the **last** row's multiplicity, so "rows consumed" alone is not
a valid cursor: the last row may still grow after it was read.  The
watermark is therefore the pair ``(row, mult)`` — every row below ``row``
is fully consumed, and ``mult`` multiplicities of row ``row`` itself are
consumed.  An update covering rows ``[row, hi)`` weights row ``row`` by
``multiplicity[row] - mult`` and every later row by its full
multiplicity; afterwards the watermark points at the last existing row
with its current multiplicity (never past it), so growth of that row is
picked up by the next update.  Appends only ever extend the buffer or
bump the last row, so deltas never overlap and their summaries partition
the logical event stream exactly — which is what makes
``merge(shards) == batch`` hold bit-for-bit.

Summaries hold NumPy arrays only, never device tensors: the backends
return NumPy, so a shard pickles across processes whatever backend reduced
it.  The sweep aggregator that ships shards between processes is not
ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Union

import numpy as np

from repro_torch.core.backend import ReduceBackend, resolve_backend
from repro_torch.core.profiler import CommProfile, RegionStats
from repro_torch.core.regions import RegionRecorder, TraceBuffer

#: Peer-set codes pack ``(rank << PEER_SHIFT) | peer`` into one int64, a
#: *fixed* encoding (unlike the data-dependent strides of the dedup
#: kernels) so code sets from different shards/deltas union directly.
PEER_SHIFT = 32
_PEER_MASK = (1 << PEER_SHIFT) - 1
#: Largest rank/peer id the fixed encoding can carry.
MAX_RANK = (1 << 31) - 1

_I64 = np.int64


def _pad_to(vec: np.ndarray, n: int) -> np.ndarray:
    if len(vec) >= n:
        return vec
    out = np.zeros(n, vec.dtype)
    out[: len(vec)] = vec
    return out


@dataclass(eq=False)
class RegionSummary:
    """Mergeable per-region summary (the pre-min/max form of RegionStats).

    All vectors are dense over ranks ``[0, n)``; ``dest_codes`` /
    ``src_codes`` are the distinct destination/source peer sets as sorted
    unique ``(rank << PEER_SHIFT) | peer`` int64 codes.  ``first_row`` is
    the smallest TraceBuffer row index that contributed (merge takes the
    min), used only to reproduce the batch profiler's first-appearance
    region ordering at finalize time.
    """

    n: int
    first_row: int
    sends: np.ndarray
    recvs: np.ndarray
    bsent: np.ndarray
    brecv: np.ndarray
    cbytes: np.ndarray
    part: np.ndarray  # bool: ranks participating in any p2p event
    cpart: np.ndarray  # bool: ranks participating in any collective
    dest_codes: np.ndarray
    src_codes: np.ndarray
    coll: int = 0
    largest: int = 0
    kinds: dict = field(default_factory=dict)

    @staticmethod
    def empty() -> "RegionSummary":
        z = np.zeros(0, _I64)
        return RegionSummary(
            n=0,
            first_row=np.iinfo(np.int64).max,
            sends=z,
            recvs=z.copy(),
            bsent=z.copy(),
            brecv=z.copy(),
            cbytes=z.copy(),
            part=np.zeros(0, bool),
            cpart=np.zeros(0, bool),
            dest_codes=z.copy(),
            src_codes=z.copy(),
        )

    def merge(self, other: "RegionSummary") -> "RegionSummary":
        """Combine two summaries of disjoint event sets (new object).

        Associative and commutative: every field is an elementwise sum,
        OR, set union, min, or max.
        """
        n = max(self.n, other.n)
        kinds = dict(self.kinds)
        for k, v in other.kinds.items():
            kinds[k] = kinds.get(k, 0) + v
        return RegionSummary(
            n=n,
            first_row=min(self.first_row, other.first_row),
            sends=_pad_to(self.sends, n) + _pad_to(other.sends, n),
            recvs=_pad_to(self.recvs, n) + _pad_to(other.recvs, n),
            bsent=_pad_to(self.bsent, n) + _pad_to(other.bsent, n),
            brecv=_pad_to(self.brecv, n) + _pad_to(other.brecv, n),
            cbytes=_pad_to(self.cbytes, n) + _pad_to(other.cbytes, n),
            part=_pad_to(self.part, n) | _pad_to(other.part, n),
            cpart=_pad_to(self.cpart, n) | _pad_to(other.cpart, n),
            dest_codes=np.union1d(self.dest_codes, other.dest_codes),
            src_codes=np.union1d(self.src_codes, other.src_codes),
            coll=self.coll + other.coll,
            largest=max(self.largest, other.largest),
            kinds=kinds,
        )

    def stats(
        self, region: str, *, instances: int, n_ranks: int, replication: int
    ) -> RegionStats:
        """Collapse into the batch profiler's RegionStats (Table I form)."""

        def mm(vec: np.ndarray, mask: np.ndarray) -> tuple:
            if self.n == 0 or not mask.any():
                return (0, 0)
            live = vec[mask]
            return (int(live.min()), int(live.max()))

        def distinct(codes: np.ndarray) -> np.ndarray:
            counts = np.zeros(self.n, _I64)
            if len(codes):
                ranks = (codes >> PEER_SHIFT).astype(_I64)
                counts = np.bincount(ranks, minlength=self.n).astype(_I64)
            return counts

        return RegionStats(
            region=region,
            instances=instances,
            sends=mm(self.sends, self.part),
            recvs=mm(self.recvs, self.part),
            dest_ranks=mm(distinct(self.dest_codes), self.part),
            src_ranks=mm(distinct(self.src_codes), self.part),
            bytes_sent=mm(self.bsent, self.part),
            bytes_recv=mm(self.brecv, self.part),
            coll=self.coll,
            coll_bytes=mm(self.cbytes, self.cpart),
            total_bytes_sent=int(self.bsent.sum()) * replication,
            total_sends=int(self.sends.sum()) * replication,
            largest_send=self.largest,
            n_ranks=n_ranks,
            kinds=dict(self.kinds),
        )


@dataclass(eq=False)
class ProfileSummary:
    """Mergeable whole-profile summary: one shard of a profile.

    ``regions`` maps region name to :class:`RegionSummary`;
    ``instances`` carries region *entry-count deltas* (how many times
    each region was entered within this shard's span — sums on merge; a
    region present in events but never entered falls back to the batch
    profiler's default of 1 at finalize).  ``n_events`` is the number of
    logical events covered (the merge-level ingest watermark).
    """

    regions: dict = field(default_factory=dict)
    instances: dict = field(default_factory=dict)
    n_events: int = 0

    @staticmethod
    def empty() -> "ProfileSummary":
        return ProfileSummary()

    def merge(self, other: "ProfileSummary") -> "ProfileSummary":
        """Associative, commutative shard combine (new object)."""
        regions = dict(self.regions)
        for name, rs in other.regions.items():
            mine = regions.get(name)
            regions[name] = rs if mine is None else mine.merge(rs)
        instances = dict(self.instances)
        for name, cnt in other.instances.items():
            instances[name] = instances.get(name, 0) + cnt
        return ProfileSummary(
            regions=regions,
            instances=instances,
            n_events=self.n_events + other.n_events,
        )

    def finalize(
        self,
        *,
        name: str = "profile",
        replication: int = 1,
        meta: Optional[dict] = None,
    ) -> CommProfile:
        """Collapse into a CommProfile.

        Byte-identical (``to_json()``) to
        ``CommPatternProfiler.from_recorder`` over the same events:
        every statistic is an exact int64 sum/min/max/union, so any
        partition of the event stream into shards reduces to the same
        values.  Event regions come out in first-appearance order
        (``first_row``); entered-but-quiet regions follow.
        """
        extent = 0
        for rs in self.regions.values():
            both = _pad_to(rs.part, rs.n) | _pad_to(rs.cpart, rs.n)
            idx = np.flatnonzero(both)
            if len(idx):
                extent = max(extent, int(idx[-1]) + 1)
        n_ranks = extent * replication
        prof = CommProfile(name=name, n_ranks=n_ranks, meta=dict(meta or {}))
        ordered = sorted(self.regions.items(), key=lambda kv: kv[1].first_row)
        for rname, rs in ordered:
            prof.regions[rname] = rs.stats(
                rname,
                instances=self.instances.get(rname, 1),
                n_ranks=n_ranks,
                replication=replication,
            )
        for rname, cnt in self.instances.items():
            if rname not in self.regions:
                prof.regions[rname] = RegionStats(
                    region=rname, instances=cnt, n_ranks=n_ranks
                )
        return prof


def merge_tree(summaries: Iterable[ProfileSummary]) -> ProfileSummary:
    """Reduce shards in a balanced pairwise aggregation tree.

    ``merge`` is associative and commutative, so the tree shape is purely
    an efficiency choice (O(log n) depth keeps intermediate code-set
    unions small); any shape yields the identical summary.
    """
    items = list(summaries)
    if not items:
        return ProfileSummary.empty()
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(items[i].merge(items[i + 1]))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


# ---------------------------------------------------------------------------
# Delta reduction: TraceBuffer rows [lo, hi) -> {region: RegionSummary}
# ---------------------------------------------------------------------------


def _summarize_rows(
    buf: TraceBuffer, lo: int, lo_mult: int, hi: int, be: ReduceBackend
) -> tuple:
    """Reduce buffer rows ``[lo, hi)`` into mergeable region summaries.

    Row ``lo``'s multiplicity is reduced by ``lo_mult`` (the part an
    earlier update already consumed — see the watermark semantics in the
    module docstring).  The reduction mirrors the batch profiler's
    multiplicity-weighted path — (region x struct) int64 weight matrices
    against the struct table's dense slabs via ``backend.matmul``, peer
    sets deduped by ``backend.pair_codes`` — but restricted to the
    structs the delta rows actually reference, so an update costs
    O(delta rows + delta structs x extent), not O(whole buffer).
    Returns ``(regions, n_events)``.
    """
    rows = np.arange(lo, hi, dtype=_I64)
    w = buf.multiplicity[lo:hi].astype(_I64, copy=True)
    if len(w):
        w[0] -= lo_mult
    keep = w > 0
    rows, w = rows[keep], w[keep]
    n_events = int(w.sum())
    R = len(rows)
    if R == 0:
        return {}, 0

    rids = buf.region_ids[rows]
    uniq, first = np.unique(rids, return_index=True)
    perm = np.argsort(first, kind="stable")
    ordered = uniq[perm]
    first_abs = rows[first][perm]  # rows ascending -> min row per region
    G = len(ordered)
    region_names = [buf.region_names[int(r)] for r in ordered]
    gid_of_rid = np.zeros(max(len(buf.region_names), 1), _I64)
    gid_of_rid[ordered] = np.arange(G)
    g_of_row = gid_of_rid[rids]

    tab = buf.structs
    # One materialized view per delta: lazy tables build (and cache) their
    # flat slabs here; eager tables alias live columns for free.
    view = tab.reduction_view()
    sid = buf.struct_ids[rows]
    scale = buf.nbytes[rows]
    is_coll = buf.is_collective[rows].astype(bool)
    p2p = ~is_coll

    # Only the structs this delta references are laid out / multiplied.
    sub, sid_pos = np.unique(sid, return_inverse=True)
    sid_pos = sid_pos.reshape(-1).astype(_I64)
    S = len(sub)
    lens = view.rank_lens[sub]
    indptr = view.rank_indptr()
    Rmax = int(lens.max()) if S else 0
    if Rmax > MAX_RANK:
        raise ValueError(
            f"rank extent {Rmax} exceeds the mergeable peer-code encoding "
            f"(max {MAX_RANK})"
        )

    sends_g = np.zeros((G, Rmax), _I64)
    recvs_g = np.zeros((G, Rmax), _I64)
    bsent_g = np.zeros((G, Rmax), _I64)
    brecv_g = np.zeros((G, Rmax), _I64)
    cbytes_g = np.zeros((G, Rmax), _I64)
    part_g = np.zeros((G, Rmax), bool)
    cpart_g = np.zeros((G, Rmax), bool)
    if Rmax:
        m = int(lens.sum())
        offs = np.zeros(S, _I64)
        np.cumsum(lens[:-1], out=offs[1:])
        within = np.arange(m) - np.repeat(offs, lens)
        src_idx = np.repeat(indptr[sub], lens) + within
        flat_pos = np.repeat(np.arange(S), lens) * Rmax + within

        def layout(col: np.ndarray) -> np.ndarray:
            grid = np.zeros((S, Rmax), col.dtype)
            grid.reshape(-1)[flat_pos] = col[src_idx]
            return grid

        part_i = layout(view.participants).astype(_I64)
        wc = np.zeros((G, S), _I64)
        wb = np.zeros((G, S), _I64)
        wcm = np.zeros((G, S), _I64)
        wcb = np.zeros((G, S), _I64)
        np.add.at(wc, (g_of_row[p2p], sid_pos[p2p]), w[p2p])
        np.add.at(wb, (g_of_row[p2p], sid_pos[p2p]), w[p2p] * scale[p2p])
        np.add.at(wcm, (g_of_row[is_coll], sid_pos[is_coll]), w[is_coll])
        np.add.at(
            wcb, (g_of_row[is_coll], sid_pos[is_coll]), w[is_coll] * scale[is_coll]
        )
        sends_g = be.matmul(wc, layout(view.sends))
        recvs_g = be.matmul(wc, layout(view.recvs))
        bsent_g = be.matmul(wb, layout(view.bsent_units))
        brecv_g = be.matmul(wb, layout(view.brecv_units))
        cbytes_g = be.matmul(wcb, layout(view.bsent_units))
        part_g = be.matmul((wc > 0).astype(_I64), part_i) > 0
        cpart_g = be.matmul((wcm > 0).astype(_I64), part_i) > 0

    # Distinct peer sets over unique (region, struct) combos, carried as
    # sorted unique (rank << PEER_SHIFT) | peer codes per region.
    if S:
        combos = np.unique(g_of_row[p2p] * S + sid_pos[p2p])
        gu, su = combos // S, sub[combos % S]
    else:
        gu = su = np.zeros(0, _I64)

    def peer_codes(
        rows_col: np.ndarray,
        peers_col: np.ndarray,
        lens_col: np.ndarray,
        tab_indptr: np.ndarray,
    ) -> tuple:
        if Rmax == 0 or not len(gu):
            return np.zeros(G + 1, _I64), np.zeros(0, _I64)
        ln = lens_col[su]
        mm = int(ln.sum())
        if mm == 0:
            return np.zeros(G + 1, _I64), np.zeros(0, _I64)
        offs2 = np.zeros(len(su), _I64)
        np.cumsum(ln[:-1], out=offs2[1:])
        within2 = np.arange(mm) - np.repeat(offs2, ln)
        gather = np.repeat(tab_indptr[su], ln) + within2
        gp = np.repeat(gu, ln)  # non-decreasing: gu is sorted by group
        return be.pair_codes(gp, rows_col[gather], peers_col[gather], G)

    dptr, dcodes = peer_codes(
        view.dest_rows, view.dest_peers, view.dest_lens, view.dest_indptr()
    )
    sptr, scodes = peer_codes(
        view.src_rows, view.src_peers, view.src_lens, view.src_indptr()
    )

    coll_counts = np.zeros(G, _I64)
    largest_r = np.zeros(G, _I64)
    np.add.at(coll_counts, g_of_row[is_coll], w[is_coll])
    np.maximum.at(largest_r, g_of_row[p2p], buf.largest[rows][p2p])
    K = len(buf.kind_names)
    kind_counts = np.zeros((G, K), _I64)
    if K:
        np.add.at(kind_counts, (g_of_row, buf.kind_ids[rows]), w)

    regions: dict = {}
    for g, rname in enumerate(region_names):
        kinds = {
            buf.kind_names[int(k)]: int(kind_counts[g, k])
            for k in np.flatnonzero(kind_counts[g])
        }
        regions[rname] = RegionSummary(
            n=Rmax,
            first_row=int(first_abs[g]),
            sends=sends_g[g].copy(),
            recvs=recvs_g[g].copy(),
            bsent=bsent_g[g].copy(),
            brecv=brecv_g[g].copy(),
            cbytes=cbytes_g[g].copy(),
            part=part_g[g].copy(),
            cpart=cpart_g[g].copy(),
            dest_codes=dcodes[dptr[g] : dptr[g + 1]].copy(),
            src_codes=scodes[sptr[g] : sptr[g + 1]].copy(),
            coll=int(coll_counts[g]),
            largest=int(largest_r[g]),
            kinds=kinds,
        )
    return regions, n_events


# ---------------------------------------------------------------------------
# Incremental profiler
# ---------------------------------------------------------------------------


class StreamingProfiler:
    """Incremental mode of ``CommPatternProfiler`` (watermark + deltas).

    Construct via :meth:`CommPatternProfiler.incremental
    <repro_torch.core.profiler.CommPatternProfiler.incremental>`; each
    :meth:`update` reduces only the TraceBuffer rows recorded since the
    watermark, returns the delta as a mergeable :class:`ProfileSummary`
    shard, and folds it into :attr:`summary`.  :meth:`profile` collapses
    the running summary into a CommProfile byte-identical to the batch
    reduction over the same events.
    """

    def __init__(
        self,
        rec: RegionRecorder,
        *,
        backend: Union[ReduceBackend, str, None] = None,
    ):
        self._rec = rec
        self._be = resolve_backend(backend)
        self._wrow = 0
        self._wmult = 0
        self._inst_seen: dict = {}
        self._summary = ProfileSummary.empty()

    @property
    def watermark(self) -> tuple:
        """``(row, multiplicity)`` consumed so far (module docstring)."""
        return (self._wrow, self._wmult)

    @property
    def summary(self) -> ProfileSummary:
        """The running merged summary (all deltas folded in)."""
        return self._summary

    def update(self, up_to_row: Optional[int] = None) -> ProfileSummary:
        """Consume new rows up to ``up_to_row`` (default: all recorded).

        Returns the **delta** summary — the mergeable shard covering
        exactly the newly consumed events (empty summary when nothing new
        was recorded).  Instance-count deltas ride on the shard that
        first observes them.
        """
        buf = self._rec.buffer
        n_rows = buf.n_rows
        hi = n_rows if up_to_row is None else min(max(int(up_to_row), 0), n_rows)
        lo, lom = self._wrow, self._wmult
        if hi < lo:
            hi = lo
        inst_delta: dict = {}
        for rname, cnt in self._rec.instances.items():
            seen = self._inst_seen.get(rname, 0)
            if cnt > seen:
                inst_delta[rname] = cnt - seen
                self._inst_seen[rname] = cnt
        regions, n_events = _summarize_rows(buf, lo, lom, hi, self._be)
        delta = ProfileSummary(
            regions=regions, instances=inst_delta, n_events=n_events
        )
        if hi >= n_rows and n_rows > 0:
            # the last row may still collapse further events into itself:
            # keep pointing at it with its current multiplicity
            self._wrow = n_rows - 1
            self._wmult = int(buf.multiplicity[n_rows - 1])
        elif hi > lo:
            self._wrow, self._wmult = hi, 0
        # hi == lo: nothing consumed beyond what (lo, lom) already tracks —
        # the watermark never rewinds, even for stale up_to_row cursors
        self._summary = self._summary.merge(delta)
        return delta

    def profile(
        self,
        *,
        name: str = "profile",
        replication: int = 1,
        meta: Optional[dict] = None,
        update: bool = True,
    ) -> CommProfile:
        """Finalize the running summary into a CommProfile.

        ``update=True`` (default) first consumes any rows recorded since
        the last :meth:`update`, so the profile covers the whole trace.
        """
        if update:
            self.update()
        return self._summary.finalize(
            name=name, replication=replication, meta=meta
        )
