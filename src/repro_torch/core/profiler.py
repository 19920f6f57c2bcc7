"""Communication-pattern profiler (paper §III, Table I).

The paper's profiler is invoked at the end of each marked communication
region and computes message / rank / data-volume statistics for the MPI
operations that occurred within the region boundaries.  This module is the
PyTorch analog: it reduces the columnar :class:`~repro_torch.core.regions.TraceBuffer`
produced by the instrumented collectives into per-region
:class:`RegionStats`.

Table I schema (all reproduced here):

  Sends        Min/Max number of messages sent
  Recvs        Min/Max number of messages received
  Dest ranks   Min/Max number of distinct destination ranks
  Src ranks    Min/Max number of distinct source ranks
  Bytes sent   Min/Max bytes sent by a process in the region
  Bytes recv   Min/Max bytes received by a process in the region
  Coll         Max collective calls in the region

Extensions over the paper:
  coll_bytes   total collective bytes moved per rank (min/max) — on
               accelerator meshes much traffic is collectives, so pattern
               analysis needs it;
  totals      totals across ranks (paper Table IV columns).

Both profilers in this module run on the same grouped segment-reduction
kernels (``segment_spans`` / ``block_reduce`` / ``segment_reduce``):
:class:`CommPatternProfiler` reduces the traced-layer ``TraceBuffer``
through its ``structs.reduction_view()`` — one flat eager layout whether
the struct table stores materialized slabs or lazy ``(generator,
extent)`` fingerprints (the default; slabs expand once per reduction and
cache per append version, see :mod:`repro_torch.core.regions`) — and
:class:`HloCollectiveProfiler` reduces the compiled-layer
``repro_torch.core.hlo.HloCollectiveBuffer`` into per-region ``layer="hlo"``
rows for ``thicket.Frame`` — one ordering pass, one block reduction per
statistic, no per-event/per-op Python in either.

Backend contract (see :mod:`repro_torch.core.backend`): the kernels live in
a swappable reduction backend selected by ``backend=`` / ``REPRO_BACKEND``
(``"numpy"`` reference, or ``"torch"`` — the default, on the CUDA card,
with the hand-written segmented-reduce kernel behind ``segment_reduce``).
Boundaries are NumPy arrays in both directions; every int64
count/byte path is **exact**, so profiles are bit-identical across backends.
Host NumPy keeps the O(rows) scatters/orderings; the backend owns the
O(G x S x Rmax) weight-grid matmuls and the peer-set dedup that dominate at
high rank counts.

Live monitoring (see :mod:`repro_torch.core.streaming`): batch
``from_recorder`` has an incremental twin — :meth:`CommPatternProfiler.incremental`
returns a ``StreamingProfiler`` holding a ``(row, multiplicity)``
watermark into the recorder's TraceBuffer; each ``update()`` re-reduces
only the rows recorded since the watermark (through the same backend
kernels) and yields the delta as an associative/commutative mergeable
``ProfileSummary`` shard, which merges in any order into a profile
byte-identical to the batch reduction.  :func:`trace_observer` installs a
thread-local hook that lets a harness intercept :func:`profile_traced`'s
recorder (e.g. to reduce one trace with two backends and time each, or to
profile it incrementally) without any app-code change.
"""

from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.backend import (  # noqa: F401  (re-exported kernel API)
    ReduceBackend,
    block_reduce,
    resolve_backend,
    segment_reduce,
    segment_spans,
)
from repro_torch.core.regions import RegionRecorder, TraceBuffer, recording


@dataclass
class RegionStats:
    """Per-region communication statistics (Table I + extensions)."""

    region: str
    instances: int = 0
    # Table I attributes: (min, max) across ranks.
    sends: tuple = (0, 0)
    recvs: tuple = (0, 0)
    dest_ranks: tuple = (0, 0)
    src_ranks: tuple = (0, 0)
    bytes_sent: tuple = (0, 0)
    bytes_recv: tuple = (0, 0)
    coll: int = 0  # max collective calls in the region
    # Extensions.
    coll_bytes: tuple = (0, 0)  # (min, max) collective bytes per rank
    total_bytes_sent: int = 0  # across all ranks (Table IV col 1)
    total_sends: int = 0  # across all ranks (Table IV col 2)
    largest_send: int = 0  # largest single message (Table IV col 3)
    n_ranks: int = 0
    kinds: dict = field(default_factory=dict)  # kind -> call count

    @property
    def avg_send_size(self) -> float:
        """Average send size in bytes (Table IV col 4)."""
        return self.total_bytes_sent / self.total_sends if self.total_sends else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d["avg_send_size"] = self.avg_send_size
        return d


@dataclass
class CommProfile:
    """A full profile: one program/step, many regions (a .cali-file analog)."""

    name: str
    n_ranks: int
    regions: dict = field(default_factory=dict)  # region -> RegionStats
    meta: dict = field(default_factory=dict)  # free-form (config, mesh, ...)

    def region(self, name: str) -> RegionStats:
        return self.regions[name]

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "n_ranks": self.n_ranks,
                "meta": self.meta,
                "regions": {k: v.to_dict() for k, v in self.regions.items()},
            },
            indent=2,
            sort_keys=True,
        )

    @staticmethod
    def from_json(text: str) -> "CommProfile":
        raw = json.loads(text)
        prof = CommProfile(
            name=raw["name"], n_ranks=raw["n_ranks"], meta=raw.get("meta", {})
        )
        for rname, rd in raw["regions"].items():
            rd = dict(rd)
            rd.pop("avg_send_size", None)
            for k in (
                "sends",
                "recvs",
                "dest_ranks",
                "src_ranks",
                "bytes_sent",
                "bytes_recv",
                "coll_bytes",
            ):
                rd[k] = tuple(rd[k])
            prof.regions[rname] = RegionStats(**rd)
        return prof

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path) -> "CommProfile":
        with open(path) as f:
            return CommProfile.from_json(f.read())


_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min


# Grouped segment-reduction kernels (``segment_spans`` / ``block_reduce`` /
# ``segment_reduce``) live in :mod:`repro_torch.core.backend` and are re-exported
# above: both profilers order events/ops by a composite group code once,
# then run ONE backend reduction per statistic across all groups at once.


class CommPatternProfiler:
    """Reduces a RegionRecorder's columnar trace into RegionStats.

    Events live in the recorder's structure-interned
    :class:`~repro_torch.core.regions.TraceBuffer`: scalar rows ``(region, path,
    kind, axis, struct_id, nbytes, multiplicity)`` referencing unique
    communication structures in a :class:`~repro_torch.core.regions.StructTable`
    (dense per-rank count/byte-unit slabs plus CSR peer-set pair columns —
    see the data-model section of :mod:`repro_torch.core.regions`).  Two
    implementations with bit-identical output:

    * ``impl="numpy"`` (default) — the hot path.  Multiplicity-weighted
      reductions over ``(struct_id, weight)``: rows accumulate into
      (region x struct) weight matrices — event counts scale by
      ``multiplicity``, bytes by ``multiplicity * nbytes`` — and every
      per-rank grid is one exact int64 matmul of a weight matrix against
      the struct table's dense slabs, laid out once as (struct x
      max-extent) grids.  Distinct source/destination ranks deduplicate
      over *unique* (region, struct) combinations only (multiplicity
      cannot change a set union), via one bitmap scatter / ``np.unique``
      over encoded (region, rank, peer) codes; per-rank min/max are masked
      axis reductions.  There is no per-event or per-rank Python anywhere —
      cost is O(unique structs x max extent + rows) vector work regardless
      of the logical event count.
    * ``impl="reference"`` — the original dict-of-dicts accounting, kept
      as the executable specification; it consumes multiplicity-expanded
      RegionEvent views through ``RegionEvent.to_dicts()``.  The parity
      tests in ``tests/test_profiler_parity.py`` assert equality on
      randomized event streams and on the real kripke/amg/laghos profile
      paths, with interning on and off.

    The vectorized path's heavy kernels — the (G x S) weight matmuls
    against the (S x Rmax) slabs and the peer-set dedup — dispatch through
    a :class:`~repro_torch.core.backend.ReduceBackend` (``backend=`` parameter,
    default from ``REPRO_BACKEND``; NumPy arrays at every boundary, int64
    paths exact, so profiles are bit-identical across backends).
    """

    @staticmethod
    def incremental(
        rec: RegionRecorder,
        *,
        backend: Union[ReduceBackend, str, None] = None,
    ):
        """Incremental mode: a ``StreamingProfiler`` over ``rec``.

        Holds a ``(row, multiplicity)`` watermark into the recorder's
        TraceBuffer; each ``update()`` reduces only the newly recorded
        rows (same backend kernels as the batch path; the default backend
        is torch on the CUDA card) and returns the delta as a mergeable
        ``ProfileSummary`` shard.  ``profile()`` collapses the running
        summary into a CommProfile byte-identical to :meth:`from_recorder`
        over the same events.  See :mod:`repro_torch.core.streaming` for
        the merge contract.
        """
        from repro_torch.core.streaming import StreamingProfiler

        return StreamingProfiler(rec, backend=backend)

    @staticmethod
    def from_recorder(
        rec: RegionRecorder,
        *,
        name: str = "profile",
        replication: int = 1,
        meta: Optional[dict] = None,
        impl: str = "numpy",
        backend: Union[ReduceBackend, str, None] = None,
    ) -> CommProfile:
        """Build a CommProfile.

        ``replication``: number of identical communicator groups the axis
        pattern repeats over (e.g. a ppermute over a 16-wide axis of a
        16x16 mesh repeats over 16 groups).  Totals scale by it; min/max
        per-rank stats do not.

        ``backend``: reduction backend name/instance for the vectorized
        implementation (see :func:`repro_torch.core.backend.resolve_backend`);
        ``impl="reference"`` is pure-Python and ignores it.
        """
        if impl == "numpy":
            return CommPatternProfiler._from_recorder_numpy(
                rec, name=name, replication=replication, meta=meta, backend=backend
            )
        elif impl == "reference":
            return CommPatternProfiler._from_recorder_reference(
                rec, name=name, replication=replication, meta=meta
            )
        raise ValueError(f"unknown profiler impl: {impl!r}")

    # -- segment-reduced implementation (default) ---------------------------

    @staticmethod
    def _from_recorder_numpy(
        rec: RegionRecorder,
        *,
        name: str,
        replication: int,
        meta: Optional[dict],
        backend: Union[ReduceBackend, str, None] = None,
    ) -> CommProfile:
        be = resolve_backend(backend)
        buf = getattr(rec, "buffer", None)
        if buf is None:  # duck-typed recorder carrying a plain event list
            buf = TraceBuffer()
            for ev in rec.events:
                buf.append_event(ev)

        R = buf.n_rows
        rids = buf.region_ids
        # Output region order matches the reference: first-event appearance
        # (multiplicity collapse preserves first-row order), then regions
        # that were entered but recorded no communication (pure-compute
        # phases like Kripke's "solve" still get a row — the paper's Fig. 1
        # compares compute vs communication regions).
        if R:
            uniq, first = np.unique(rids, return_index=True)
            ordered = uniq[np.argsort(first, kind="stable")]
        else:
            ordered = np.zeros(0, np.int64)
        G = len(ordered)
        region_names = [buf.region_names[int(r)] for r in ordered]
        seen = set(region_names)
        extra = [r for r in rec.instances if r not in seen]

        gid_of_rid = np.zeros(max(len(buf.region_names), 1), np.int64)
        gid_of_rid[ordered] = np.arange(G)
        g_of_row = gid_of_rid[rids]

        tab = buf.structs
        S = tab.n_structs
        # One materialized view per profile call: lazy (generator-payload)
        # tables build their flat slabs here and cache them on the table
        # until the next append; eager tables alias live columns for free.
        view = tab.reduction_view()
        lens = view.rank_lens
        indptr = view.rank_indptr()
        Rmax = int(lens.max()) if S else 0
        sid = buf.struct_ids
        mult = buf.multiplicity
        scale = buf.nbytes
        is_coll = buf.is_collective.astype(bool)
        p2p = ~is_coll

        # Per-region per-rank grids, (G, Rmax), via multiplicity-weighted
        # reductions over the unique structures: rows accumulate into
        # (G, S) weight matrices (counts weighted by multiplicity, bytes
        # by multiplicity * nbytes), and each grid is one exact int64
        # matmul of a weight matrix against the struct table's dense
        # slabs laid out once as (S, Rmax) matrices.
        sends_g = np.zeros((G, Rmax), np.int64)
        recvs_g = np.zeros((G, Rmax), np.int64)
        bsent_g = np.zeros((G, Rmax), np.int64)
        brecv_g = np.zeros((G, Rmax), np.int64)
        cbytes_g = np.zeros((G, Rmax), np.int64)
        part_g = np.zeros((G, Rmax), bool)
        cpart_g = np.zeros((G, Rmax), bool)
        if R and Rmax:
            # Uniform struct tables (every structure spans the same rank
            # extent — the shape every real app trace has) lay out by pure
            # reshape; ragged tables scatter into a rectangular grid via
            # one precomputed (source, destination) index pair.
            uniform = int(lens.min()) == Rmax
            if not uniform:
                m = int(lens.sum())
                srows = np.repeat(np.arange(S), lens)
                offs = np.zeros(S, np.int64)
                np.cumsum(lens[:-1], out=offs[1:])
                within = np.arange(m) - np.repeat(offs, lens)
                src_idx = np.repeat(indptr[:-1], lens) + within
                flat_pos = srows * Rmax + within

            def layout(col: np.ndarray) -> np.ndarray:
                if uniform:
                    return col.reshape(S, Rmax)
                grid = np.zeros((S, Rmax), col.dtype)
                grid.reshape(-1)[flat_pos] = col[src_idx]
                return grid

            part_i = layout(view.participants).astype(np.int64)
            wc = np.zeros((G, S), np.int64)
            wb = np.zeros((G, S), np.int64)
            wcm = np.zeros((G, S), np.int64)
            wcb = np.zeros((G, S), np.int64)
            np.add.at(wc, (g_of_row[p2p], sid[p2p]), mult[p2p])
            np.add.at(wb, (g_of_row[p2p], sid[p2p]), mult[p2p] * scale[p2p])
            np.add.at(wcm, (g_of_row[is_coll], sid[is_coll]), mult[is_coll])
            np.add.at(
                wcb, (g_of_row[is_coll], sid[is_coll]), mult[is_coll] * scale[is_coll]
            )

            sends_g = be.matmul(wc, layout(view.sends))
            recvs_g = be.matmul(wc, layout(view.recvs))
            bsent_g = be.matmul(wb, layout(view.bsent_units))
            brecv_g = be.matmul(wb, layout(view.brecv_units))
            cbytes_g = be.matmul(wcb, layout(view.bsent_units))
            part_g = be.matmul((wc > 0).astype(np.int64), part_i) > 0
            cpart_g = be.matmul((wcm > 0).astype(np.int64), part_i) > 0

        # Unique (region, struct) combinations of point-to-point rows —
        # shared by both peer-set sides (repetition cannot change a union).
        if R and S:
            combos = np.unique(g_of_row[p2p] * S + sid[p2p])
            gu, su = combos // S, combos % S
        else:
            gu = su = np.zeros(0, np.int64)

        def distinct_grid(
            rows_col: np.ndarray,
            peers_col: np.ndarray,
            lens_col: np.ndarray,
            tab_indptr: np.ndarray,
        ) -> np.ndarray:
            """|union of peer sets| per (region, rank), deduplicated.

            Only the unique (region, struct) combinations contribute.
            Host code gathers the (group, rank, peer) pair columns; the
            backend's ``pair_counts`` collapses cross-struct duplicates
            (dense bitmap scatter, group-chunked scatter at high rank
            counts, or a sort over the encoded codes — see
            :func:`repro_torch.core.backend._dedup_strategy`).
            """
            if not R or Rmax == 0 or not len(rows_col):
                return np.zeros((G, Rmax), np.int64)
            ln = lens_col[su]
            m = int(ln.sum())
            if m == 0:
                return np.zeros((G, Rmax), np.int64)
            offs = np.zeros(len(su), np.int64)
            np.cumsum(ln[:-1], out=offs[1:])
            within = np.arange(m) - np.repeat(offs, ln)
            src_idx = np.repeat(tab_indptr[su], ln) + within
            rows = rows_col[src_idx]
            peers = peers_col[src_idx]
            gp = np.repeat(gu, ln)  # non-decreasing: gu is sorted by group
            return be.pair_counts(gp, rows, peers, G, Rmax)

        dests_g = distinct_grid(
            view.dest_rows, view.dest_peers, view.dest_lens, view.dest_indptr()
        )
        srcs_g = distinct_grid(
            view.src_rows, view.src_peers, view.src_lens, view.src_indptr()
        )

        # Per-row scalar columns reduce to per-region scalars directly
        # (counts weighted by multiplicity; largest is a max, unweighted).
        coll_counts = np.zeros(G, np.int64)
        largest_r = np.zeros(G, np.int64)
        if R:
            np.add.at(coll_counts, g_of_row[is_coll], mult[is_coll])
            np.maximum.at(largest_r, g_of_row[p2p], buf.largest[p2p])
        K = len(buf.kind_names)
        kind_counts = np.zeros((G, K), np.int64)
        if R and K:
            np.add.at(kind_counts, (g_of_row, buf.kind_ids), mult)

        def mm(grid: np.ndarray, mask: np.ndarray) -> tuple:
            """(min, max) per region over the participant-masked rank axis."""
            if G == 0 or Rmax == 0:
                zero = np.zeros(G, np.int64)
                return zero, zero
            any_ = mask.any(axis=1)
            lo = np.where(mask, grid, _I64_MAX).min(axis=1)
            hi = np.where(mask, grid, _I64_MIN).max(axis=1)
            return np.where(any_, lo, 0), np.where(any_, hi, 0)

        sends_mm = mm(sends_g, part_g)
        recvs_mm = mm(recvs_g, part_g)
        dests_mm = mm(dests_g, part_g)
        srcs_mm = mm(srcs_g, part_g)
        bsent_mm = mm(bsent_g, part_g)
        brecv_mm = mm(brecv_g, part_g)
        cbytes_mm = mm(cbytes_g, cpart_g)
        tot_bsent = bsent_g.sum(axis=1)
        tot_sends = sends_g.sum(axis=1)

        cols_any = (part_g | cpart_g).any(axis=0)
        n_ranks = int(np.flatnonzero(cols_any)[-1]) + 1 if cols_any.any() else 0

        prof = CommProfile(name=name, n_ranks=n_ranks * replication, meta=meta or {})
        for g, region in enumerate(region_names):
            kinds = {
                buf.kind_names[int(k)]: int(kind_counts[g, k])
                for k in np.flatnonzero(kind_counts[g])
            }
            prof.regions[region] = RegionStats(
                region=region,
                instances=rec.instances.get(region, 1),
                sends=(int(sends_mm[0][g]), int(sends_mm[1][g])),
                recvs=(int(recvs_mm[0][g]), int(recvs_mm[1][g])),
                dest_ranks=(int(dests_mm[0][g]), int(dests_mm[1][g])),
                src_ranks=(int(srcs_mm[0][g]), int(srcs_mm[1][g])),
                bytes_sent=(int(bsent_mm[0][g]), int(bsent_mm[1][g])),
                bytes_recv=(int(brecv_mm[0][g]), int(brecv_mm[1][g])),
                coll=int(coll_counts[g]),
                coll_bytes=(int(cbytes_mm[0][g]), int(cbytes_mm[1][g])),
                total_bytes_sent=int(tot_bsent[g]) * replication,
                total_sends=int(tot_sends[g]) * replication,
                largest_send=int(largest_r[g]),
                n_ranks=n_ranks * replication,
                kinds=kinds,
            )
        for region in extra:
            prof.regions[region] = RegionStats(
                region=region,
                instances=rec.instances.get(region, 1),
                n_ranks=n_ranks * replication,
            )
        return prof

    # -- reference implementation (executable spec, parity-tested) ----------

    @staticmethod
    def _from_recorder_reference(
        rec: RegionRecorder, *, name: str, replication: int, meta: Optional[dict]
    ) -> CommProfile:
        per_region: dict[str, dict] = {}

        def acc(region: str) -> dict:
            if region not in per_region:
                per_region[region] = dict(
                    sends={},
                    recvs={},
                    dests={},
                    srcs={},
                    bsent={},
                    brecv={},
                    cbytes={},
                    coll=0,
                    largest=0,
                    kinds={},
                )
            return per_region[region]

        for ev in rec.events:
            a = acc(ev.region)
            a["kinds"][ev.kind] = a["kinds"].get(ev.kind, 0) + 1
            d = ev.to_dicts()
            if ev.is_collective:
                a["coll"] += 1
                for r, b in d["bytes_sent"].items():
                    a["cbytes"][r] = a["cbytes"].get(r, 0) + b
                continue
            ranks = set(d["sends_per_rank"]) | set(d["recvs_per_rank"])
            for r in ranks:
                a["sends"][r] = a["sends"].get(r, 0) + d["sends_per_rank"].get(r, 0)
                a["recvs"][r] = a["recvs"].get(r, 0) + d["recvs_per_rank"].get(r, 0)
                a["dests"].setdefault(r, set()).update(d["dest_ranks"].get(r, ()))
                a["srcs"].setdefault(r, set()).update(d["src_ranks"].get(r, ()))
                a["bsent"][r] = a["bsent"].get(r, 0) + d["bytes_sent"].get(r, 0)
                a["brecv"][r] = a["brecv"].get(r, 0) + d["bytes_recv"].get(r, 0)
            if d["sends_per_rank"]:
                n_msgs = max(1, max(d["sends_per_rank"].values()))
                # largest single message in this event:
                per_msg = (
                    max(d["bytes_sent"].values()) // n_msgs if d["bytes_sent"] else 0
                )
                a["largest"] = max(a["largest"], per_msg)

        # Regions entered but containing no communication (pure-compute
        # phases like Kripke's "solve") still get a row — the paper's Fig. 1
        # compares compute vs communication regions.
        for rname in rec.instances:
            acc(rname)

        n_ranks = 0
        for a in per_region.values():
            for key in ("sends", "recvs", "bsent", "brecv", "cbytes"):
                if a[key]:
                    n_ranks = max(n_ranks, max(a[key]) + 1)

        prof = CommProfile(name=name, n_ranks=n_ranks * replication, meta=meta or {})
        for region, a in per_region.items():

            def mm(d, default=0):
                if not d:
                    return (default, default)
                return (min(d.values()), max(d.values()))

            stats = RegionStats(
                region=region,
                instances=rec.instances.get(region, 1),
                sends=mm(a["sends"]),
                recvs=mm(a["recvs"]),
                dest_ranks=mm({r: len(s) for r, s in a["dests"].items()}),
                src_ranks=mm({r: len(s) for r, s in a["srcs"].items()}),
                bytes_sent=mm(a["bsent"]),
                bytes_recv=mm(a["brecv"]),
                coll=a["coll"],
                coll_bytes=mm(a["cbytes"]),
                total_bytes_sent=sum(a["bsent"].values()) * replication,
                total_sends=sum(a["sends"].values()) * replication,
                largest_send=a["largest"],
                n_ranks=n_ranks * replication,
                kinds=dict(a["kinds"]),
            )
            prof.regions[region] = stats
        return prof


class HloCollectiveProfiler:
    """Compiled-layer sibling of :class:`CommPatternProfiler`.

    Reduces a columnar ``repro_torch.core.hlo.HloCollectiveBuffer`` (interned
    region/kind ids plus wire/operand/result byte columns) into per-region
    rows with the same grouped segment-reduction kernels the traced-layer
    profiler uses: one composite region ordering
    (:func:`segment_spans`), then one ``segment_reduce`` / ``bincount``
    pass per statistic across all regions at once — no per-op Python.
    The per-statistic reductions dispatch through the same
    :class:`~repro_torch.core.backend.ReduceBackend` as the traced layer
    (``backend=`` parameter, default from ``REPRO_BACKEND``), with
    bit-identical int64 outputs on every backend; on the torch backend the
    per-region sums and maxima run the CUDA segmented-reduce kernel.

    The rows are plain dicts tagged ``layer="hlo"`` and keyed like
    ``thicket.Frame.from_profiles`` rows (``profile`` / ``n_ranks`` /
    ``region``), so ``thicket.Frame.from_hlo`` can land compiled-layer
    traffic in the same frames as traced-layer traffic and reports can
    join the two layers per region (``reports.hlo_vs_traced``).
    """

    @staticmethod
    def region_rows(
        buf,
        *,
        name: str = "hlo",
        n_ranks: int = 0,
        meta: Optional[dict] = None,
        backend: Union[ReduceBackend, str, None] = None,
    ) -> list:
        """One row dict per region, in first-appearance order."""
        be = resolve_backend(backend)
        N = buf.n_ops
        rids = buf.region_ids
        if N:
            uniq, first = np.unique(rids, return_index=True)
            ordered = uniq[np.argsort(first, kind="stable")]
        else:
            ordered = np.zeros(0, np.int64)
        G = len(ordered)
        gid_of_rid = np.zeros(max(len(buf.region_names), 1), np.int64)
        gid_of_rid[ordered] = np.arange(G)
        g_of_op = gid_of_rid[rids]

        # Group codes are assigned in first-appearance order, so the sorted
        # segments come out in exactly the output row order.
        order, _, starts, _ = segment_spans(g_of_op)
        wire = be.segment_reduce(buf.wire_bytes, order, starts)
        operand = be.segment_reduce(buf.operand_bytes, order, starts)
        result = be.segment_reduce(buf.result_bytes, order, starts)
        largest = be.segment_reduce(buf.wire_bytes, order, starts, np.maximum)
        counts = np.bincount(g_of_op, minlength=G)
        K = len(buf.kind_names)
        kind_counts = np.zeros((G, K), np.int64)
        if N and K:
            kc = np.bincount(g_of_op * K + buf.kind_ids, minlength=G * K)
            kind_counts = kc.reshape(G, K)

        rows = []
        for g, rid in enumerate(ordered):
            # compact "kind=count;..." string: dict cells would break the
            # naive (unquoted) Frame.to_csv on multi-kind regions
            kinds = ";".join(
                f"{buf.kind_names[int(k)]}={int(kind_counts[g, k])}"
                for k in np.flatnonzero(kind_counts[g])
            )
            row = {
                "profile": name,
                "n_ranks": n_ranks,
                "region": buf.region_names[int(rid)],
                "layer": "hlo",
                "hlo_ops": int(counts[g]),
                "hlo_wire_bytes": int(wire[g]),
                "hlo_operand_bytes": int(operand[g]),
                "hlo_result_bytes": int(result[g]),
                "hlo_largest_wire": int(largest[g]),
                "hlo_kinds": kinds,
            }
            row.update({f"meta_{k}": v for k, v in (meta or {}).items()})
            rows.append(row)
        return rows


_observer_tls = threading.local()


@contextmanager
def trace_observer(cb: Callable):
    """Install a thread-local hook over :func:`profile_traced`.

    Within the scope, every ``profile_traced`` call hands its finished
    recorder to ``cb(rec, name=..., replication=..., meta=...)`` *instead
    of* reducing it through the batch path.  The callback may return a
    :class:`CommProfile` (used as the result — e.g. one trace reduced by
    two backends, each timed, or built via
    :meth:`CommPatternProfiler.incremental`) or ``None`` to fall through to
    the batch ``from_recorder`` reduction.  Hooks nest; the innermost wins.
    """
    prev = getattr(_observer_tls, "cb", None)
    _observer_tls.cb = cb
    try:
        yield
    finally:
        _observer_tls.cb = prev


def _to_meta(x):
    """A tensor argument moves to the meta device; anything else is kept."""
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def profile_traced(
    fn: Callable,
    *args,
    name: str = "profile",
    replication: int = 1,
    meta: Optional[dict] = None,
    backend: Union[ReduceBackend, str, None] = None,
    **kwargs,
) -> CommProfile:
    """Trace ``fn`` abstractly and return its communication profile.

    Runs ``fn`` once with every tensor argument moved to ``device="meta"``
    (the counterpart of ``jax.eval_shape``): shapes and dtypes propagate,
    nothing is computed or allocated, and the communication structure of
    the SPMD per-rank program is fully visible.  ``fn`` must use the
    instrumented collectives from ``repro_torch.core.collectives`` inside
    its ``compat.shard_map`` regions.  ``backend`` picks the reduction
    backend (see :func:`repro_torch.core.backend.resolve_backend`).

    A :func:`trace_observer` hook, when installed, is offered the recorder
    first and may supply the profile; a ``None`` return falls through to
    the batch reduction.
    """
    with recording() as rec:
        fn(*map(_to_meta, args), **{k: _to_meta(v) for k, v in kwargs.items()})
    cb = getattr(_observer_tls, "cb", None)
    if cb is not None:
        prof = cb(rec, name=name, replication=replication, meta=meta)
        if prof is not None:
            return prof
    return CommPatternProfiler.from_recorder(
        rec, name=name, replication=replication, meta=meta, backend=backend
    )
