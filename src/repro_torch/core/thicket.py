"""Thicket analog — exploratory analysis over many communication profiles.

The paper pairs Caliper with Thicket (a pandas-based toolkit) to aggregate
profiles from scaling studies into tables/plots (Figs. 1-6, Table IV).  This
module is a dependency-free tabular equivalent: a :class:`Frame` with
group-by / pivot / derived-metric helpers, plus loaders that ingest
:class:`repro_torch.core.profiler.CommProfile` JSON files and the dry-run roofline
records.

Columnar data model
-------------------

A Frame is **NumPy-backed**: rows are stored as a column dict
``{name: ndarray}`` plus a per-column boolean *presence mask* (rows of a
sparse scaling sweep legitimately lack columns — a profile without a region
contributes no cell).  Column dtypes are inferred once at construction:

* all-integer columns -> ``int64`` (absent cells hold 0 under a False mask),
* numeric mixes       -> ``float64`` (absent cells hold NaN),
* booleans            -> ``bool``,
* everything else     -> ``object`` (absent cells hold None).

Relational ops (``where`` / ``select`` / ``sort`` / ``concat`` / row
slicing) are whole-column NumPy operations — no per-row dict is built.
Row-oriented accessors (``rows``, iteration, ``group_by``, predicate
``filter``, ``with_column``) materialize plain-Python dict views on demand
(NumPy scalars are converted back to Python scalars, so downstream code and
JSON serialization see exactly what the old list-of-dicts Frame produced).
Column order is first-appearance order, matching the legacy behavior.

``Frame.concat`` stitches frames from independent runs into one table for
cross-run scaling studies; columns are unioned and dtypes re-unified, so
sweeps with disjoint meta/region columns concatenate without loss.

Frames are **layered**: :meth:`Frame.from_profiles` rows carry
``layer="traced"`` (application-layer traffic from the instrumented
collectives) and :meth:`Frame.from_hlo` rows carry ``layer="hlo"``
(compiler-inserted traffic from the columnar HLO analyzer), joined per
(profile, n_ranks, region) — the ``commr::`` scopes give every layer one
region namespace.  The JAX package's third, modeled-network layer
(``from_network``) is not ported yet.  ``group_by`` / ``agg`` run
vectorized: one factorize pass over composite key codes, no per-row dict
materialization.  The factorize dispatches through the same
:class:`~repro_torch.core.backend.ReduceBackend` as the profilers
(``backend=`` keyword on ``from_hlo`` / ``group_by`` / ``agg`` /
``pivot``, default from ``REPRO_BACKEND``) with identical grouping on
every backend; object-dtype and masked key columns always factorize
host-side.

Derived metrics mirror the paper's §V analysis:
  bandwidth   bytes sent per second per process (Fig. 5/6 left axes)
  msg_rate    messages sent per second per process (Fig. 5/6 right axes)
where "seconds" on real MPI systems is wall time; here it is the roofline
time of the step (sum of the dominant terms) where no wall time was taken.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Iterable, Optional

import numpy as np

from repro_torch.core.backend import resolve_backend
from repro_torch.core.profiler import CommProfile, HloCollectiveProfiler


def _infer_column(values: list, present: np.ndarray) -> np.ndarray:
    """Pick a compact dtype for a column; fall back to object."""
    live = [v for v, p in zip(values, present) if p]
    if live and all(isinstance(v, bool) for v in live):
        return np.array([bool(v) if p else False for v, p in zip(values, present)])
    if live and all(
        isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in live
    ):
        try:
            return np.array(
                [int(v) if p else 0 for v, p in zip(values, present)], np.int64
            )
        except OverflowError:
            pass
    elif live and all(
        isinstance(v, (int, float, np.integer, np.floating))
        and not isinstance(v, bool)
        for v in live
    ):
        return np.array(
            [float(v) if p else np.nan for v, p in zip(values, present)], np.float64
        )
    out = np.empty(len(values), object)
    for i, (v, p) in enumerate(zip(values, present)):
        out[i] = v if p else None
    return out


def _pyval(v):
    """NumPy scalar -> plain Python scalar (rows look like the legacy dicts)."""
    return v.item() if isinstance(v, np.generic) else v


class Frame:
    """A minimal dataframe: NumPy column dict + relational utilities.

    Public API is row-compatible with the legacy list-of-dicts Frame:
    ``Frame(rows)`` construction, ``.rows`` / iteration yielding dicts, and
    every helper below.  Storage and the bulk ops are columnar (see the
    module docstring for the data model).
    """

    def __init__(self, rows: Optional[Iterable[dict]] = None):
        rows = [dict(r) for r in (rows or [])]
        self._n = len(rows)
        self._cols: dict[str, np.ndarray] = {}
        self._mask: dict[str, np.ndarray] = {}
        order: list[str] = []
        for r in rows:
            for k in r:
                if k not in self._mask:
                    self._mask[k] = None  # placeholder to keep order
                    order.append(k)
        for k in order:
            present = np.fromiter((k in r for r in rows), bool, count=self._n)
            values = [r.get(k) for r in rows]
            self._cols[k] = _infer_column(values, present)
            self._mask[k] = present

    @classmethod
    def _from_columns(cls, cols: dict, mask: dict, n: int) -> "Frame":
        out = cls.__new__(cls)
        out._n = n
        out._cols = cols
        out._mask = mask
        return out

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_profiles(profiles: Iterable[CommProfile]) -> "Frame":
        """One row per (profile, region), tagged ``layer="traced"``.

        The layer tag distinguishes these application-layer rows from the
        compiled-layer rows of :meth:`from_hlo` when both land in one frame
        (two-layer per-region joins — ``reports.hlo_vs_traced``).

        A **degraded** profile (zero regions, ``meta["degraded"]`` — a
        sweep point that exhausted its supervised retries, see
        the sweep runner) still contributes one placeholder row
        carrying the profile / n_ranks keys and its meta columns
        (``meta_degraded`` / ``meta_retries`` / ``meta_error``) with every
        stats column *absent* — the presence masks show the gap honestly
        instead of fabricating zeros.
        """
        rows = []
        for p in profiles:
            if not p.regions and p.meta.get("degraded"):
                row = {
                    "profile": p.name,
                    "n_ranks": p.n_ranks,
                    "layer": "traced",
                }
                row.update({f"meta_{k}": v for k, v in p.meta.items()})
                rows.append(row)
                continue
            for rname, st in p.regions.items():
                row = {
                    "profile": p.name,
                    "n_ranks": p.n_ranks,
                    "region": rname,
                    "layer": "traced",
                    "instances": st.instances,
                    "sends_min": st.sends[0],
                    "sends_max": st.sends[1],
                    "recvs_min": st.recvs[0],
                    "recvs_max": st.recvs[1],
                    "dest_ranks_min": st.dest_ranks[0],
                    "dest_ranks_max": st.dest_ranks[1],
                    "src_ranks_min": st.src_ranks[0],
                    "src_ranks_max": st.src_ranks[1],
                    "bytes_sent_min": st.bytes_sent[0],
                    "bytes_sent_max": st.bytes_sent[1],
                    "bytes_recv_min": st.bytes_recv[0],
                    "bytes_recv_max": st.bytes_recv[1],
                    "coll": st.coll,
                    "coll_bytes_max": st.coll_bytes[1],
                    "total_bytes_sent": st.total_bytes_sent,
                    "total_sends": st.total_sends,
                    "largest_send": st.largest_send,
                    "avg_send_size": st.avg_send_size,
                }
                row.update({f"meta_{k}": v for k, v in p.meta.items()})
                rows.append(row)
        return Frame(rows)

    @staticmethod
    def from_profile_dir(path: str, pattern: str = "*.json") -> "Frame":
        profs = [
            CommProfile.load(p) for p in sorted(glob.glob(os.path.join(path, pattern)))
        ]
        return Frame.from_profiles(profs)

    @staticmethod
    def from_hlo(entries, backend=None) -> "Frame":
        """Compiled-layer rows: one per (module, region), ``layer="hlo"``.

        ``entries`` is an iterable of ``(profile_name, n_ranks, buffer)``
        or ``(profile_name, n_ranks, buffer, meta)`` tuples, where
        ``buffer`` is a ``repro_torch.core.hlo.HloCollectiveBuffer``.  Rows share
        the join keys of :meth:`from_profiles` (profile / n_ranks /
        region), so ``Frame.concat`` stitches the two layers into one
        per-region table.  ``backend`` picks the reduction backend
        (name/instance; default resolved from ``REPRO_BACKEND``).
        """
        rows = []
        for entry in entries:
            name, n_ranks, buf, *rest = entry
            rows.extend(
                HloCollectiveProfiler.region_rows(
                    buf,
                    name=name,
                    n_ranks=n_ranks,
                    meta=rest[0] if rest else None,
                    backend=backend,
                )
            )
        return Frame(rows)

    @staticmethod
    def from_records(path: str) -> "Frame":
        """Load a JSON list-of-dicts file (e.g. dry-run roofline records)."""
        with open(path) as f:
            return Frame(json.load(f))

    @staticmethod
    def concat(frames: Iterable["Frame"]) -> "Frame":
        """Stack frames row-wise (cross-run scaling studies).

        Columns are unioned in first-appearance order; rows from frames
        lacking a column get absent cells (mask False), and dtypes are
        re-unified (falling back to object on mixes).
        """
        frames = list(frames)
        n = sum(f._n for f in frames)
        order: list[str] = []
        for f in frames:
            for k in f._cols:
                if k not in order:
                    order.append(k)
        cols: dict[str, np.ndarray] = {}
        mask: dict[str, np.ndarray] = {}
        for k in order:
            dtypes = {f._cols[k].dtype for f in frames if k in f._cols}
            masks = [
                f._mask[k] if k in f._mask else np.zeros(f._n, bool) for f in frames
            ]
            if len(dtypes) == 1:
                dtype = next(iter(dtypes))
                fill = np.zeros(1, dtype)[0] if dtype != object else None
                pieces = [
                    f._cols[k] if k in f._cols else np.full(f._n, fill, dtype)
                    for f in frames
                ]
                cols[k] = np.concatenate(pieces) if pieces else np.zeros(0, dtype)
            else:
                pieces = []
                for f in frames:
                    if k in f._cols:
                        obj = f._cols[k].astype(object)
                        obj[~f._mask[k]] = None
                    else:
                        obj = np.full(f._n, None, object)
                    pieces.append(obj)
                cols[k] = np.concatenate(pieces) if pieces else np.zeros(0, object)
            mask[k] = np.concatenate(masks) if masks else np.zeros(0, bool)
        return Frame._from_columns(cols, mask, n)

    # -- row views ---------------------------------------------------------
    def _row(self, i: int) -> dict:
        out = {}
        for k, col in self._cols.items():
            if self._mask[k][i]:
                out[k] = _pyval(col[i])
        return out

    @property
    def rows(self) -> list:
        """All rows as plain dicts (absent cells omitted, Python scalars)."""
        return [self._row(i) for i in range(self._n)]

    def _take(self, idx) -> "Frame":
        idx = np.asarray(idx)
        cols = {k: c[idx] for k, c in self._cols.items()}
        mask = {k: m[idx] for k, m in self._mask.items()}
        n = int(idx.sum()) if idx.dtype == bool else len(idx)
        return Frame._from_columns(cols, mask, n)

    # -- relational ops ---------------------------------------------------
    def filter(self, pred: Callable[[dict], bool]) -> "Frame":
        keep = np.fromiter(
            (bool(pred(self._row(i))) for i in range(self._n)), bool, count=self._n
        )
        return self._take(keep)

    def where(self, **eq) -> "Frame":
        """Vectorized equality filter (``r.get(k) == v`` per column)."""
        keep = np.ones(self._n, bool)
        for k, v in eq.items():
            if k not in self._cols:
                if v is not None:
                    keep[:] = False
                continue  # missing key reads as None, so v=None matches all
            col, m = self._cols[k], self._mask[k]
            if v is None:
                if col.dtype == object:
                    hit = np.fromiter((x is None for x in col), bool, count=self._n)
                else:
                    hit = np.zeros(self._n, bool)
                keep &= hit | ~m
                continue
            try:
                hit = np.asarray(col == v)
                if hit.shape != (self._n,):
                    hit = np.full(self._n, bool(hit))
            except Exception:
                hit = np.fromiter(
                    (col[i] == v for i in range(self._n)), bool, count=self._n
                )
            keep &= m & hit
        return self._take(keep)

    def with_column(
        self,
        name: str,
        fn: Callable[[dict], object],
        present: Optional[Callable[[dict], bool]] = None,
    ) -> "Frame":
        """Derive a column row-wise; ``present(row)`` (default: always True)
        clears the presence mask where the metric is undefined, so reports
        render a gap instead of a fabricated value."""
        values = [fn(self._row(i)) for i in range(self._n)]
        if present is None:
            mask_col = np.ones(self._n, bool)
        else:
            mask_col = np.fromiter(
                (bool(present(self._row(i))) for i in range(self._n)),
                bool,
                count=self._n,
            )
        cols = dict(self._cols)
        mask = dict(self._mask)
        cols[name] = _infer_column(values, mask_col)
        mask[name] = mask_col
        return Frame._from_columns(cols, mask, self._n)

    def select(self, *cols: str) -> "Frame":
        """Project to ``cols``; missing cells surface as explicit None."""
        out_cols: dict[str, np.ndarray] = {}
        out_mask: dict[str, np.ndarray] = {}
        for c in cols:
            if c in self._cols and self._mask[c].all():
                out_cols[c] = self._cols[c]
            elif c in self._cols:
                obj = self._cols[c].astype(object)
                obj[~self._mask[c]] = None
                out_cols[c] = obj
            else:
                out_cols[c] = np.full(self._n, None, object)
            out_mask[c] = np.ones(self._n, bool)
        return Frame._from_columns(out_cols, out_mask, self._n)

    def sort(self, *cols: str, reverse: bool = False) -> "Frame":
        """Stable sort by column tuple (legacy ``r.get`` key semantics).

        Numeric fully-present keys sort via ``np.lexsort``; otherwise a
        Python stable sort runs, falling back to type-grouped keys when the
        values are not mutually comparable (e.g. None mixed with str in a
        sparse sweep).
        """
        if not cols or self._n <= 1:
            return self._take(np.arange(self._n))
        fast = not reverse and all(
            c in self._cols
            and self._mask[c].all()
            and self._cols[c].dtype.kind in "biuf"
            for c in cols
        )
        if fast:
            idx = np.lexsort(tuple(self._cols[c] for c in reversed(cols)))
            return self._take(idx)
        keys = [self.column(c) for c in cols]
        try:
            idx = sorted(
                range(self._n),
                key=lambda i: tuple(k[i] for k in keys),
                reverse=reverse,
            )
        except TypeError:  # mixed/missing types: group by type name first
            idx = sorted(
                range(self._n),
                key=lambda i: tuple(
                    (k[i] is not None, type(k[i]).__name__, str(k[i])) for k in keys
                ),
                reverse=reverse,
            )
        return self._take(np.asarray(idx))

    def _key_codes(self, keys: tuple, be=None) -> np.ndarray:
        """Dense int64 group code per row for the key-column tuple.

        Numeric fully-present key columns factorize through the reduction
        backend ``be`` (one unique/inverse pass); object/masked columns
        fall back to a dict factorization (absent cells read as None,
        matching ``r.get``).  Codes are re-compacted after every key, so
        composites never overflow (each stage's code is < n_rows).
        """
        be = be if be is not None else resolve_backend(None)
        n = self._n
        codes = np.zeros(n, np.int64)
        if n == 0:
            return codes
        for k in keys:
            col = self._cols.get(k)
            if col is None:
                continue  # missing column: single None value, code 0
            m = self._mask[k]
            if col.dtype.kind in "biuf" and m.all():
                kc = be.factorize(col)[2]
            else:
                ids: dict = {}
                kc = np.empty(n, np.int64)
                for i in range(n):
                    v = _pyval(col[i]) if m[i] else None
                    code = ids.get(v)
                    if code is None:
                        code = len(ids)
                        ids[v] = code
                    kc[i] = code
            combined = codes * (int(kc.max()) + 1) + kc
            codes = be.factorize(combined)[2]
        return codes

    def group_by(self, *keys: str, backend=None) -> dict:
        """Group rows by key columns: {key_tuple: sub-Frame}.

        Vectorized: one factorize pass over composite key codes (see
        ``_key_codes``) — no per-row dict is materialized.  Groups keep
        first-appearance order and sub-frames preserve row order; iterate
        a sub-frame (or take ``.rows``) for the row dicts the legacy
        list-valued ``group_by`` returned.  ``backend`` picks the reduction
        backend (name/instance; default resolved from ``REPRO_BACKEND``).
        """
        if self._n == 0:
            return {}
        be = resolve_backend(backend)
        codes = self._key_codes(keys, be)
        uniq, first, inv = be.factorize(codes)
        by_code = np.argsort(inv, kind="stable")  # ascending rows per group
        bounds = np.concatenate(
            ([0], np.flatnonzero(np.diff(inv[by_code])) + 1, [self._n])
        )
        groups = {}
        for rank in np.argsort(first, kind="stable"):  # first-appearance order
            i0 = int(first[rank])
            key = []
            for k in keys:  # r.get semantics: absent cells read as None
                if k in self._cols and self._mask[k][i0]:
                    key.append(_pyval(self._cols[k][i0]))
                else:
                    key.append(None)
            sub = self._take(by_code[bounds[rank] : bounds[rank + 1]])
            groups[tuple(key)] = sub
        return groups

    def agg(self, keys: tuple, aggs: dict, backend=None) -> "Frame":
        """aggs: out_col -> (in_col, fn) where fn maps list->scalar.

        Runs on the vectorized group path: each fn receives the group's
        column values as a list (absent cells -> None, like ``r.get``).
        ``backend`` threads through to :meth:`group_by`.
        """
        out = []
        for kv, sub in self.group_by(*keys, backend=backend).items():
            row = dict(zip(keys, kv))
            for out_col, (in_col, fn) in aggs.items():
                row[out_col] = fn(sub.column(in_col))
            out.append(row)
        return Frame(out)

    def pivot(self, index: str, column: str, value: str, backend=None) -> "Frame":
        """Rows keyed by `index`, one output column per distinct `column`.

        Sparse (index, column) combinations simply leave the cell absent —
        ``to_markdown``/``to_csv`` render them empty and row dicts omit the
        key, so disjoint region sets across profiles pivot cleanly.

        Vectorized like ``group_by``: rows factorize to composite
        (index-group, column) cell codes, one backend factorize pass finds
        the distinct cells (and the legacy dict-insertion column order), and
        the cell grid fills with last-row-wins fancy assignment — no
        per-row dict is materialized.  Output is structurally identical to
        the historical row-dict implementation, including the
        ``str(column_value)`` column naming, the ``(str(type), value)``
        row ordering, and the overwrite behavior when a column value
        collides with the index name.
        """
        if self._n == 0:
            return Frame([])
        ivals = self.column(index)
        cnames = [str(v) for v in self.column(column)]
        vvals = self.column(value)

        gmap: dict = {}
        gid = np.empty(self._n, np.int64)
        for i, v in enumerate(ivals):
            code = gmap.get(v)
            if code is None:
                code = len(gmap)
                gmap[v] = code
            gid[i] = code
        cmap: dict = {}
        cid = np.empty(self._n, np.int64)
        for i, c in enumerate(cnames):
            code = cmap.get(c)
            if code is None:
                code = len(cmap)
                cmap[c] = code
            cid[i] = code
        uniq_ivals = list(gmap)
        col_names = list(cmap)
        NG, NC = len(uniq_ivals), len(col_names)

        codes = gid * NC + cid
        flat_vals = np.empty(self._n, object)
        for i, v in enumerate(vvals):
            flat_vals[i] = v
        cell_vals = np.empty(NG * NC, object)
        cell_vals[codes] = flat_vals  # duplicate cells: last row wins
        present = np.zeros(NG * NC, bool)
        present[codes] = True
        uniq_codes, first_rows, _ = resolve_backend(backend).factorize(codes)

        order = sorted(
            range(NG), key=lambda g: (str(type(uniq_ivals[g])), uniq_ivals[g])
        )
        # Column order replicates dict insertion: scan groups in output-row
        # order, each group's columns by first assignment.
        by_group: dict[int, list] = {}
        for code, fr in zip(uniq_codes, first_rows):
            by_group.setdefault(int(code) // NC, []).append((int(fr), int(code) % NC))
        out_names = [index]
        seen = {index}
        for g in order:
            for _, pc in sorted(by_group.get(g, [])):
                name = col_names[pc]
                if name not in seen:
                    seen.add(name)
                    out_names.append(name)

        # Index column first; a column literally named like the index
        # overwrites its cells (legacy dict-assignment semantics).
        idx_vals = [uniq_ivals[g] for g in order]
        if index in cmap:
            ci = cmap[index]
            for r_out, g in enumerate(order):
                if present[g * NC + ci]:
                    idx_vals[r_out] = cell_vals[g * NC + ci]
        cols: dict[str, np.ndarray] = {}
        mask: dict[str, np.ndarray] = {}
        all_present = np.ones(NG, bool)
        cols[index] = _infer_column(idx_vals, all_present)
        mask[index] = all_present
        for name in out_names[1:]:
            ci = cmap[name]
            vals = [cell_vals[g * NC + ci] for g in order]
            pr = np.fromiter((present[g * NC + ci] for g in order), bool, count=NG)
            cols[name] = _infer_column(vals, pr)
            mask[name] = pr
        return Frame._from_columns(cols, mask, NG)

    # -- access -----------------------------------------------------------
    def column(self, name: str) -> list:
        """Column values as a Python list (absent cells -> None)."""
        if name not in self._cols:
            return [None] * self._n
        col, m = self._cols[name], self._mask[name]
        return [_pyval(col[i]) if m[i] else None for i in range(self._n)]

    def column_array(self, name: str) -> tuple:
        """NumPy view of a column: ``(values, presence_mask)``."""
        if name not in self._cols:
            return np.full(self._n, None, object), np.zeros(self._n, bool)
        return self._cols[name], self._mask[name]

    def columns(self) -> list:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return (self._row(i) for i in range(self._n))

    # -- output -----------------------------------------------------------
    def _cell(self, i: int, c: str):
        """Cell value with ``r.get(c, "")`` semantics ("" when absent)."""
        if c not in self._cols or not self._mask[c][i]:
            return ""
        return _pyval(self._cols[c][i])

    def to_markdown(self, cols: Optional[list] = None, floatfmt: str = "{:.4g}") -> str:
        cols = cols or self.columns()

        def fmt(v):
            if isinstance(v, float):
                return floatfmt.format(v)
            return str(v)

        lines = [
            "| " + " | ".join(cols) + " |",
            "|" + "|".join("---" for _ in cols) + "|",
        ]
        for i in range(self._n):
            lines.append("| " + " | ".join(fmt(self._cell(i, c)) for c in cols) + " |")
        return "\n".join(lines)

    def to_csv(self, cols: Optional[list] = None) -> str:
        cols = cols or self.columns()
        lines = [",".join(cols)]
        for i in range(self._n):
            lines.append(",".join(str(self._cell(i, c)) for c in cols))
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(self.rows, indent=2, default=str)


# ---------------------------------------------------------------------------
# Paper-style derived metrics (§V bandwidth / message-rate analysis)
# ---------------------------------------------------------------------------


def add_rate_metrics(frame: Frame, seconds_col: str = "meta_seconds") -> Frame:
    """Add per-process bandwidth (B/s) and message rate (msgs/s).

    ``seconds_col`` must hold the per-step time estimate (roofline seconds
    from the dry-run, or measured seconds where available).  Rows whose
    seconds are missing or zero get NaN cells with the presence mask
    cleared — fig5/6-style tables show a gap there, never a fake ``0.0``
    rate that reads as "measured no traffic".
    """

    def has_seconds(r):
        s = r.get(seconds_col)
        return isinstance(s, (int, float)) and s > 0

    def bw(r):
        s, n = r.get(seconds_col) or 0.0, max(1, r.get("n_ranks", 1))
        return (r.get("total_bytes_sent", 0) / n / s) if s else float("nan")

    def rate(r):
        s, n = r.get(seconds_col) or 0.0, max(1, r.get("n_ranks", 1))
        return (r.get("total_sends", 0) / n / s) if s else float("nan")

    frame = frame.with_column("bandwidth_Bps", bw, present=has_seconds)
    return frame.with_column("msg_rate_per_s", rate, present=has_seconds)


def scaling_table(frame: Frame, region: str, value: str = "total_bytes_sent") -> Frame:
    """Paper Fig-style table: value vs n_ranks for one region."""
    return frame.where(region=region).select("n_ranks", value).sort("n_ranks")
