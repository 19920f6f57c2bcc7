"""Compiled-HLO communication analysis — the paper's profiler applied to XLA.

Under ``jit``, most communication in a sharded JAX program is *inserted by the
GSPMD partitioner* — the user never writes it.  Caliper's PMPI interception
has no analog for compiler-generated traffic, so this module extends the
paper's idea to the compiled artifact: parse ``compiled.as_text()`` (post-SPMD
HLO), find every collective op, compute its byte cost from the shapes in the
IR, and attribute it to the innermost communication region via the
``commr::<name>`` named-scope component in op metadata.

This is also the source of the *collective roofline term*:

  collective_term_seconds = wire_bytes_per_device / link_bandwidth

Byte model per collective kind (ring-equivalent wire traffic per
participating device, group size n):

  all-reduce          2 * (n-1)/n * operand_bytes
  all-gather          (n-1)/n * result_bytes      (= (n-1) * shard)
  reduce-scatter      (n-1)/n * operand_bytes
  all-to-all          (n-1)/n * operand_bytes
  collective-permute  result_bytes (per source appearance)
  collective-broadcast (n-1)/n * operand_bytes

``operand_bytes`` / ``result_bytes`` are per-device shard sizes as written in
the post-partitioning HLO (shapes in compiled HLO are already per-device).

Columnar analyzer (unified two-layer schema)
--------------------------------------------

Like the traced layer (:mod:`repro_torch.core.regions`), the HLO layer is
**structure-of-arrays**: :func:`scan_hlo_collectives` tokenizes the module
text in a single pass and appends one row per collective op into an
:class:`HloCollectiveBuffer` — built from the same ``Column`` /
``Interner`` substrate as the traced-layer ``TraceBuffer``.  Column schema
(``N`` collective ops scanned so far):

* ``kind_ids`` / ``region_ids`` — interned int32 codes into ``kind_names``
  / ``region_names`` (regions come from the innermost ``commr::`` scope in
  op metadata, i.e. the *same* region namespace the traced layer records);
* ``result_bytes`` / ``operand_bytes`` / ``wire_bytes`` — int64 per-device
  byte columns (wire bytes follow the ring model above, computed
  vectorized over the whole batch);
* ``group_size`` / ``n_groups`` — replica-group geometry;
* ``channel_ids`` — int64 channel id (-1 when absent);
* ``trip_factors`` — int64 execution count of the enclosing computation
  (while-loop trip scaling; 1 outside loops).  ``wire_bytes`` and
  ``operand_bytes`` are already trip-scaled.

:class:`CollectiveOp` survives as a per-op *view* (``buffer.op(i)`` /
``buffer.to_ops()``) and :class:`CollectiveSummary` as the aggregate view
(``buffer.summarize()``, reduced with one vectorized pass), exactly as
``RegionEvent`` adapts the traced-layer buffer.  The original per-op
dict/dataclass implementation is retained as
:func:`parse_hlo_collectives_reference` — the executable specification the
columnar path is parity-tested against (``tests/test_hlo_golden.py``,
``tests/test_hlo_property.py``).

The PyTorch port has no XLA: its compiled layer comes from a captured
graph instead (:func:`scan_graph_collectives` / :func:`graph_collectives`),
one row per instrumented-collective custom op, in the same buffer schema and
HLO kind names.  That layer is the collectives the per-rank program calls,
before any combiner: it is not post-XLA HLO.

Per-region reduction of a buffer (compiled-layer rows for
``thicket.Frame``, tagged ``layer="hlo"``) lives in
:class:`repro_torch.core.profiler.HloCollectiveProfiler`, which shares the
grouped segment-reduction kernels with the traced-layer profiler.
"""

from __future__ import annotations

import bisect
import math
import re
from collections import Counter
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.regions import Column, Interner, annotating

# ---------------------------------------------------------------------------
# Shape / dtype parsing
# ---------------------------------------------------------------------------

#: Bits per element.  Sub-byte dtypes (s4/u4) are why this table is in bits:
#: byte accounting accumulates bits and rounds up once per type string.
_DTYPE_BITS = {
    "pred": 8,
    "s4": 4,
    "u4": 4,
    "s8": 8,
    "u8": 8,
    "s16": 16,
    "u16": 16,
    "f16": 16,
    "bf16": 16,
    "s32": 32,
    "u32": 32,
    "f32": 32,
    "s64": 64,
    "u64": 64,
    "f64": 64,
    "c64": 64,
    "c128": 128,
    "f8e4m3fn": 8,
    "f8e5m2": 8,
    "f8e4m3": 8,
    "f8e4m3b11fnuz": 8,
    "f8e5m2fnuz": 8,
    "f8e4m3fnuz": 8,
    "token": 0,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Total bytes of an HLO type string, incl. tuple types.

    Accumulates in *bits* and rounds up once at the end, so sub-byte
    dtypes do not truncate per shape: ``s4[3]`` is 2 bytes (12 bits), and
    ``(s4[1], s4[1])`` is 1 byte — the old float accumulation truncated
    odd-element s4/u4 tensors down.
    """
    bits = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        per_elem = _DTYPE_BITS.get(dtype)
        if per_elem is None:
            continue
        if dims:
            n = math.prod(int(d) for d in dims.split(",") if d)
        else:
            n = 1
        bits += n * per_elem
    return (bits + 7) >> 3


#: type-string -> bytes memo (shapes repeat heavily within a module; the
#: scanner resolves each distinct type string once).
_SHAPE_BYTES_MEMO: dict = {}


def _shape_bytes_cached(type_str: str) -> int:
    b = _SHAPE_BYTES_MEMO.get(type_str)
    if b is None:
        b = _shape_bytes(type_str)
        if len(_SHAPE_BYTES_MEMO) < 65536:
            _SHAPE_BYTES_MEMO[type_str] = b
    return b


# ---------------------------------------------------------------------------
# HLO instruction parsing
# ---------------------------------------------------------------------------

# %name = <type> opkind(...), attrs..., metadata={...}
_INSTR_PATTERN = (
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*"
    r"(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*([\w\-]+)\((.*)$"
)
_INSTR_RE = re.compile(_INSTR_PATTERN)

# Single whole-text tokenizer pass: computation headers (groups 1-2, same
# shape as _COMP_HEADER_RE) or instructions (groups 3-6, same shape as
# _INSTR_RE), alternation ordered header-first to keep the reference's
# line dispatch precedence.
_SCAN_M_PATTERN = (
    r"^(?:(ENTRY\s+)?%?([\w.\-$]+)\s*\(.*\{\s*$"
    r"|\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*"
    r"(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*([\w\-]+)\((.*)$)"
)
_SCAN_M_RE = re.compile(_SCAN_M_PATTERN, re.M)

#: Kind table of the columnar buffer, in fixed id order.
_KIND_ORDER = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
    "ragged-all-to-all",
)
_COLLECTIVE_KINDS = set(_KIND_ORDER)
_KIND_ID = {k: i for i, k in enumerate(_KIND_ORDER)}
_PERMUTE_ID = _KIND_ID["collective-permute"]

_GROUP_RE = re.compile(r"\{([\d,\s]*)\}")
#: tokens marking lines that can contribute call-graph factor edges
_EDGE_TOKENS = ("body=", "condition=", "calls=", "to_apply=", " while(")
_WHILE_EXPR_RE = re.compile(r"=\s*\([^=]*\)\s*while\(")
_PAIRS_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")
_PAIR_RE = re.compile(r"\{(\d+),(\d+)\}")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_OPERANDS_RE = re.compile(r"%([\w.\-]+)")
_CHANNEL_RE = re.compile(r"channel_id=(\d+)")
_DIGITS_RE = re.compile(r"\d+")
_COMMR_RE = re.compile(r"commr::([\w\-.]+)")

#: Region attributed to collectives with no commr:: scope in their metadata.
UNATTRIBUTED_REGION = "<unattributed>"


def _base_kind(opkind: str) -> Optional[str]:
    if opkind.endswith("-start"):
        opkind = opkind[: -len("-start")]
    if opkind.endswith("-done"):
        return None  # counted at -start
    return opkind if opkind in _COLLECTIVE_KINDS else None


#: opkind -> base kind memo (opkind strings repeat per module; the scanner
#: resolves each distinct spelling once).
_BASE_KIND_MEMO: dict = {}


def _base_kind_cached(opkind: str) -> Optional[str]:
    try:
        return _BASE_KIND_MEMO[opkind]
    except KeyError:
        kind = _base_kind(opkind)
        if len(_BASE_KIND_MEMO) < 4096:
            _BASE_KIND_MEMO[opkind] = kind
        return kind


@dataclass
class CollectiveOp:
    """One collective instruction in post-SPMD HLO.

    A per-op *view* over the columnar :class:`HloCollectiveBuffer`
    (``buffer.op(i)`` / ``buffer.to_ops()``) — the columnar pipeline never
    materializes these; they exist for the reference implementation,
    adapters, and tests.
    """

    name: str
    kind: str  # base kind (all-reduce, ...)
    result_bytes: int  # per-device result shard bytes
    operand_bytes: int  # per-device operand shard bytes (trip-scaled)
    group_size: int  # participants per replica group
    n_groups: int
    wire_bytes: int  # ring-model bytes over a device's link (trip-scaled)
    region: str  # attributed comm region ("<unattributed>")
    op_name: str  # full metadata op_name path
    channel_id: int = -1
    trip_factor: int = 1  # enclosing-computation execution count

    def to_dict(self) -> dict:
        return asdict(self)


def _explicit_group_sizes(rest: str, start: int) -> Optional[list]:
    """Sizes of an explicit ``replica_groups={{...},...}`` list, or None.

    ``start`` indexes just past the opening ``{``.  Balanced-brace scan to
    its matching close.  The old regex
    (``replica_groups=\\{(\\{[^=]*?\\})\\}``) could not cross an ``=`` and
    required byte-adjacent ``}}`` termination, so nonstandard spellings
    (``{ {0,1}, {2,3} }``) silently fell through to the one-flat-group
    default — wrong group geometry with no error.
    """
    depth = 1
    i = start
    while i < len(rest) and depth:
        c = rest[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
        i += 1
    if depth:
        return None  # unterminated list
    body = rest[start : i - 1]
    sizes = [
        len([r for r in g.replace(" ", "").split(",") if r])
        for g in _GROUP_RE.findall(body)
    ]
    return [s for s in sizes if s] or None


_IOTA_TAIL_RE = re.compile(r"\[(\d+),(\d+)\]<=")
#: replica-group token -> (group_size, n_groups) memo; group spellings
#: repeat across a module's ops, so each distinct token parses once.
_GROUPS_MEMO: dict = {}
_MEMO_MISS = object()  # distinguishes "not cached" from a cached None


def _parse_groups(rest: str, total_devices: Optional[int], start: int = 0) -> tuple:
    at = rest.find("replica_groups=", start)
    if at >= 0:
        j = at + len("replica_groups=")
        lead = rest[j : j + 1]
        if lead == "[":
            m = _IOTA_TAIL_RE.match(rest, j)
            if m:
                token = m.group(0)
                hit = _GROUPS_MEMO.get(token)
                if hit is None:
                    hit = (int(m.group(2)), int(m.group(1)))
                    if len(_GROUPS_MEMO) < 4096:
                        _GROUPS_MEMO[token] = hit
                return hit
        elif lead == "{":
            # standard spellings end at the first "}}", giving an exact,
            # repeating memo key; nonstandard (spaced) spellings have no
            # cheap stable key and just parse directly
            end = rest.find("}}", j)
            if end >= 0:
                token = rest[j : end + 2]
                hit = _GROUPS_MEMO.get(token, _MEMO_MISS)
                if hit is _MEMO_MISS:
                    sizes = _explicit_group_sizes(rest, j + 1)
                    hit = (max(sizes), len(sizes)) if sizes else None
                    if len(_GROUPS_MEMO) < 4096:
                        _GROUPS_MEMO[token] = hit
            else:
                sizes = _explicit_group_sizes(rest, j + 1)
                hit = (max(sizes), len(sizes)) if sizes else None
            if hit is not None:
                return hit
    # flat single group over all devices
    if total_devices:
        return total_devices, 1
    return 1, 1


def _region_from_op_name(op_name: str) -> str:
    """Innermost commr:: scope component, else <unattributed>."""
    hits = _COMMR_RE.findall(op_name)
    return hits[-1] if hits else UNATTRIBUTED_REGION


_REGION_MEMO: dict = {}


def _region_cached(op_name: str) -> str:
    region = _REGION_MEMO.get(op_name)
    if region is None:
        region = _region_from_op_name(op_name)
        if len(_REGION_MEMO) < 8192:
            _REGION_MEMO[op_name] = region
    return region


def _wire_bytes(
    kind: str, result_b: int, operand_b: int, n: int, n_pairs_per_src: float = 1.0
) -> int:
    if n <= 1 and kind != "collective-permute":
        return 0
    if kind == "all-reduce":
        return int(2 * (n - 1) / n * operand_b)
    if kind == "all-gather":
        return int((n - 1) / n * result_b)
    if kind == "reduce-scatter":
        return int((n - 1) / n * operand_b)
    if kind in ("all-to-all", "ragged-all-to-all"):
        return int((n - 1) / n * operand_b)
    if kind == "collective-broadcast":
        return int((n - 1) / n * operand_b)
    if kind == "collective-permute":
        return int(result_b * n_pairs_per_src)
    return operand_b


# ---------------------------------------------------------------------------
# Columnar store
# ---------------------------------------------------------------------------


class HloCollectiveBuffer:
    """Columnar (structure-of-arrays) store of one module's collective ops.

    See the module docstring for the column schema.  Built on the same
    ``Column`` / ``Interner`` substrate as the traced-layer
    ``regions.TraceBuffer``; :func:`scan_hlo_collectives` fills it with one
    batched append, ``op(i)`` / ``to_ops()`` materialize
    :class:`CollectiveOp` views, ``summarize()`` reduces it vectorized,
    and ``repro_torch.core.profiler.HloCollectiveProfiler`` turns it into
    per-region ``layer="hlo"`` frame rows.
    """

    def __init__(self) -> None:
        self.kind_names: list = list(_KIND_ORDER)
        self._regions = Interner()
        self.region_names: list = self._regions.values
        self.names: list = []  # instruction names, one per op
        self.op_names: list = []  # metadata op_name paths, one per op
        self._kind = Column(np.int32)
        self._region = Column(np.int32)
        self._result = Column(np.int64)
        self._operand = Column(np.int64)
        self._wire = Column(np.int64)
        self._gsize = Column(np.int64)
        self._ngroups = Column(np.int64)
        self._channel = Column(np.int64)
        self._trip = Column(np.int64)

    # -- column views (live prefixes, read-only) ----------------------------

    @property
    def n_ops(self) -> int:
        return len(self._kind)

    @property
    def kind_ids(self) -> np.ndarray:
        return self._kind.view()

    @property
    def region_ids(self) -> np.ndarray:
        return self._region.view()

    @property
    def result_bytes(self) -> np.ndarray:
        return self._result.view()

    @property
    def operand_bytes(self) -> np.ndarray:
        return self._operand.view()

    @property
    def wire_bytes(self) -> np.ndarray:
        return self._wire.view()

    @property
    def group_size(self) -> np.ndarray:
        return self._gsize.view()

    @property
    def n_groups(self) -> np.ndarray:
        return self._ngroups.view()

    @property
    def channel_ids(self) -> np.ndarray:
        return self._channel.view()

    @property
    def trip_factors(self) -> np.ndarray:
        return self._trip.view()

    def region_id(self, name: str) -> int:
        return self._regions.intern(name)

    # -- appends ------------------------------------------------------------

    def append_op(
        self,
        *,
        name: str,
        kind: str,
        result_bytes: int,
        operand_bytes: int,
        group_size: int,
        n_groups: int,
        region: str,
        op_name: str,
        channel_id: int = -1,
        trip_factor: int = 1,
        n_pairs_per_src: float = 1.0,
    ) -> None:
        """record_collective-style scalar append of one op.

        Wire bytes are derived from the ring model and trip-scaled, exactly
        as the batched path does; ``operand_bytes`` is the *unscaled* value
        (scaling is applied here).
        """
        self.names.append(name)
        self.op_names.append(op_name)
        self._kind.push(_KIND_ID[kind])
        self._region.push(self._regions.intern(region))
        self._result.push(result_bytes)
        self._operand.push(operand_bytes * trip_factor)
        wire = _wire_bytes(
            kind, result_bytes, operand_bytes, group_size, n_pairs_per_src
        )
        self._wire.push(wire * trip_factor)
        self._gsize.push(group_size)
        self._ngroups.push(n_groups)
        self._channel.push(channel_id)
        self._trip.push(trip_factor)

    def extend_ops(
        self,
        *,
        names: list,
        op_names: list,
        kind_ids: np.ndarray,
        region_ids: np.ndarray,
        result_bytes: np.ndarray,
        operand_bytes: np.ndarray,
        group_size: np.ndarray,
        n_groups: np.ndarray,
        channel_ids: np.ndarray,
        trip_factors: np.ndarray,
        n_pairs_per_src: np.ndarray,
    ) -> None:
        """Batched append; wire bytes are computed vectorized over the batch.

        ``region_ids`` must already be interned through :meth:`region_id`;
        ``operand_bytes`` is unscaled (trip scaling is applied here, to both
        operand and wire bytes, matching the reference's loop scaling).
        """
        self.names.extend(names)
        self.op_names.extend(op_names)
        self._kind.extend(kind_ids)
        self._region.extend(region_ids)
        self._result.extend(result_bytes)
        self._operand.extend(operand_bytes * trip_factors)
        wire = _wire_bytes_batch(
            kind_ids, result_bytes, operand_bytes, group_size, n_pairs_per_src
        )
        self._wire.extend(wire * trip_factors)
        self._gsize.extend(group_size)
        self._ngroups.extend(n_groups)
        self._channel.extend(channel_ids)
        self._trip.extend(trip_factors)

    # -- views --------------------------------------------------------------

    def op(self, i: int) -> CollectiveOp:
        """Materialize the i-th op as a :class:`CollectiveOp` view."""
        if not 0 <= i < self.n_ops:
            raise IndexError(i)
        return CollectiveOp(
            name=self.names[i],
            kind=self.kind_names[self.kind_ids[i]],
            result_bytes=int(self.result_bytes[i]),
            operand_bytes=int(self.operand_bytes[i]),
            group_size=int(self.group_size[i]),
            n_groups=int(self.n_groups[i]),
            wire_bytes=int(self.wire_bytes[i]),
            region=self.region_names[self.region_ids[i]],
            op_name=self.op_names[i],
            channel_id=int(self.channel_ids[i]),
            trip_factor=int(self.trip_factors[i]),
        )

    def to_ops(self) -> list:
        """All ops as :class:`CollectiveOp` views (adapter path only)."""
        return [self.op(i) for i in range(self.n_ops)]

    def summarize(self) -> "CollectiveSummary":
        """Aggregate the buffer in one vectorized pass.

        Bit-identical to ``summarize_collectives(self.to_ops())`` including
        the first-appearance ordering of the ``by_kind`` / ``by_region``
        tables (sums accumulate in int64, never float).
        """
        s = CollectiveSummary()
        n = self.n_ops
        s.n_ops = n
        if not n:
            return s
        wire = self.wire_bytes
        s.total_wire_bytes = int(wire.sum())
        s.total_operand_bytes = int(self.operand_bytes.sum())
        for ids, table, out in (
            (self.kind_ids, self.kind_names, s.by_kind),
            (self.region_ids, self.region_names, s.by_region),
        ):
            size = max(len(table), 1)
            counts = np.bincount(ids, minlength=size)
            sums = np.zeros(size, np.int64)
            np.add.at(sums, ids, wire)
            uniq, first = np.unique(ids, return_index=True)
            for code in uniq[np.argsort(first, kind="stable")]:
                out[table[code]] = (int(counts[code]), int(sums[code]))
        return s


def _wire_bytes_batch(
    kind_ids, result_b, operand_b, group_size, n_pairs_per_src
) -> np.ndarray:
    """Vectorized ring-model wire bytes (same arithmetic as _wire_bytes).

    Evaluation order and float64 rounding match the scalar reference
    exactly (int64 numerator, one float division, truncation toward zero).
    """
    gs = np.maximum(group_size, 1)  # guard the division; masked below
    frac = (gs - 1) / gs
    wire = np.select(
        [
            kind_ids == _KIND_ID["all-reduce"],
            kind_ids == _KIND_ID["all-gather"],
            kind_ids == _PERMUTE_ID,
        ],
        [
            2 * (gs - 1) / gs * operand_b,
            frac * result_b,
            result_b * n_pairs_per_src,
        ],
        default=frac * operand_b,  # reduce-scatter / all-to-all / broadcast
    )
    wire = wire.astype(np.int64)
    wire[(group_size <= 1) & (kind_ids != _PERMUTE_ID)] = 0
    return wire


# ---------------------------------------------------------------------------
# Single-pass columnar scanner
# ---------------------------------------------------------------------------


def scan_hlo_collectives(
    hlo_text: str,
    total_devices: Optional[int] = None,
    *,
    with_loops: bool = False,
    buffer: Optional[HloCollectiveBuffer] = None,
) -> HloCollectiveBuffer:
    """Scan compiled HLO text into a columnar :class:`HloCollectiveBuffer`.

    One pass over the text tokenizes every instruction (result types for
    operand lookup, collective ops by kind); the collected per-op fields
    are then resolved and appended as batched NumPy columns — no
    :class:`CollectiveOp` objects are built.

    ``with_loops=True`` scales ops inside while bodies by the call-graph
    execution factors (:func:`computation_factors`), recording the factor
    in the ``trip_factors`` column; ops in unreachable computations
    (factor 0) are dropped.  Operand lookup is then per-computation,
    matching the reference's per-computation parse.
    """
    buf = buffer if buffer is not None else HloCollectiveBuffer()
    comp_names = ["<preamble>"]
    # ``types`` receives every instruction's result type: in loop mode it
    # is rebound per computation (per-computation operand lookup, matching
    # the reference's per-computation parse); in plain mode it stays one
    # module-global dict.
    types: dict = {}
    comp_types: list = [types]
    entry = None
    cur = 0
    raw = []  # (name, type_str, kind, rest, comp_index)
    header_offsets = []  # text offset of each header line (comp k+1)
    base_kind = _base_kind_cached

    # One multiline finditer over the whole text: headers and instructions
    # arrive in text order, so the current computation is a running index,
    # and non-matching lines (braces, blanks) never reach Python.
    for m in _SCAN_M_RE.finditer(hlo_text):
        name, type_str, opkind = m.group(3, 4, 5)
        if name is None:  # "[ENTRY ]%name (args) -> type {" header
            comp_names.append(m.group(2))
            cur = len(comp_names) - 1
            header_offsets.append(m.start())
            if with_loops:  # plain mode keeps one global type dict
                types = {}
            comp_types.append(types)
            if m.group(1):
                entry = m.group(2)
            continue
        types[name] = type_str
        kind = base_kind(opkind)
        if kind is not None:
            raw.append((name, type_str, kind, m.group(6), cur))

    if with_loops:
        if entry is None:
            # no ENTRY marker: loop scaling is undefined; rescan plain
            # (same unscaled behavior as the reference's fallback)
            return scan_hlo_collectives(hlo_text, total_devices, buffer=buf)
        comp_factor = _relax_factors(
            comp_names, _edge_lines(hlo_text, header_offsets), entry
        )
    loops = with_loops

    rows = []
    shape_bytes = _shape_bytes_cached
    for name, type_str, kind, rest, ci in raw:
        if loops:
            factor = comp_factor[ci]
            if factor == 0:
                continue
            types = comp_types[ci]
        else:
            factor = 1
        result_b = shape_bytes(type_str)
        # Operand bytes: sum of referenced operand result types (first
        # paren-group only — cut at first "),", without copying the tail).
        cut = rest.find("),")
        if cut < 0:
            cut = 0  # no attribute section; searches start at 0 either way
        operand_b = 0
        for op in _OPERANDS_RE.findall(rest, 0, cut if cut else len(rest)):
            ts = types.get(op)
            if ts is not None:
                operand_b += shape_bytes(ts)
        if operand_b == 0:
            operand_b = result_b

        # attributes always follow the operand close-paren: every search
        # below starts at ``cut`` instead of rescanning the operand list
        n_pairs_per_src = 1.0
        if kind == "collective-permute":
            pairs_m = _PAIRS_RE.search(rest, cut)
            if pairs_m:
                pairs = _PAIR_RE.findall(pairs_m.group(0))
                srcs = [int(a) for a, _ in pairs]
                if srcs:
                    n_pairs_per_src = max(Counter(srcs).values())
                group_size, n_groups = (total_devices or len(set(srcs)) or 1), 1
            else:
                group_size, n_groups = _parse_groups(rest, total_devices, cut)
        else:
            group_size, n_groups = _parse_groups(rest, total_devices, cut)

        op_name = ""
        k = rest.find('op_name="', cut)
        if k >= 0:
            e = rest.find('"', k + 9)  # len('op_name="') == 9
            if e >= 0:
                op_name = rest[k + 9 : e]

        channel = -1
        k = rest.find("channel_id=", cut)
        while k >= 0:  # first occurrence followed by digits, like the regex
            m2 = _DIGITS_RE.match(rest, k + 11)
            if m2 is not None:
                channel = int(m2.group())
                break
            k = rest.find("channel_id=", k + 11)

        rows.append(
            (
                name,
                op_name,
                _KIND_ID[kind],
                buf.region_id(_region_cached(op_name)),
                result_b,
                operand_b,
                group_size,
                n_groups,
                channel,
                factor,
                n_pairs_per_src,
            )
        )

    cols = tuple(zip(*rows)) if rows else ((),) * 11
    buf.extend_ops(
        names=list(cols[0]),
        op_names=list(cols[1]),
        kind_ids=np.asarray(cols[2], np.int32),
        region_ids=np.asarray(cols[3], np.int32),
        result_bytes=np.asarray(cols[4], np.int64),
        operand_bytes=np.asarray(cols[5], np.int64),
        group_size=np.asarray(cols[6], np.int64),
        n_groups=np.asarray(cols[7], np.int64),
        channel_ids=np.asarray(cols[8], np.int64),
        trip_factors=np.asarray(cols[9], np.int64),
        n_pairs_per_src=np.asarray(cols[10], np.float64),
    )
    return buf


def _edge_lines(hlo_text: str, header_offsets: list) -> list:
    """(comp_index, line) candidates for the call-graph factor walk.

    One keyword sweep over the whole module text (instead of a per-line
    check); hits map back to their line and computation via the header
    offsets the tokenizer recorded.  Mirrors the reference's per-line
    scan: each computation's lines[0] — the header, or the file's first
    line for the preamble — contributes no edges.
    """
    # str.find sweeps (memchr-accelerated) instead of one alternation
    # regex — alternations with no shared literal prefix step per char
    positions = []
    for token in _EDGE_TOKENS:
        i = hlo_text.find(token)
        while i >= 0:
            positions.append(i)
            i = hlo_text.find(token, i + 1)
    positions.sort()

    header_set = set(header_offsets)
    out = []
    last_start = -1
    n = len(hlo_text)
    for pos in positions:
        start = hlo_text.rfind("\n", 0, pos) + 1
        if start == last_start:
            continue  # several keywords on one line
        last_start = start
        if start in header_set or start == 0:
            continue  # comp lines[0] never contribute edges
        end = hlo_text.find("\n", pos)
        line = hlo_text[start : end if end >= 0 else n]
        ci = bisect.bisect_right(header_offsets, start)
        out.append((ci, line))
    return out


def _relax_factors(comp_names: list, edge_lines: list, entry: str) -> list:
    """Per-computation-index execution factors from scan-collected lines.

    The same while detection, edge multipliers, relaxation, and rounding
    as :func:`computation_factors`, but fed by the scanner's single pass
    (``edge_lines`` holds the keyword-prefiltered candidate lines with
    their computation index) instead of re-splitting the module text.
    """
    known = set(comp_names)
    edges: dict = {c: [] for c in comp_names}
    for ci, line in edge_lines:
        cname = comp_names[ci]
        # every spelling of the while dispatch requires the substring
        if "while" in line and (
            " while(" in line
            or line.strip().startswith("%while")
            or _WHILE_EXPR_RE.search(line)
        ):
            body_m = _WHILE_BODY_RE.search(line)
            trip_m = _TRIP_RE.search(line)
            trip = int(trip_m.group(1)) if trip_m else 1
            for ref_m in _CALLS_RE.finditer(line):
                child = ref_m.group(1)
                mult = trip if (body_m and child == body_m.group(1)) else 1
                if child in known:
                    edges[cname].append((child, mult))
        else:
            for ref_m in _CALLS_RE.finditer(line):
                child = ref_m.group(1)
                if child in known:
                    edges[cname].append((child, 1))

    factors: dict = {c: 0.0 for c in known}
    factors[entry] = 1.0
    for _ in range(len(known) + 2):
        changed = False
        new = {c: 0.0 for c in known}
        new[entry] = 1.0
        for parent, out in edges.items():
            for child, mult in out:
                new[child] += factors[parent] * mult
        for c in known:
            if abs(new[c] - factors[c]) > 1e-9:
                changed = True
        factors = new
        if not changed:
            break
    final = {c: max(1, int(round(f))) if f > 0 else 0 for c, f in factors.items()}
    return [final[c] for c in comp_names]


# ---------------------------------------------------------------------------
# The port's compiled layer: collectives read from a captured graph
# ---------------------------------------------------------------------------

#: The instrumented collectives' custom ops (``torch.ops.repro_torch.<op>``)
#: and the HLO kind each one is in ``repro``'s compiled programs: ``pmean``,
#: ``pmin`` and ``pbroadcast`` are all-reduces there too (``repro`` realizes
#: a broadcast as a masked psum).
GRAPH_KINDS = {
    "ppermute": "collective-permute",
    "psum": "all-reduce",
    "pmean": "all-reduce",
    "pmax": "all-reduce",
    "pmin": "all-reduce",
    "pbroadcast": "all-reduce",
    "all_gather": "all-gather",
    "psum_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
}


#: The functional collectives that DTensor inserts between placements
#: (``torch.ops._c10d_functional.<op>``; ``wait_tensor`` is skipped) and
#: their HLO kind; each names its process group in its last argument.
C10D_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _node_bytes(node) -> int:
    val = node.meta.get("val", node.meta.get("example_value"))
    return val.numel() * val.element_size()


def _group_ranks(group) -> tuple:
    import torch.distributed as dist

    return tuple(sorted(dist.get_process_group_ranks(group)))


def _mesh_axes_of(device_mesh):
    """group name -> the mesh axes that process group spans, for a
    ``torch.distributed`` DeviceMesh: its own group of each dimension, or
    else a group of the same ranks (an equal mesh made again has groups of
    its own, and DTensor may run on either)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    by_name, by_ranks = {}, {}
    for d, name in enumerate(device_mesh.mesh_dim_names):
        group = device_mesh.get_group(d)
        by_name[group.group_name] = (name,)
        by_ranks.setdefault(_group_ranks(group), (name,))

    def axes(group_name: str) -> tuple:
        hit = by_name.get(group_name)
        if hit is None:
            hit = by_ranks.get(_group_ranks(_resolve_process_group(group_name)))
        if hit is None:
            raise ValueError(f"process group {group_name!r} is not a dimension of "
                             f"the device mesh {device_mesh}")
        return hit

    return axes


def graph_collectives(
    graph,
    *,
    mesh=None,
    total_devices: int,
    device_mesh=None,
) -> HloCollectiveBuffer:
    """Every collective node of an FX ``graph`` (in graph order) as an
    :class:`HloCollectiveBuffer`, one row a node: the ``repro_torch``
    instrumented collectives, and the ``_c10d_functional`` collectives that
    DTensor inserts on ``device_mesh`` (a DeviceMesh; ``mesh`` then
    defaults to its axes).

    The graph may come from ``make_fx`` or from a ``torch.compile``
    backend.  A ``repro_torch`` node's arguments carry its axis key, static
    parameters and region path (Dynamo drops ``record_function`` scopes, so
    the path travels as an argument); a ``_c10d_functional`` node names its
    process group, mapped to mesh axes through ``DeviceMesh.get_group``,
    and takes its region path from the ``comm_region`` annotation that
    :func:`~repro_torch.core.regions.comm_region` stamps on the nodes
    captured inside it.  The row's ``op_name`` is
    ``"commr::a/commr::b/<kind>"``, so the region is the innermost one, as
    :func:`scan_hlo_collectives` attributes it.  Groups are
    ``Topology.groups(axis)`` over ``mesh``; a permute counts as one group
    of ``total_devices``, with ``n_pairs_per_src`` taken from the executed
    perm's global pairs, as the HLO scanner takes it from
    ``source_target_pairs``.  Bytes are per device, from the nodes' shapes.
    """
    from repro_torch.core.compat import make_mesh
    from repro_torch.core.topology import Topology

    if mesh is None:
        mesh = make_mesh(device_mesh.mesh.shape, device_mesh.mesh_dim_names)
    mesh_axes = _mesh_axes_of(device_mesh) if device_mesh is not None else None
    buf = HloCollectiveBuffer()
    topo = Topology(list(zip(mesh.axis_names, mesh.axis_sizes)))
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        # an OpOverload (make_fx) names its schema; Dynamo keeps the packet
        schema = getattr(node.target, "_schema", None)
        qualified = schema.name if schema is not None else getattr(
            node.target, "_qualified_op_name", "")
        namespace, _, opname = qualified.partition("::")
        if namespace == "repro_torch" and opname in GRAPH_KINDS:
            kind = GRAPH_KINDS[opname]
            names = tuple(node.args[1].split(","))
            path = node.args[-1]
        elif namespace == "_c10d_functional" and opname in C10D_KINDS:
            if mesh_axes is None:
                raise ValueError(f"{node.name}: a DTensor collective needs the "
                                 "device mesh (device_mesh=)")
            kind = C10D_KINDS[opname]
            names = mesh_axes(node.args[-1])
            path = node.meta.get("custom", {}).get("comm_region", "")
        else:
            continue
        rows = topo.groups(names)  # row[j]: global rank of axis index j
        path = [r for r in path.split("/") if r]
        op_name = "/".join([f"commr::{r}" for r in path] + [kind])
        n_pairs_per_src = 1.0
        if kind == "collective-permute":
            perm = node.args[2]
            srcs = rows[:, list(perm[0::2])].reshape(-1)
            if srcs.size:
                n_pairs_per_src = max(Counter(srcs.tolist()).values())
            group_size, n_groups = total_devices or len(set(srcs.tolist())) or 1, 1
        else:
            n_groups, group_size = (int(d) for d in rows.shape)
        buf.append_op(
            name=node.name,
            kind=kind,
            result_bytes=_node_bytes(node),
            operand_bytes=_node_bytes(node.args[0]),
            group_size=group_size,
            n_groups=n_groups,
            region=_region_cached(op_name),
            op_name=op_name,
            n_pairs_per_src=n_pairs_per_src,
        )
    return buf


def _to_meta(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to("meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def scan_graph_collectives(
    fn,
    *args,
    mesh,
    total_devices: int,
) -> HloCollectiveBuffer:
    """The port's compiled collective layer of ``fn(*args)``.

    ``fn`` is the per-rank program (or a ``compat.shard_map`` over it);
    it is captured with ``make_fx`` on meta copies of ``args`` inside
    ``mesh``'s axis environment, which needs no process group and no
    device: the collectives' custom ops trace through their fake
    implementations.  :func:`graph_collectives` then reads the graph.

    What the layer is: the collectives the program calls, one row per
    custom-op call, **before** any combiner or scheduler pass.  It is not
    post-XLA HLO: where XLA merges ops (``repro``'s beatnik folds three
    ``reduce_norm`` psums into one all-reduce), this layer keeps each op.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core import compat

    with compat.axis_env(mesh):
        gm = make_fx(fn)(*_to_meta(args))
    return graph_collectives(gm.graph, mesh=mesh, total_devices=total_devices)


def capture_graph_collectives(fn, *args, device_mesh) -> HloCollectiveBuffer:
    """The compiled collective layer of a DTensor program on this rank.

    ``fn(*args)`` runs once, for real (its collectives execute on the
    process group and its in-place updates land), under ``make_fx``, which
    records every op DTensor dispatches to this rank's shards: the
    ``_c10d_functional`` collectives it inserts between placements among
    them.  Node metadata is preserved and the regions annotate
    (:func:`~repro_torch.core.regions.annotating`), so each node carries the
    ``comm_region`` path it ran in (a backward node the path its backward
    ran in).  :func:`graph_collectives` reads the graph on ``device_mesh``.
    Like :func:`scan_graph_collectives`, the layer is the collectives as
    the program issues them, before any combiner or scheduler pass.
    """
    import torch.fx.traceback as fx_traceback
    from torch.fx.experimental.proxy_tensor import make_fx

    with fx_traceback.preserve_node_meta(), annotating():
        gm = make_fx(fn)(*args)
    return graph_collectives(gm.graph, total_devices=device_mesh.size(),
                             device_mesh=device_mesh)


def parse_hlo_collectives(hlo_text: str, total_devices: Optional[int] = None) -> list:
    """Extract every collective op from compiled HLO text.

    Adapter over the columnar scanner: returns :class:`CollectiveOp` views
    (per-device byte accounting).  Prefer :func:`scan_hlo_collectives` when
    the buffer itself is wanted.
    """
    return scan_hlo_collectives(hlo_text, total_devices).to_ops()


def parse_hlo_collectives_with_loops(
    hlo_text: str, total_devices: Optional[int] = None
) -> list:
    """Like parse_hlo_collectives, but scales ops inside while bodies by the
    loop trip count (call-graph walk; unscaled if no trip count recorded)."""
    return scan_hlo_collectives(hlo_text, total_devices, with_loops=True).to_ops()


@dataclass
class CollectiveSummary:
    """Aggregate of all collectives in one compiled program (per device)."""

    total_wire_bytes: int = 0  # ring-model bytes over a device link
    total_operand_bytes: int = 0  # raw operand-size sum (assignment metric)
    n_ops: int = 0
    by_kind: dict = field(default_factory=dict)  # kind -> (count, wire_bytes)
    by_region: dict = field(default_factory=dict)  # region -> (count, wire_bytes)

    def to_dict(self) -> dict:
        return asdict(self)


def summarize_collectives(ops) -> CollectiveSummary:
    """Aggregate collectives: a buffer (vectorized) or an op list (reference).

    The op-list path is the original per-op dict accounting, retained as
    the executable specification ``HloCollectiveBuffer.summarize`` is
    parity-tested against.
    """
    if isinstance(ops, HloCollectiveBuffer):
        return ops.summarize()
    s = CollectiveSummary()
    for op in ops:
        s.n_ops += 1
        s.total_wire_bytes += op.wire_bytes
        s.total_operand_bytes += op.operand_bytes
        c, b = s.by_kind.get(op.kind, (0, 0))
        s.by_kind[op.kind] = (c + 1, b + op.wire_bytes)
        c, b = s.by_region.get(op.region, (0, 0))
        s.by_region[op.region] = (c + 1, b + op.wire_bytes)
    return s


# ---------------------------------------------------------------------------
# Reference implementation (executable spec, parity-tested)
# ---------------------------------------------------------------------------


def parse_hlo_collectives_reference(
    hlo_text: str, total_devices: Optional[int] = None
) -> list:
    """The original per-op parse: one CollectiveOp dataclass per op.

    Retained as the executable specification for the columnar scanner —
    ``tests/test_hlo_golden.py`` / ``tests/test_hlo_property.py`` assert
    :func:`scan_hlo_collectives` is bit-identical to this on the golden
    corpus and on randomized synthetic modules.
    """
    # First pass: result type of every instruction, for operand lookup.
    result_types: dict = {}
    instrs = []
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, type_str, opkind, rest = m.groups()
        result_types[name] = type_str
        instrs.append((name, type_str, opkind, rest))

    ops: list = []
    for name, type_str, opkind, rest in instrs:
        kind = _base_kind(opkind)
        if kind is None:
            continue
        result_b = _shape_bytes(type_str)
        arg_str = rest.split("),", 1)[0]
        operand_b = 0
        for op in _OPERANDS_RE.findall(arg_str):
            if op in result_types:
                operand_b += _shape_bytes(result_types[op])
        if operand_b == 0:
            operand_b = result_b

        pairs_m = _PAIRS_RE.search(rest)
        n_pairs_per_src = 1.0
        if kind == "collective-permute" and pairs_m:
            pairs = _PAIR_RE.findall(pairs_m.group(0))
            srcs = [int(a) for a, _ in pairs]
            if srcs:
                n_pairs_per_src = max(Counter(srcs).values())
            group_size, n_groups = (total_devices or len(set(srcs)) or 1), 1
        else:
            group_size, n_groups = _parse_groups(rest, total_devices)

        opname_m = _OPNAME_RE.search(rest)
        op_name = opname_m.group(1) if opname_m else ""
        ch_m = _CHANNEL_RE.search(rest)

        ops.append(
            CollectiveOp(
                name=name,
                kind=kind,
                result_bytes=result_b,
                operand_bytes=operand_b,
                group_size=group_size,
                n_groups=n_groups,
                wire_bytes=_wire_bytes(
                    kind, result_b, operand_b, group_size, n_pairs_per_src
                ),
                region=_region_from_op_name(op_name),
                op_name=op_name,
                channel_id=int(ch_m.group(1)) if ch_m else -1,
            )
        )
    return ops


def parse_hlo_collectives_with_loops_reference(
    hlo_text: str, total_devices: Optional[int] = None
) -> list:
    """Reference loop-scaled parse (per-computation dict accounting)."""
    comps, entry = split_computations(hlo_text)
    if entry is None:
        return parse_hlo_collectives_reference(hlo_text, total_devices)
    factors = computation_factors(hlo_text)
    ops: list = []
    for cname, lines in comps.items():
        factor = factors.get(cname, 1)
        if factor == 0:
            continue
        for op in parse_hlo_collectives_reference("\n".join(lines), total_devices):
            op.wire_bytes *= factor
            op.operand_bytes *= factor
            op.trip_factor = factor
            ops.append(op)
    return ops


# ---------------------------------------------------------------------------
# While-loop trip-count scaling
# ---------------------------------------------------------------------------
# Scanned layer stacks put per-layer collectives inside a while loop; the HLO
# body appears once but executes trip-count times.  cost_analysis() already
# multiplies by trip count; for wire bytes we do the same by walking the HLO
# call graph: factor(body) = factor(parent) * known_trip_count, summed over
# call sites.  XLA records ``backend_config={"known_trip_count":{"n":"62"}}``
# on while ops lowered from jax.lax.scan.

_COMP_HEADER_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-$]+)\s*\(.*\{\s*$")
_WHILE_BODY_RE = re.compile(r"body=%?([\w.\-$]+)")
_TRIP_RE = re.compile(r'known_trip_count[^0-9]*?(\d+)')
_CALLS_RE = re.compile(r"(?:calls=|to_apply=|condition=|body=)%?([\w.\-$]+)")


def split_computations(hlo_text: str) -> tuple:
    """Split HLO text into (name -> lines); returns (comps, entry_name)."""
    comps: dict = {}
    entry = None
    name = "<preamble>"
    comps[name] = []
    for line in hlo_text.splitlines():
        m = _COMP_HEADER_RE.match(line)
        if m:
            name = m.group(2)
            comps[name] = []
            if m.group(1):
                entry = name
        comps[name].append(line)
    return comps, entry


def computation_factors(hlo_text: str) -> dict:
    """Execution count of each computation, propagated from the entry.

    While bodies multiply by known trip count; calls/fusions/conditions
    propagate the parent factor.  Multiple call sites accumulate.
    Invariants (property-tested): the entry's factor is 1, factors
    multiply along nested while edges, unreachable computations get 0.
    """
    comps, entry = split_computations(hlo_text)
    # edges: parent -> list of (child, multiplier)
    edges: dict = {c: [] for c in comps}
    for cname, lines in comps.items():
        for line in lines[1:] if lines else []:
            if (
                " while(" in line
                or line.strip().startswith("%while")
                or re.search(r"=\s*\([^=]*\)\s*while\(", line)
            ):
                body_m = _WHILE_BODY_RE.search(line)
                trip_m = _TRIP_RE.search(line)
                trip = int(trip_m.group(1)) if trip_m else 1
                for ref_m in _CALLS_RE.finditer(line):
                    child = ref_m.group(1)
                    mult = trip if (body_m and child == body_m.group(1)) else 1
                    if child in comps:
                        edges[cname].append((child, mult))
            else:
                for ref_m in _CALLS_RE.finditer(line):
                    child = ref_m.group(1)
                    if child in comps:
                        edges[cname].append((child, 1))

    factors: dict = {c: 0.0 for c in comps}
    if entry is None:
        # No ENTRY marker: treat every computation as executed once.
        return {c: 1 for c in comps}
    factors[entry] = 1.0
    # Propagate in topological-ish order via repeated relaxation (call
    # graphs are small DAGs; bound the iteration count defensively).
    for _ in range(len(comps) + 2):
        changed = False
        new = {c: 0.0 for c in comps}
        new[entry] = 1.0
        for parent, out in edges.items():
            for child, mult in out:
                new[child] += factors[parent] * mult
        for c in comps:
            if abs(new[c] - factors[c]) > 1e-9:
                changed = True
        factors = new
        if not changed:
            break
    return {c: max(1, int(round(f))) if f > 0 else 0 for c, f in factors.items()}
