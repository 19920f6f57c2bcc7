"""Per-computation FLOP/byte accounting: post-SPMD HLO text, and captured graphs.

The port of ``repro/core/hlo_cost.py``, plus its counterpart for the graphs
the port captures (:func:`graph_cost`).

XLA's ``compiled.cost_analysis()`` counts a while-loop body **once**, so any
scan-over-layers model under-reports FLOPs/bytes by ~n_layers.
:func:`analyze_cost` re-derives both from the HLO text per computation and
scales by the call-graph execution factors
(:func:`repro_torch.core.hlo.computation_factors` — the same machinery the
collective analyzer uses), giving trip-count-correct totals.

FLOPs: ``dot`` ops contribute 2 * prod(result_dims) * prod(contracting_dims)
(read from ``lhs_contracting_dims`` + the lhs operand shape).  Elementwise
FLOPs are ignored (sub-percent for transformer workloads).

Bytes: every top-level instruction that represents a real kernel (fusion,
dot, reduce, data movement, collectives) contributes operand + result bytes
— the same convention cost_analysis uses for "bytes accessed" on fused
post-optimization HLO.

:func:`analyze_cost` runs on the collective analyzer's **single-pass
tokenizer**: one ``_SCAN_M_RE`` finditer over the whole module text yields
computation headers and instructions in order (no per-computation
re-split and no per-line regex dispatch), shape-byte and dimension parsing
are memoized per distinct type string, and the call-graph factors relax
from the same pass's keyword-prefiltered edge candidates
(``repro_torch.core.hlo._edge_lines`` / ``_relax_factors``).  The original
two-pass implementation is retained as :func:`analyze_cost_reference` —
the executable specification the tokenizer path is parity-tested against.

:func:`graph_cost` counts a ``torch.fx`` graph (``make_fx`` of a step) by
the same conventions: FLOPs of the products only, bytes as operand +
result bytes of every node that launches a kernel.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

from repro_torch.core.hlo import (
    _INSTR_RE,
    _OPERANDS_RE,
    _SCAN_M_RE,
    _edge_lines,
    _relax_factors,
    _shape_bytes,
    _shape_bytes_cached,
    computation_factors,
    split_computations,
)

_SHAPE_DIMS_RE = re.compile(r"[a-z0-9]+\[([0-9,]*)\]")
_LHS_C_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_CALLEE_RE = re.compile(r"calls=%?([\w.\-$]+)")
_TO_APPLY_RE = re.compile(r"to_apply=%?([\w.\-$]+)")

# ops that move memory (post-fusion top-level kernels)
# fmt: off
_MEM_OPS = {
    "fusion", "dot", "convolution", "reduce", "copy", "transpose",
    "broadcast", "concatenate", "pad", "slice", "reverse", "convert",
    "dynamic-slice", "dynamic-update-slice", "gather", "scatter",
    "reduce-window", "select-and-scatter", "iota", "rng", "sort", "map",
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "custom-call", "cholesky",
    "triangular-solve", "exp", "log", "tanh", "add", "multiply", "subtract",
    "divide", "maximum", "minimum", "compare", "select", "and", "or", "not",
    "clamp", "rsqrt", "sqrt", "power", "negate", "abs", "sign", "floor",
    "ceil", "round-nearest-afz", "cbrt", "logistic", "sine", "cosine",
    "atan2", "rem", "shift-left", "shift-right-logical", "xor",
}
# fmt: on


def _dims(type_str: str) -> list:
    m = _SHAPE_DIMS_RE.search(type_str)
    if not m or not m.group(1):
        return []
    return [int(d) for d in m.group(1).split(",") if d]


#: type-string -> dims memo (shapes repeat heavily within a module; the
#: tokenizer path resolves each distinct type string once).
_DIMS_MEMO: dict = {}


def _dims_cached(type_str: str) -> list:
    d = _DIMS_MEMO.get(type_str)
    if d is None:
        d = _dims(type_str)
        if len(_DIMS_MEMO) < 65536:
            _DIMS_MEMO[type_str] = d
    return d


@dataclass
class CostSummary:
    flops: float = 0.0  # per-device, trip-count-scaled
    bytes_accessed: float = 0.0  # per-device, trip-count-scaled
    dot_flops_unscaled: float = 0.0


def _accumulate(parsed, result_types, factors, shape_bytes, dims) -> CostSummary:
    """Shared accounting core over pre-tokenized instruction rows.

    ``parsed`` maps computation name -> [(name, type_str, opkind, rest)]
    in appearance order; ``factors`` maps names to execution counts.
    ``shape_bytes`` / ``dims`` let the tokenizer path plug in the memoized
    parsers while the reference keeps the plain ones — the arithmetic and
    accumulation order are identical either way (bit-identical floats).
    """
    # Fusion bodies and reduction combiners are *inlined* kernels: their
    # traffic is the fusion op's operand/result bytes at the call site.
    inlined: set = set()
    for rows in parsed.values():
        for _name, _type_str, opkind, rest in rows:
            if opkind == "fusion":
                for m in _CALLEE_RE.finditer(rest):
                    inlined.add(m.group(1))
            if "to_apply=" in rest:
                for m in _TO_APPLY_RE.finditer(rest):
                    inlined.add(m.group(1))

    out = CostSummary()
    for cname, rows in parsed.items():
        factor = factors.get(cname, 1)
        if factor == 0 or cname in inlined:
            continue
        for _name, type_str, opkind, rest in rows:
            base = opkind[:-6] if opkind.endswith("-start") else opkind
            if base.endswith("-done"):
                continue
            if base == "dot":
                res = dims(type_str)
                lhs_m = _OPERANDS_RE.search(rest)
                k = 1
                cm = _LHS_C_RE.search(rest)
                if lhs_m and cm and lhs_m.group(1) in result_types:
                    lhs_dims = dims(result_types[lhs_m.group(1)])
                    for ci in (int(c) for c in cm.group(1).split(",") if c):
                        if ci < len(lhs_dims):
                            k *= lhs_dims[ci]
                fl = 2.0 * math.prod(res) * k if res else 0.0
                out.flops += factor * fl
                out.dot_flops_unscaled += fl
            if base in _MEM_OPS:
                b = shape_bytes(type_str)
                arg_str = rest.split("),", 1)[0]
                for op in _OPERANDS_RE.findall(arg_str):
                    if op in result_types:
                        b += shape_bytes(result_types[op])
                out.bytes_accessed += factor * b
    return out


def analyze_cost(hlo_text: str) -> CostSummary:
    """Trip-count-scaled FLOP/byte totals via the single-pass tokenizer."""
    comp_names = ["<preamble>"]
    header_offsets: list = []
    entry = None
    result_types: dict = {}
    parsed: dict = {"<preamble>": []}
    rows = parsed["<preamble>"]
    for m in _SCAN_M_RE.finditer(hlo_text):
        name, type_str, opkind = m.group(3, 4, 5)
        if name is None:  # "[ENTRY ]%name (args) -> type {" header
            cname = m.group(2)
            comp_names.append(cname)
            header_offsets.append(m.start())
            # duplicate names replace earlier content, like the
            # reference's split_computations
            parsed[cname] = []
            rows = parsed[cname]
            if m.group(1):
                entry = cname
            continue
        result_types[name] = type_str
        rows.append((name, type_str, opkind, m.group(6)))

    if entry is not None:
        edge_lines = _edge_lines(hlo_text, header_offsets)
        factors = dict(zip(comp_names, _relax_factors(comp_names, edge_lines, entry)))
    else:
        factors = {c: 1 for c in comp_names}
    return _accumulate(
        parsed, result_types, factors, _shape_bytes_cached, _dims_cached
    )


def analyze_cost_reference(hlo_text: str) -> CostSummary:
    """The original two-pass accounting (per-computation re-parse).

    Retained as the executable specification :func:`analyze_cost` is
    parity-tested against on the golden HLO corpus.
    """
    comps, entry = split_computations(hlo_text)
    factors = computation_factors(hlo_text) if entry else {c: 1 for c in comps}

    # result types for operand lookup (global namespace is fine: names are
    # unique across computations in post-optimization HLO)
    result_types: dict = {}
    parsed: dict = {}
    for cname, lines in comps.items():
        rows = []
        for line in lines:
            m = _INSTR_RE.match(line)
            if not m:
                continue
            name, type_str, opkind, rest = m.groups()
            result_types[name] = type_str
            rows.append((name, type_str, opkind, rest))
        parsed[cname] = rows

    return _accumulate(parsed, result_types, factors, _shape_bytes, _dims)


# ---------------------------------------------------------------------------
# Captured torch.fx graphs
# ---------------------------------------------------------------------------

#: the aten products, as ``repro`` counts only ``dot``: ``make_fx`` leaves
#: ``einsum``, ``matmul`` and ``linear`` as these
_PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")

#: ops that allocate without launching a kernel
_NO_KERNEL = ("empty", "empty_like", "empty_strided", "empty_permuted", "wait_tensor")


def tensors_in(value) -> list:
    """The tensors in a node's value or argument (a list, tuple or dict of
    them, or nested)."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in tensors_in(v)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in tensors_in(v)]
    return []


def node_value(node):
    """The tensor (or tree of tensors) ``make_fx`` recorded for ``node``."""
    return node.meta.get("val", node.meta.get("example_value"))


def _arg_values(node) -> list:
    """The tensors a call node reads: its arguments' recorded values."""
    import torch.fx

    out = []

    def visit(a):
        if isinstance(a, torch.fx.Node):
            out.extend(tensors_in(node_value(a)))
        return a

    torch.fx.node.map_arg((node.args, node.kwargs), visit)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def is_view(node) -> bool:
    """Whether a call node returns aliases of its inputs and writes nothing
    (a view, ``detach``, ``getitem``): it launches no kernel."""
    import operator

    if node.target is operator.getitem:
        return True
    schema = getattr(node.target, "_schema", None)
    if schema is None or not schema.returns:
        return False
    return all(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns)


def node_flops(node) -> float:
    """2 x the multiply-adds of a product node (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``), from its recorded values; 0 for any other node."""
    packet = getattr(node.target, "overloadpacket", None)
    name = getattr(packet, "__name__", "")
    if node.op != "call_function" or name not in _PRODUCTS:
        return 0.0
    out = node_value(node)
    a = node_value(node.args[1] if name in ("addmm", "baddbmm") else node.args[0])
    return 2.0 * math.prod(out.shape) * a.shape[-1]


def node_bytes(node) -> int:
    """Operand + result bytes of a call node that launches a kernel; 0 for a
    view, an alias, an allocation, a ``wait_tensor`` or a non-call node."""
    if node.op != "call_function" or is_view(node):
        return 0
    packet = getattr(node.target, "overloadpacket", None)
    if getattr(packet, "__name__", "") in _NO_KERNEL:
        return 0
    return (sum(_nbytes(t) for t in tensors_in(node_value(node)))
            + sum(_nbytes(t) for t in _arg_values(node)))


def graph_cost(gm) -> CostSummary:
    """FLOPs and bytes of a captured ``torch.fx`` graph (``gm`` a
    ``GraphModule`` or its ``graph``), per device: the graph of a DTensor
    step holds the ops of one rank's shards.

    The conventions are :func:`analyze_cost`'s.  FLOPs are the products'
    only (:func:`node_flops`), as ``repro`` counts only ``dot``: no
    convolution and no elementwise op.  Bytes are operand + result bytes of
    every node that launches a kernel (:func:`node_bytes`).  A graph has no
    loops, so every factor is 1 and ``dot_flops_unscaled == flops``.

    The byte count is not ``repro``'s quantity: it is of the eager, unfused
    aten ops the graph records, each reading its operands and writing its
    result in memory, where ``repro`` counts XLA's fused kernels, whose
    intermediates stay on chip.  So it is larger than a fused program's
    traffic, and the two are not compared.
    """
    graph = getattr(gm, "graph", gm)
    out = CostSummary()
    for node in graph.nodes:
        fl = node_flops(node)
        out.flops += fl
        out.dot_flops_unscaled += fl
        out.bytes_accessed += node_bytes(node)
    return out
