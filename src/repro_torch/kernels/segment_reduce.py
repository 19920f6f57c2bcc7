"""Segmented sum / max / min over contiguous row spans.

The port of ``repro/core/backend.py::_pallas_segment_reduce`` to a kernel
written by hand for Hopper: ``csrc/segment_reduce.cu``, CUDA C++ for
``sm_90a``, built with ``nvcc`` at first use and loaded with ``ctypes``
(see :mod:`repro_torch.kernels._build`).  The source's header says how it
is laid out; in short, a thread block reduces one contiguous run of rows,
threads reduce their column in registers, and warp shuffles plus a small
shared-memory table fold the block.  It is bound by memory (it reads the
``N x C`` values once).  So that a span far longer than the others does
not leave one SM doing most of the work, the rows are cut at every
multiple of :func:`rows_per_piece`: a span longer than that is reduced
by its own block up to the first cut and by one block a cut from there,
and a second launch combines its pieces.  :func:`pieces` is the plain
statement of that plan; the kernel follows it from the spans alone, with
nothing planned on the host.  Where ``N`` is at most one piece there is
no cut and the kernel runs once, one block a span.

:func:`segment_reduce` is the wrapper.  For a tensor on the CPU it runs
:func:`segment_reduce_plain`, the plain PyTorch version of the same
function; for a CUDA tensor it launches the kernel or raises — there is no
fallback.  Each call that launches the kernel (one launch or two) adds one
to :func:`launch_count`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/segment_reduce.cu"

OPS = ("sum", "max", "min")

_OP_CODE = {"sum": 0, "max": 1, "min": 2}
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}

#: dtypes the kernel takes.
DTYPES = tuple(_DTYPE_CODE)

#: Values (rows x columns) between two cuts: 2^23 rows of one int64 column
#: make 256 pieces.  The H100 holds 1056 of the kernel's blocks at once (8
#: an SM), so these pieces fill a quarter of one wave; the rest of a call's
#: blocks take the other spans.  Of 2^13-2^16, 2^15 was fastest at the giant
#: span and no slower elsewhere (``tools/segment_reduce_times.py``).
PIECE_ELEMS = 1 << 15

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def init_value(op: str, dtype: torch.dtype):
    """Identity of ``op`` in ``dtype``: 0, or the type's lowest / highest."""
    if op == "sum":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _check(vals, starts, ends, op) -> None:
    if op not in OPS:
        raise ValueError(f"unknown segment op {op!r} (expected one of {OPS})")
    if vals.dim() != 2:
        raise ValueError(f"vals must be 2-D (N, C), got shape {tuple(vals.shape)}")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_reduce takes {DTYPES}, got {vals.dtype}")
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
    if starts.shape != ends.shape:
        raise ValueError("starts and ends differ in length")
    if not (vals.is_contiguous() and starts.is_contiguous() and ends.is_contiguous()):
        raise ValueError("segment_reduce needs contiguous tensors")


def rows_per_piece(n_cols: int) -> int:
    """Rows of ``n_cols`` columns in one piece of the first pass."""
    return max(1, PIECE_ELEMS // max(1, n_cols))


def cut_count(n_rows: int, rows: int) -> int:
    """Cuts inside ``n_rows`` rows, one every ``rows`` rows: ``ceil(n_rows /
    rows) - 1``, or 0."""
    return max(0, -(-n_rows // rows) - 1)


def pieces(starts: torch.Tensor, ends: torch.Tensor, n_rows: int, rows: int) -> tuple:
    """The pieces the kernel reduces, as ``(span, lo, hi)`` int64 tensors.

    The rows are cut at every multiple of ``rows`` below ``n_rows``.  Piece
    ``s`` (one a span, in span order) covers span ``s`` whole, or, where
    the span is longer than ``rows``, up to the first cut above its start;
    then, for each cut in order that lies inside such a long span past its
    first row, a piece covers that span from the cut to the next cut or the
    span's end.  An empty span keeps its one, empty, piece.  The spans must
    be in order (``starts[s] <= ends[s] <= starts[s + 1]``).  Plain version
    for the tests: the kernel finds the same pieces itself.
    """
    n_spans = starts.shape[0]
    long = ends - starts > rows
    first_cut = (torch.div(starts, rows, rounding_mode="floor") + 1) * rows
    own_hi = torch.where(long, first_cut, ends)
    x = torch.arange(1, cut_count(n_rows, rows) + 1, dtype=torch.int64, device=starts.device)
    x = x * rows
    span = torch.searchsorted(starts, x) - 1  # the last span starting below x
    held = span.clamp_min(0)
    inside = (span >= 0) & (ends[held] > x) & long[held]
    span, x = span[inside], x[inside]
    return (
        torch.cat([torch.arange(n_spans, device=starts.device), span]),
        torch.cat([starts, x]),
        torch.cat([own_hi, torch.minimum(x + rows, ends[span])]),
    )


def segment_reduce_plain(
    vals: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor, op: str
) -> torch.Tensor:
    """Plain PyTorch version: one reduction per span, stacked.

    ``vals`` is ``(N, C)``; span ``s`` covers rows ``starts[s]:ends[s]``.
    An empty span gives the identity of ``op`` (:func:`init_value`), as the
    kernel does.
    """
    n_cols = vals.shape[1]
    rows = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        span = vals[s:e]
        if e <= s:
            rows.append(vals.new_full((n_cols,), init_value(op, vals.dtype)))
        elif op == "sum":
            rows.append(span.sum(dim=0, dtype=vals.dtype))
        elif op == "max":
            rows.append(span.amax(dim=0))
        else:
            rows.append(span.amin(dim=0))
    if not rows:
        return vals.new_empty((0, n_cols))
    return torch.stack(rows)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("segment_reduce")
    fn = lib.repro_segment_reduce
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def segment_reduce(
    vals: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor, op: str
) -> torch.Tensor:
    """Reduce each span of rows of ``vals (N, C)`` into one ``(S, C)`` row.

    ``starts`` / ``ends`` are int64 ``(S,)`` on the device of ``vals``; the
    spans must lie inside ``[0, N)`` and be in order, ``starts[s] <=
    ends[s] <= starts[s + 1]`` (the kernel checks neither;
    :func:`~repro_torch.core.backend.segment_spans` gives such spans, as
    the TPU kernel's sorted segment ids did).  ``op`` is ``"sum"``,
    ``"max"`` or ``"min"``.  A CPU tensor runs :func:`segment_reduce_plain`;
    a CUDA tensor launches the kernel on the current stream: once where
    ``N`` fits one piece, else a launch over the spans and the cuts'
    pieces (:func:`pieces`) and one that combines each long span's pieces.
    """
    _check(vals, starts, ends, op)
    if vals.device.type == "cpu":
        return segment_reduce_plain(vals, starts, ends, op)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_reduce runs on cpu or cuda, not {vals.device}")
    global _launches
    lib = _library()
    n, n_cols = vals.shape
    n_spans = starts.shape[0]
    rows = rows_per_piece(n_cols)
    n_cuts = cut_count(n, rows) if n_spans else 0
    # the result, then the cuts' partial rows, in one allocation
    out = torch.empty((n_spans + n_cuts, n_cols), dtype=vals.dtype, device=vals.device)
    partial = None
    if n_cuts:
        out, partial = out[:n_spans], out[n_spans:]
    if n_spans == 0 or n_cols == 0:
        return out
    with torch.cuda.device(vals.device):
        err = lib.repro_segment_reduce(
            vals.data_ptr(),
            starts.data_ptr(),
            ends.data_ptr(),
            out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            n_spans,
            n_cuts,
            n_cols,
            rows,
            _DTYPE_CODE[vals.dtype],
            _OP_CODE[op],
            torch.cuda.current_stream(vals.device).cuda_stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"segment_reduce kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    return out
