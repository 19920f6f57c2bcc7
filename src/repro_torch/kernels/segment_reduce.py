"""Segmented sum / max / min over contiguous row spans.

The port of ``repro/core/backend.py::_pallas_segment_reduce`` to a kernel
written by hand for Hopper: ``csrc/segment_reduce.cu``, CUDA C++ for
``sm_90a``, built with ``nvcc`` at first use and loaded with ``ctypes``
(see :mod:`repro_torch.kernels._build`).  The source's header says how it
is laid out; in short, one thread block owns one span, threads reduce
their column in registers, and warp shuffles plus a small shared-memory
table fold the block.  It is bound by memory (it reads the ``N x C``
values once), and a span far longer than the others leaves one block
doing most of the work; splitting long spans is later work.

:func:`segment_reduce` is the wrapper.  For a tensor on the CPU it runs
:func:`segment_reduce_plain`, the plain PyTorch version of the same
function; for a CUDA tensor it launches the kernel or raises — there is no
fallback.  Each launch adds one to :func:`launch_count`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/segment_reduce.cu"

OPS = ("sum", "max", "min")

_OP_CODE = {"sum": 0, "max": 1, "min": 2}
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}

#: dtypes the kernel takes.
DTYPES = tuple(_DTYPE_CODE)

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


def _library() -> ctypes.CDLL:
    lib = _build.load("segment_reduce")
    fn = lib.repro_segment_reduce
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64,
        ctypes.c_int64,
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

    ``starts`` / ``ends`` are int64 ``(S,)`` on the device of ``vals``, and
    every span must lie inside ``[0, N)`` (the kernel does not check).
    ``op`` is ``"sum"``, ``"max"`` or ``"min"``.  A CPU tensor runs
    :func:`segment_reduce_plain`; a CUDA tensor launches the kernel on the
    current stream.
    """
    _check(vals, starts, ends, op)
    if vals.device.type == "cpu":
        return segment_reduce_plain(vals, starts, ends, op)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_reduce runs on cpu or cuda, not {vals.device}")
    global _launches
    lib = _library()
    n_spans, n_cols = starts.shape[0], vals.shape[1]
    out = torch.empty((n_spans, n_cols), dtype=vals.dtype, device=vals.device)
    if n_spans == 0 or n_cols == 0:
        return out
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.repro_segment_reduce(
            vals.data_ptr(),
            starts.data_ptr(),
            ends.data_ptr(),
            out.data_ptr(),
            n_spans,
            n_cols,
            _DTYPE_CODE[vals.dtype],
            _OP_CODE[op],
            stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"segment_reduce kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    return out
