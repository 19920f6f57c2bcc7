"""One query token over a preallocated KV cache (every decode step).

The port of ``repro/kernels/decode_attention.py::decode_attention`` to a
kernel written by hand for Hopper: ``csrc/decode_attention.cu``, CUDA C++
for ``sm_90a``, built with ``nvcc`` at first use and loaded with ``ctypes``.
One thread block owns one (batch row, kv head) and serves up to 8 query
heads of its group, looping over 64-key K/V tiles of ``[0, kv_len)`` with an
f32 online softmax, so each K/V row is read once per group.  It is bound by
the bytes of K and V up to ``kv_len``; with one block per (b, kv head) a
small batch leaves most SMs idle (split-K is later work).

:func:`decode_attention` is the wrapper: a CPU tensor runs
:func:`decode_attention_plain` (``repro/kernels/ref.py::decode_attention_ref``
with the exclusive ``kv_len`` of the TPU kernel); a CUDA tensor launches the
kernel or raises.  Each launch adds one to :func:`launch_count`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    _DTYPE_CODE,
    NEG_INF,
    check_kernel_inputs,
    check_qkv,
    kernel_args,
)

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/decode_attention.cu"

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _check(q, k, v, kv_len: int) -> None:
    check_qkv(q, k, v)
    if q.shape[2] != 1:
        raise ValueError(f"decode attention takes one query row, got {q.shape[2]}")
    if not 1 <= kv_len <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[2]}]")


def decode_attention_plain(q, k, v, kv_len: int) -> torch.Tensor:
    """Plain PyTorch version: the direct definition, f32 softmax.

    q (B,Hq,1,D); k/v (B,Hkv,S,D); keys ``[0, kv_len)`` are attended.
    """
    kv_len = int(kv_len)
    _check(q, k, v, kv_len)
    d = q.shape[-1]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = torch.arange(k.shape[2], device=q.device) < kv_len
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention(q, k, v, kv_len: int) -> torch.Tensor:
    """q (B,Hq,1,D) over keys ``[0, kv_len)`` of k/v (B,Hkv,S,D) -> (B,Hq,1,D).

    ``kv_len`` is a host int, exclusive.  A CPU tensor runs
    :func:`decode_attention_plain`; a CUDA tensor launches the kernel on the
    current stream.
    """
    kv_len = int(kv_len)
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    check_kernel_inputs("decode_attention", q)
    global _launches
    lib = _library()
    b, hq, _, d = q.shape
    out = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q, k, v, strides = kernel_args(q, k, v, out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            ctypes.addressof(strides),
            b,
            hq,
            k.shape[1],
            kv_len,
            d,
            _DTYPE_CODE[q.dtype],
            stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    return out
