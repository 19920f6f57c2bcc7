"""One query token over a preallocated KV cache (every decode step).

The port of ``repro/kernels/decode_attention.py::decode_attention`` to
kernels written by hand for Hopper: ``csrc/decode_attention.cu``, CUDA C++
for ``sm_90a``, built with ``nvcc`` at first use and loaded with ``ctypes``.
It is bound by the bytes of K and V up to ``kv_len``, so it splits the keys
across blocks (split-K) to read from enough SMs at once.  :func:`split_plan`
cuts ``[0, kv_len)`` into ranges; one block per (batch row, kv head, group
of up to 8 query heads, range) walks its range in 64-key tiles staged by
16-byte ``cp.async`` copies, double-buffered, with an f32 online softmax, and
writes its partial (max, sum, accumulator) in f32; a second kernel combines
the ranges.  With one range the first kernel writes the output itself.
Asked for it, the last kernel also writes each row's log-sum-exp, ``max +
log(sum)``, by which the outputs over several slices of a cache merge.

:func:`decode_attention` is the wrapper: a CPU tensor runs
:func:`decode_attention_plain` (``repro/kernels/ref.py::decode_attention_ref``
with the exclusive ``kv_len`` of the TPU kernel); a CUDA tensor launches the
kernels or raises.  Each call adds one to :func:`launch_count`, however many
CUDA kernels it runs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    _DTYPE_CODE,
    NEG_INF,
    check_aligned,
    check_kernel_inputs,
    check_qkv,
    kernel_args,
)

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/decode_attention.cu"

#: a range's length is a multiple of this, so that every range but the last
#: is whole 64-key tiles (the kernel takes any length)
SPLIT_ALIGN = 64
#: the least keys a range reads, unless the cache holds fewer
MIN_SPLIT_KEYS = 128

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


def split_plan(
    batch: int,
    n_kv_heads: int,
    group: int,
    kv_len: int,
    *,
    sms: int,
    blocks_per_sm: int,
) -> tuple:
    """(n_split, keys_per_split): how the decode kernel cuts ``[0, kv_len)``.

    Range ``i`` is ``[i * keys_per_split, min((i + 1) * keys_per_split,
    kv_len))``; the ranges tile the keys exactly once and none is empty.
    The ranges times the (batch row, kv head, group of 8 query heads) blocks
    come to at most one wave of ``blocks_per_sm * sms`` resident blocks (a
    second, partial wave runs at a fraction of the memory rate), as many as
    fit; each range is at least ``MIN_SPLIT_KEYS`` long but the last, and
    ``keys_per_split`` is a multiple of ``SPLIT_ALIGN``.  A cache of up to
    ``MIN_SPLIT_KEYS`` keys, or a batch that fills the wave by itself, is
    one range.  :func:`card_wave` gives a card's ``sms`` and
    ``blocks_per_sm``; :func:`card_split_plan` is the plan the wrapper uses.
    """
    if kv_len < 1:
        raise ValueError(f"kv_len {kv_len} < 1")
    blocks = batch * n_kv_heads * -(-group // 8)
    want = blocks_per_sm * sms // max(blocks, 1)
    n_split = max(1, min(want, kv_len // MIN_SPLIT_KEYS))
    per = -(-kv_len // n_split)
    per = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-kv_len // per), per


def _scores_plain(q, k, kv_len: int) -> torch.Tensor:
    """The scaled f32 scores (B,Hq,1,S), NEG_INF past ``kv_len``."""
    d = q.shape[-1]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = torch.arange(k.shape[2], device=q.device) < kv_len
    return torch.where(mask, scores, NEG_INF)


def decode_attention_plain(q, k, v, kv_len: int, *, return_lse: bool = False):
    """Plain PyTorch version: the direct definition, f32 softmax.

    q (B,Hq,1,D); k/v (B,Hkv,S,D); keys ``[0, kv_len)`` are attended.  With
    ``return_lse``, also the log-sum-exp the kernel writes: each row's
    natural log-sum-exp of its scaled scores, (B,Hq,1) f32.
    """
    kv_len = int(kv_len)
    _check(q, k, v, kv_len)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        v = v.repeat_interleave(rep, dim=1)
    scores = _scores_plain(q, k, kv_len)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
    return (out, torch.logsumexp(scores, dim=-1)) if return_lse else out


def _library() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = lib.repro_decode_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, err: int, what: str) -> None:
    msg = lib.repro_cuda_error_string(err).decode()
    raise RuntimeError(f"decode_attention {what} failed: CUDA error {err}: {msg}")


@functools.lru_cache(maxsize=None)
def card_wave(device: torch.device, dtype: torch.dtype, head_dim: int) -> dict:
    """``sms`` and ``blocks_per_sm`` of :func:`split_plan` on a card: its SMs
    and how many blocks of the partial kernel for (dtype, head_dim) one SM
    holds at once (the CUDA occupancy calculator's answer)."""
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.repro_decode_blocks_per_sm(
            head_dim, _DTYPE_CODE[dtype], ctypes.byref(blocks)
        )
    if err:
        _raise(lib, err, "occupancy query")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"sms": sms, "blocks_per_sm": blocks.value}


def card_split_plan(q, k, kv_len: int) -> tuple:
    """The :func:`split_plan` that :func:`decode_attention` uses for CUDA
    tensors q (B,Hq,1,D) and k (B,Hkv,S,D) on their card."""
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    wave = card_wave(q.device, q.dtype, d)
    return split_plan(b, hkv, hq // hkv, int(kv_len), **wave)


def decode_attention(q, k, v, kv_len: int, *, return_lse: bool = False):
    """q (B,Hq,1,D) over keys ``[0, kv_len)`` of k/v (B,Hkv,S,D) -> (B,Hq,1,D).

    ``kv_len`` is a host int, exclusive.  A CPU tensor runs
    :func:`decode_attention_plain`; a CUDA tensor launches the kernels on the
    current stream, with the keys cut by :func:`split_plan`.  With
    ``return_lse`` the result is ``(out, lse)``, lse the (B,Hq,1) f32
    log-sum-exp of each row's scores (on the CPU, that of
    :func:`decode_attention_plain`), which merges the outputs of
    several slices of one cache.
    """
    kv_len = int(kv_len)
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, return_lse=return_lse)
    check_kernel_inputs("decode_attention", q)
    global _launches
    lib = _library()
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    out = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, 1), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    q, k, v, strides = kernel_args(q, k, v, out)
    check_aligned("decode_attention", k, v)
    n_split, per = card_split_plan(q, k, kv_len)
    part_acc = part_ml = None
    if n_split > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part_acc = torch.empty((b, hq, n_split, d), **f32)
        part_ml = torch.empty((b, hq, n_split, 2), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            ctypes.addressof(strides),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b,
            hq,
            hkv,
            kv_len,
            d,
            _DTYPE_CODE[q.dtype],
            n_split,
            per,
            stream,
        )
    if err:
        _raise(lib, err, "kernel")
    _launches += 1
    return (out, lse) if return_lse else out
