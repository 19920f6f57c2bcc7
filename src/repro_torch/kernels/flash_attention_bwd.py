"""The gradient of blocked attention: dQ, dK and dV (every training step).

A kernel of the port with no TPU counterpart: the JAX package's models
never call its Pallas kernels, and ``jax.value_and_grad`` differentiates
the plain attention through XLA.  The port's train step runs the forward
kernel (:mod:`repro_torch.kernels.flash_attention`), so its gradient is a
kernel too: ``csrc/flash_attention_bwd.cu``, CUDA C++ for ``sm_90a``, built
with ``nvcc`` at first use and loaded with ``ctypes`` (see
:mod:`repro_torch.kernels._build`).  It is chosen by dtype:

* bf16 (the training dtype) runs on the tensor cores from the log-sum-exp
  that the forward stored (``flash_attention(..., return_lse=True)``): a
  pass computes ``Delta = rowsum(dO * O)``; one block per (b, q head, key
  tile) accumulates that head's dK and dV with ``wgmma`` while TMA streams
  Q and dO tiles through a ring; one block per (b, q head, query tile)
  accumulates dQ while TMA streams K and V.  With more than one query head
  a kv head (GQA, MQA), each query head's dK and dV go to f32 scratch
  (:func:`group_scratch_shape`) and a last pass sums each group in head
  order (:func:`group_sum_plain` is its plain version).  TMA needs 16-byte
  aligned bases and (b, h, s) strides of q, k, v and dout, and lse rows a
  multiple of 4 floats apart: the wrapper copies a tensor that breaks this
  (counted by :func:`copy_count`) rather than refusing it.
* f32 runs the SIMT kernels of the first version: one recomputes each query
  row's log-sum-exp and Delta, then dQ; one accumulates dK and dV over its
  group's query heads; products on the CUDA cores in f32.  It takes no lse.

No kernel uses atomics, so two calls give equal bits.  The function is the
forward kernel's: GQA / MQA with the kv head ``h // (Hq // Hkv)``, causal
with the queries at the end of the keys or non-causal with any Sq and Sk,
head dims {32, 64, 128, 256}.  The gradients come back in the input's
dtype, as autograd of
:func:`~repro_torch.kernels.flash_attention.flash_attention_plain` gives
them.

:func:`flash_attention_bwd` is the wrapper.  For tensors on the CPU it runs
:func:`flash_attention_bwd_plain`, that autograd; for CUDA tensors it
launches the kernel or raises: there is no fallback.  Each call adds one
to :func:`launch_count` (one call is two to four CUDA kernels).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    _DTYPE_CODE,
    check_kernel_inputs,
    check_qkv,
    flash_attention_plain,
    is_aligned,
)

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"

_launches = 0
_copies = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches, _copies
    _launches = 0
    _copies = 0


def copy_count() -> int:
    """Inputs the bf16 route copied into a layout TMA takes, since the last
    :func:`reset_launch_count`."""
    return _copies


def flash_attention_bwd_plain(q, k, v, dout, *, causal: bool = True) -> tuple:
    """Plain PyTorch version: ``torch.autograd`` of ``flash_attention_plain``.

    Returns (dq, dk, dv) in q's dtype for the output gradient ``dout``.
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, dout)


def group_scratch_shape(q, k) -> tuple | None:
    """The f32 scratch of the bf16 route's GQA split: each query head's dK
    and dV, (2, B, Hq, Sk, D); None when every kv head has one query head
    (dK and dV are then written directly)."""
    b, hq, _, d = q.shape
    if hq == k.shape[1]:
        return None
    return (2, b, hq, k.shape[2], d)


def group_sum_plain(scratch: torch.Tensor, n_kv_heads: int, dtype) -> tuple:
    """Plain version of the group-sum pass: (dk, dv) (B, Hkv, Sk, D) in
    ``dtype`` from the (2, B, Hq, Sk, D) f32 scratch, each kv head the sum
    of its query heads added in head order, from 0."""
    _, b, hq, sk, d = scratch.shape
    group = scratch.view(2, b, n_kv_heads, hq // n_kv_heads, sk, d)
    acc = torch.zeros((2, b, n_kv_heads, sk, d), dtype=torch.float32,
                      device=scratch.device)
    for g in range(group.shape[3]):
        acc = acc + group[:, :, :, g]
    return acc[0].to(dtype), acc[1].to(dtype)


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if TMA can read it (unit head-dim stride, 16-byte aligned base
    and (b, h, s) strides), else a contiguous copy, counted."""
    global _copies
    if t.stride(-1) == 1 and is_aligned(t):
        return t
    _copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def lse_rows(lse: torch.Tensor) -> tuple:
    """(rows, ld): the forward's (B, Hq, Sq) log-sum-exp as the bf16 route
    reads it, row (b, h) at ``(b * Hq + h) * ld`` with ``ld`` a multiple of
    4 floats (a TMA stride) and the base 16-byte aligned: ``lse`` itself
    where it has that layout, else a padded copy, counted."""
    global _copies
    b, hq, sq = lse.shape
    padded = -(-sq // 4) * 4
    ld = lse.stride(1) if hq > 1 else lse.stride(0) if b > 1 else padded
    if (lse.stride(2) == 1 and ld >= sq and ld % 4 == 0 and lse.data_ptr() % 16 == 0
            and (b == 1 or lse.stride(0) == hq * ld)):
        return lse, ld
    _copies += 1
    rows = torch.zeros((b, hq, padded), dtype=torch.float32, device=lse.device)
    rows[:, :, :sq] = lse
    return rows, padded


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        lse: torch.Tensor | None = None) -> tuple:
    """(dq, dk, dv) of attention for q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D), the
    forward's ``out`` and its gradient ``dout`` (B,Hq,Sq,D).

    A CPU tensor runs :func:`flash_attention_bwd_plain` (which recomputes
    ``out``); a CUDA tensor launches the kernel on the current stream.  The
    bf16 kernel needs ``lse``, the (B,Hq,Sq) f32 log-sum-exp that
    ``flash_attention(..., return_lse=True)`` returned beside ``out``; the
    f32 kernel recomputes it and does not read ``lse``.
    """
    check_qkv(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(
            f"causal attention needs Sq <= Sk, got {q.shape[2]} > {k.shape[2]}"
        )
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal)
    check_kernel_inputs("flash_attention_bwd", q)
    global _launches
    lib = _library()
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, sk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or sk == 0:
        return dq, dk.zero_(), dv.zero_()
    scratch = None
    if q.dtype == torch.bfloat16:
        if lse is None:
            raise ValueError(
                "the bf16 flash_attention_bwd kernel takes the forward's "
                "log-sum-exp: pass lse= from flash_attention(..., return_lse=True)"
            )
        if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or lse.device != q.device:
            raise ValueError(
                f"lse {tuple(lse.shape)} {lse.dtype} on {lse.device}: expected "
                f"{(b, hq, sq)} float32 on {q.device}"
            )
        q, k, v, dout = (_tma_ready(t) for t in (q, k, v, dout))
        out = out if out.stride(-1) == 1 else out.contiguous()
        lse, ld = lse_rows(lse)
        delta = torch.empty((b, hq, ld), dtype=torch.float32, device=q.device)
        shape = group_scratch_shape(q, k)
        if shape is not None:
            scratch = torch.empty(shape, dtype=torch.float32, device=q.device)
    else:
        q, k, v, out, dout = (
            t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, out, dout)
        )
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        delta, ld = torch.empty_like(lse), sq
    tensors = [q, k, v, out, dout, dq, dk, dv]
    strides = (ctypes.c_int64 * 24)(*[s for t in tensors for s in t.stride()[:3]])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            *[t.data_ptr() for t in tensors],
            lse.data_ptr(),
            delta.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            ctypes.addressof(strides),
            b,
            hq,
            hkv,
            sq,
            sk,
            d,
            _DTYPE_CODE[q.dtype],
            int(causal),
            ld,
            stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"flash_attention_bwd kernel failed: CUDA error {err}: {msg}"
        )
    _launches += 1
    return dq, dk, dv
