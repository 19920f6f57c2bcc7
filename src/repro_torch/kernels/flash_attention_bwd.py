"""The gradient of blocked attention: dQ, dK and dV (every training step).

A kernel of the port with no TPU counterpart: the JAX package's models
never call its Pallas kernels, and ``jax.value_and_grad`` differentiates
the plain attention through XLA.  The port's train step runs the forward
kernel (:mod:`repro_torch.kernels.flash_attention`), so its gradient is a
kernel too: ``csrc/flash_attention_bwd.cu``, CUDA C++ for ``sm_90a``, built
with ``nvcc`` at first use and loaded with ``ctypes`` (see
:mod:`repro_torch.kernels._build`).  One call runs two CUDA kernels: one
block per (b, q head, query tile) recomputes each query row's log-sum-exp
and ``Delta = rowsum(dO * O)``, then accumulates dQ; one block per (b, kv
head, key tile) accumulates dK and dV over its group's query heads.  Both
compute in f32 on the CUDA cores, for bf16 and f32 inputs alike, and use
no atomics, so two calls give equal bits.

The function is the forward kernel's: GQA / MQA with the kv head
``h // (Hq // Hkv)``, causal with the queries at the end of the keys or
non-causal with any Sq and Sk, head dims {32, 64, 128, 256}, bf16 or f32.
The gradients come back in the input's dtype, as autograd of
:func:`~repro_torch.kernels.flash_attention.flash_attention_plain` gives
them.

:func:`flash_attention_bwd` is the wrapper.  For tensors on the CPU it runs
:func:`flash_attention_bwd_plain`, that autograd; for CUDA tensors it
launches the kernel or raises: there is no fallback.  Each call adds one
to :func:`launch_count` (one call is two CUDA kernels).
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
)

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def flash_attention_bwd_plain(q, k, v, dout, *, causal: bool = True) -> tuple:
    """Plain PyTorch version: ``torch.autograd`` of ``flash_attention_plain``.

    Returns (dq, dk, dv) in q's dtype for the output gradient ``dout``.
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, dout)


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True) -> tuple:
    """(dq, dk, dv) of attention for q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D), the
    forward's ``out`` and its gradient ``dout`` (B,Hq,Sq,D).

    A CPU tensor runs :func:`flash_attention_bwd_plain` (which recomputes
    ``out``); a CUDA tensor launches the kernel on the current stream.  Any
    layout with a unit head-dim stride goes to the kernel as it is; another
    is copied.
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
    ins = [t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, out, dout)]
    tensors = [*ins, dq, dk, dv]
    strides = (ctypes.c_int64 * 24)(*[s for t in tensors for s in t.stride()[:3]])
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            *[t.data_ptr() for t in tensors],
            lse.data_ptr(),
            delta.data_ptr(),
            ctypes.addressof(strides),
            b,
            hq,
            hkv,
            sq,
            sk,
            d,
            _DTYPE_CODE[q.dtype],
            int(causal),
            stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"flash_attention_bwd kernel failed: CUDA error {err}: {msg}"
        )
    _launches += 1
    return dq, dk, dv
