"""Public wrappers for the model kernels, as the models call them.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, or the call raises.  Inside :func:`plain`, CUDA
tensors go to the plain versions too: tests and ``chip_smoke.py`` use it to
hold the model with kernels against the same model without them on the
card.  Nothing on the serving or training path enters it.

Gradients: :func:`flash_attention` on a CUDA input that needs one runs
through :class:`FlashAttention`, whose forward also stores each query
row's log-sum-exp and whose backward is the hand-written backward kernel
(:mod:`repro_torch.kernels.flash_attention_bwd`), which reads it.  The SSD
and mLSTM scans have no backward kernel yet, so on such an input they
raise; CPU tensors take the plain versions, which autograd differentiates.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import mlstm_scan as _mlstm
from repro_torch.kernels import ssd_scan as _ssd

_plain_depth = 0


@contextlib.contextmanager
def plain() -> Iterator[None]:
    """Route CUDA tensors to the plain versions for the duration."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def _needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these CUDA tensors."""
    return (
        torch.is_grad_enabled()
        and tensors[0].device.type == "cuda"
        and any(t is not None and t.requires_grad for t in tensors)
    )


class FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _flash.flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd.flash_attention_bwd(
            q, k, v, out, dout, causal=ctx.causal, lse=lse
        )
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B,Hq,Sq,D); k/v (B,Hkv,Sk,D) -> (B,Hq,Sq,D); see the kernel module."""
    if _plain_depth:
        return _flash.flash_attention_plain(q, k, v, causal=causal)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _flash.flash_attention(q, k, v, causal=causal)


def _no_backward(name: str, item: str, *tensors) -> None:
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel yet (ROADMAP queue 1 item {item}): "
            "a CUDA input that needs a gradient cannot go through it"
        )


def decode_attention(q, k, v, kv_len: int) -> torch.Tensor:
    """q (B,Hq,1,D) over keys [0, kv_len) of k/v (B,Hkv,S,D) -> (B,Hq,1,D)."""
    if _plain_depth:
        return _decode.decode_attention_plain(q, k, v, kv_len)
    return _decode.decode_attention(q, k, v, kv_len)


def ssd_scan(xh, la, Bm, Cm, h0=None, *, block_q: int = 128) -> tuple:
    """xh (B,S,H,P), la (B,S,H), Bm/Cm (B,S,N) -> (y, h_final (B,H,P,N) f32)."""
    if _plain_depth:
        return _ssd.ssd_scan_plain(xh, la, Bm, Cm, h0, block_q=block_q)
    _no_backward("ssd_scan", "9b", xh, la, Bm, Cm, h0)
    return _ssd.ssd_scan(xh, la, Bm, Cm, h0, block_q=block_q)


def mlstm_scan(q, k, v, lf, li, state=None, *, block_q: int = 128) -> tuple:
    """q/k/v (B,S,H,D), lf/li (B,S,H) -> (h (B,S,H,D) f32, (C, n, m) f32)."""
    if _plain_depth:
        return _mlstm.mlstm_scan_plain(q, k, v, lf, li, state, block_q=block_q)
    _no_backward("mlstm_scan", "9c", q, k, v, lf, li, *(state or ()))
    return _mlstm.mlstm_scan(q, k, v, lf, li, state, block_q=block_q)


_KERNELS = {
    "flash_attention": _flash,
    "flash_attention_bwd": _flash_bwd,
    "decode_attention": _decode,
    "ssd_scan": _ssd,
    "mlstm_scan": _mlstm,
}


def launch_counts() -> dict:
    """Kernel launches of each model kernel since the last reset."""
    return {name: mod.launch_count() for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.reset_launch_count()
