"""Public wrappers for the model kernels, as the models call them.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, or the call raises.  Inside :func:`plain`, CUDA
tensors go to the plain versions too: tests and ``chip_smoke.py`` use it to
hold the model with kernels against the same model without them on the
card.  Nothing on the serving path enters it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
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


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B,Hq,Sq,D); k/v (B,Hkv,Sk,D) -> (B,Hq,Sq,D); see the kernel module."""
    if _plain_depth:
        return _flash.flash_attention_plain(q, k, v, causal=causal)
    return _flash.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k, v, kv_len: int) -> torch.Tensor:
    """q (B,Hq,1,D) over keys [0, kv_len) of k/v (B,Hkv,S,D) -> (B,Hq,1,D)."""
    if _plain_depth:
        return _decode.decode_attention_plain(q, k, v, kv_len)
    return _decode.decode_attention(q, k, v, kv_len)


def ssd_scan(xh, la, Bm, Cm, h0=None, *, block_q: int = 128) -> tuple:
    """xh (B,S,H,P), la (B,S,H), Bm/Cm (B,S,N) -> (y, h_final (B,H,P,N) f32)."""
    if _plain_depth:
        return _ssd.ssd_scan_plain(xh, la, Bm, Cm, h0, block_q=block_q)
    return _ssd.ssd_scan(xh, la, Bm, Cm, h0, block_q=block_q)


def mlstm_scan(q, k, v, lf, li, state=None, *, block_q: int = 128) -> tuple:
    """q/k/v (B,S,H,D), lf/li (B,S,H) -> (h (B,S,H,D) f32, (C, n, m) f32)."""
    if _plain_depth:
        return _mlstm.mlstm_scan_plain(q, k, v, lf, li, state, block_q=block_q)
    return _mlstm.mlstm_scan(q, k, v, lf, li, state, block_q=block_q)


_KERNELS = {
    "flash_attention": _flash,
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
