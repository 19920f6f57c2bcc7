"""Public wrappers for the attention kernels, as the models call them.

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


def launch_counts() -> dict:
    """Kernel launches of each attention kernel since the last reset."""
    return {
        "flash_attention": _flash.launch_count(),
        "decode_attention": _decode.launch_count(),
    }


def reset_launch_counts() -> None:
    _flash.reset_launch_count()
    _decode.reset_launch_count()
