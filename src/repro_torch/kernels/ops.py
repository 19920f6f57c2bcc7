"""Public wrappers for the model kernels, as the models call them.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, or the call raises.  Inside :func:`plain`, CUDA
tensors go to the plain versions too: tests and ``chip_smoke.py`` use it to
hold the model with kernels against the same model without them on the
card, and the dry run (``launch/dryrun.py``) to capture the plain math.
Nothing on the serving or training path enters it.

Gradients: each forward kernel on a CUDA input that needs one runs through
a ``torch.autograd.Function`` whose backward is a hand-written backward
kernel: :class:`FlashAttention` (its forward also stores each query row's
log-sum-exp, which :mod:`repro_torch.kernels.flash_attention_bwd` reads),
:class:`SSDScan` (:mod:`repro_torch.kernels.ssd_scan_bwd`) and
:class:`MLSTMScan` (:mod:`repro_torch.kernels.mlstm_scan_bwd`).  CPU tensors
take the plain versions, which autograd differentiates; the Functions also
run on CPU tensors (their backward then takes the plain backward), which is
how the CPU tests hold them to that autograd.

Under a device mesh the kernels take DTensors (:func:`_on_shards`): a
custom op has no DTensor sharding rule, so each call redistributes its
inputs to the placements the kernel can take (batch on the plan's data
axes, attention heads on ``model`` where the plan shards both query and
KV heads there, sequence and head dims whole; DTensor inserts the
all-gathers GSPMD would), then runs the same wrapper on this rank's local
shards through ``local_map``: the kernel on the card (with no plain
fallback), the plain version on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import mlstm_scan as _mlstm
from repro_torch.kernels import mlstm_scan_bwd as _mlstm_bwd
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssd_bwd

_plain_depth = 0


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _on_shards(fn, args: tuple, logical: tuple, out_logical):
    """``fn(*local shards)`` for DTensor ``args``: each redistributed to
    the placements of its entry of ``logical`` (a tuple of logical axes, or
    None for an argument that is None) under the current plan, the result
    placed by ``out_logical`` (one tuple, or a tuple of them for several
    outputs)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.context import current_plan

    plan = current_plan()
    if plan is None:
        raise ValueError("a DTensor reached a kernel outside parallel_context: "
                         "the plan says where its shards go")
    mesh = next(a for a in args if a is not None).device_mesh

    def placed(axes):  # a list: local_map reads a tuple as one entry an output
        return None if axes is None else list(plan.placements(mesh, *axes))

    out = (placed(out_logical) if isinstance(out_logical[0], (str, type(None)))
           else tuple(placed(o) for o in out_logical))
    return local_map(fn, out_placements=out,
                     in_placements=tuple(placed(a) for a in logical),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _attn_axes() -> tuple:
    """(q's, k/v's) logical axes at the attention kernels: heads sharded only
    where the plan puts query and KV heads on the same mesh axes (so each
    rank's query heads read its own KV heads)."""
    from repro_torch.parallel.context import current_plan

    plan = current_plan()
    same = plan is not None and plan.get("heads") == plan.get("kv_heads")
    heads, kv = ("heads", "kv_heads") if same else (None, None)
    return ("batch", heads, None, None), ("batch", kv, None, None)


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
    if _is_dtensor(q):
        qa, kva = _attn_axes()
        return _on_shards(lambda q, k, v: flash_attention(q, k, v, causal=causal),
                          (q, k, v), (qa, kva, kva), qa)
    if _plain_depth:
        return _flash.flash_attention_plain(q, k, v, causal=causal)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _flash.flash_attention(q, k, v, causal=causal)


def decode_attention(q, k, v, kv_len: int) -> torch.Tensor:
    """q (B,Hq,1,D) over keys [0, kv_len) of k/v (B,Hkv,S,D) -> (B,Hq,1,D)."""
    if _is_dtensor(q):
        qa, kva = _attn_axes()
        return _on_shards(lambda q, k, v: decode_attention(q, k, v, kv_len),
                          (q, k, v), (qa, kva, kva), qa)
    if _plain_depth:
        return _decode.decode_attention_plain(q, k, v, kv_len)
    return _decode.decode_attention(q, k, v, kv_len)


class SSDScan(torch.autograd.Function):
    """The SSD forward kernel, with the SSD backward kernel as its gradient.

    Saves the inputs only: the backward recomputes the chunk states.  An
    output nobody differentiates (``h_final`` in training) comes back as
    None and costs nothing.
    """

    @staticmethod
    def forward(ctx, xh, la, Bm, Cm, h0, block_q: int):
        ctx.set_materialize_grads(False)
        y, h_final = _ssd.ssd_scan(xh, la, Bm, Cm, h0, block_q=block_q)
        ctx.save_for_backward(xh, la, Bm, Cm, h0)
        ctx.block_q = block_q
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        xh, la, Bm, Cm, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xh)
        dxh, dla, dBm, dCm, dh0 = _ssd_bwd.ssd_scan_bwd(
            xh, la, Bm, Cm, h0, dy, dh_final, block_q=ctx.block_q
        )
        return dxh, dla, dBm, dCm, dh0, None


class MLSTMScan(torch.autograd.Function):
    """The mLSTM forward kernel, with the mLSTM backward kernel as its
    gradient.  Saves the inputs only: the backward recomputes the states
    entering each chunk.  ``state`` is passed as its three tensors (or three
    Nones)."""

    @staticmethod
    def forward(ctx, q, k, v, lf, li, C0, n0, m0, block_q: int):
        ctx.set_materialize_grads(False)
        state = None if C0 is None else (C0, n0, m0)
        h, (C, n, m) = _mlstm.mlstm_scan(q, k, v, lf, li, state, block_q=block_q)
        ctx.save_for_backward(q, k, v, lf, li, C0, n0, m0)
        ctx.block_q = block_q
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, lf, li, C0, n0, m0 = ctx.saved_tensors
        state = None if C0 is None else (C0, n0, m0)
        if dh is None:
            dh = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dq, dk, dv, dlf, dli, dstate = _mlstm_bwd.mlstm_scan_bwd(
            q, k, v, lf, li, state, dh, dC, dn, dm, block_q=ctx.block_q
        )
        dstate = (None, None, None) if dstate is None else dstate
        return dq, dk, dv, dlf, dli, *dstate, None


def ssd_scan(xh, la, Bm, Cm, h0=None, *, block_q: int = 128) -> tuple:
    """xh (B,S,H,P), la (B,S,H), Bm/Cm (B,S,N) -> (y, h_final (B,H,P,N) f32).

    Under a mesh the scan's inputs are split by batch only."""
    if _is_dtensor(xh):
        b4, b3 = ("batch", None, None, None), ("batch", None, None)
        return _on_shards(lambda *a: ssd_scan(*a, block_q=block_q),
                          (xh, la, Bm, Cm, h0),
                          (b4, b3, b3, b3, None if h0 is None else b4), (b4, b4))
    if _plain_depth:
        return _ssd.ssd_scan_plain(xh, la, Bm, Cm, h0, block_q=block_q)
    if _needs_grad(xh, la, Bm, Cm, h0):
        return SSDScan.apply(xh, la, Bm, Cm, h0, block_q)
    return _ssd.ssd_scan(xh, la, Bm, Cm, h0, block_q=block_q)


def mlstm_scan(q, k, v, lf, li, state=None, *, block_q: int = 128) -> tuple:
    """q/k/v (B,S,H,D), lf/li (B,S,H) -> (h (B,S,H,D) f32, (C, n, m) f32).

    Under a mesh the scan's inputs are split by batch only."""
    if _is_dtensor(q):
        b4, b3, b2 = ("batch", None, None, None), ("batch", None, None), ("batch", None)
        st = (b4, b3, b2) if state is not None else (None,) * 3

        def local(q, k, v, lf, li, C0, n0, m0):
            s0 = None if C0 is None else (C0, n0, m0)
            h, (C, n, m) = mlstm_scan(q, k, v, lf, li, s0, block_q=block_q)
            return h, C, n, m

        h, C, n, m = _on_shards(local, (q, k, v, lf, li, *(state or (None,) * 3)),
                                (b4, b4, b4, b3, b3, *st), (b4, b4, b3, b2))
        return h, (C, n, m)
    if _plain_depth:
        return _mlstm.mlstm_scan_plain(q, k, v, lf, li, state, block_q=block_q)
    if _needs_grad(q, k, v, lf, li, *(state or ())):
        h, C, n, m = MLSTMScan.apply(q, k, v, lf, li, *(state or (None,) * 3), block_q)
        return h, (C, n, m)
    return _mlstm.mlstm_scan(q, k, v, lf, li, state, block_q=block_q)


_KERNELS = {
    "flash_attention": _flash,
    "flash_attention_bwd": _flash_bwd,
    "decode_attention": _decode,
    "ssd_scan": _ssd,
    "ssd_scan_bwd": _ssd_bwd,
    "mlstm_scan": _mlstm,
    "mlstm_scan_bwd": _mlstm_bwd,
}


def launch_counts() -> dict:
    """Kernel launches of each model kernel since the last reset."""
    return {name: mod.launch_count() for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.reset_launch_count()
