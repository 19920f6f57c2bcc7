"""xLSTM mLSTM block (arXiv:2405.04517): matrix memory, exponential gating.

The port of ``repro/models/xlstm.py``.  Sequential semantics per head (key
dim = value dim = Dh):

    m_t  = max(log f_t + m_{t-1}, log i_t)                    (stabiliser)
    C~_t = exp(log f_t + m_{t-1} - m_t) C~_{t-1} + exp(log i_t - m_t) k_t v_tᵀ
    n~_t = (the same recurrence on k_t)
    h_t  = (q_t C~_t) / max(|q_t · n~_t|, exp(-m_t))

A whole sequence (training forward and prefill) runs through
:func:`repro_torch.kernels.ops.mlstm_scan`: the hand-written chunked scan on
the card, its plain version on the host; both return the final ``(C~, n~,
m)`` that decode starts from.  The reference computes the same function
with ``_chunked_mlstm`` in XLA.  In training the scan's gradient (of q, k,
v and both gates) is the hand-written mLSTM backward kernel on the card
(``ops.MLSTMScan``), autograd of the plain version on the host.

Decode is O(1) per token: :func:`mlstm_decode` updates the conv, ``C``,
``n`` and ``m`` states in place (the reference returns new ones).  ``C``
is (B, H, Dh, Dh) f32, 64 MiB a layer at xlstm-1.3b's B 4, so it is scaled
and updated by in-place ops and no new copy is made per step.

The 1.3B config uses block-diagonal per-head q/k/v (4 heads), proj factor 2,
no separate FFN (d_ff = 0); the gate projection and its bias stay in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.blocks import rmsnorm
from repro_torch.models.mamba import _causal_conv  # the same depthwise conv
from repro_torch.models.params import ParamDef
from repro_torch.parallel.context import elementwise


def _dims(cfg) -> tuple:
    m = cfg.mlstm
    di = m.proj_factor * cfg.d_model
    H = cfg.n_heads
    Dh = di // H
    return m, di, H, Dh


def mlstm_defs(cfg) -> dict:
    m, di, H, Dh = _dims(cfg)
    d = cfg.d_model
    return {
        "up": ParamDef((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamDef((m.conv_width, di), ("conv", "mlp")),
        "conv_b": ParamDef((di,), ("mlp",), init="zeros"),
        "wq": ParamDef((H, Dh, Dh), ("heads", None, None)),
        "wk": ParamDef((H, Dh, Dh), ("heads", None, None)),
        "wv": ParamDef((H, Dh, Dh), ("heads", None, None)),
        "w_gates": ParamDef((di, 2 * H), ("mlp", None), dtype="float32"),
        "gate_bias": ParamDef((2 * H,), (None,), init="zeros", dtype="float32"),
        "head_norm": ParamDef((di,), ("mlp",), init="zeros"),
        "down": ParamDef((di, d), ("mlp", "embed")),
    }


def mlstm_state_shape(cfg, batch: int) -> dict:
    m, di, H, Dh = _dims(cfg)
    return {
        "conv": ((batch, m.conv_width - 1, di), ("batch", None, "mlp")),
        "C": ((batch, H, Dh, Dh), ("batch", "heads", None, "state")),
        "n": ((batch, H, Dh), ("batch", "heads", None)),
        "m": ((batch, H), ("batch", "heads")),
    }


def _qkv_gates(cfg, p, xm, conv_state=None) -> tuple:
    m, di, H, Dh = _dims(cfg)
    xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"], conv_state)
    xch = xc.reshape(*xc.shape[:2], H, Dh)
    xmh = xm.reshape(*xm.shape[:2], H, Dh)
    q = torch.einsum("bshd,hde->bshe", xch, p["wq"])
    k = torch.einsum("bshd,hde->bshe", xch, p["wk"]) / math.sqrt(Dh)
    v = torch.einsum("bshd,hde->bshe", xmh, p["wv"])
    gates = torch.einsum("bsk,kg->bsg", xc.float(), p["w_gates"]) + p["gate_bias"][None, None]
    lf = elementwise(F.logsigmoid, gates[..., :H])  # log forget gate
    li = gates[..., H:]  # log input gate (exp)
    return q, k, v, lf, li, new_conv


def mlstm_train(cfg, p, x, return_state: bool = False, state=None):
    """x (B,S,D) -> y (B,S,D) (+ the final {C, n, m, conv} state if requested).

    ``state`` (a decode state) continues the recurrence from it.
    """
    m, di, H, Dh = _dims(cfg)
    up = torch.einsum("bsd,dk->bsk", x, p["up"])
    xm, z = up[..., :di], up[..., di:]
    conv_init = None if state is None else state["conv"]
    q, k, v, lf, li, new_conv = _qkv_gates(cfg, p, xm, conv_init)
    inner = None
    if state is not None:
        inner = tuple(state[key].float() for key in ("C", "n", "m"))
    h, (C, n, mf) = ops.mlstm_scan(q, k, v, lf, li, inner, block_q=m.chunk)
    h = h.to(x.dtype).reshape(*x.shape[:2], di)
    h = rmsnorm(h, p["head_norm"])
    y = torch.einsum("bsk,kd->bsd", h * F.silu(z), p["down"])
    if return_state:
        return y, {"C": C, "n": n, "m": mf, "conv": new_conv}
    return y


def mlstm_decode(cfg, p, x, state: dict) -> tuple:
    """Single-token step.  x (B,1,D); state {conv, C, n, m}, updated in place."""
    m, di, H, Dh = _dims(cfg)
    B = x.shape[0]
    # plain matmuls, not einsum: a step is host-bound, and einsum's planning
    # costs more host time than the small products it plans
    up = x @ p["up"]
    xm, z = up[..., :di], up[..., di:]

    conv = state["conv"]
    xp = torch.cat([conv.to(xm.dtype), xm], dim=1)
    w = p["conv_w"]
    out = sum(xp[:, i : i + 1] * w[i][None, None] for i in range(w.shape[0]))
    xc = F.silu(out + p["conv_b"][None, None])
    conv.copy_(xp[:, 1:])

    xch = xc.reshape(B, H, Dh).transpose(0, 1)  # (H, B, Dh)
    xmh = xm.reshape(B, H, Dh).transpose(0, 1)
    qh = torch.bmm(xch, p["wq"]).transpose(0, 1).float()  # (B, H, Dh)
    kh = (torch.bmm(xch, p["wk"]) / math.sqrt(Dh)).transpose(0, 1).float()
    vh = torch.bmm(xmh, p["wv"]).transpose(0, 1).float()
    gates = xc[:, 0].float() @ p["w_gates"] + p["gate_bias"][None]
    lf = elementwise(F.logsigmoid, gates[..., :H])
    li = gates[..., H:]

    mp = state["m"]
    mn = torch.maximum(lf + mp, li)
    a = torch.exp(lf + mp - mn)  # (B,H)
    b = torch.exp(li - mn)
    C, n = state["C"], state["n"]
    # C <- a C + b k vᵀ, in place: (B·H, Dh, Dh) += (b k) (Dh, 1) @ v (1, Dh)
    C.mul_(a[..., None, None])
    C.view(B * H, Dh, Dh).baddbmm_(
        (b[..., None] * kh).reshape(B * H, Dh, 1), vh.reshape(B * H, 1, Dh)
    )
    n.mul_(a[..., None]).add_(b[..., None] * kh)
    mp.copy_(mn)
    num = torch.bmm(qh.reshape(B * H, 1, Dh), C.view(B * H, Dh, Dh)).reshape(B, H, Dh)
    den = torch.maximum((qh * n).sum(dim=-1).abs(), torch.exp(-mn))
    h = (num / den[..., None]).to(x.dtype)
    h = rmsnorm(h.reshape(B, 1, di), p["head_norm"])
    return (h * F.silu(z)) @ p["down"], state
