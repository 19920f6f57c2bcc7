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
from repro_torch.models.blocks import heads_whole, rmsnorm
from repro_torch.models.mamba import _causal_conv  # the same depthwise conv
from repro_torch.models.params import ParamDef
from repro_torch.parallel.context import elementwise, rows_einsum, shard_act, value_split


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


def _einsum(eq: str, x, *ws) -> tuple:
    """``torch.einsum(eq, x, w)`` for each ``w`` (:func:`rows_einsum`'s
    signature, for the products as the plan places them)."""
    return tuple(torch.einsum(eq, x, w) for w in ws)


def _qkv_gates(cfg, p, xm, conv_state=None) -> tuple:
    m, di, H, Dh = _dims(cfg)
    whole = heads_whole(cfg)
    if whole:
        # heads that do not divide the model axis: the causal conv takes the
        # sequence whole; then the inner dim whole, so its reshape into heads
        # sees whole heads, and each rank's own rows (of the sequence, as the
        # plan splits it) by the whole weights
        xc, new_conv = _causal_conv(shard_act(xm, ("batch", None, None)), p["conv_w"],
                                    p["conv_b"], conv_state)
        xc, xm = shard_act(xc, ("batch", "seq", None)), shard_act(xm, ("batch", "seq", None))
    else:
        xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"], conv_state)
    xch = xc.reshape(*xc.shape[:2], H, Dh)
    xmh = xm.reshape(*xm.shape[:2], H, Dh)
    product = rows_einsum if whole else _einsum
    q, k = product("bshd,hde->bshe", xch, p["wq"], p["wk"])
    k = k / math.sqrt(Dh)
    (v,) = product("bshd,hde->bshe", xmh, p["wv"])
    gates = product("bsk,kg->bsg", xc.float(), p["w_gates"])[0] + p["gate_bias"][None, None]
    lf = elementwise(F.logsigmoid, gates[..., :H])  # log forget gate
    li = gates[..., H:]  # log input gate (exp)
    return q, k, v, lf, li, new_conv


def mlstm_train(cfg, p, x, return_state: bool = False, state=None):
    """x (B,S,D) -> y (B,S,D) (+ the final {C, n, m, conv} state if requested).

    ``state`` (a decode state) continues the recurrence from it.
    """
    m, di, H, Dh = _dims(cfg)
    if heads_whole(cfg):
        # each rank's own rows by the whole weight, so the inner dim splits
        # into xm and z, and later into heads, whole
        up = rows_einsum("bsd,dk->bsk", shard_act(x, ("batch", "seq", "act_embed")),
                         p["up"])[0]
    else:
        up = torch.einsum("bsd,dk->bsk", x, p["up"])
    xm, z = up[..., :di], up[..., di:]
    conv_init = None if state is None else state["conv"]
    q, k, v, lf, li, new_conv = _qkv_gates(cfg, p, xm, conv_init)
    inner = None
    if state is not None:
        inner = tuple(state[key].float() for key in ("C", "n", "m"))
    h, (C, n, mf) = ops.mlstm_scan(q, k, v, lf, li, inner, block_q=m.chunk)
    h = h.to(x.dtype).reshape(*x.shape[:2], di)
    if heads_whole(cfg):
        # back to each rank's own rows, the inner dim whole, for the down
        # projection (as GSPMD multiplies them)
        h, z = shard_act(h, ("batch", "seq", None)), shard_act(z, ("batch", "seq", None))
        h = rmsnorm(h, shard_act(p["head_norm"], (None,)))
        y = rows_einsum("bsk,kd->bsd", h * F.silu(z), p["down"])[0]
    else:
        h = rmsnorm(h, p["head_norm"])
        y = torch.einsum("bsk,kd->bsd", h * F.silu(z), p["down"])
    if return_state:
        return y, {"C": C, "n": n, "m": mf, "conv": new_conv}
    return y


def _step(qh, kh, vh, lf, li, C, n, mp):
    """One token's recurrence on plain tensors: q/k (B,H,Dk), v (B,H,Dv),
    the log gates (B,H); C (B,H,Dk,Dv), n and m updated in place; h
    (B,H,Dv) f32.  A slice of v's value columns and of C's gives that
    slice of h."""
    B, H, Dk = qh.shape
    Dv = vh.shape[-1]
    mn = torch.maximum(lf + mp, li)
    a = torch.exp(lf + mp - mn)  # (B,H)
    b = torch.exp(li - mn)
    # C <- a C + b k vᵀ, in place: (B·H, Dk, Dv) += (b k) (Dk, 1) @ v (1, Dv)
    C.mul_(a[..., None, None])
    C.view(B * H, Dk, Dv).baddbmm_(
        (b[..., None] * kh).reshape(B * H, Dk, 1), vh.reshape(B * H, 1, Dv)
    )
    n.mul_(a[..., None]).add_(b[..., None] * kh)
    mp.copy_(mn)
    num = torch.bmm(qh.reshape(B * H, 1, Dk), C.view(B * H, Dk, Dv)).reshape(B, H, Dv)
    den = torch.maximum((qh * n).sum(dim=-1).abs(), torch.exp(-mn))
    return num / den[..., None]


def _recur(qh, kh, vh, lf, li, C, n, mp):
    """:func:`_step`; DTensors take it on their local shards (each row's
    recurrence is its own; DTensor has no rule for the in-place
    ``baddbmm_``): the state as it lies, so it is updated in place, and the
    token's q, k and gates placed as the state's (batch, heads), v and h as
    C's value columns."""
    args = (qh, kh, vh, lf, li, C, n, mp)
    if not hasattr(C, "placements"):
        return _step(*args)
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Shard

    state = list(mp.placements)
    # C (B, H, Dk, Dv): its value columns are v's and h's dim 2
    values = [Shard(2) if p.is_shard() and p.dim == 3 else p for p in C.placements]
    placed = (state, state, values, state, state, list(C.placements),
              list(n.placements), state)
    return local_map(_step, out_placements=values, in_placements=placed,
                     device_mesh=C.device_mesh, redistribute_inputs=True)(*args)


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
    if heads_whole(cfg):  # the inner dim whole before it splits into heads
        xc, xm = shard_act(xc, ("batch", None, None)), shard_act(xm, ("batch", None, None))

    xch = xc.reshape(B, H, Dh).transpose(0, 1)  # (H, B, Dh)
    xmh = xm.reshape(B, H, Dh).transpose(0, 1)
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    values = value_split(H, Dh)
    if values:
        # the value columns of C split over the plan's mlp axes, as GSPMD
        # splits the state's work: the per-head projections by columns
        # (q and k then gathered whole, v kept split), the state placed so
        cols = (None, None, "mlp")
        wq, wk, wv = (shard_act(w, cols) for w in (wq, wk, wv))
        state["C"] = shard_act(state["C"], ("batch", None, None, "mlp"))
    qh = torch.bmm(xch, wq).transpose(0, 1).float()  # (B, H, Dh)
    kh = (torch.bmm(xch, wk) / math.sqrt(Dh)).transpose(0, 1).float()
    vh = torch.bmm(xmh, wv).transpose(0, 1).float()
    if values:
        qh, kh = (shard_act(t, ("batch", None, None)) for t in (qh, kh))
    gates = xc[:, 0].float() @ p["w_gates"] + p["gate_bias"][None]
    lf = elementwise(F.logsigmoid, gates[..., :H])
    li = gates[..., H:]

    h = _recur(qh, kh, vh, lf, li, state["C"], state["n"], state["m"])
    if values:
        h = shard_act(h, ("batch", None, None))
    h = h.to(x.dtype)
    h = rmsnorm(h.reshape(B, 1, di), p["head_norm"])
    return (h * F.silu(z)) @ p["down"], state
