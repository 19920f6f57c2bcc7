"""Mamba-2 block (SSD, the state-space duality chunked algorithm).

The port of ``repro/models/mamba.py``.  The selective state space
``h_t = a_t h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D x_t`` runs over a
whole sequence (training forward and prefill) through
:func:`repro_torch.kernels.ops.ssd_scan`: the hand-written SSD kernel on the
card, its plain version on the host.  The reference computes the same
function with ``_ssd_chunked`` in XLA, which rounds the intra-chunk weights
to bf16; the kernel keeps them in f32 (its bf16 route feeds them to the
tensor cores as two bf16 parts, about 16 bits).  In training the scan's
gradient (of xh, the log decays that train ``a_log`` and ``dt_bias``, and
the strided Bm / Cm) is the hand-written SSD backward kernel on the card
(``ops.SSDScan``), autograd of the plain version on the host.

Decode keeps ``(conv, ssm)`` states and is O(1) per token, a few small
PyTorch ops; :func:`mamba_decode` updates both states in place (the
reference returns new ones).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.blocks import rmsnorm
from repro_torch.models.params import ParamDef
from repro_torch.parallel.context import (
    replicate,
    rows_einsum,
    seq_rows,
    shard_act,
    split_over,
)


def _dims(cfg) -> tuple:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nheads = di // s.headdim
    conv_dim = di + 2 * s.state
    return s, di, nheads, conv_dim


def mamba_defs(cfg) -> dict:
    s, di, nheads, conv_dim = _dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": ParamDef((d, 2 * di + 2 * s.state + nheads), ("embed", "mlp")),
        "conv_w": ParamDef((s.conv_width, conv_dim), ("conv", "mlp")),
        "conv_b": ParamDef((conv_dim,), ("mlp",), init="zeros"),
        "a_log": ParamDef((nheads,), (None,), init="zeros", dtype="float32"),
        "d_skip": ParamDef((nheads,), (None,), init="ones", dtype="float32"),
        "dt_bias": ParamDef((nheads,), (None,), init="zeros", dtype="float32"),
        "gate_norm": ParamDef((di,), ("mlp",), init="zeros"),
        "out_proj": ParamDef((di, d), ("mlp", "embed")),
    }


def mamba_state_shape(cfg, batch: int) -> dict:
    s, di, nheads, conv_dim = _dims(cfg)
    return {
        "conv": ((batch, s.conv_width - 1, conv_dim), ("batch", None, "mlp")),
        "ssm": (
            (batch, nheads, s.headdim, s.state),
            ("batch", None, None, "state"),
        ),
    }


def _split_proj(cfg, proj: torch.Tensor) -> tuple:
    s, di, nheads, _ = _dims(cfg)
    z = proj[..., :di]
    xbc = proj[..., di : di + di + 2 * s.state]
    dt_raw = proj[..., di + di + 2 * s.state :]
    return z, xbc, dt_raw


def _causal_conv(xbc, w, b, init_state=None) -> tuple:
    """Depthwise causal conv along seq.  xbc (B,S,K); w (W,K).

    Returns the activated output and the last ``W - 1`` inputs (a copy, so
    the decode state does not keep the whole padded sequence alive).
    """
    W = w.shape[0]
    if init_state is None:
        pad = replicate(torch.zeros(
            (xbc.shape[0], W - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device
        ))
    else:
        pad = init_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = sum(xp[:, i : i + S] * w[i][None, None] for i in range(W))
    new_state = xp[:, xp.shape[1] - (W - 1) :].clone()
    return F.silu(out + b[None, None]), new_state


def _gates(p, dt_raw: torch.Tensor) -> tuple:
    """dt (softplus, f32) and the per-step log decay ``dt * A``."""
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])  # (B,S,H)
    A = -torch.exp(p["a_log"].float())  # (H,)
    return dt, dt * A[None, None]


def mamba_train(cfg, p, x, return_state: bool = False, state=None):
    """x (B,S,D) -> y (B,S,D) (+ the final {conv, ssm} state if requested)."""
    s, di, nheads, conv_dim = _dims(cfg)
    rows = seq_rows()
    if rows:
        # a split sequence: each rank's own rows by the whole weight, as
        # GSPMD places the projections (so no split of the output columns
        # meets the slices below); the causal conv then takes the sequence
        # whole, and the scan splits the heads (ops.ssd_scan)
        proj = rows_einsum("bsd,dk->bsk", x, p["in_proj"])[0]
        z, xbc, dt_raw = _split_proj(cfg, proj)
        xbc, dt_raw = (shard_act(t, ("batch", None, None)) for t in (xbc, dt_raw))
    else:
        proj = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
        z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_init = None if state is None else state["conv"]
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_init)

    xin = xbc[..., :di]
    Bmat = xbc[..., di : di + s.state]  # strided views: the kernel takes them
    Cmat = xbc[..., di + s.state :]
    dt, la = _gates(p, dt_raw)
    xh = xin.reshape(*xin.shape[:2], nheads, s.headdim)
    xh_dt = xh * dt[..., None].to(xh.dtype)

    h0 = None if state is None else state["ssm"].float()
    y, h_last = ops.ssd_scan(xh_dt, la, Bmat, Cmat, h0, block_q=s.chunk)
    y = y + xh * p["d_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(*x.shape[:2], di)
    if rows:
        # back to each rank's own rows, the inner dim whole, for the gate,
        # the norm and the out projection (as GSPMD multiplies them)
        y = shard_act(y, ("batch", "seq", None))
        y = rmsnorm(y * F.silu(z), shard_act(p["gate_norm"], (None,)))
        out = rows_einsum("bsk,kd->bsd", y, p["out_proj"])[0]
    else:
        y = rmsnorm(y * F.silu(z), p["gate_norm"])
        out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    if return_state:
        return out, {"conv": conv_state, "ssm": h_last}
    return out


def mamba_decode(cfg, p, x, state: dict) -> tuple:
    """Single-token step.  x (B,1,D); state {conv, ssm}, updated in place."""
    s, di, nheads, conv_dim = _dims(cfg)
    proj = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, proj)

    # conv state update (shift register)
    conv = state["conv"]
    xp = torch.cat([conv.to(xbc.dtype), xbc], dim=1)
    w = p["conv_w"]
    out = sum(xp[:, i : i + 1] * w[i][None, None] for i in range(w.shape[0]))
    xbc = F.silu(out + p["conv_b"][None, None])
    conv.copy_(xp[:, 1:])

    xin = xbc[..., :di]
    Bmat = xbc[..., di : di + s.state]  # (B,1,N)
    Cmat = xbc[..., di + s.state :]
    dt, la = _gates(p, dt_raw)
    decay = torch.exp(la)[:, 0]  # (B,H)

    xh = xin.reshape(xin.shape[0], nheads, s.headdim)  # (B,H,P)
    dtx = xh.float() * dt[:, 0, :, None]
    h = state["ssm"]
    h.mul_(decay[..., None, None]).add_(
        torch.einsum("bhp,bn->bhpn", dtx, Bmat[:, 0].float())
    )
    if split_over(nheads, "mlp"):
        # the state's read-out on each rank's own heads, as GSPMD splits it
        h = shard_act(h, ("batch", "mlp", None, None))
    y = torch.einsum("bhpn,bn->bhp", h, Cmat[:, 0].float())
    y = y.to(x.dtype) + xh * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(x.shape[0], 1, di)
    y = rmsnorm(y * F.silu(z), p["gate_norm"])
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    return out, state
