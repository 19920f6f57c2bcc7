"""Mixture-of-Experts FFN: GShard-style top-k dispatch and combine einsums.

The port of ``repro/models/moe.py``: the capacity-bounded dense dispatch.
Tokens are cut into groups of ``min(group_size, B·S)`` (the last group
zero-padded), routed top-k within their group, and dispatched to
per-expert buffers of ``C = max(1, int(T·top_k/E·capacity_factor))`` slots
by one-hot einsums; a token past its expert's capacity is dropped.  The
router's logits and softmax are f32, ``dispatch`` takes x's dtype and
``combine`` is cast to x's dtype for the final einsum (the reference's
bf16 combine).

The expert products stay ``torch.einsum``, as in the reference: no Pallas
kernel computes them.  The reference's ``shard_act`` constraints sit
where it puts them (the identity without a device mesh).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef
from repro_torch.parallel.context import replicate, shard_act, splits_evenly


def moe_defs(cfg) -> dict:
    e = cfg.moe
    d = cfg.d_model
    return {
        "router": ParamDef((d, e.n_experts), ("embed", "experts"), dtype="float32"),
        "w_gate": ParamDef(
            (e.n_experts, d, e.d_expert), ("experts", "embed", "expert_mlp")
        ),
        "w_up": ParamDef((e.n_experts, d, e.d_expert), ("experts", "embed", "expert_mlp")),
        "w_down": ParamDef(
            (e.n_experts, e.d_expert, d), ("experts", "expert_mlp", "embed")
        ),
    }


def capacity(cfg, group: int) -> int:
    """Slots per expert in a group of ``group`` tokens."""
    e = cfg.moe
    return max(1, int(group * e.top_k / e.n_experts * e.capacity_factor))


def _route(cfg, p, xg: torch.Tensor) -> tuple:
    """xg (G,T,D) -> combine (G,T,E,C) f32, dispatch (G,T,E,C), aux loss.

    ``top_k`` rounds of argmax (the first maximal index on ties, as
    ``jnp.argmax``), one-hot, and each token's place in its expert's buffer
    by a cumulative sum over the group, after the places earlier rounds
    filled.  The aux loss is GShard's load-balance loss.
    """
    e = cfg.moe
    G, T, _ = xg.shape
    E = e.n_experts
    C = capacity(cfg, T)
    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)  # (G, T, E) f32
    slots = replicate(torch.arange(C, device=xg.device))
    combine = replicate(torch.zeros((G, T, E, C), dtype=torch.float32, device=xg.device))
    fill = replicate(torch.zeros((G, E), dtype=torch.float32, device=xg.device))
    remaining = probs
    for _ in range(e.top_k):
        onehot = F.one_hot(torch.argmax(remaining, dim=-1), E).float()  # (G,T,E)
        gate = (remaining * onehot).sum(-1)  # (G, T)
        remaining = remaining * (1.0 - onehot)
        pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        pos_tok = (pos * onehot).sum(-1)  # (G, T)
        # a place past the buffer has no slot (jax.nn.one_hot's zero row)
        posoh = (pos_tok.long()[..., None] == slots).float()  # (G, T, C)
        within = (pos_tok < C).float()
        combine = combine + (gate * within)[..., None, None] * (
            onehot[..., None] * posoh[..., None, :]
        )
        fill = fill + onehot.sum(dim=1)
    dispatch = (combine > 0).to(xg.dtype)
    # every round places each token once, so the load is the fill
    frac_tokens = fill / (T * e.top_k)
    frac_probs = probs.sum(dim=1) / T
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return combine, dispatch, aux


def moe_ffn(cfg, p, x: torch.Tensor) -> tuple:
    """x (B,S,D) -> (y (B,S,D), aux loss)."""
    e = cfg.moe
    B, S, D = x.shape
    tokens = B * S
    group = min(e.group_size, tokens)
    pad = (-tokens) % group
    xf = x.reshape(tokens, D)
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, D))], dim=0)
    xg = xf.reshape(-1, group, D)
    # a decode step's few groups may not split over the data axes
    groups = "moe_groups" if splits_evenly(xg.shape[0], "moe_groups") else None
    xg = shard_act(xg, (groups, None, "act_embed"))

    combine, dispatch, aux = _route(cfg, p, xg)
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    expert_in = shard_act(expert_in, ("experts", groups, "moe_cap", "act_embed"))
    g = torch.einsum("egcd,edf->egcf", expert_in, p["w_gate"])
    u = torch.einsum("egcd,edf->egcf", expert_in, p["w_up"])
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if cfg.act == "geglu" else F.silu(g)
    h = shard_act(act * u, ("experts", groups, "moe_cap", "expert_mlp"))
    expert_out = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    expert_out = shard_act(expert_out, ("experts", groups, "moe_cap", "act_embed"))
    y = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype), expert_out)
    return y.reshape(-1, D)[:tokens].reshape(B, S, D), aux
