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

Under ``repro``'s plan on a device mesh the dispatch and combine einsums
take the share of each group GSPMD gives a device
(:func:`~repro_torch.parallel.context.moe_tiles`): the routing is computed
whole (its capacity positions are a cumulative sum over the group), the
dispatch over whole groups, the combine and the backward over each
group's tokens of the rank's rows; the expert weights are gathered along
``embed`` (FSDP), so a decode group is computed whole, as GSPMD does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef
from repro_torch.parallel.context import moe_tiles, replicate, shard_act, splits_evenly


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


class _Dispatch(torch.autograd.Function):
    """The dispatch einsum over a rank's tiles (local tensors): forward on
    the groups of ``tiles.dispatch`` over their whole tokens (zeros for the
    others, and from a rank that does not lead), backward on ``tiles.rows``
    (xg's gradient there, its own rows only; zeros elsewhere)."""

    @staticmethod
    def forward(ctx, dispatch, xg, tiles):
        g0, gn = tiles.dispatch
        if tiles.lead:
            out = torch.einsum("gtec,gtd->egcd", dispatch[g0 : g0 + gn], xg[g0 : g0 + gn])
        else:
            out = xg.new_zeros((dispatch.shape[2], gn, dispatch.shape[3], xg.shape[2]),
                               dtype=torch.result_type(dispatch, xg))
        if gn < xg.shape[0]:
            out = F.pad(out, (0, 0, 0, 0, g0, xg.shape[0] - g0 - gn))
        ctx.save_for_backward(dispatch)
        ctx.tiles, ctx.shape = tiles, xg.shape
        return out

    @staticmethod
    def backward(ctx, d_in):
        (dispatch,) = ctx.saved_tensors
        g0, gn, t0, tn = ctx.tiles.rows
        G, T, _ = ctx.shape
        own = torch.tensor(ctx.tiles.own, dtype=d_in.dtype, device=d_in.device)
        d = torch.einsum("egcd,gtec->gtd", d_in[:, g0 : g0 + gn],
                         dispatch[g0 : g0 + gn, t0 : t0 + tn]) * own[:, None, None]
        return None, F.pad(d, (0, 0, t0, T - t0 - tn, g0, G - g0 - gn)), None


def _moved(placements) -> list:
    """The placements of a result (E, G, C, D) whose groups lie as those of
    (G, T, D) ``placements`` (a split of the groups moves to dim 1)."""
    from torch.distributed.tensor import Shard

    return [Shard(1) if p.is_shard() else p for p in placements]


def _tiled(xg, tiles) -> tuple:
    """(the placements of ``xg``'s groups with the tiles' dims partial,
    those of the groups' results (E, G, C, D) likewise)."""
    from torch.distributed.tensor import Partial

    groups = [Partial() if i in tiles.dims else p for i, p in enumerate(xg.placements)]
    return groups, [Partial() if i in tiles.dims else p
                    for i, p in enumerate(_moved(xg.placements))]


def _dispatch_tiled(dispatch, xg, tiles):
    """``einsum("gtec,gtd->egcd", dispatch, xg)`` of DTensors over the
    rank's tiles: a partial sum over the tiles' mesh dims where the ranks
    there hold different groups, else whole."""
    from torch.distributed.tensor.experimental import local_map

    grad, moved = _tiled(xg, tiles)
    place = list(xg.placements)
    whole = tiles.dispatch[1] == xg.to_local().shape[0] and tiles.lead
    out = _moved(place) if whole else moved
    return local_map(lambda d, x: _Dispatch.apply(d, x, tiles), out_placements=out,
                     in_placements=(place, place), in_grad_placements=(place, grad),
                     device_mesh=xg.device_mesh, redistribute_inputs=True)(dispatch, xg)


def _combine_tiled(combine, expert_out, xg, tiles):
    """``einsum("gtec,egcd->gtd", combine, expert_out)`` of DTensors over
    the rank's rows (``tiles.rows``, its own groups there): each token's
    output from its owner, a partial sum over the tiles' mesh dims."""
    from torch.distributed.tensor.experimental import local_map

    grad, moved = _tiled(xg, tiles)
    place = list(xg.placements)
    g0, gn, t0, tn = tiles.rows

    def local(c, eo):
        own = torch.tensor(tiles.own, dtype=c.dtype, device=c.device)
        y = torch.einsum("gtec,egcd->gtd",
                         c[g0 : g0 + gn, t0 : t0 + tn] * own[:, None, None, None],
                         eo[:, g0 : g0 + gn])
        return F.pad(y, (0, 0, t0, c.shape[1] - t0 - tn, g0, c.shape[0] - g0 - gn))

    return local_map(local, out_placements=grad, in_placements=(place, _moved(place)),
                     in_grad_placements=(grad, moved),
                     device_mesh=xg.device_mesh, redistribute_inputs=True)(combine, expert_out)


def _whole_grad(t):
    """``t`` itself; its gradient, a partial sum where the tiled combine
    leaves one, is reduced to ``t``'s placements here, before it meets the
    expert products (whose weights the model axis splits)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local(), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape, stride=t.stride())


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
    tiles = moe_tiles(x, xg)
    if tiles is not None:
        expert_in = _dispatch_tiled(dispatch, xg, tiles)
    else:
        expert_in = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    expert_in = shard_act(expert_in, ("experts", groups, "moe_cap", "act_embed"))
    # the expert weights whole along embed (their FSDP split gathered), as
    # GSPMD multiplies the groups by them
    w_in = ("experts", None, "expert_mlp")
    g = torch.einsum("egcd,edf->egcf", expert_in, shard_act(p["w_gate"], w_in))
    u = torch.einsum("egcd,edf->egcf", expert_in, shard_act(p["w_up"], w_in))
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if cfg.act == "geglu" else F.silu(g)
    h = shard_act(act * u, ("experts", groups, "moe_cap", "expert_mlp"))
    w_down = shard_act(p["w_down"], ("experts", "expert_mlp", None))
    expert_out = torch.einsum("egcf,efd->egcd", h, w_down)
    expert_out = shard_act(expert_out, ("experts", groups, "moe_cap", "act_embed"))
    if tiles is None:
        y = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype), expert_out)
    else:
        y = _combine_tiled(combine.to(x.dtype), _whole_grad(expert_out), xg, tiles)
    return y.reshape(-1, D)[:tokens].reshape(B, S, D), aux
