"""Decoder-only LM assembly for every decoder-only family.

The port of ``repro/models/lm.py``.  Families:

  dense / vlm    pre-norm attention (GQA/MQA or MLA) + gated FFN; the VLM
                 (qwen2-vl) puts a stub vision prefix before the prompt and
                 rotates with M-RoPE
  moe            pre-norm attention + GShard MoE FFN
  ssm            xLSTM mLSTM blocks (no FFN, assigned d_ff = 0)
  hybrid         zamba2: a Mamba-2 backbone with one shared attention + FFN
                 block after every ``shared_attn_every`` layers but the last
                 group, run at width ``2 d`` on the concatenation with the
                 initial embedding, each invocation with its own
                 down-projection

The reference stacks each layer group's parameters on a ``layers`` axis and
drives it with ``lax.scan``; here a group is an ``nn.ModuleList`` of
per-layer modules and the scan is a Python loop.  The KV caches (MLA's
latent caches among them) are preallocated per layer and the Mamba and
mLSTM states come from the prefill; all are updated in place by
:meth:`LM.decode` (the reference returns updated copies).

Every phase is wrapped in a communication region, as in the reference:
``embed``, ``attn``, ``mlp``, ``moe``, ``ssm``, ``shared_attn``,
``lm_head``.  The reference's ``shard_act`` constraints sit where it puts
them (:mod:`repro_torch.parallel.context`: the identity without a device
mesh).  Under ``cfg.remat == "full"`` (every published config) training
recomputes each layer, and the hybrid's shared block, in the backward
(:func:`remat`), as the reference wraps them in ``jax.checkpoint``.  The
encoder-decoder family is :mod:`repro_torch.models.encdec`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.backend import BackendUnavailable
from repro_torch.core.regions import comm_region
from repro_torch.models import blocks as B
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.params import (
    ParamDef,
    ParamTree,
    init_tree,
    stack_defs,
    unstack,
)
from repro_torch.parallel.context import replicate, rows_product, seq_rows, shard_act

# ---------------------------------------------------------------------------
# Layer definitions
# ---------------------------------------------------------------------------


def layer_defs(cfg, kind: str) -> dict:
    if kind in ("attn_ffn", "attn_moe"):
        d = {
            "norm1": B.norm_def(cfg),
            "attn": B.mla_defs(cfg) if cfg.mla is not None else B.attn_defs(cfg),
            "norm2": B.norm_def(cfg),
        }
        if kind == "attn_ffn":
            d["ffn"] = B.ffn_defs(cfg)
        else:
            d["moe"] = MOE.moe_defs(cfg)
    elif kind == "mamba":
        d = {"norm1": B.norm_def(cfg), "ssm": M.mamba_defs(cfg)}
    elif kind == "mlstm":
        d = {"norm1": B.norm_def(cfg), "ssm": X.mlstm_defs(cfg)}
    else:
        raise ValueError(kind)
    return {k: v for k, v in d.items() if v is not None}


def layer_plan(cfg) -> list:
    """[(kind, n_layers)]; hybrid: mamba groups of ``shared_attn_every``."""
    if cfg.family in ("dense", "vlm"):
        return [("attn_ffn", cfg.n_layers)]
    if cfg.family == "moe":
        return [("attn_moe", cfg.n_layers)]
    if cfg.family == "ssm":
        return [("mlstm", cfg.n_layers)]
    if cfg.family == "hybrid":
        n, k = cfg.n_layers, cfg.shared_attn_every
        return [("mamba", min(k, n - i)) for i in range(0, n, k)]
    raise ValueError(f"{cfg.name}: no decoder-only plan for family {cfg.family!r}")


def _shared_block_cfg(cfg):
    """zamba2's shared attention block operates at width 2*d."""
    return replace(
        cfg,
        d_model=2 * cfg.d_model,
        head_dim=2 * cfg.d_model // cfg.n_heads,
        mla=None,
        moe=None,
    )


def shared_defs(cfg) -> dict:
    scfg = _shared_block_cfg(cfg)
    n_inv = max(1, len(layer_plan(cfg)) - 1) if cfg.family == "hybrid" else 0
    return {
        "norm1": B.norm_def(scfg),
        "attn": B.attn_defs(scfg),
        "norm2": B.norm_def(scfg),
        "ffn": B.ffn_defs(scfg, cfg.d_ff),
        # per-invocation (unshared) down projections 2d -> d
        "down": ParamDef(
            (n_inv, 2 * cfg.d_model, cfg.d_model), ("layers", "mlp", "embed")
        ),
    }


def model_defs(cfg) -> dict:
    defs = {
        "embed": B.embed_defs(cfg),
        "groups": tuple(
            stack_defs(layer_defs(cfg, kind), n) for kind, n in layer_plan(cfg)
        ),
    }
    if cfg.family == "hybrid":
        defs["shared"] = shared_defs(cfg)
    return defs


# ---------------------------------------------------------------------------
# Rotary context
# ---------------------------------------------------------------------------


@dataclass
class Ctx:
    cos: Optional[torch.Tensor] = None
    sin: Optional[torch.Tensor] = None
    pos: Optional[int] = None  # decode: the position written this step
    s_max: int = 0  # cache length


def make_rope(cfg, positions: torch.Tensor, vision_grid: Optional[tuple] = None):
    """positions (S,) or (B,S) -> cos/sin; M-RoPE builds 3 position streams.

    ``vision_grid`` is ``(v, rows, cols)`` of a vision prefix: its tokens
    take (t = 0, h, w) grid coordinates, and text continues with
    t = h = w = position.
    """
    if cfg.family == "hybrid":
        # the only attention is the shared block at width 2*d
        hd = 2 * cfg.d_model // cfg.n_heads
    elif cfg.mla is not None:
        hd = cfg.mla.rope_dim
    else:
        hd = cfg.head_dim
    if cfg.mrope_sections is None:
        return B.rope_angles(positions, hd, cfg.rope_theta)
    if positions.dim() == 1:
        positions = positions[None]
    p3 = torch.stack([positions] * 3)  # (3, B, S): t, h, w
    if vision_grid is not None:
        v, _, cols = vision_grid
        grid = torch.arange(v, dtype=positions.dtype, device=positions.device)
        p3[0, :, :v] = 0
        p3[1, :, :v] = grid // cols
        p3[2, :, :v] = grid % cols
    return B.mrope_angles(p3, hd, cfg.rope_theta, cfg.mrope_sections)


# ---------------------------------------------------------------------------
# Per-layer forward (train / prefill / decode)
# ---------------------------------------------------------------------------


def remat(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat == "full"`` its activations are not
    kept for the backward but recomputed there (the reference's
    ``jax.checkpoint`` of a layer body).  The layers draw no random numbers,
    so the RNG state is not stashed.  Without autograd it is a plain call."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


#: the recurrent layer kinds: (train, decode) of their block module
_RECURRENT = {
    "mamba": (M.mamba_train, M.mamba_decode),
    "mlstm": (X.mlstm_train, X.mlstm_decode),
}


def _attention(cfg) -> tuple:
    """(train, prefill, decode) of a layer's attention: MLA or GQA."""
    if cfg.mla is not None:
        return B.mla_train, B.mla_prefill, B.mla_decode
    return B.attn_train, B.attn_prefill, B.attn_decode


def _ffn_half(cfg, kind: str, p, x) -> tuple:
    """The gated FFN (``attn_ffn``) or MoE (``attn_moe``) half of a layer:
    (x, the layer's aux loss; 0.0 without experts)."""
    if kind == "attn_moe":
        with comm_region("moe"):
            y, aux = MOE.moe_ffn(cfg, p["moe"], B.norm(cfg, p.get("norm2"), x))
            return x + shard_act(y, B.ACT), aux
    with comm_region("mlp"):
        h = B.ffn(cfg, p["ffn"], B.norm(cfg, p.get("norm2"), x))
        return x + shard_act(h, B.ACT), 0.0


def _recurrent_norm(cfg, kind: str, p, x):
    """The norm that opens a recurrent block: the mLSTM's takes each rank's
    own rows (:func:`~repro_torch.models.blocks.rows_norm`), and so does the
    Mamba block's where the sequence is split (its projections take the
    rows)."""
    if kind == "mlstm":
        return B.rows_norm(cfg, p.get("norm1"), x)
    if seq_rows():
        return B.norm(cfg, p.get("norm1"), x, B.ACT)
    return B.norm(cfg, p.get("norm1"), x)


def layer_train(cfg, kind: str, p, x, ctx: Ctx) -> tuple:
    """Returns (x, the layer's aux loss) for one layer."""
    if kind in _RECURRENT:
        train, _ = _RECURRENT[kind]
        with comm_region("ssm"):
            h = train(cfg, p["ssm"], _recurrent_norm(cfg, kind, p, x))
            x = x + shard_act(h, B.ACT)
        return shard_act(x, B.ACT), 0.0
    train, _, _ = _attention(cfg)
    with comm_region("attn"):
        h = B.rows_norm(cfg, p.get("norm1"), x)
        x = x + shard_act(train(cfg, p["attn"], h, ctx.cos, ctx.sin), B.ACT)
    x, aux = _ffn_half(cfg, kind, p, x)
    return shard_act(x, B.ACT), aux


def layer_prefill(cfg, kind: str, p, x, ctx: Ctx) -> tuple:
    """Returns (x, cache) for one layer."""
    if kind in _RECURRENT:
        train, _ = _RECURRENT[kind]
        with comm_region("ssm"):
            h, cache = train(
                cfg, p["ssm"], _recurrent_norm(cfg, kind, p, x), return_state=True
            )
        return shard_act(x + shard_act(h, B.ACT), B.ACT), cache
    _, prefill, _ = _attention(cfg)
    with comm_region("attn"):
        h = B.rows_norm(cfg, p.get("norm1"), x)
        h, cache = prefill(cfg, p["attn"], h, ctx.cos, ctx.sin, ctx.s_max)
        x = x + shard_act(h, B.ACT)
    x = _ffn_half(cfg, kind, p, x)[0]
    return shard_act(x, B.ACT), cache


def layer_decode(cfg, kind: str, p, x, ctx: Ctx, cache: dict) -> tuple:
    if kind in _RECURRENT:
        _, decode = _RECURRENT[kind]
        with comm_region("ssm"):
            h, cache = decode(cfg, p["ssm"], B.norm(cfg, p.get("norm1"), x), cache)
            return x + shard_act(h, B.ACT), cache
    _, _, decode = _attention(cfg)
    with comm_region("attn"):
        h = B.rows_norm(cfg, p.get("norm1"), x)
        h, cache = decode(cfg, p["attn"], h, ctx.cos, ctx.sin, cache, ctx.pos)
        x = x + shard_act(h, B.ACT)
    return _ffn_half(cfg, kind, p, x)[0], cache


def layer_cache_shape(cfg, kind: str, batch: int, s_max: int) -> dict:
    if kind == "mamba":
        return M.mamba_state_shape(cfg, batch)
    if kind == "mlstm":
        return X.mlstm_state_shape(cfg, batch)
    if cfg.mla is not None:
        return B.mla_cache_shape(cfg, batch, s_max)
    return B.attn_cache_shape(cfg, batch, s_max)


# ---------------------------------------------------------------------------
# Shared attention block (zamba2)
# ---------------------------------------------------------------------------


def _shared_out(scfg, sp, u, x, inv: int) -> torch.Tensor:
    h = B.ffn(scfg, sp["ffn"], B.norm(scfg, sp.get("norm2"), u))
    u = u + shard_act(h, B.ACT)
    return x + rows_product(u, sp["down"][inv])


def shared_train(cfg, sp, x, x0, inv: int, ctx: Ctx) -> torch.Tensor:
    scfg = _shared_block_cfg(cfg)
    with comm_region("shared_attn"):
        u = torch.cat([x, x0], dim=-1)
        h = B.norm(scfg, sp.get("norm1"), u)
        h = B.attn_train(scfg, sp["attn"], h, ctx.cos, ctx.sin)
        u = u + shard_act(h, B.ACT)
        return _shared_out(scfg, sp, u, x, inv)


def shared_prefill(cfg, sp, x, x0, inv: int, ctx: Ctx) -> tuple:
    scfg = _shared_block_cfg(cfg)
    with comm_region("shared_attn"):
        u = torch.cat([x, x0], dim=-1)
        h = B.norm(scfg, sp.get("norm1"), u)
        h, cache = B.attn_prefill(scfg, sp["attn"], h, ctx.cos, ctx.sin, ctx.s_max)
        return _shared_out(scfg, sp, u + shard_act(h, B.ACT), x, inv), cache


def shared_decode(cfg, sp, x, x0, inv: int, ctx: Ctx, cache: dict) -> tuple:
    scfg = _shared_block_cfg(cfg)
    with comm_region("shared_attn"):
        u = torch.cat([x, x0], dim=-1)
        h = B.norm(scfg, sp.get("norm1"), u)
        h, cache = B.attn_decode(scfg, sp["attn"], h, ctx.cos, ctx.sin, cache, ctx.pos)
        return _shared_out(scfg, sp, u + shard_act(h, B.ACT), x, inv), cache


def shared_cache_shape(cfg, batch: int, s_max: int) -> dict:
    return B.attn_cache_shape(_shared_block_cfg(cfg), batch, s_max)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; the default is the CUDA card.

    Raises :class:`~repro_torch.core.backend.BackendUnavailable` when CUDA is
    asked for and absent: there is no fallback to the host.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise BackendUnavailable(
            "the model runs on a CUDA device and none is available; "
            "pass device='cpu' to run it on the host"
        )
    return device


def shared_after(cfg, plan, gi: int) -> bool:
    """Whether a hybrid model's shared block runs after group ``gi`` of
    ``plan`` (``layer_plan(cfg)``): after each group but the last."""
    return cfg.family == "hybrid" and gi < len(plan) - 1


class LM(nn.Module):
    """Decoder-only model over a ModelConfig, with its parameters.

    Parameters are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; by default one seeded with ``seed``) by the reference's
    init rule.  ``embed`` holds the embedding (and LM head); ``groups`` holds
    one ``nn.ModuleList`` of layers per layer group; a hybrid model's
    ``shared`` holds the shared block, its ``down`` stacked by invocation.

    The caches (:meth:`prefill`, :meth:`decode`) are a tuple with one list of
    per-layer caches for each group; a hybrid model's tuple also holds the
    shared block's KV cache (a dict) after each group but the last.
    """

    def __init__(self, cfg, *, device=None, generator=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        self.defs = model_defs(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        self.embed = ParamTree(init_tree(self.defs["embed"], generator, device))
        self.groups = nn.ModuleList()
        for (kind, n), gdefs in zip(self.plan, self.defs["groups"]):
            stacked = init_tree(gdefs, generator, device)
            self.groups.append(
                nn.ModuleList(ParamTree(unstack(stacked, i)) for i in range(n))
            )
            del stacked
        if "shared" in self.defs:
            self.shared = ParamTree(init_tree(self.defs["shared"], generator, device))

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def _shared_after(self, gi: int) -> bool:
        return shared_after(self.cfg, self.plan, gi)

    # -- embedding (with the VLM's vision prefix) --------------------------
    def _embed(self, batch: dict) -> torch.Tensor:
        with comm_region("embed"):
            x = B.embed_tokens(self.cfg, self.embed, batch["tokens"])
            if self.cfg.family == "vlm" and "vision_embeds" in batch:
                x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
            return x

    def _positions(self, seq: int) -> torch.Tensor:
        return torch.arange(seq, dtype=torch.int32, device=self.device)

    def _vision_grid(self, batch: dict) -> Optional[tuple]:
        """(v, rows, cols) of the vision prefix's grid, or None."""
        if self.cfg.family == "vlm" and "vision_embeds" in batch:
            v = batch["vision_embeds"].shape[1]
            g = int(math.sqrt(v))
            return (v, g, max(1, v // g))
        return None

    def _rope(self, batch: dict, seq: int) -> tuple:
        cos, sin = make_rope(self.cfg, self._positions(seq), self._vision_grid(batch))
        return replicate(cos), replicate(sin)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        with comm_region("lm_head"):
            return B.lm_logits(self.cfg, self.embed, x)

    # -- forward -----------------------------------------------------------
    def train_logits(self, batch: dict) -> tuple:
        """Logits over every position and the summed aux loss.

        A VLM's logits cover the vision prefix too.  Autograd records the
        call when a parameter requires a gradient (the trainer's
        ``requires_grad_(True)``); serving callers run it under
        ``torch.no_grad()``.
        """
        cfg = self.cfg
        x = self._embed(batch)
        cos, sin = self._rope(batch, x.shape[1])
        ctx = Ctx(cos=cos, sin=sin)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x0 = x
        for gi, ((kind, _), layers) in enumerate(zip(self.plan, self.groups)):
            for lp in layers:
                x, a = remat(cfg, layer_train, cfg, kind, lp, x, ctx)
                aux = aux + a
            if self._shared_after(gi):
                x = remat(cfg, shared_train, cfg, self.shared, x, x0, gi, ctx)
        return self._head(x), aux

    # -- serving -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: dict, s_max: int) -> tuple:
        """Logits of the last prompt position and the caches (padded to s_max).

        ``s_max`` counts a VLM's vision prefix: the prompt's positions start
        after it.
        """
        cfg = self.cfg
        x = self._embed(batch)
        cos, sin = self._rope(batch, x.shape[1])
        ctx = Ctx(cos=cos, sin=sin, s_max=s_max)
        caches = []
        x0 = x
        for gi, ((kind, _), layers) in enumerate(zip(self.plan, self.groups)):
            group = []
            for lp in layers:
                x, cache = layer_prefill(cfg, kind, lp, x, ctx)
                group.append(cache)
            caches.append(group)
            if self._shared_after(gi):
                x, cache = shared_prefill(cfg, self.shared, x, x0, gi, ctx)
                caches.append(cache)
        return self._head(x[:, -1:]), tuple(caches)

    @torch.no_grad()
    def decode(self, caches: tuple, token: torch.Tensor, pos: int) -> tuple:
        """token (B,1) int; pos (host int) is the next position to write.

        The caches are updated in place and returned.
        """
        cfg = self.cfg
        pos = int(pos)
        x = self._embed({"tokens": token})
        # arange, not torch.tensor: a host->device copy would stall the step
        poss = torch.arange(pos, pos + 1, dtype=torch.int32, device=x.device)
        cos, sin = (replicate(t) for t in make_rope(cfg, poss))
        ctx = Ctx(cos=cos, sin=sin, pos=pos)
        x0 = x
        ci = 0
        for gi, ((kind, _), layers) in enumerate(zip(self.plan, self.groups)):
            group = caches[ci]
            for i, lp in enumerate(layers):
                x, group[i] = layer_decode(cfg, kind, lp, x, ctx, group[i])
            ci += 1
            if self._shared_after(gi):
                x, _ = shared_decode(cfg, self.shared, x, x0, gi, ctx, caches[ci])
                ci += 1
        return self._head(x), caches

    # -- cache templates ---------------------------------------------------
    def cache_shapes(self, batch: int, s_max: int) -> tuple:
        return cache_shapes(self.cfg, batch, s_max)


def cache_shapes(cfg, batch: int, s_max: int) -> tuple:
    """The caches' (shape, logical axes), each group's stacked along a
    leading ``layers`` axis as in the reference, with a hybrid model's
    shared-block cache after each group but the last."""
    plan = layer_plan(cfg)
    out = []
    for gi, (kind, n) in enumerate(plan):
        per = layer_cache_shape(cfg, kind, batch, s_max)
        out.append({k: ((n,) + sh, ("layers",) + axes) for k, (sh, axes) in per.items()})
        if shared_after(cfg, plan, gi):
            out.append(shared_cache_shape(cfg, batch, s_max))
    return tuple(out)
