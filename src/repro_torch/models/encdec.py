"""Encoder-decoder model (the SeamlessM4T-medium backbone).

The port of ``repro/models/encdec.py``.  The audio and text frontends are
stubs, as in the reference: the encoder takes precomputed frame embeddings
(B, S_src, d); the decoder is a causal transformer with cross-attention
over the encoder's output.  Communication regions are the reference's:
``encoder``, ``embed``, ``self_attn``, ``cross_attn``, ``mlp``,
``lm_head``.

Attention runs on the hand-written kernels through
:mod:`repro_torch.kernels.ops`: the encoder's bidirectional self-attention
and the prefill's cross-attention (queries the prompt, keys the source
frames) on the flash kernel with ``causal=False``; the decoder's
self-attention through the blocks' ``attn_train`` / ``attn_prefill`` /
``attn_decode``; the cross-attention of a decode step on the decode kernel
over all ``S_src`` keys.  The reference computes these with ``sdpa``,
which rounds the probabilities to bf16; the kernels keep them in f32.

As in :mod:`repro_torch.models.lm`, a stacked layer group is an
``nn.ModuleList`` of per-layer modules and the scan is a Python loop.  The
encoder's K/V of each decoder layer are computed once at prefill and
carried in the caches; the decoder's self-attention caches are updated in
place by :meth:`EncDec.decode`.  Under ``cfg.remat == "full"`` training
recomputes each decoder layer in the backward, as the reference
checkpoints its decoder body (the encoder runs straight, as there).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.regions import comm_region
from repro_torch.kernels import ops
from repro_torch.models import blocks as B
from repro_torch.models.lm import remat, resolve_device
from repro_torch.models.params import (
    ParamDef,
    ParamTree,
    init_tree,
    stack_defs,
    unstack,
)
from repro_torch.parallel.context import replicate, shard_act


def cross_attn_defs(cfg) -> dict:
    hd = cfg.head_dim
    d = cfg.d_model
    return {
        "wq": ParamDef((d, cfg.n_heads, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((cfg.n_heads, hd, d), ("heads", None, "embed")),
    }


def cross_attend(cfg, p, x, enc_kv: dict, *, step: bool = False) -> torch.Tensor:
    """x (B,Sq,D) over the encoder's K/V (B,Hkv,S_src,hd), unmasked.

    ``step`` marks a decode step (Sq = 1): it runs the decode kernel over
    all ``S_src`` keys; otherwise the flash kernel runs with ``causal=False``.
    """
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    k, v = enc_kv["k"], enc_kv["v"]
    if step:
        out = ops.decode_attention(q, k, v, k.shape[2])
    else:
        out = ops.flash_attention(q, k, v, causal=False)
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"])


def cross_kv(cfg, p, enc_out: torch.Tensor) -> dict:
    return {
        "k": torch.einsum("bsd,dhk->bhsk", enc_out, p["wk"]),
        "v": torch.einsum("bsd,dhk->bhsk", enc_out, p["wv"]),
    }


def enc_layer_defs(cfg) -> dict:
    d = {
        "norm1": B.norm_def(cfg),
        "attn": B.attn_defs(cfg),
        "norm2": B.norm_def(cfg),
        "ffn": B.ffn_defs(cfg),
    }
    return {k: v for k, v in d.items() if v is not None}


def dec_layer_defs(cfg) -> dict:
    d = {
        "norm1": B.norm_def(cfg),
        "self_attn": B.attn_defs(cfg),
        "norm_c": B.norm_def(cfg),
        "cross": cross_attn_defs(cfg),
        "norm2": B.norm_def(cfg),
        "ffn": B.ffn_defs(cfg),
    }
    return {k: v for k, v in d.items() if v is not None}


def model_defs(cfg) -> dict:
    if cfg.n_enc_layers <= 0:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs n_enc_layers > 0")
    defs = {
        "embed": B.embed_defs(cfg),
        "enc": stack_defs(enc_layer_defs(cfg), cfg.n_enc_layers),
        "enc_norm": B.norm_def(cfg),
        "dec": stack_defs(dec_layer_defs(cfg), cfg.n_layers),
    }
    return {k: v for k, v in defs.items() if v is not None}


def enc_layer(cfg, p, x, cos, sin) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention, then the FFN."""
    with comm_region("encoder"):
        a = B.norm(cfg, p.get("norm1"), x)
        q = B.apply_rope(torch.einsum("bsd,dhk->bhsk", a, p["attn"]["wq"]), cos, sin)
        k = B.apply_rope(torch.einsum("bsd,dhk->bhsk", a, p["attn"]["wk"]), cos, sin)
        v = torch.einsum("bsd,dhk->bhsk", a, p["attn"]["wv"])
        o = ops.flash_attention(q, k, v, causal=False)
        x = x + shard_act(torch.einsum("bhsk,hkd->bsd", o, p["attn"]["wo"]), B.ACT)
        h = B.ffn(cfg, p["ffn"], B.norm(cfg, p.get("norm2"), x))
        x = x + shard_act(h, B.ACT)
        return shard_act(x, B.ACT)


def _layers(defs: dict, n: int, generator, device) -> nn.ModuleList:
    """A stacked group's parameters, drawn whole, as one module per layer."""
    stacked = init_tree(defs, generator, device)
    return nn.ModuleList(ParamTree(unstack(stacked, i)) for i in range(n))


class EncDec(nn.Module):
    """Encoder-decoder over a ModelConfig, with its parameters.

    Parameters are drawn from ``generator`` (by default a ``torch.Generator``
    on ``device`` seeded with ``seed``) by the reference's init rule, in the
    reference's layouts: ``embed``, ``enc`` and ``dec`` (one module per
    layer), and ``enc_norm``.  ``device`` defaults to the CUDA card.

    The caches (:meth:`prefill`, :meth:`decode`) are ``(self_caches,
    enc_kvs)``: one self-attention KV cache and one dict of the encoder's
    K/V per decoder layer.
    """

    def __init__(self, cfg, *, device=None, generator=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.defs = model_defs(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        self.embed = ParamTree(init_tree(self.defs["embed"], generator, device))
        self.enc = _layers(self.defs["enc"], cfg.n_enc_layers, generator, device)
        self.enc_norm = None
        if "enc_norm" in self.defs:
            tree = init_tree({"enc_norm": self.defs["enc_norm"]}, generator, device)
            self.enc_norm = nn.Parameter(tree["enc_norm"], requires_grad=False)
        self.dec = _layers(self.defs["dec"], cfg.n_layers, generator, device)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def _rope(self, seq: int) -> tuple:
        positions = torch.arange(seq, dtype=torch.int32, device=self.device)
        cos, sin = B.rope_angles(positions, self.cfg.head_dim, self.cfg.rope_theta)
        return replicate(cos), replicate(sin)

    # -- encoder -----------------------------------------------------------
    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_src, d) -> the encoder's output (B, S_src, d)."""
        return self._encode(frames)

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = shard_act(frames.to(self.embed["tok"].dtype), B.ACT)
        cos, sin = self._rope(x.shape[1])
        for lp in self.enc:
            x = enc_layer(cfg, lp, x, cos, sin)
        return B.norm(cfg, self.enc_norm, x)

    # -- decoder -----------------------------------------------------------
    def _dec_layer(self, lp, x, cos, sin, enc_kv, mode: str, cache=None, pos=None,
                   s_max: int = 0) -> tuple:
        cfg = self.cfg
        with comm_region("self_attn"):
            h = B.norm(cfg, lp.get("norm1"), x)
            if mode == "train":
                h = B.attn_train(cfg, lp["self_attn"], h, cos, sin)
                x = x + shard_act(h, B.ACT)
            elif mode == "prefill":
                o, cache = B.attn_prefill(cfg, lp["self_attn"], h, cos, sin, s_max)
                x = x + shard_act(o, B.ACT)
            else:
                o, cache = B.attn_decode(cfg, lp["self_attn"], h, cos, sin, cache, pos)
                x = x + shard_act(o, B.ACT)
        with comm_region("cross_attn"):
            h = B.norm(cfg, lp.get("norm_c"), x)
            h = cross_attend(cfg, lp["cross"], h, enc_kv, step=mode == "decode")
            x = x + shard_act(h, B.ACT)
        with comm_region("mlp"):
            h = B.ffn(cfg, lp["ffn"], B.norm(cfg, lp.get("norm2"), x))
            x = x + shard_act(h, B.ACT)
        return shard_act(x, B.ACT), cache

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        with comm_region("embed"):
            return B.embed_tokens(self.cfg, self.embed, tokens)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        with comm_region("lm_head"):
            return B.lm_logits(self.cfg, self.embed, x)

    def train_logits(self, batch: dict) -> tuple:
        """Logits over every target position and a zero aux loss; ``batch``
        holds ``frames`` and ``tokens``.  Autograd records the call when a
        parameter requires a gradient."""
        enc_out = self._encode(batch["frames"])
        x = self._embed(batch["tokens"])
        cos, sin = self._rope(x.shape[1])
        for lp in self.dec:
            x = remat(self.cfg, self._train_layer, lp, x, cos, sin, enc_out)
        return self._head(x), torch.zeros((), dtype=torch.float32, device=x.device)

    def _train_layer(self, lp, x, cos, sin, enc_out) -> torch.Tensor:
        """One decoder layer of :meth:`train_logits`, its cross K/V included
        (the body the reference checkpoints under ``remat == "full"``)."""
        enc_kv = cross_kv(self.cfg, lp["cross"], enc_out)
        return self._dec_layer(lp, x, cos, sin, enc_kv, "train")[0]

    # -- serving -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: dict, s_max: int) -> tuple:
        """Logits of the last prompt position and the caches: the decoder's
        self-attention caches (padded to s_max) and the encoder's K/V."""
        enc_out = self.encode(batch["frames"])
        x = self._embed(batch["tokens"])
        cos, sin = self._rope(x.shape[1])
        self_caches, enc_kvs = [], []
        for lp in self.dec:
            enc_kv = cross_kv(self.cfg, lp["cross"], enc_out)
            x, cache = self._dec_layer(lp, x, cos, sin, enc_kv, "prefill", s_max=s_max)
            self_caches.append(cache)
            enc_kvs.append(enc_kv)
        return self._head(x[:, -1:]), (self_caches, enc_kvs)

    @torch.no_grad()
    def decode(self, caches: tuple, token: torch.Tensor, pos: int) -> tuple:
        """token (B,1) int; pos (host int) is the next position to write.

        The self-attention caches are updated in place; the caches are
        returned.
        """
        pos = int(pos)
        self_caches, enc_kvs = caches
        x = self._embed(token)
        # arange, not torch.tensor: a host->device copy would stall the step
        poss = torch.arange(pos, pos + 1, dtype=torch.int32, device=x.device)
        cos, sin = (replicate(t) for t in B.rope_angles(poss, self.cfg.head_dim,
                                                         self.cfg.rope_theta))
        for i, lp in enumerate(self.dec):
            x, self_caches[i] = self._dec_layer(
                lp, x, cos, sin, enc_kvs[i], "decode", cache=self_caches[i], pos=pos
            )
        return self._head(x), caches

    # -- cache templates ---------------------------------------------------
    def cache_shapes(self, batch: int, s_max: int, s_src: int) -> tuple:
        return cache_shapes(self.cfg, batch, s_max, s_src)


def cache_shapes(cfg, batch: int, s_max: int, s_src: int) -> tuple:
    """(self-attention caches, the encoder's K/V): each (shape, logical
    axes), stacked along a leading ``layers`` axis."""
    n = cfg.n_layers
    self_c = {
        k: ((n,) + shape, ("layers",) + axes)
        for k, (shape, axes) in B.attn_cache_shape(cfg, batch, s_max).items()
    }
    enc_kv = {
        k: (
            (n, batch, cfg.n_kv_heads, s_src, cfg.head_dim),
            ("layers", "batch", "kv_heads", None, None),
        )
        for k in ("k", "v")
    }
    return (self_c, enc_kv)
