"""Transformer building blocks of the dense GQA path: norms, rotary
embeddings, attention (MHA / GQA / MQA), gated FFNs, embeddings.

The port of ``repro/models/blocks.py`` for the dense family.  Conventions
are the reference's:

  * activations are ``cfg.dtype`` (bf16); softmax/norm statistics in f32;
  * parameters are read as ``p["name"]`` from a
    :class:`~repro_torch.models.params.ParamTree`, in the reference's
    layouts (``wq`` is ``(d, H, hd)``, ``wo`` is ``(H, hd, d)``), so weights
    carry across without transposes;
  * shapes: x (B, S, D); attention internals (B, H, S, hd).

Attention goes through :mod:`repro_torch.kernels.ops`: the flash kernel for
prefill and the teacher-forced forward, the decode kernel over the
preallocated cache.  The reference computes the same function with XLA
(``sdpa``), which rounds the probabilities to bf16 before P·V; the kernels
keep them in f32.  MLA and M-RoPE wait for a later slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale/bias)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm(cfg, p, x):
    if cfg.norm == "nonparam_ln":
        return nonparam_layernorm(x)
    return rmsnorm(x, p)


def norm_def(cfg) -> Optional[ParamDef]:
    if cfg.norm == "nonparam_ln":
        return None
    return ParamDef((cfg.d_model,), ("embed",), init="zeros")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta**exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions (..., S) int -> cos/sin (..., S, head_dim//2)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, hd); cos/sin (B, S, hd//2) or (S, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        c, s = cos[None, None], sin[None, None]
    else:
        c, s = cos[:, None], sin[:, None]
    c, s = c.to(x.dtype), s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention layer (covers MHA / GQA / MQA)
# ---------------------------------------------------------------------------


def attn_defs(cfg) -> dict:
    hd = cfg.head_dim
    d = cfg.d_model
    defs = {
        "wq": ParamDef((d, cfg.n_heads, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((cfg.n_heads, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="zeros")
        defs["k_norm"] = ParamDef((hd,), (None,), init="zeros")
    return defs


def attn_cache_shape(cfg, batch: int, s_max: int) -> dict:
    hd = cfg.head_dim
    return {
        "k": (
            (batch, cfg.n_kv_heads, s_max, hd),
            ("batch", "kv_heads", "kv_seq", None),
        ),
        "v": (
            (batch, cfg.n_kv_heads, s_max, hd),
            ("batch", "kv_heads", "kv_seq", None),
        ),
    }


def _qkv(cfg, p, x, cos, sin) -> tuple:
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out_proj(p, out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"])


def attn_train(cfg, p, x, cos, sin) -> torch.Tensor:
    """Causal self-attention over the whole sequence (forward only)."""
    q, k, v = _qkv(cfg, p, x, cos, sin)
    return _out_proj(p, ops.flash_attention(q, k, v, causal=True))


def attn_prefill(cfg, p, x, cos, sin, s_max: int) -> tuple:
    sq = x.shape[1]
    q, k, v = _qkv(cfg, p, x, cos, sin)
    out = ops.flash_attention(q, k, v, causal=True)
    pad = (0, 0, 0, s_max - sq)
    cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    return _out_proj(p, out), cache


def attn_decode(cfg, p, x, cos, sin, cache: dict, pos: int) -> tuple:
    """x (B,1,D); cache k/v (B,Hkv,S_max,hd), written in place at ``pos``.

    The reference masks keys ``<= pos`` (inclusive); the kernel's ``kv_len``
    is exclusive, hence ``pos + 1``.
    """
    q, k_new, v_new = _qkv(cfg, p, x, cos, sin)
    k, v = cache["k"], cache["v"]
    k[:, :, pos : pos + 1] = k_new.to(k.dtype)
    v[:, :, pos : pos + 1] = v_new.to(v.dtype)
    out = ops.decode_attention(q, k, v, pos + 1)
    return _out_proj(p, out), cache


# ---------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def ffn_defs(cfg, d_ff: Optional[int] = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    return {
        "w_gate": ParamDef((d, d_ff), ("embed", "mlp")),
        "w_up": ParamDef((d, d_ff), ("embed", "mlp")),
        "w_down": ParamDef((d_ff, d), ("mlp", "embed")),
    }


def ffn(cfg, p, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if cfg.act == "geglu" else F.silu(g)
    return (act * u) @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def embed_defs(cfg) -> dict:
    defs = {
        # stddev 1/sqrt(d): keeps tied-LM-head logits O(1) at init
        "tok": ParamDef(
            (cfg.vocab_padded, cfg.d_model), ("vocab", "embed"), scale=cfg.d_model**-0.5
        ),
        "out_norm": norm_def(cfg),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"))
    return {k: v for k, v in defs.items() if v is not None}


def embed_tokens(cfg, p, tokens: torch.Tensor) -> torch.Tensor:
    x = p["tok"][tokens]
    if cfg.embed_scale:
        # a 0-d host tensor acts as a scalar (no copy to the card), rounded to
        # x.dtype as the reference rounds it
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_logits(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head; f32 logits over the padded vocab.

    The reference's einsum takes bf16 operands with an f32 result
    (``preferred_element_type``); the f32 product of the bf16 values is the
    same function.
    """
    x = norm(cfg, p.get("out_norm"), x)
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return x.float() @ w.float()
