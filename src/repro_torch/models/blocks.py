"""Transformer building blocks: norms, rotary embeddings (RoPE and Qwen2-VL's
M-RoPE), attention (MHA / GQA / MQA / MLA), gated FFNs, embeddings.

The port of ``repro/models/blocks.py``.  Conventions are the reference's:

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
keep them in f32.

MLA (MiniCPM3's latent KV cache) stays plain ``torch.einsum``, as the
reference's is plain einsum: its absorbed form scores q against one shared
latent "head" whose q·k width (``kv_lora + rope_dim``) differs from its
value width (``kv_lora``), which the flash and decode kernels do not take.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef
from repro_torch.parallel.context import (
    attention_placement,
    contraction_slices,
    current_plan,
    embedding,
    local_offset,
    replicate,
    rows_einsum,
    rows_product,
    seq_rows,
    shard_act,
    sliced_einsum,
    split_dims,
    table_split,
    write_row,
    write_rows,
    zero_pad,
)

#: the residual stream's logical axes, (batch, seq, d_model): where the
#: reference constrains a layer's output, and where a block's output is
#: placed before the residual add
ACT = ("batch", "seq", "act_embed")

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


def norm(cfg, p, x, axes=("batch", None, "act_embed")):
    """The normalised ``x``, its sequence whole: a norm opens each block (and
    the LM head), and under sequence parallelism it is where the sequence is
    gathered for the block's products (Megatron-SP's all-gather, which GSPMD
    places at the product: a DTensor cannot fold a split sequence dim into
    the batch, as ``einsum`` and ``matmul`` do).  ``axes`` places it
    otherwise."""
    y = nonparam_layernorm(x) if cfg.norm == "nonparam_ln" else rmsnorm(x, p)
    return shard_act(y, axes)


def heads_whole(cfg) -> bool:
    """Whether attention (or the mLSTM) keeps ``cfg``'s heads whole on the
    context's mesh (:func:`~repro_torch.parallel.context.attention_placement`):
    its projections then run on each rank's own rows (:func:`_qkv`), and
    attention splits the sequence or, in decode, the cache's sequence."""
    return attention_placement(cfg.n_heads).heads == "rows"


def rows_norm(cfg, p, x):
    """The norm that opens an attention block or an mLSTM block:
    :func:`norm`, but with the heads kept whole (MLA: the sequence split)
    the rows stay split as the residual stream splits them (the block's
    projections take each rank's own rows, so nothing is gathered)."""
    if heads_whole(cfg) if cfg.mla is None else seq_rows():
        return norm(cfg, p, x, ACT)
    return norm(cfg, p, x)


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


def mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections) -> tuple:
    """M-RoPE (Qwen2-VL): positions3 (3, B, S) for (t, h, w) -> cos/sin
    (B, S, head_dim//2); the rotary half-dims are split into ``sections``
    (summing to head_dim//2), each rotating with its own position stream."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {head_dim // 2}")
    freqs = rope_freqs(head_dim, theta, positions3.device)
    ang = positions3[..., None].float() * freqs  # (3, B, S, half)
    cos, sin, start = [], [], 0
    for i, sec in enumerate(sections):
        cos.append(torch.cos(ang[i, ..., start : start + sec]))
        sin.append(torch.sin(ang[i, ..., start : start + sec]))
        start += sec
    return torch.cat(cos, dim=-1), torch.cat(sin, dim=-1)


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


def _qkv(cfg, p, x, cos, sin, decode: bool = False) -> tuple:
    heads = attention_placement(cfg.n_heads).heads
    # the whole heads' products: on each rank's rows by the gathered
    # weights, or in decode under FSDP over each model rank's slice of d
    whole = sliced_einsum if contraction_slices(decode) else rows_einsum
    if heads == "rows":
        # each rank's own rows (its part of the sequence, or of the batch in
        # decode): the (heads x head_dim) outputs are never split, as the
        # heads do not divide the model axis
        q, k, v = whole("bsd,dhk->bhsk", shard_act(x, ACT), p["wq"], p["wk"], p["wv"])
    else:
        q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
        if heads == "kv_rows":
            # query heads split, KV heads whole (they do not divide the axis)
            k, v = whole("bsd,dhk->bhsk", shard_act(x, ACT), p["wk"], p["wv"])
        else:
            k = torch.einsum("bsd,dhk->bhsk", x, p["wk"])
            v = torch.einsum("bsd,dhk->bhsk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = shard_act(apply_rope(q, cos, sin), ("batch", "heads", "seq", None))
    return q, apply_rope(k, cos, sin), v


def _out_proj(cfg, p, out: torch.Tensor) -> torch.Tensor:
    if heads_whole(cfg):
        return rows_einsum("bhsk,hkd->bsd", out, p["wo"])[0]
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"])


def _split_cache(cfg, t) -> bool:
    """Whether a cache entry is a DTensor whose sequence the plan splits
    (``kv_seq`` over more than one rank): decode then attends slice by
    slice."""
    return hasattr(t, "placements") and attention_placement(cfg.n_heads).cache_slices


def attn_train(cfg, p, x, cos, sin) -> torch.Tensor:
    """Causal self-attention over the whole sequence (teacher forcing, training)."""
    q, k, v = _qkv(cfg, p, x, cos, sin)
    return _out_proj(cfg, p, ops.flash_attention(q, k, v, causal=True))


def attn_prefill(cfg, p, x, cos, sin, s_max: int) -> tuple:
    sq = x.shape[1]
    q, k, v = _qkv(cfg, p, x, cos, sin)
    out = ops.flash_attention(q, k, v, causal=True)
    pad = (0, 0, 0, s_max - sq)
    cache = {"k": zero_pad(k, pad), "v": zero_pad(v, pad)}
    return _out_proj(cfg, p, out), cache


def attn_decode(cfg, p, x, cos, sin, cache: dict, pos: int) -> tuple:
    """x (B,1,D); cache k/v (B,Hkv,S_max,hd), written in place at ``pos``.

    The reference masks keys ``<= pos`` (inclusive); the kernel's ``kv_len``
    is exclusive, hence ``pos + 1``.
    """
    q, k_new, v_new = _qkv(cfg, p, x, cos, sin, decode=True)
    k, v = cache["k"], cache["v"]
    if _split_cache(cfg, k):
        # the cache placed as the plan splits it, each rank writing and
        # attending over its own slice (ops.decode_attention merges them)
        axes = attn_cache_shape(cfg, 1, 1)["k"][1]
        k, v = shard_act(k, axes), shard_act(v, axes)
        cache.update(k=k, v=v)
        write_rows(k, k_new, pos, 2)
        write_rows(v, v_new, pos, 2)
    else:
        k[:, :, pos : pos + 1] = k_new.to(k.dtype)
        v[:, :, pos : pos + 1] = v_new.to(v.dtype)
    # a cache kept in another dtype (the reference's f32 caches of the
    # hybrid family) is read in its own, as the reference promotes q
    out = ops.decode_attention(q.to(k.dtype), k, v, pos + 1).to(q.dtype)
    return _out_proj(cfg, p, out), cache


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek-V2 style latent KV)
# ---------------------------------------------------------------------------


def mla_defs(cfg) -> dict:
    m = cfg.mla
    d = cfg.d_model
    h = cfg.n_heads
    return {
        "wdq": ParamDef((d, m.q_lora), ("embed", None)),
        "q_norm": ParamDef((m.q_lora,), (None,), init="zeros"),
        "wuq": ParamDef((m.q_lora, h, m.nope_dim + m.rope_dim), (None, "heads", None)),
        "wdkv": ParamDef((d, m.kv_lora), ("embed", None)),
        "kv_norm": ParamDef((m.kv_lora,), (None,), init="zeros"),
        "wuk": ParamDef((m.kv_lora, h, m.nope_dim), (None, "heads", None)),
        "wuv": ParamDef((m.kv_lora, h, m.v_dim), (None, "heads", None)),
        "wkr": ParamDef((d, m.rope_dim), ("embed", None)),
        "wo": ParamDef((h, m.v_dim, d), ("heads", None, "embed")),
    }


def mla_cache_shape(cfg, batch: int, s_max: int) -> dict:
    m = cfg.mla
    return {
        "c_kv": ((batch, s_max, m.kv_lora), ("batch", "kv_seq", None)),
        "k_rope": ((batch, s_max, m.rope_dim), ("batch", "kv_seq", None)),
    }


def _mla_q(cfg, p, x, cos, sin, product=None) -> tuple:
    """(q_nope, q_rope); ``product`` runs the projections (``torch.einsum``'s
    signature; :func:`~repro_torch.parallel.context.rows_einsum` on each
    rank's rows where the sequence is split)."""
    m = cfg.mla
    product = product or torch.einsum
    cq = rmsnorm(product("bsd,dr->bsr", x, p["wdq"]), p["q_norm"])
    q = product("bsr,rhk->bhsk", cq, p["wuq"])
    return q[..., : m.nope_dim], apply_rope(q[..., m.nope_dim :], cos, sin)


def _mla_latents(cfg, p, x, cos, sin, product=None) -> tuple:
    product = product or torch.einsum
    c_kv = rmsnorm(product("bsd,dr->bsr", x, p["wdkv"]), p["kv_norm"])
    k_rope = product("bsd,dr->bsr", x, p["wkr"])
    k_rope = apply_rope(k_rope[:, None], cos, sin)[:, 0]  # (B, S, rope)
    return c_kv, k_rope


def _rows_einsum(eq: str, x, w):
    """One product of :func:`rows_einsum`."""
    return rows_einsum(eq, x, w)[0]


def _mla_rows(cfg, p, x, cos, sin) -> tuple:
    """MLA's train and prefill where the plan splits the sequence, as
    ``repro``'s GSPMD places it: the projections on each rank's own rows by
    the whole weights; the latents c_kv (B,S,kv_lora) and k_rope (B,S,rope)
    gathered whole along the sequence; each rank's query rows, all heads,
    scored against the whole latents from its row offset
    (:func:`_mla_attend_rows`).  -> (out (B,S,D), c_kv, k_rope), the
    latents whole."""
    x = shard_act(x, ACT)
    q_nope, q_rope = _mla_q(cfg, p, x, cos, sin, _rows_einsum)
    c_kv, k_rope = _mla_latents(cfg, p, x, cos, sin, _rows_einsum)
    whole = ("batch", None, None)
    c_kv, k_rope = shard_act(c_kv, whole), shard_act(k_rope, whole)
    return _mla_attend_rows(cfg, p, q_nope, q_rope, c_kv, k_rope), c_kv, k_rope


def _mla_attend_rows(cfg, p, q_nope, q_rope, c_kv, k_rope):
    """:func:`mla_attend` of DTensors through ``local_map``: each rank's
    query rows (q (B,H,Sq,*) split along Sq) against the whole latents, the
    causal mask from the rank's row offset, the weights gathered; the
    latents' gradients are partial sums over the mesh dims that split the
    sequence, the weights' over those that split the rows (batch or
    sequence)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q_nope.device_mesh
    plan = current_plan()
    rows = list(plan.placements(mesh, "batch", None, "seq", None))
    lat = list(plan.placements(mesh, "batch", None, None))
    out = list(plan.placements(mesh, "batch", "seq", None))
    lat_grad = [Partial() if r.is_shard() and r.dim == 2 else w for r, w in zip(rows, lat)]
    whole = [Replicate()] * mesh.ndim
    w_grad = [Partial() if r.is_shard() else Replicate() for r in rows]
    offset = local_offset(q_nope, 2, rows)
    names = ("wuk", "wuv", "wo")

    def local(q_nope, q_rope, c_kv, k_rope, *ws):
        sq, sk = q_nope.shape[2], c_kv.shape[1]
        pos = torch.arange(sk, device=c_kv.device)
        mask = (offset + pos[:sq, None]) >= pos[None, :]
        return mla_attend(cfg, dict(zip(names, ws)), q_nope, q_rope, c_kv, k_rope, mask)

    return local_map(local, out_placements=out,
                     in_placements=(rows, rows, lat, lat, *(whole for _ in names)),
                     in_grad_placements=(rows, rows, lat_grad, lat_grad,
                                         *(w_grad for _ in names)),
                     device_mesh=mesh, redistribute_inputs=True)(
        q_nope, q_rope, c_kv, k_rope, *(p[n] for n in names))


def mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, mask, groups=()) -> torch.Tensor:
    """Absorbed-matrix MLA attention over the latent cache.

    q_nope (B,H,Sq,nope), q_rope (B,H,Sq,rope); c_kv (B,Sk,kv_lora),
    k_rope (B,Sk,rope); ``mask`` (Sq, Sk), True = attend, or None.  The
    scores are f32 products of the operands (the reference's
    ``preferred_element_type``); the probabilities are rounded to the
    cache's dtype before ``probs · c_kv``, as the reference rounds them.

    ``groups``: where each rank holds a slice of the cache, the process
    groups of the mesh dims that split it; the softmax's max and sum and
    the context ``probs · c_kv`` are then all-reduced over them (each a
    (B,H,Sq)- or (B,H,Sq,kv_lora)-sized tensor), so every rank ends with
    the attention over the whole cache.
    """
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.nope_dim + m.rope_dim)
    # absorb W_uk into q: (B, H, Sq, kv_lora)
    q_eff = torch.einsum("bhsk,rhk->bhsr", q_nope, p["wuk"])
    scores = torch.einsum("bhsr,btr->bhst", q_eff.float(), c_kv.float())
    scores = scores + torch.einsum("bhsk,btk->bhst", q_rope.float(), k_rope.float())
    scores = scores * scale
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    if not groups:
        # one fused pass over the f32 scores; the merged steps below read
        # them five times, which MLA's card-bound prefill pays (minicpm3-4b
        # on an H100: 521 ms of card work a prefill against 418 ms)
        probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
        ctx = torch.einsum("bhst,btr->bhsr", probs, c_kv)
    else:
        import torch.distributed._functional_collectives as funcol

        top = scores.amax(dim=-1, keepdim=True)
        for g in groups:
            top = funcol.all_reduce(top, "max", g)
        e = torch.exp(scores - top)
        total = e.sum(dim=-1, keepdim=True)
        for g in groups:
            total = funcol.all_reduce(total, "sum", g)
        probs = (e / total).to(c_kv.dtype)
        ctx = torch.einsum("bhst,btr->bhsr", probs, c_kv)
        for g in groups:
            ctx = funcol.all_reduce(ctx, "sum", g)
    out = torch.einsum("bhsr,rhv->bhsv", ctx, p["wuv"])
    return torch.einsum("bhsv,hvd->bsd", out, p["wo"])


def _causal_mask(sq: int, device) -> torch.Tensor:
    pos = torch.arange(sq, device=device)
    return replicate(pos[:, None] >= pos[None, :])


def mla_train(cfg, p, x, cos, sin) -> torch.Tensor:
    if seq_rows():
        return _mla_rows(cfg, p, x, cos, sin)[0]
    q_nope, q_rope = _mla_q(cfg, p, x, cos, sin)
    c_kv, k_rope = _mla_latents(cfg, p, x, cos, sin)
    mask = _causal_mask(x.shape[1], x.device)
    return mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, mask)


def mla_prefill(cfg, p, x, cos, sin, s_max: int) -> tuple:
    sq = x.shape[1]
    if seq_rows():
        out, c_kv, k_rope = _mla_rows(cfg, p, x, cos, sin)
    else:
        q_nope, q_rope = _mla_q(cfg, p, x, cos, sin)
        c_kv, k_rope = _mla_latents(cfg, p, x, cos, sin)
        out = mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, _causal_mask(sq, x.device))
    pad = (0, 0, 0, s_max - sq)
    return out, {"c_kv": zero_pad(c_kv, pad), "k_rope": zero_pad(k_rope, pad)}


def mla_decode(cfg, p, x, cos, sin, cache: dict, pos: int) -> tuple:
    """x (B,1,D); cache c_kv (B,S_max,kv_lora) and k_rope (B,S_max,rope),
    written in place at ``pos``.

    The reference masks the cache to keys ``<= pos``; attending over the
    first ``pos + 1`` positions is the same function (a masked key's
    probability is exactly zero).  A cache split along its sequence is
    attended slice by slice (:func:`_mla_decode_split`).
    """
    if _split_cache(cfg, cache["c_kv"]):
        return _mla_decode_split(cfg, p, x, cos, sin, cache, pos)
    return _mla_decode_local(cfg, p, x, cos, sin, cache["c_kv"], cache["k_rope"], pos), cache


def _mla_decode_local(cfg, p, x, cos, sin, c_kv, k_rope, pos: int, start: int = 0,
                      groups=()) -> torch.Tensor:
    """:func:`mla_decode`'s attention on plain tensors: the new latents
    written at ``pos`` of the cache c_kv, k_rope, or of a rank's slice of it
    that starts at ``start``; a slice (``groups``, the process groups that
    split the cache) is written with the same select on every rank and its
    keys masked past ``pos``, as the reference masks the whole cache, and
    the slices merge in :func:`mla_attend`."""
    q_nope, q_rope = _mla_q(cfg, p, x, cos, sin)
    c_new, kr_new = _mla_latents(cfg, p, x, cos, sin)
    if groups:
        write_row(c_kv, c_new, pos - start, 1)
        write_row(k_rope, kr_new, pos - start, 1)
        mask = (start + torch.arange(c_kv.shape[1], device=x.device) <= pos)[None]
        return mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, mask, groups)
    c_kv[:, pos : pos + 1] = c_new.to(c_kv.dtype)
    k_rope[:, pos : pos + 1] = kr_new.to(k_rope.dtype)
    return mla_attend(cfg, p, q_nope, q_rope, c_kv[:, : pos + 1], k_rope[:, : pos + 1], None)


def _mla_decode_split(cfg, p, x, cos, sin, cache: dict, pos: int) -> tuple:
    """:func:`mla_decode` over a latent cache split along its sequence
    (:func:`_mla_decode_local` on each rank's own batch rows, its cache
    slice, the heads whole and the weights gathered), the slices merged in
    place of gathering the cache."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    axes = mla_cache_shape(cfg, 1, 1)
    c_kv = shard_act(cache["c_kv"], axes["c_kv"][1])
    k_rope = shard_act(cache["k_rope"], axes["k_rope"][1])
    cache.update(c_kv=c_kv, k_rope=k_rope)
    mesh = c_kv.device_mesh
    rows = list(current_plan().placements(mesh, "batch", None, None))
    whole = [Replicate()] * mesh.ndim
    groups = [mesh.get_group(d) for d in split_dims(c_kv, 1)]
    start = local_offset(c_kv, 1)
    names = sorted(mla_defs(cfg))

    def local(x, cos, sin, c_kv, k_rope, *ws):
        return _mla_decode_local(cfg, dict(zip(names, ws)), x, cos, sin, c_kv, k_rope,
                                 pos, start, groups)

    cp = list(c_kv.placements)
    out = local_map(local, out_placements=rows,
                    in_placements=(rows, whole, whole, cp, cp, *(whole for _ in names)),
                    device_mesh=mesh, redistribute_inputs=True)(
        x, replicate(cos), replicate(sin), c_kv, k_rope, *(p[n] for n in names))
    return out, cache


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
    return rows_product(shard_act(act * u, ("batch", "seq", "mlp")), p["w_down"])


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
    tok = p["tok"]
    if table_split(tok):
        # each rank's own rows of the table, the partial sums reduced to the
        # residual stream's placements; the table's gradient is placed as
        # the table is, so the tied LM head's joins it
        x = embedding(tok, tokens, ACT)
    elif hasattr(tok, "placements"):
        # a table whole on every rank (the (1, 1) mesh), read by
        # F.embedding: indexing's backward has no sharding on torch 2.11
        x = F.embedding(tokens, shard_act(tok, (None, "embed")))
    else:
        x = tok[tokens]
    if cfg.embed_scale:
        # the scale rounded to x.dtype, as the reference rounds it, then
        # applied as a host scalar (no copy to the card)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return shard_act(x, ("batch", "seq", "act_embed"))


def lm_logits(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head; f32 logits over the padded vocab.

    The reference's einsum takes bf16 operands with an f32 result
    (``preferred_element_type``); the f32 product of the bf16 values is the
    same function.
    """
    x = norm(cfg, p.get("out_norm"), x)
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    # vocab-parallel logits; seq replicated even under sequence parallelism
    return shard_act(x.float() @ w.float(), ("batch", None, "vocab"))
