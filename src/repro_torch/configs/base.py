"""Model/shape configuration system.

``ModelConfig`` covers the ten assigned architectures via family-specific
sub-configs (MLA, MoE, SSM, mLSTM, hybrid, enc-dec, VLM).  ``ShapeConfig``
encodes the four assigned input shapes.  ``configs.registry`` maps arch ids
to their exact published configurations plus reduced smoke variants.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


def pad_to(n: int, mult: int = 256) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 768
    kv_lora: int = 256
    nope_dim: int = 64
    rope_dim: int = 32
    v_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 0            # per-expert hidden size
    capacity_factor: float = 1.25
    group_size: int = 512        # GShard dispatch group length (tokens)
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD block."""
    state: int = 64              # N
    headdim: int = 64            # P
    expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128             # SSD chunk length


@dataclass(frozen=True)
class MLSTMConfig:
    """xLSTM mLSTM block."""
    proj_factor: int = 2         # inner = proj_factor * d_model
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 32000
    head_dim: int = 0            # 0 -> d_model // n_heads
    act: str = "swiglu"          # swiglu | geglu
    norm: str = "rms"            # rms | nonparam_ln
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple] = None   # qwen2-vl M-RoPE
    qk_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma multiplies embeddings by sqrt(d)
    dtype: str = "bfloat16"
    remat: str = "full"          # none | full  (training scan policy)
    use_pallas: bool = False     # TPU Pallas kernels (tests use interpret)
    attn_impl: str = "naive"     # naive | chunked (flash-style XLA path)
    attn_chunk: int = 1024       # KV block for chunked attention
    # family extensions
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mlstm: Optional[MLSTMConfig] = None
    shared_attn_every: int = 0   # zamba2: shared attn block interval
    n_enc_layers: int = 0        # encdec split (n_layers = decoder layers)
    # notes from the source line (verification tier etc.)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab)

    # -- analytic parameter counts (MODEL_FLOPS = 6*N*D uses these) -------
    def params_per_attn(self) -> int:
        d, h, kv, hd = (self.d_model, self.n_heads, self.n_kv_heads,
                        self.head_dim)
        if self.mla is not None:
            m = self.mla
            return (d * m.q_lora + m.q_lora * h * (m.nope_dim + m.rope_dim)
                    + d * m.kv_lora + m.kv_lora * h * (m.nope_dim + m.v_dim)
                    + d * m.rope_dim + h * m.v_dim * d)
        return d * h * hd + 2 * d * kv * hd + h * hd * d

    def params_per_ffn(self) -> int:
        if self.moe is not None:
            e = self.moe
            return (self.d_model * e.n_experts          # router
                    + e.n_experts * 3 * self.d_model * e.d_expert)
        return 3 * self.d_model * self.d_ff

    def params_per_ffn_active(self) -> int:
        if self.moe is not None:
            e = self.moe
            return (self.d_model * e.n_experts
                    + e.top_k * 3 * self.d_model * e.d_expert)
        return self.params_per_ffn()

    def params_per_ssm(self) -> int:
        s = self.ssm
        di = s.expand * self.d_model
        nheads = di // s.headdim
        # in_proj emits [z(di), x(di), B(N), C(N), dt(H)] (n_groups = 1)
        return (self.d_model * (2 * di + 2 * s.state + nheads)
                + s.conv_width * (di + 2 * s.state) + di
                + di * self.d_model)

    def params_per_mlstm(self) -> int:
        m = self.mlstm
        di = m.proj_factor * self.d_model
        dh = di // max(1, self.n_heads)
        return (self.d_model * 2 * di       # up proj (mlstm + gate streams)
                + 3 * di * dh               # q,k,v — block-diagonal per head
                + di * 2 * self.n_heads     # i/f gate projections
                + m.conv_width * di + di    # causal conv + head norm
                + di * self.d_model)        # down proj

    def param_count(self, active_only: bool = False) -> int:
        d = self.d_model
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        per_ffn = (self.params_per_ffn_active() if active_only
                   else self.params_per_ffn())
        if self.family in ("dense", "moe", "vlm"):
            return emb + self.n_layers * (self.params_per_attn() + per_ffn)
        if self.family == "ssm":
            return emb + self.n_layers * self.params_per_mlstm()
        if self.family == "hybrid":
            # shared attention block operates at width 2d (H*hd == 2d);
            # per-invocation down projections 2d -> d are unshared
            d2 = 2 * d
            n_inv = max(1, -(-self.n_layers // max(1, self.shared_attn_every))
                        - 1)
            shared = 4 * d2 * d2 + 3 * d2 * self.d_ff + n_inv * d2 * d
            return emb + self.n_layers * self.params_per_ssm() + shared
        if self.family in ("encdec", "audio"):
            enc = self.n_enc_layers * (self.params_per_attn() + per_ffn)
            dec = self.n_layers * (2 * self.params_per_attn() + per_ffn)
            return emb + enc + dec
        raise ValueError(self.family)

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 5),
            d_model=128,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            remat="none",
        )
        if self.family == "hybrid":
            kw["shared_attn_every"] = 2
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora=64, kv_lora=32, nope_dim=32,
                                  rope_dim=16, v_dim=32)
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_experts=min(self.moe.n_experts, 8),
                                top_k=min(self.moe.top_k, 2), d_expert=64,
                                group_size=64)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state=16, headdim=32, chunk=16)
        if self.mlstm is not None:
            kw["mlstm"] = replace(self.mlstm, chunk=16)
        if self.mrope_sections is not None:
            kw["head_dim"] = 32
            kw["mrope_sections"] = (4, 6, 6)
        kw.update(overrides)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); D = tokens
    processed by the step (decode: one token per sequence)."""
    n_active = cfg.param_count(active_only=True) \
        - cfg.vocab_padded * cfg.d_model * (0 if cfg.tie_embeddings else 1) \
        + cfg.vocab_padded * cfg.d_model  # lm head matmul counts; embedding gather doesn't
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.tokens)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n_active * tokens
