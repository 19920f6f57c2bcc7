"""The ten assigned architectures — exact published configurations.

Source lines (verification tier in brackets) are quoted from the assignment;
see DESIGN.md §4 for applicability notes and the granite expert-count
discrepancy (structured field "40e top-8" wins over the bracket note).
"""

from __future__ import annotations

from repro_torch.configs.base import (MLAConfig, MLSTMConfig, MoEConfig,
                                ModelConfig, SSMConfig)


ARCHS: dict = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


minicpm3_4b = _register(ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=64,
    mla=MLAConfig(q_lora=768, kv_lora=256, nope_dim=64, rope_dim=32,
                  v_dim=64),
    source="[hf:openbmb/MiniCPM3-4B; hf] MLA",
))

deepseek_coder_33b = _register(ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, head_dim=128,
    source="[arXiv:2401.14196; hf] llama-arch GQA kv=8",
))

gemma_2b = _register(ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=256000, head_dim=256,
    act="geglu", embed_scale=True, tie_embeddings=True,
    source="[arXiv:2403.08295; hf] GeGLU, head_dim=256, MQA",
))

olmo_1b = _register(ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304, head_dim=128,
    norm="nonparam_ln", tie_embeddings=True,
    source="[arXiv:2402.00838; hf] non-parametric LN",
))

zamba2_1p2b = _register(ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=128,   # head_dim at shared 2d width
    ssm=SSMConfig(state=64, headdim=64, expand=2, conv_width=4, chunk=128),
    shared_attn_every=6,
    source="[arXiv:2411.15242; hf] Mamba2 + shared attn blocks, ssm_state=64",
))

qwen2_vl_7b = _register(ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    mrope_sections=(16, 24, 24),
    source="[arXiv:2409.12191; hf] M-RoPE, dynamic resolution (stub frontend)",
))

seamless_m4t_medium = _register(ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    source="[arXiv:2308.11596; hf] enc-dec, multimodal (stub frontend)",
))

xlstm_1p3b = _register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=1024,
    mlstm=MLSTMConfig(proj_factor=2, conv_width=4, chunk=128),
    source="[arXiv:2405.04517; unverified] sLSTM + mLSTM blocks",
))

granite_moe_3b = _register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512,
                  capacity_factor=1.25, group_size=256),
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] MoE 40e top-8",
))

grok_1_314b = _register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768,
                  capacity_factor=1.25, group_size=256),
    source="[hf:xai-org/grok-1; unverified] MoE 8e top-2",
))


ARCH_IDS = tuple(ARCHS)


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return ARCHS[name]
