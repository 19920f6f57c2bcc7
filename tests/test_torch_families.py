"""The port's MLA, MoE, VLM and encoder-decoder models against the JAX package's.

Reduced configs (``cfg.reduced()``: 4 layers, 2 for the encoder-decoder's
encoder, d 128) of minicpm3-4b (MLA), granite-moe-3b-a800m and grok-1-314b
(MoE), qwen2-vl-7b (M-RoPE with 16 stub vision tokens) and
seamless-m4t-medium (16 stub source frames).  The JAX parameters cross as
numpy arrays through ``interop``.

* Whole model, f32: both sides run the same weights cast to f32 (the JAX
  config's ``dtype`` too, which only the encoder's input cast reads), held
  with rtol 2e-2, atol 0.02 * max|logits| (the rule of
  ``tests/test_models.py``) over the teacher-forced logits, the prefill and
  4 decode steps; the MoE aux loss to rtol 1e-5.
* Blocks, bf16: each block against its reference on the same inputs, atol
  0.02 * max|out|, rtol 2e-2; M-RoPE's angles in f32 to 1e-6.
* Routing: ``_route`` on seeded f32 groups, ``dispatch`` exact, ``combine``
  and the aux loss to rtol 1e-5, at the published capacity and at one that
  drops tokens.
* The port's own bf16 decode against its own teacher-forced logits, and
  ``serve_lm`` on the CPU.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import blocks as JB
from repro.models import encdec as JE
from repro.models import lm as JL
from repro.models import moe as JM
from repro.models.model import build_model as jax_build
from repro.models.params import param_count as jax_param_count
from repro_torch import interop, serve_lm
from repro_torch.configs import registry
from repro_torch.core.backend import BackendUnavailable
from repro_torch.models import blocks as TB
from repro_torch.models import encdec as TE
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from repro_torch.models.model import build_model

FAMILIES = [
    "minicpm3-4b",
    "granite-moe-3b-a800m",
    "grok-1-314b",
    "qwen2-vl-7b",
    "seamless-m4t-medium",
]
B, S, PRE = 2, 16, 12
#: stub vision tokens (vlm) and source frames (audio), as tests/test_models.py
N_VISION, N_FRAMES = 16, 16


def _encdec(cfg) -> bool:
    return cfg.family in ("encdec", "audio")


def _state(cfg, tree):
    if _encdec(cfg):
        return interop.encdec_params_from_numpy(cfg, tree)
    return interop.lm_params_from_numpy(cfg, tree)


@functools.lru_cache(maxsize=None)
def _pair(arch, f32=False):
    """(jax cfg, jax model, jax params, port model) with the same weights."""
    jcfg = jax_registry.get(arch).reduced()
    if f32:
        jcfg = dataclasses.replace(jcfg, dtype="float32")
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    cfg = interop.model_config_from_dict(dataclasses.asdict(jcfg))
    model = build_model(cfg, device="cpu")
    if f32:
        model = model.float()
    model.load_state_dict(_state(cfg, jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, model


def _inputs(cfg, seed=7) -> dict:
    """Tokens (B, S) and the family's stub embeddings, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = 0.01 * rng.standard_normal((B, N_VISION, cfg.d_model))
    if _encdec(cfg):
        out["frames"] = 0.1 * rng.standard_normal((B, N_FRAMES, cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in out.items()}


def _jax_batch(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _torch_batch(inputs):
    out = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _offset(cfg) -> int:
    return N_VISION if cfg.family == "vlm" else 0


def _close(got, want, scale):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0.02 * scale)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_pair(a):
    """The same bf16 values as a torch tensor and a JAX array."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# Parameters and caches
# ---------------------------------------------------------------------------


def _defs(arch):
    cfg, jcfg = registry.get(arch), jax_registry.get(arch)
    if _encdec(cfg):
        return JE.EncDec(jcfg).defs, TE.model_defs(cfg)
    return JL.model_defs(jcfg), TL.model_defs(cfg)


def _count(defs) -> int:
    if isinstance(defs, dict):
        return sum(_count(v) for v in defs.values())
    if isinstance(defs, (tuple, list)):
        return sum(_count(v) for v in defs)
    return math.prod(defs.shape)


@pytest.mark.parametrize("arch", jax_registry.ARCH_IDS)
def test_param_counts_match_analytic(arch):
    """The port's declared parameters equal the reference's, within 5% of
    the analytic count (which leaves out norms), and a built (reduced)
    model holds exactly its declared count."""
    jdefs, tdefs = _defs(arch)
    declared = _count(tdefs)
    assert declared == jax_param_count(jdefs)
    analytic = registry.get(arch).param_count()
    assert abs(declared - analytic) / analytic < 0.05, (declared, analytic)
    cfg = registry.get(arch).reduced()
    model = build_model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == _count(model.defs)


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_shapes_match_reference(arch):
    jcfg, jm, _, model = _pair(arch)
    args = (B, S + 8, N_FRAMES) if _encdec(model.cfg) else (B, S + 8)
    assert model.cache_shapes(*args) == jm.cache_shapes(*args)


# ---------------------------------------------------------------------------
# Whole model, f32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_matches_reference_f32(arch):
    _, jm, params, model = _pair(arch, f32=True)
    cfg = model.cfg
    inputs = _inputs(cfg)
    jb, tb = _jax_batch(inputs), _torch_batch(inputs)
    full_j, aux_j = jax.jit(jm.train_logits)(params, jb)
    full_t, aux_t = model.train_logits(tb)
    full_j = np.asarray(full_j)
    scale = float(np.abs(full_j).max())
    _close(full_t.numpy(), full_j, scale)
    if cfg.moe is not None:
        assert float(aux_t) > 0
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)

    off = _offset(cfg)
    s_max = off + S + 8
    pj, pt = dict(jb), dict(tb)
    pj["tokens"], pt["tokens"] = jb["tokens"][:, :PRE], tb["tokens"][:, :PRE]
    lj, cj = jax.jit(jm.prefill, static_argnums=2)(params, pj, s_max)
    lt, ct = model.prefill(pt, s_max=s_max)
    _close(lt.numpy(), np.asarray(lj), scale)
    decode = jax.jit(jm.decode)
    for t in range(PRE, PRE + 4):
        lj, cj = decode(params, cj, jb["tokens"][:, t : t + 1], jnp.int32(off + t))
        lt, ct = model.decode(ct, tb["tokens"][:, t : t + 1], off + t)
        _close(lt.numpy(), np.asarray(lj), scale)


# ---------------------------------------------------------------------------
# Blocks, bf16
# ---------------------------------------------------------------------------


def _layer(arch, i=1):
    """Layer i's parameters on both sides (the first group, or the decoder)."""
    jcfg, _, params, model = _pair(arch)
    if _encdec(model.cfg):
        return jcfg, model.cfg, jax.tree.map(lambda a: a[i], params["dec"]), model.dec[i]
    lp_j = jax.tree.map(lambda a: a[i], params["groups"][0])
    return jcfg, model.cfg, lp_j, model.groups[0][i]


def _x(cfg, seq=S, seed=11):
    rng = np.random.default_rng(seed)
    return _bf16_pair(rng.standard_normal((B, seq, cfg.d_model)))


def _ropes(jcfg, cfg, seq=S):
    rj = JL.make_rope(jcfg, jnp.arange(seq, dtype=jnp.int32))
    rt = TL.make_rope(cfg, torch.arange(seq, dtype=torch.int32))
    return rj, rt


def _mla_pairs(block):
    jcfg, cfg, lp_j, lp_t = _layer("minicpm3-4b")
    pj, pt = lp_j["attn"], lp_t["attn"]
    xt, xj = _x(cfg)
    rj, rt = _ropes(jcfg, cfg)
    if block == "mla_train":
        return [(JB.mla_train(jcfg, pj, xj, *rj), TB.mla_train(cfg, pt, xt, *rt))]
    cs_j, cs_t = (rj[0][:PRE], rj[1][:PRE]), (rt[0][:PRE], rt[1][:PRE])
    oj, cj = JB.mla_prefill(jcfg, pj, xj[:, :PRE], *cs_j, S)
    ot, ct = TB.mla_prefill(cfg, pt, xt[:, :PRE], *cs_t, S)
    pairs = [(oj, ot), (cj["c_kv"], ct["c_kv"]), (cj["k_rope"], ct["k_rope"])]
    if block == "mla_prefill":
        return pairs
    pairs = []
    for pos in range(PRE, PRE + 3):
        sl = slice(pos, pos + 1)
        cs_j, cs_t = (rj[0][sl], rj[1][sl]), (rt[0][sl], rt[1][sl])
        oj, cj = JB.mla_decode(jcfg, pj, xj[:, sl], *cs_j, cj, jnp.int32(pos))
        ot, ct = TB.mla_decode(cfg, pt, xt[:, sl], *cs_t, ct, pos)
        # the port writes its cache in place: compare a snapshot
        pairs += [(oj, ot), (cj["c_kv"], ct["c_kv"].clone())]
        pairs += [(cj["k_rope"], ct["k_rope"].clone())]
    return pairs


def _moe_pairs():
    jcfg, cfg, lp_j, lp_t = _layer("granite-moe-3b-a800m")
    # 2 x 48 tokens: one whole group of 64 and a zero-padded one
    xt, xj = _x(cfg, seq=48)
    yj, aux_j = JM.moe_ffn(jcfg, lp_j["moe"], xj)
    yt, aux_t = TM.moe_ffn(cfg, lp_t["moe"], xt)
    assert yt.dtype == torch.bfloat16 and aux_t.dtype == torch.float32
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    return [(yj, yt)]


def _cross_pairs():
    jcfg, cfg, lp_j, lp_t = _layer("seamless-m4t-medium")
    xt, xj = _x(cfg)
    et, ej = _x(cfg, seq=N_FRAMES + 4, seed=12)  # Sq = 16 queries over 20 frames
    kv_j = JE.cross_kv(jcfg, lp_j["cross"], ej)
    kv_t = TE.cross_kv(cfg, lp_t["cross"], et)
    pairs = [(kv_j["k"], kv_t["k"]), (kv_j["v"], kv_t["v"])]
    pairs.append(
        (JE.cross_attend(jcfg, lp_j["cross"], xj, kv_j),
         TE.cross_attend(cfg, lp_t["cross"], xt, kv_t))
    )
    # a decode step: one query on the decode kernel's path
    pairs.append(
        (JE.cross_attend(jcfg, lp_j["cross"], xj[:, :1], kv_j),
         TE.cross_attend(cfg, lp_t["cross"], xt[:, :1], kv_t, step=True))
    )
    return pairs


def _enc_layer_pairs():
    jcfg, _, params, model = _pair("seamless-m4t-medium")
    cfg = model.cfg
    xt, xj = _x(cfg, seq=N_FRAMES)
    one = dict(params, enc=jax.tree.map(lambda a: a[:1], params["enc"]))
    want = JE.EncDec(jcfg).encode(one, xj)
    cos, sin = model._rope(N_FRAMES)
    got = TB.norm(cfg, model.enc_norm, TE.enc_layer(cfg, model.enc[0], xt, cos, sin))
    return [(want, got)]


def _mrope_pairs():
    jcfg, cfg = jax_registry.get("qwen2-vl-7b").reduced(), registry.get("qwen2-vl-7b").reduced()
    rng = np.random.default_rng(3)
    p3 = rng.integers(0, 64, (3, B, S)).astype(np.int32)
    hd, theta, sec = cfg.head_dim, cfg.rope_theta, cfg.mrope_sections
    pairs = list(zip(JB.mrope_angles(jnp.asarray(p3), hd, theta, sec),
                     TB.mrope_angles(torch.from_numpy(p3), hd, theta, sec)))
    # the model's streams: a 4 x 4 vision grid, then text; and a decode step
    pos = np.arange(N_VISION + S, dtype=np.int32)
    grid = (N_VISION, 4, 4)
    pairs += list(zip(JL.make_rope(jcfg, jnp.asarray(pos), grid),
                      TL.make_rope(cfg, torch.from_numpy(pos), grid)))
    pairs += list(zip(JL.make_rope(jcfg, jnp.asarray(pos[-1:])),
                      TL.make_rope(cfg, torch.from_numpy(pos[-1:]))))
    return pairs


BLOCKS = ["mla_train", "mla_prefill", "mla_decode", "moe_ffn", "cross_attend",
          "enc_layer"]


@pytest.mark.parametrize("block", BLOCKS)
def test_block_matches_reference_bf16(block):
    if block.startswith("mla"):
        pairs = _mla_pairs(block)
    elif block == "moe_ffn":
        pairs = _moe_pairs()
    elif block == "cross_attend":
        pairs = _cross_pairs()
    else:
        pairs = _enc_layer_pairs()
    for want, got in pairs:
        assert got.dtype == torch.bfloat16
        want, got = _np32(want), _np32(got)
        _close(got, want, float(np.abs(want).max()))


def test_mrope_angles_match_reference_f32():
    for want, got in _mrope_pairs():
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_mrope_sections_must_cover_half_the_head():
    with pytest.raises(ValueError):
        TB.mrope_angles(torch.zeros((3, 1, 4), dtype=torch.int32), 32, 1e4, (4, 6, 5))


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_route_matches_reference(capacity_factor):
    jcfg = jax_registry.get("granite-moe-3b-a800m").reduced()
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor)
    )
    cfg = interop.model_config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(5)
    xg = rng.standard_normal((3, 64, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.moe.n_experts)) / 8).astype(np.float32)
    cj, dj, aux_j = JM._route(jcfg, {"router": jnp.asarray(router)}, jnp.asarray(xg))
    ct, dt, aux_t = TM._route(cfg, {"router": torch.from_numpy(router)},
                              torch.from_numpy(xg))
    C = TM.capacity(cfg, 64)
    assert ct.shape == (3, 64, cfg.moe.n_experts, C) and dt.dtype == torch.float32
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    # each token holds at most one slot of an expert; a slot at most one token
    assert float(dt.sum(dim=3).max()) <= 1 and float(dt.sum(dim=1).max()) <= 1
    placed = int(dt.sum())
    if capacity_factor < 1:
        assert placed < 3 * 64 * cfg.moe.top_k  # the buffers overflow: drops
        assert placed == int(np.asarray(dj).sum())
    else:
        assert placed > 0.9 * 3 * 64 * cfg.moe.top_k


# ---------------------------------------------------------------------------
# The port's own bf16 decode, and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "arch", ["minicpm3-4b", "qwen2-vl-7b", "seamless-m4t-medium", "granite-moe-3b-a800m"]
)
def test_decode_matches_own_teacher_forcing_bf16(arch):
    cfg = registry.get(arch).reduced()
    if cfg.moe is not None:
        # ample capacity: no token dropped (tests/test_models.py's rule)
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0)
        )
    model = build_model(cfg, device="cpu", seed=5)
    tb = _torch_batch(_inputs(cfg))
    full, _ = model.train_logits(tb)
    scale = float(full.abs().max())
    off = _offset(cfg)
    pre = dict(tb, tokens=tb["tokens"][:, :PRE])
    logits, caches = model.prefill(pre, s_max=off + S + 8)
    _close(logits[:, 0], full[:, off + PRE - 1], scale)
    for t in range(PRE, S):
        logits, caches = model.decode(caches, tb["tokens"][:, t : t + 1], off + t)
        _close(logits[:, 0], full[:, off + t], scale)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_lm_runs_on_the_cpu(arch, capsys):
    res = serve_lm.main(
        ["--arch", arch, "--device", "cpu", "--batch", "2"]
        + ["--prompt-len", "8", "--new-tokens", "5"]
    )
    assert tuple(res.tokens.shape) == (2, 5)
    assert len(res.decode_logits) == 4
    assert int(res.tokens.max()) < registry.get(arch).reduced().vocab_padded
    assert "tok/s" in capsys.readouterr().out


def test_encdec_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        build_model(registry.get("seamless-m4t-medium").reduced())
    with pytest.raises(BackendUnavailable):
        serve_lm.main(["--arch", "qwen2-vl-7b"])
