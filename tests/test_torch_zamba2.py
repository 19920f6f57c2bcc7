"""The port's zamba2 (hybrid: Mamba-2 + shared attention) against the JAX one.

The reduced zamba2-1.2b (5 Mamba-2 layers in groups 2+2+1, d 128, SSD heads
of 32 over a state of 16, chunk 16; a shared attention + FFN block at width
256 after the first two groups).  The JAX parameters cross as numpy arrays
through ``interop.lm_params_from_numpy``.

* Blocks, bf16: the Mamba-2 block (train, prefill state, decode steps) and
  the shared block (train, prefill, decode) against the reference on the
  same inputs, with atol 0.02 * max|out| and rtol 2e-2.  The port's SSD
  keeps its intra-chunk weights in f32; the reference's ``_ssd_chunked``
  rounds them to bf16.
* Whole model, f32: prefill, four decode steps and the teacher-forced
  logits against the JAX ``LM`` by the rule of ``tests/test_torch_lm.py``
  (rtol 2e-2, atol 0.02 * max|logits|, and within 1e-3 of the scale).
* The port's own decode against its own teacher forcing: in bf16 within
  0.05 * max|logits| on ``tests/test_models.py``'s config for recurrent
  archs (2 layers, no shared block), and in f32 within 1e-3 of the scale on
  the reduced config with its shared blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import lm as JL
from repro.models import mamba as JM
from repro.models.model import build_model as jax_build
from repro_torch import interop, serve_lm
from repro_torch.configs import registry
from repro_torch.core.backend import BackendUnavailable
from repro_torch.models import lm as TL
from repro_torch.models import mamba as TM
from repro_torch.models.model import build_model

ARCH = "zamba2-1.2b"
B, S, PRE = 2, 20, 12


def _pair(dtype=None):
    """(jax cfg, jax model, jax params, port model) with the same weights."""
    jcfg = jax_registry.get(ARCH).reduced()
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if dtype is not None:
        params = jax.tree.map(lambda a: a.astype(dtype), params)
    cfg = interop.model_config_from_dict(dataclasses.asdict(jcfg))
    model = build_model(cfg, device="cpu")
    if dtype == jnp.float32:
        model = model.float()
    tree = jax.tree.map(np.asarray, params)
    model.load_state_dict(interop.lm_params_from_numpy(cfg, tree))
    return jcfg, jm, params, model


def _tokens(cfg, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, scale):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0.02 * scale)


def _close_pairs(pairs):
    for want, got in pairs:
        want = _np32(want)
        _close(got, want, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_param_defs_match_reference(size):
    jcfg, tcfg = jax_registry.get(ARCH), registry.get(ARCH)
    if size == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jdefs, tdefs = JL.model_defs(jcfg), TL.model_defs(tcfg)
    is_def = lambda x: hasattr(x, "axes")  # noqa: E731
    jleaves = jax.tree_util.tree_flatten_with_path(jdefs, is_leaf=is_def)[0]
    tleaves = jax.tree_util.tree_flatten_with_path(tdefs, is_leaf=is_def)[0]
    assert [(p, dataclasses.asdict(d)) for p, d in jleaves] == [
        (p, dataclasses.asdict(d)) for p, d in tleaves
    ]
    assert TL.layer_plan(tcfg) == JL.layer_plan(jcfg)
    n_inv = len(JL.layer_plan(jcfg)) - 1
    assert tdefs["shared"]["down"].shape == (n_inv, 2 * tcfg.d_model, tcfg.d_model)


def test_plan_and_cache_shapes_match_reference():
    jcfg = jax_registry.get(ARCH).reduced()
    model = build_model(registry.get(ARCH).reduced(), device="cpu")
    assert model.plan == [("mamba", 2), ("mamba", 2), ("mamba", 1)]
    assert model.cache_shapes(B, 32) == JL.LM(jcfg).cache_shapes(B, 32)
    full = registry.get(ARCH)
    assert [n for _, n in TL.layer_plan(full)] == [6, 6, 6, 6, 6, 6, 2]


def test_init_follows_the_reference_rule():
    cfg = registry.get(ARCH).reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    ssm = model.groups[0][0]["ssm"]
    for name, fill in (("a_log", 0.0), ("d_skip", 1.0), ("dt_bias", 0.0)):
        assert ssm[name].dtype == torch.float32
        assert torch.all(ssm[name] == fill)
    assert ssm["in_proj"].dtype == torch.bfloat16
    assert torch.count_nonzero(ssm["gate_norm"]) == 0
    # normal x 1/sqrt(shape[-2]): the stacked (n, d, k) in_proj -> d
    std = ssm["in_proj"].float().std().item()
    assert abs(std - cfg.d_model**-0.5) < 0.05 * cfg.d_model**-0.5
    down = model.shared["down"]
    assert tuple(down.shape) == (2, 2 * cfg.d_model, cfg.d_model)
    std = down.float().std().item()
    assert abs(std - (2 * cfg.d_model) ** -0.5) < 0.05 * (2 * cfg.d_model) ** -0.5


def test_rope_runs_at_the_shared_width():
    """The hybrid's rotary dim is 2 d / n_heads (64 here), not head_dim (32)."""
    jcfg = jax_registry.get(ARCH).reduced()
    cfg = registry.get(ARCH).reduced()
    cos_j, sin_j = JL.make_rope(jcfg, jnp.arange(S, dtype=jnp.int32))
    cos_t, sin_t = TL.make_rope(cfg, torch.arange(S, dtype=torch.int32))
    assert cos_t.shape[-1] == cfg.d_model // cfg.n_heads != cfg.head_dim // 2
    _close_pairs([(cos_j, cos_t), (sin_j, sin_t)])


# ---------------------------------------------------------------------------
# Blocks, bf16
# ---------------------------------------------------------------------------


def _block_inputs():
    jcfg, _, params, model = _pair()
    cfg = model.cfg
    rng = np.random.default_rng(11)

    def both(shape):
        t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t

    return jcfg, cfg, params, model, both


@pytest.mark.parametrize("block", ["train", "state", "decode"])
def test_mamba_block_matches_reference_bf16(block):
    jcfg, cfg, params, model, both = _block_inputs()
    lp_j = jax.tree.map(lambda a: a[1], params["groups"][0])["ssm"]
    lp_t = model.groups[0][1]["ssm"]
    xj, xt = both((B, S, cfg.d_model))
    pairs = []
    if block == "train":
        pairs.append((JM.mamba_train(jcfg, lp_j, xj), TM.mamba_train(cfg, lp_t, xt)))
    else:
        oj, sj = JM.mamba_train(jcfg, lp_j, xj[:, :PRE], return_state=True)
        ot, st = TM.mamba_train(cfg, lp_t, xt[:, :PRE], return_state=True)
        assert st["ssm"].dtype == torch.float32
        # decode updates the state in place: compare snapshots
        pairs += [(oj, ot), (sj["conv"], st["conv"].clone())]
        pairs += [(sj["ssm"], st["ssm"].clone())]
        if block == "decode":
            for t in range(PRE, PRE + 4):
                oj, sj = JM.mamba_decode(jcfg, lp_j, xj[:, t : t + 1], sj)
                ot, st2 = TM.mamba_decode(cfg, lp_t, xt[:, t : t + 1], st)
                assert st2 is st  # updated in place
                pairs += [(oj, ot), (sj["conv"], st["conv"].clone())]
                pairs += [(sj["ssm"], st["ssm"].clone())]
    _close_pairs(pairs)


@pytest.mark.parametrize("block", ["train", "prefill", "decode"])
def test_shared_block_matches_reference_bf16(block):
    jcfg, cfg, params, model, both = _block_inputs()
    xj, xt = both((B, S, cfg.d_model))
    x0j, x0t = both((B, S, cfg.d_model))
    cos_j, sin_j = JL.make_rope(jcfg, jnp.arange(S, dtype=jnp.int32))
    cos_t, sin_t = TL.make_rope(cfg, torch.arange(S, dtype=torch.int32))
    sp_j, sp_t = params["shared"], model.shared
    inv = 1  # the second invocation's own down-projection
    pairs = []
    if block == "train":
        ctx_j, ctx_t = JL.Ctx(cos=cos_j, sin=sin_j), TL.Ctx(cos=cos_t, sin=sin_t)
        want = JL.shared_train(jcfg, sp_j, xj, x0j, inv, ctx_j)
        pairs.append((want, TL.shared_train(cfg, sp_t, xt, x0t, inv, ctx_t)))
    else:
        ctx_j = JL.Ctx(cos=cos_j[:PRE], sin=sin_j[:PRE], s_max=S)
        ctx_t = TL.Ctx(cos=cos_t[:PRE], sin=sin_t[:PRE], s_max=S)
        sl = slice(0, PRE)
        oj, cj = JL.shared_prefill(jcfg, sp_j, xj[:, sl], x0j[:, sl], inv, ctx_j)
        ot, ct = TL.shared_prefill(cfg, sp_t, xt[:, sl], x0t[:, sl], inv, ctx_t)
        # decode writes the cache in place: compare snapshots
        pairs += [(oj, ot), (cj["k"], ct["k"].clone()), (cj["v"], ct["v"].clone())]
        if block == "decode":
            for pos in range(PRE, PRE + 3):
                sl = slice(pos, pos + 1)
                ctx_j = JL.Ctx(cos=cos_j[sl], sin=sin_j[sl], pos=jnp.int32(pos))
                ctx_t = TL.Ctx(cos=cos_t[sl], sin=sin_t[sl], pos=pos)
                oj, cj = JL.shared_decode(
                    jcfg, sp_j, xj[:, sl], x0j[:, sl], inv, ctx_j, cj
                )
                ot, ct = TL.shared_decode(
                    cfg, sp_t, xt[:, sl], x0t[:, sl], inv, ctx_t, ct
                )
                pairs += [(oj, ot), (cj["k"], ct["k"].clone())]
    _close_pairs(pairs)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def test_model_matches_reference_f32():
    _, jm, params, model = _pair(jnp.float32)
    toks = _tokens(model.cfg)
    tt = torch.from_numpy(toks).long()
    full_j = np.asarray(jm.train_logits(params, {"tokens": jnp.asarray(toks)})[0])
    full_t = model.train_logits({"tokens": tt})[0].numpy()
    scale = float(np.abs(full_j).max())
    checks = [(full_t, full_j)]
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :PRE])}, s_max=S + 8)
    lt, ct = model.prefill({"tokens": tt[:, :PRE]}, s_max=S + 8)
    checks.append((lt.numpy(), np.asarray(lj)))
    for t in range(PRE, PRE + 4):
        lj, cj = jm.decode(params, cj, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
        lt, ct = model.decode(ct, tt[:, t : t + 1], t)
        checks.append((lt.numpy(), np.asarray(lj)))
    for got, want in checks:
        assert got.shape == want.shape and np.isfinite(got).all()
        _close(got, want, scale)
        assert np.abs(got - want).max() < 1e-3 * scale


def _own_decode_errors(model) -> tuple:
    """Max |decode - teacher forcing| per step, the logit scale, the caches."""
    toks = torch.from_numpy(_tokens(model.cfg)).long()
    full, _ = model.train_logits({"tokens": toks})
    logits, caches = model.prefill({"tokens": toks[:, :PRE]}, s_max=S + 8)
    errs = [float((logits[:, 0] - full[:, PRE - 1]).abs().max())]
    for t in range(PRE, S):
        logits, caches = model.decode(caches, toks[:, t : t + 1], t)
        errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    return errs, float(full.abs().max()), caches


def test_decode_matches_own_teacher_forcing_bf16():
    """The recurrent rule of tests/test_models.py, on its config (2 layers,
    one group: no shared block).  With the shared block the reference init
    makes its attention one-hot, and bf16 rounding flips it: the reference's
    own bf16 decode then misses this rule on the reduced config, so the
    full reduced model is held in f32 (below)."""
    cfg = registry.get(ARCH).reduced(n_layers=2, shared_attn_every=2)
    errs, scale, _ = _own_decode_errors(build_model(cfg, device="cpu", seed=5))
    assert max(errs) < 0.05 * scale, (errs, scale)


def test_decode_matches_own_teacher_forcing_f32():
    """Chunked (prefill, train) and stepwise (decode) paths, with the shared
    block's KV caches between the groups, agree to f32 rounding."""
    model = build_model(registry.get(ARCH).reduced(), device="cpu", seed=5).float()
    errs, scale, caches = _own_decode_errors(model)
    assert max(errs) < 1e-3 * scale, (errs, scale)
    # groups of mamba states with the shared block's KV cache between them
    kinds = [type(c).__name__ for c in caches]
    assert kinds == ["list", "dict", "list", "dict", "list"]
    shapes = model.cache_shapes(B, S + 8)
    assert tuple(caches[0][0]["ssm"].shape) == shapes[0]["ssm"][0][1:]
    assert tuple(caches[1]["k"].shape) == shapes[1]["k"][0]


def test_serve_lm_runs_on_the_cpu(capsys):
    res = serve_lm.main(
        ["--arch", ARCH, "--device", "cpu", "--batch", "2"]
        + ["--prompt-len", "20", "--new-tokens", "5"]
    )
    assert tuple(res.tokens.shape) == (2, 5)
    assert len(res.decode_logits) == 4
    assert int(res.tokens.max()) < registry.get(ARCH).reduced().vocab_padded
    assert "tok/s" in capsys.readouterr().out


def test_serve_lm_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendUnavailable):
        serve_lm.main(["--arch", ARCH])
