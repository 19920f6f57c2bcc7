"""The port's xlstm (the ssm family: mLSTM layers only) against the JAX one.

The reduced xlstm-1.3b (4 mLSTM layers, d 128, 4 heads of 64, conv 4,
chunk 16, no FFN).  The JAX parameters cross as numpy arrays through
``interop.lm_params_from_numpy``.

* Block, bf16: the mLSTM block (train, train with its final state, a
  prefill continued from a state, decode steps) against the reference on
  the same inputs, with atol 0.02 * max|out| and rtol 2e-2.
* Whole model, f32: prefill, four decode steps and the teacher-forced
  logits against the JAX ``LM`` by the rule of ``tests/test_torch_zamba2.py``
  (rtol 2e-2, atol 0.02 * max|logits|, and within 1e-3 of the scale).
* The port's own decode against its own teacher forcing: in bf16 within
  0.05 * max|logits| on ``tests/test_models.py``'s config for recurrent
  archs (2 layers), and in f32 within 1e-3 of the scale on the reduced
  config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import lm as JL
from repro.models import xlstm as JX
from repro.models.model import build_model as jax_build
from repro_torch import interop, serve_lm
from repro_torch.configs import registry
from repro_torch.core.backend import BackendUnavailable
from repro_torch.models import lm as TL
from repro_torch.models import xlstm as TX
from repro_torch.models.model import build_model

ARCH = "xlstm-1.3b"
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
    assert TL.layer_plan(tcfg) == JL.layer_plan(jcfg) == [("mlstm", tcfg.n_layers)]
    ssm = tdefs["groups"][0]["ssm"]
    assert ssm["w_gates"].dtype == ssm["gate_bias"].dtype == "float32"
    if size == "full":
        # d 2048, 4 heads of 1024: (4, 1024, 1024) block-diagonal q/k/v
        assert ssm["wq"].shape == (48, 4, 1024, 1024)
        assert ssm["up"].shape == (48, 2048, 8192)


def test_plan_and_cache_shapes_match_reference():
    jcfg = jax_registry.get(ARCH).reduced()
    model = build_model(registry.get(ARCH).reduced(), device="cpu")
    assert model.plan == [("mlstm", 4)]
    assert model.cache_shapes(B, 32) == JL.LM(jcfg).cache_shapes(B, 32)
    full = registry.get(ARCH)
    assert TL.layer_plan(full) == [("mlstm", 48)]
    shapes = TX.mlstm_state_shape(full, 4)
    assert shapes["C"][0] == (4, 4, 1024, 1024)


def test_init_follows_the_reference_rule():
    cfg = registry.get(ARCH).reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    ssm = model.groups[0][0]["ssm"]
    assert ssm["w_gates"].dtype == ssm["gate_bias"].dtype == torch.float32
    assert torch.count_nonzero(ssm["gate_bias"]) == 0
    assert torch.count_nonzero(ssm["conv_b"]) == 0
    assert torch.count_nonzero(ssm["head_norm"]) == 0
    assert ssm["up"].dtype == ssm["wq"].dtype == torch.bfloat16
    # normal x 1/sqrt(shape[-2]) of the stacked shapes: up (n, d, 2di) -> d,
    # wq (n, H, Dh, Dh) -> Dh, w_gates (n, di, 2H) -> di
    for name, fan in (("up", cfg.d_model), ("wq", 64), ("w_gates", 2 * cfg.d_model)):
        std = ssm[name].float().std().item()
        assert abs(std - fan**-0.5) < 0.08 * fan**-0.5, (name, std)


def test_interop_carries_the_f32_gates():
    """``lm_params_from_numpy`` carries the ssm subtree unchanged, f32 gates
    included, one module per layer."""
    jcfg, _, params, model = _pair()
    state = interop.lm_params_from_numpy(model.cfg, jax.tree.map(np.asarray, params))
    assert set(state) == set(model.state_dict())
    want = np.asarray(params["groups"][0]["ssm"]["w_gates"][2])
    got = state["groups.0.2.ssm.w_gates"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert state["groups.0.3.ssm.wq"].dtype == torch.bfloat16
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


# ---------------------------------------------------------------------------
# Block, bf16
# ---------------------------------------------------------------------------


def _block_inputs():
    jcfg, _, params, model = _pair()
    cfg = model.cfg
    rng = np.random.default_rng(11)
    t = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))
    t = t.bfloat16()
    xj = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    lp_j = jax.tree.map(lambda a: a[1], params["groups"][0])["ssm"]
    return jcfg, cfg, lp_j, model.groups[0][1]["ssm"], xj, t


def _snapshot(st):
    return {k: v.clone() for k, v in st.items()}


@pytest.mark.parametrize("block", ["train", "state", "continue", "decode"])
def test_mlstm_block_matches_reference_bf16(block):
    jcfg, cfg, lp_j, lp_t, xj, xt = _block_inputs()
    pairs = []
    if block == "train":
        pairs.append((JX.mlstm_train(jcfg, lp_j, xj), TX.mlstm_train(cfg, lp_t, xt)))
        _close_pairs(pairs)
        return
    oj, sj = JX.mlstm_train(jcfg, lp_j, xj[:, :PRE], return_state=True)
    ot, st = TX.mlstm_train(cfg, lp_t, xt[:, :PRE], return_state=True)
    assert st["C"].dtype == st["n"].dtype == st["m"].dtype == torch.float32
    assert list(st) == list(sj)
    pairs.append((oj, ot))
    # decode updates the state in place: compare snapshots
    pairs += [(sj[k], v) for k, v in _snapshot(st).items()]
    if block == "continue":
        oj, sj = JX.mlstm_train(jcfg, lp_j, xj[:, PRE:], return_state=True, state=sj)
        ot, st = TX.mlstm_train(cfg, lp_t, xt[:, PRE:], return_state=True, state=st)
        pairs.append((oj, ot))
        pairs += [(sj[k], v) for k, v in st.items()]
    if block == "decode":
        for t in range(PRE, PRE + 4):
            oj, sj = JX.mlstm_decode(jcfg, lp_j, xj[:, t : t + 1], sj)
            ot, st2 = TX.mlstm_decode(cfg, lp_t, xt[:, t : t + 1], st)
            assert st2 is st  # updated in place
            pairs.append((oj, ot))
            pairs += [(sj[k], v) for k, v in _snapshot(st).items()]
    _close_pairs(pairs)


def test_decode_updates_the_state_in_place():
    """No new (B, H, Dh, Dh) tensor per step: C, n, m and conv keep their
    storage."""
    _, cfg, _, lp_t, _, xt = _block_inputs()
    _, st = TX.mlstm_train(cfg, lp_t, xt[:, :PRE], return_state=True)
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    before = _snapshot(st)
    TX.mlstm_decode(cfg, lp_t, xt[:, PRE : PRE + 1], st)
    assert {k: v.data_ptr() for k, v in st.items()} == ptrs
    assert all(not torch.equal(before[k], st[k]) for k in ("C", "n", "conv"))


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
    """The recurrent rule of tests/test_models.py, on its config (2 layers)."""
    cfg = registry.get(ARCH).reduced(n_layers=2)
    errs, scale, _ = _own_decode_errors(build_model(cfg, device="cpu", seed=5))
    assert max(errs) < 0.05 * scale, (errs, scale)


def test_decode_matches_own_teacher_forcing_f32():
    """Chunked (prefill, train) and stepwise (decode) paths agree to f32
    rounding; the caches are one group of per-layer mLSTM states."""
    model = build_model(registry.get(ARCH).reduced(), device="cpu", seed=5).float()
    errs, scale, caches = _own_decode_errors(model)
    assert max(errs) < 1e-3 * scale, (errs, scale)
    assert len(caches) == 1 and len(caches[0]) == 4
    shapes = model.cache_shapes(B, S + 8)[0]
    for key in ("conv", "C", "n", "m"):
        assert tuple(caches[0][0][key].shape) == shapes[key][0][1:]


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
