"""The train-step parity machinery shared by ``test_torch_train.py`` and
``test_torch_train_families.py`` (see the former's docstring for the rules):
repro's step in f32 and its exact (f64) step, the port's f32 step from the
same parameters and batch, and the tolerances they give."""


import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.optim import adamw as jax_adamw
from repro.train import steps as jax_steps
from repro_torch import interop
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train import steps

ARCHS = list(jax_registry.ARCH_IDS)
B, S, N_VISION, N_FRAMES = 2, 16, 16, 8
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SCALAR_RTOL = 1e-5
LEAF_TOL = 1e-4
MAX_FLIPS = 1e-3
#: how many times repro's own f32 distance from the exact step the port may
#: differ from repro's f32 step by, for the loss, the gradient norm and each
#: gradient leaf on its own (the port's f32 gradients on the CPU lie up to
#: 8.2x as far from the exact step as XLA's, deepseek-coder-33b's; 1.6-4.6x
#: on the others)
YARDSTICK = 10.0


def _encdec(cfg) -> bool:
    return cfg.family in ("encdec", "audio")


def _state(cfg, tree) -> dict:
    if _encdec(cfg):
        return interop.encdec_params_from_numpy(cfg, tree)
    return interop.lm_params_from_numpy(cfg, tree)


def _inputs(cfg, seed=7) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = 0.01 * rng.standard_normal((B, N_VISION, cfg.d_model))
    if _encdec(cfg):
        out["frames"] = 0.1 * rng.standard_normal((B, N_FRAMES, cfg.d_model))
    out = {k: v.astype(np.float32) if v.dtype == np.float64 else v
           for k, v in out.items()}
    out["labels"] = out["tokens"]
    return out


def _torch_batch(inputs: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out["tokens"] = out["tokens"].long()
    out["labels"] = out["labels"].long()
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(arch, dtype):
    return dataclasses.replace(jax_registry.get(arch).reduced(), dtype=dtype)


@contextlib.contextmanager
def _exact(on: bool):
    """f64 throughout: x64 on, and repro's f32 islands (its norms, scores,
    logits, scans and moments name ``jnp.float32``) lifted to f64."""
    if not on:
        yield
        return
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        yield


@functools.lru_cache(maxsize=None)
def _reference(arch, exact=False) -> dict:
    """repro's step on the seeded batch from its f32 parameters: in f32, or
    (``exact``) in f64 with no f32 island, the yardstick of f32 rounding.
    Params, metrics, and the grads, moments and update mapped by interop."""
    cfg = _jax_cfg(arch, "float32")
    params = _np_tree(jax_steps.make_loss_fn(cfg)[1].init(jax.random.PRNGKey(0)))
    inputs = _inputs(cfg)
    dtype = np.float64 if exact else np.float32
    with _exact(exact):
        loss_fn, _ = jax_steps.make_loss_fn(_jax_cfg(arch, dtype.__name__))
        opt_cfg = jax_adamw.OptConfig(**OPT)

        @jax.jit
        def step(params, opt, batch):
            (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, batch)
            new_p, new_opt, m = jax_adamw.apply_updates(opt_cfg, params, grads, opt)
            return loss, grads, new_p, new_opt, m

        p = jax.tree.map(lambda a: jnp.asarray(a.astype(dtype)), params)
        loss, grads, new_p, new_opt, m = _np_tree(step(
            p, jax_adamw.init_state(p),
            {k: jnp.asarray(v.astype(dtype) if v.dtype == np.float32 else v)
             for k, v in inputs.items()}))
    tcfg = interop.model_config_from_dict(dataclasses.asdict(cfg))
    new_params = _state(tcfg, new_p)
    old = _state(tcfg, params)
    return {
        "cfg": tcfg,
        "inputs": inputs,
        "params": params,
        "loss": float(loss),
        "grad_norm": float(m["grad_norm"]),
        "lr": float(m["lr"]),
        "grads": _state(tcfg, grads),
        "new_params": new_params,
        "update": {n: w.double() - old[n].double() for n, w in new_params.items()},
        "m": _state(tcfg, new_opt["m"]),
        "v": _state(tcfg, new_opt["v"]),
    }


def _distance(got, want) -> float:
    """max|got - want| relative to max|want|."""
    return (float((got.double() - want.double()).abs().max())
            / max(float(want.abs().max()), 1e-30))


def _same_sign(a, b):
    return torch.sign(a) == torch.sign(b)


@functools.lru_cache(maxsize=None)
def _rules(arch) -> dict:
    """Each number's relative tolerance.  The loss, the gradient norm and
    each gradient leaf: the base rule, or YARDSTICK x how far repro's own
    f32 step lies from its exact step for that number, whichever is looser.
    m and v follow from them: m = (1 - b1) c g with the clip scale
    c = clip / |g|, so its rule is the leaf's plus the norm's; v, a square,
    twice that."""
    r32, r64 = _reference(arch), _reference(arch, exact=True)
    rules = {k: max(SCALAR_RTOL, YARDSTICK * abs(r32[k] / r64[k] - 1))
             for k in ("loss", "grad_norm")}
    rules["lr"] = SCALAR_RTOL
    rules["grads"] = {n: max(LEAF_TOL, YARDSTICK * _distance(r32["grads"][n], w))
                      for n, w in r64["grads"].items()}
    rules["m"] = {n: t + rules["grad_norm"] for n, t in rules["grads"].items()}
    rules["v"] = {n: 2 * t for n, t in rules["m"].items()}
    return rules


@functools.lru_cache(maxsize=None)
def _port(arch) -> dict:
    """The port's f32 step from the same parameters and batch."""
    ref = _reference(arch)
    cfg = ref["cfg"]
    model = build_model(cfg, device="cpu").float()
    model.load_state_dict(_state(cfg, ref["params"]))
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = _torch_batch(ref["inputs"])
    loss, _ = steps.make_loss_fn(cfg)(model.requires_grad_(True), batch)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = adamw.init_state(dict(model.named_parameters()))
    opt, metrics = steps.make_train_step(cfg, adamw.OptConfig(**OPT))(model, opt, batch)
    assert all(p.grad is None for p in model.parameters())
    new_params = {n: p.detach() for n, p in model.named_parameters()}
    return {
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "lr": float(metrics["lr"]),
        "step": int(opt["step"]),
        "grads": grads,
        "new_params": new_params,
        "update": {n: w.double() - old[n].double() for n, w in new_params.items()},
        "m": opt["m"],
        "v": opt["v"],
    }


def _leaf_close(name, got, want, tol):
    assert got.shape == want.shape, name
    err = _distance(got, want)
    assert err <= tol, (name, err, tol)


def check_scalars(arch):
    ref, got, rules = _reference(arch), _port(arch), _rules(arch)
    assert got["step"] == 1
    for key in ("loss", "grad_norm", "lr"):
        assert got[key] == pytest.approx(ref[key], rel=rules[key]), key


def check_gradients_and_moments(arch):
    ref, got, rules = _reference(arch), _port(arch), _rules(arch)
    for part in ("grads", "m", "v"):
        assert set(got[part]) == set(ref[part]), part
        for name, want in ref[part].items():
            _leaf_close(f"{part} {name}", got[part][name], want, rules[part][name])


def check_parameters_where_gradients_agree(arch):
    """The update ``p_new - p_old`` against repro's, where repro's gradient
    lies beyond the gradient's rule from 0 and the port's has its sign; a
    gradient within rounding of 0 may take either sign (AdamW's first step
    moves it by about +-lr either way).  Held to the base rule x repro's
    largest update of the leaf, plus one f32 ulp of the new parameter (the
    two steps round ``p - lr * u`` apart), plus what the gradient's and the
    norm's rules let the first step's ``u = g' / (|g'| + eps)`` move, with
    ``g' = c g`` the clipped gradient: ``lr eps dg' / (|g'| - dg' + eps)^2``
    for a gradient off by ``dg'``."""
    ref, got, rules = _reference(arch), _port(arch), _rules(arch)
    cfg = jax_adamw.OptConfig(**OPT)
    clip = min(1.0, cfg.clip_norm / (ref["grad_norm"] + 1e-9))
    flips = total = 0
    for name, want in ref["update"].items():
        g_ref, g = ref["grads"][name].double(), got["grads"][name]
        dg = rules["grads"][name] * float(g_ref.abs().max())
        clear = g_ref.abs() > dg
        held = clear & _same_sign(g, g_ref)
        flips += int((clear & ~held).sum())
        total += held.numel()
        gc = clip * g_ref.abs()
        dgc = clip * (dg + rules["grad_norm"] * g_ref.abs())
        moved = ref["lr"] * cfg.eps * dgc / ((gc - dgc).clamp(min=0) + cfg.eps) ** 2
        ulp = torch.finfo(torch.float32).eps * ref["new_params"][name].double().abs()
        excess = (got["update"][name] - want).abs() - ulp - moved
        err = float(torch.where(held, excess, -1.0).max())
        tol = LEAF_TOL * float(want.abs().max())
        assert err <= tol, (name, err, tol)
    assert flips < MAX_FLIPS * total, (flips, total)


def check_bf16_loss(arch):
    jcfg = jax_registry.get(arch).reduced()
    loss_fn, jm = jax_steps.make_loss_fn(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    inputs = _inputs(jcfg)
    want, _ = jax.jit(loss_fn)(params, {k: jnp.asarray(v) for k, v in inputs.items()})
    cfg = interop.model_config_from_dict(dataclasses.asdict(jcfg))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(_state(cfg, jax.tree.map(np.asarray, params)))
    batch = _torch_batch(inputs)
    with torch.no_grad():
        got, _ = steps.make_loss_fn(cfg)(model, batch)
    assert float(got) == pytest.approx(float(want), rel=1e-2)
