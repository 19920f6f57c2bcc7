"""Per-layer rematerialisation (``cfg.remat``) in the port's training forward.

``repro`` wraps each layer body of its train forward, and the hybrid's
shared block, in ``jax.checkpoint`` when ``cfg.remat == "full"`` (every
published config's default); the encoder-decoder wraps its decoder body.
The port wraps the same bodies in ``torch.utils.checkpoint.checkpoint``
(``models.lm.remat``).  Held here, on the CPU, for reduced dense, hybrid
(the shared block), ssm and encoder-decoder configs in f32:

* the loss and every gradient under ``"full"`` equal those under
  ``"none"`` bit for bit (``torch.equal``): the recompute runs the same
  ops on the same inputs in the same order, and the gradients accumulate
  in the same order, so no tolerance is needed;
* a published config keeps ``"full"``, and its train forward (at a
  reduced width) goes through ``checkpoint`` once a layer and once a
  shared block, never while serving;
* the reduced dense model's loss under ``"full"`` equals ``repro``'s under
  ``"full"`` from the same parameters and batch (rtol 1e-5, the train
  parity's scalar rule).
"""

import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import train_parity as P
from repro.configs import registry as jax_registry
from repro.train import steps as jax_steps
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.models import lm as LM
from repro_torch.models.model import build_model
from repro_torch.train import steps

ARCHS = ["olmo-1b", "zamba2-1.2b", "xlstm-1.3b", "seamless-m4t-medium"]


def _batch(cfg, seed=3) -> dict:
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    out = {"tokens": tokens, "labels": tokens.clone()}
    if cfg.family in ("encdec", "audio"):
        frames = 0.1 * rng.standard_normal((2, 8, cfg.d_model))
        out["frames"] = torch.from_numpy(frames.astype(np.float32))
    return out


def _loss_and_grads(cfg, batch) -> tuple:
    model = build_model(cfg, device="cpu").float().requires_grad_(True)
    loss, _ = steps.make_loss_fn(cfg)(model, batch)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_remat_gives_the_same_loss_and_gradients(arch):
    cfg = registry.get(arch).reduced()
    batch = _batch(cfg)
    loss, grads = _loss_and_grads(dataclasses.replace(cfg, remat="none"), batch)
    with mock.patch.object(LM, "checkpoint", wraps=LM.checkpoint) as ckpt:
        loss_r, grads_r = _loss_and_grads(dataclasses.replace(cfg, remat="full"), batch)
    assert ckpt.call_count > 0
    assert torch.equal(loss, loss_r)
    assert set(grads) == set(grads_r)
    for name, g in grads.items():
        assert g is not None and torch.equal(g, grads_r[name]), name


def _wrapped_bodies(cfg) -> int:
    """The bodies repro checkpoints in one train forward of ``cfg``."""
    if cfg.family in ("encdec", "audio"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers + len(LM.layer_plan(cfg)) - 1
    return cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_published_config_checkpoints_every_layer(arch):
    published = registry.get(arch)
    assert published.remat == "full"
    # the published config at a reduced width, its remat kept
    cfg = published.reduced(remat=published.remat)
    model = build_model(cfg, device="cpu").requires_grad_(True)
    batch = _batch(cfg)
    with mock.patch.object(LM, "checkpoint", wraps=LM.checkpoint) as ckpt:
        logits, _ = model.train_logits(batch)
    assert ckpt.call_count == _wrapped_bodies(cfg)
    assert logits.requires_grad
    # serving never checkpoints
    with mock.patch.object(LM, "checkpoint", wraps=LM.checkpoint) as ckpt:
        with torch.no_grad():
            model.train_logits(batch)
            if cfg.family not in ("encdec", "audio"):
                model.prefill(batch, s_max=20)
    assert ckpt.call_count == 0


def test_full_remat_loss_matches_repro():
    jcfg = dataclasses.replace(jax_registry.get("olmo-1b").reduced(), remat="full",
                               dtype="float32")
    loss_fn, jm = jax_steps.make_loss_fn(jcfg)
    params = jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                          jm.init(jax.random.PRNGKey(0)))
    inputs = P._inputs(jcfg)
    want, _ = jax.jit(loss_fn)(params, inputs)
    cfg = interop.model_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.remat == "full"
    model = build_model(cfg, device="cpu").float()
    model.load_state_dict(P._state(cfg, params))
    got, _ = steps.make_loss_fn(cfg)(model.requires_grad_(True), P._torch_batch(inputs))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=P.SCALAR_RTOL)
