"""The port's train step against the JAX package's, on the CPU.

One step of each of the ten architectures' reduced configs, in f32 (the
JAX config's ``dtype`` too, as ``tests/test_torch_families.py`` sets it),
from the JAX model's parameters carried over by ``interop`` and one batch
made with numpy from a seed (B 2, S 16; the VLM's 16 vision tokens and the
encoder's 8 frames, as ``tests/test_models.py``).  The reference side is
``repro``'s loss, ``jax.value_and_grad`` and ``adamw.apply_updates``, jitted
together as its ``make_train_step`` runs them.  This file holds the first
five architectures; ``test_torch_train_families.py`` the other five, with
the shared machinery in ``train_parity.py``.

The rule for the loss, the gradient norm and each gradient leaf is the
base rule (rtol 1e-5 for scalars; max abs error <= 1e-4 x max|JAX leaf|
for tensors) or ten times how far repro's own f32 step lies from its exact
step for that number, whichever is looser.  The exact step is repro's in
f64 with its f32 islands (norms, scores, logits, scans, moments) lifted
too.  The reduced models' reference init (a query weight's fan-in is its
head count) makes attention nearly one-hot, and there f32 gradients are
ill-conditioned: repro's own f32 leaves lie up to ~6e-3 x max|leaf| from
the exact ones (seamless), and the port's f32 leaves on the CPU up to 8.2x
as far as repro's (deepseek-coder-33b; 1.6-4.6x on the others).  Held:

* loss, ``lr`` and ``grad_norm``, each at its own rule;
* every gradient leaf at its own rule, mapped through the same interop
  function; m (= (1 - b1) x the clipped gradient) at the leaf's rule plus
  the norm's, v (a square) at twice that;
* the update ``p_new - p_old`` wherever repro's gradient lies beyond the
  leaf's rule from 0 and the port's has its sign, to 1e-4 x repro's
  largest update of the leaf, plus one f32 ulp of the new parameter, plus
  what the gradient's and the norm's rules let the first step's
  g / (|g| + eps) move (much near eps; nothing at |g| >> eps); AdamW's
  first step moves an element by about +-lr, so a gradient within rounding
  of 0 may go either way, and clear sign flips stay under 0.1 % of the
  elements;
* bf16 (the JAX model's own bf16 weights on both sides): the loss to
  rtol 1e-2 (bf16 activations round at other places in the two
  frameworks; the loss is a mean over 30 tokens of ~6.9 nats).

Also the port of ``test_smoke_train_step`` and
``test_vocab_padding_is_masked_in_loss``, and the decay mask against
``repro``'s mask over its stacked tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_parity as P
from repro.configs import registry as jax_registry
from repro.models.model import build_model as jax_build
from repro.train import steps as jax_steps
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train import steps

#: the first five archs here; the other five in test_torch_train_families.py
ARCHS = P.ARCHS[:5]


@pytest.mark.parametrize("arch", ARCHS)
def test_step_scalars_match_repro(arch):
    P.check_scalars(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_gradients_and_moments_match_repro(arch):
    P.check_gradients_and_moments(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_parameters_match_repro_where_gradients_agree(arch):
    P.check_parameters_where_gradients_agree(arch)

@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_repro(arch):
    P.check_bf16_loss(arch)


def test_decay_mask_matches_repros_stacked_mask():
    """repro decays ``p.ndim >= 2`` of its stacked tree: each layer's 1-D
    norm scales and biases are 2-D there and are decayed."""
    seen_stacked_1d = False
    for arch in P.ARCHS:
        jcfg = jax_registry.get(arch).reduced()
        params = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
        want = P._state(interop.model_config_from_dict(dataclasses.asdict(jcfg)),
                      jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2), params))
        cfg = interop.model_config_from_dict(dataclasses.asdict(jcfg))
        model = build_model(cfg, device="cpu")
        mask = adamw.decay_mask(model)
        assert set(mask) == set(want), arch
        for name, t in want.items():
            assert mask[name] == bool(t.all()), (arch, name)
            p = model.get_parameter(name)
            seen_stacked_1d |= p.ndim == 1 and mask[name]
    assert seen_stacked_1d


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_smoke_train_step(arch):
    """The port of tests/test_models.py::test_smoke_train_step."""
    cfg = registry.get(arch).reduced()
    model = build_model(cfg, device="cpu")
    step = steps.make_train_step(cfg, adamw.OptConfig(**P.OPT))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw.init_state(dict(model.named_parameters()))
    opt, metrics = step(model, opt, P._torch_batch(P._inputs(cfg)))
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert int(opt["step"]) == 1
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_vocab_padding_is_masked_in_loss():
    logits = torch.zeros((1, 4, 512))
    logits[..., 500:] = 100.0  # huge logits in the pad region
    labels = torch.tensor([[1, 2, 3, 4]])
    loss = steps.softmax_xent(logits, labels, vocab_real=500)
    assert float(loss) == pytest.approx(np.log(500), rel=1e-3)


def test_ignored_labels_and_the_iota_pick_match_repro():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 64)).astype(np.float32) * 4
    labels = rng.integers(0, 60, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    want = jax_steps.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), 60)
    got = steps.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), 60)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("causal,sq,sk,hkv", [(True, 24, 40, 2), (False, 40, 8, 1)])
def test_flash_attention_function_returns_the_plain_gradients(causal, sq, sk, hkv):
    """``ops.FlashAttention`` on CPU tensors (its forward and backward
    wrappers take the plain versions there) gives autograd's gradients:
    the arguments, the saved tensors and the causal flag are wired right."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    rng = np.random.default_rng(sq + sk)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                     for shape in ((2, 4, sq, 32), (2, hkv, sk, 32),
                                   (2, hkv, sk, 32), (2, 4, sq, 32)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ops.FlashAttention.apply(*leaves, causal), leaves, dout)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*ref, causal=causal), ref, dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
