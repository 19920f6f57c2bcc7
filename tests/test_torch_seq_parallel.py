"""Sequence parallelism and sharded serving, on 8 gloo CPU ranks.

``repro``'s default plan (the one the dry run places every cell with)
splits the sequence over ``model`` between layers and, for decode, drops
that split.  Each of ``SEQ_PARALLEL``'s reduced archs starts from
``repro``'s seeded parameters (``PRNGKey(0)``, laid out as the port's by
``interop``) and ``sharded_ranks._family_batch``.  The ranks are spawned
once for the file (the target, ``sharded_ranks.seq_parallel_steps``): in
f32, and in f64 with the f32 islands lifted, on a (data 2, model 4) mesh
under that plan, each arch takes one train step and a prefill with the
sequence split, then a prefill and a decode step without it.  Held
against:

* ``repro``'s own sharded computations of the same config, parameters and
  batch on the same (2, 4) mesh and plans (8 forced host devices, one
  subprocess for the file), in f64: the loss, the gradient norm, each
  parameter's gradient norm (a stacked leaf of ``repro``'s taken layer by
  layer) and the logits within ``EXACT_RTOL`` (the two lie at most 4e-11
  apart);
* the same in f32, by ``tests/train_parity.py``'s rule: the loss and the
  gradient norm within rtol 1e-5, the logits within rtol 1e-4 and 1e-4 x
  their largest magnitude; or ten times how far ``repro``'s f32 number
  lies from its exact (f64) one, whichever is looser.  A parameter's
  gradient norm is held in f64 only: the reduced models' f32 gradients
  are ill-conditioned (seamless's f32 gradient norm lies 4 % from its f64
  one), and the port's f32 rounding differs from XLA's leaf by leaf;
* the port's same f32 computations on one device, by the same rules with
  the port's one-device f32 and f64 standing in for ``repro``'s.
"""

import jax
import numpy as np
import pytest
import torch

import sharded_ranks
import train_parity as P
from helpers import run_with_devices
from repro.configs import registry as jax_registry
from repro.train import steps as jax_steps
from repro_torch.core.ranks import run_ranks
from repro_torch.models.model import build_model
from repro_torch.train import steps

ARCHS = list(sharded_ranks.SEQ_PARALLEL)
#: how far the port's f64 computations may lie from repro's (relative)
EXACT_RTOL = 1e-9


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each arch's parameters (``repro``'s leaves, and the port's state
    dict) and batch, saved for the ranks and the ``repro`` subprocess."""
    d = tmp_path_factory.mktemp("seq_parallel")
    leaves, states, trees = {}, {}, {}
    for arch in ARCHS:
        cfg = sharded_ranks.seq_parallel_config(arch)
        jcfg = jax_registry.get(arch).reduced(**sharded_ranks.SEQ_PARALLEL[arch],
                                              dtype="float32")
        params = P._np_tree(jax_steps.make_loss_fn(jcfg)[1].init(jax.random.PRNGKey(0)))
        trees[arch] = jax.tree.structure(params)
        # repro initialises in bf16 whatever the config's dtype; both take f32
        leaves.update({f"{arch}/p{i}": a.astype(np.float32)
                       for i, a in enumerate(jax.tree.leaves(params))})
        states.update({f"{arch}/{n}": t.float().numpy()
                       for n, t in P._state(cfg, params).items()})
        leaves.update({f"{arch}/{k}": v.numpy().astype(np.float32 if v.is_floating_point()
                                                       else np.int32)
                       for k, v in sharded_ranks._family_batch(cfg).items()})
    np.savez(d / "repro.npz", **leaves)
    np.savez(d / "port.npz", **states)
    return {"dir": d, "trees": trees}


def _state(inputs, arch: str) -> dict:
    with np.load(inputs["dir"] / "port.npz") as f:
        return {k.split("/", 1)[1]: torch.from_numpy(f[k]) for k in f.files
                if k.split("/", 1)[0] == arch}


@pytest.fixture(scope="module")
def sharded(inputs):
    return run_ranks(sharded_ranks.seq_parallel_steps, 8, backend="gloo",
                     args=(str(inputs["dir"] / "port.npz"),), timeout_s=240)


#: repro's computations of each arch on the (2, 4) mesh under its default
#: plan, in f32 and exact (f64, its f32 islands lifted as
#: ``train_parity._exact`` does): the loss and gradients, and the prefill's
#: logits, with the sequence split; a prefill and a decode step of the
#: prompt's last token at position 32 without it
_JAX = """
import contextlib
from unittest import mock
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.launch.mesh import make_debug_mesh, mesh_shape_dict
from repro.models.params import param_shardings
from repro.parallel.context import parallel_context
from repro.parallel.sharding import default_plan
from repro.train import steps as S

mesh = make_debug_mesh(2, 4)
f = np.load({inputs!r})
out = {{}}
for arch, over in {archs!r}.items():
    for dtype in ("float32", "float64"):
        with contextlib.ExitStack() as stack:
            if dtype == "float64":
                stack.enter_context(jax.enable_x64(True))
                stack.enter_context(mock.patch.object(jnp, "float32", jnp.float64))
            cfg = registry.get(arch).reduced(**over, dtype=dtype)
            loss_fn, model = S.make_loss_fn(cfg)
            prefill = jax.jit(S.make_prefill_step(cfg, 40)[0])
            treedef = jax.tree.structure(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
            leaves = [f[f"{{arch}}/p{{i}}"].astype(dtype) for i in range(treedef.num_leaves)]
            base = default_plan(cfg, mesh_shape_dict(mesh))
            key = f"{{arch}}/{{dtype}}/"
            for name, plan in (("seq", base), ("decode", base.override(seq=None))):
                def put(a, *axes):
                    return jax.device_put(jnp.asarray(a), plan.sharding(mesh, *axes))
                with parallel_context(mesh, plan):
                    params = jax.tree.map(jax.device_put, jax.tree.unflatten(treedef, leaves),
                                          param_shardings(model.defs, mesh, plan))
                    prompt = {{"tokens": put(f[f"{{arch}}/tokens"], "batch", "seq")}}
                    if f"{{arch}}/frames" in f.files:
                        prompt["frames"] = put(f[f"{{arch}}/frames"].astype(dtype),
                                               "batch", "frames", "act_embed")
                    if name == "seq":
                        batch = dict(prompt, labels=put(f[f"{{arch}}/labels"], "batch", "seq"))
                        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                            params, batch)
                        out[key + "loss"] = np.asarray(loss)
                        out.update({{key + f"g{{i}}": np.asarray(g)
                                    for i, g in enumerate(jax.tree.leaves(grads))}})
                        out[key + "prefill"] = np.asarray(prefill(params, prompt)[0])
                    else:
                        _, caches = prefill(params, prompt)
                        token = put(f[f"{{arch}}/tokens"][:, -1:], "batch", "seq")
                        decode = jax.jit(S.make_decode_step(cfg)[0])
                        out[key + "decode"] = np.asarray(
                            decode(params, caches, token, jnp.int32(32))[0])
np.savez({output!r}, **out)
"""


@pytest.fixture(scope="module")
def reference(inputs):
    """arch -> dtype -> repro's loss, gradient norm, each parameter's
    gradient norm (by the port's names), prefill and decode logits."""
    out = inputs["dir"] / "reference.npz"
    run_with_devices(_JAX.format(inputs=str(inputs["dir"] / "repro.npz"),
                                 archs=sharded_ranks.SEQ_PARALLEL, output=str(out)))
    ref = {}
    with np.load(out) as f:
        for arch in ARCHS:
            cfg = sharded_ranks.seq_parallel_config(arch)
            treedef = inputs["trees"][arch]
            for dtype in ("float32", "float64"):
                key = f"{arch}/{dtype}/"
                grads = P._state(cfg, jax.tree.unflatten(
                    treedef, [f[f"{key}g{i}"] for i in range(treedef.num_leaves)]))
                norms = {n: float(g.double().norm()) for n, g in grads.items()}
                ref[arch, dtype] = {
                    "loss": float(f[key + "loss"]),
                    "grad_norm": float(np.sqrt(sum(x * x for x in norms.values()))),
                    "grads": norms, "prefill": f[key + "prefill"],
                    "decode": f[key + "decode"]}
    return ref


def _one_device(inputs, arch: str, exact: bool = False) -> dict:
    """The same computations on one device, in f32 or (``exact``) f64."""
    cfg = sharded_ranks.seq_parallel_config(arch)
    dtype = torch.float64 if exact else torch.float32
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in sharded_ranks._family_batch(cfg).items()}
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    model = build_model(cfg, device="cpu").float()
    model.load_state_dict(_state(inputs, arch))
    model = model.to(dtype)
    out = {}
    with sharded_ranks.exact_f64(exact):
        with torch.no_grad():
            out["prefill"] = model.prefill(prompt, 40)[0].numpy()
            _, caches = model.prefill(prompt, 40)
            out["decode"] = model.decode(caches, batch["tokens"][:, -1:], 32)[0].numpy()
        loss, _ = steps.make_loss_fn(cfg)(model.requires_grad_(True), batch)
        loss.backward()
    out["loss"] = float(loss.detach())
    out["grads"] = {n: float(p.grad.double().norm()) for n, p in model.named_parameters()}
    out["grad_norm"] = float(np.sqrt(sum(x * x for x in out["grads"].values())))
    return out


def _check_scalars(got: dict, want: dict, exact: dict, keys=("loss", "grad_norm")):
    for key in keys:
        rule = max(P.SCALAR_RTOL, P.YARDSTICK * abs(want[key] / exact[key] - 1))
        assert got[key] == pytest.approx(want[key], rel=rule), (key, got[key], want[key])


def _check_logits(got: dict, want: dict, exact: dict):
    for key in ("prefill", "decode"):
        w = want[key]
        assert got[key].shape == w.shape, (key, got[key].shape, w.shape)
        atol = max(1e-4 * np.abs(w).max(), P.YARDSTICK * np.abs(w - exact[key]).max())
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=atol, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_step_and_sharded_decode_match_one_device(inputs, sharded, arch):
    got = sharded[arch, "float32"]
    want, exact = _one_device(inputs, arch), _one_device(inputs, arch, exact=True)
    _check_scalars(got, want, exact)
    _check_logits(got, want, exact)


def _check_exact(got: dict, want: dict):
    """The f64 computations agree to ``EXACT_RTOL``: the loss, the gradient
    norm, each parameter's gradient norm, and the logits (relative to
    their largest magnitude)."""
    for key in ("loss", "grad_norm"):
        assert got[key] == pytest.approx(want[key], rel=EXACT_RTOL), key
    assert got["grads"].keys() == want["grads"].keys()
    for name, w in want["grads"].items():
        assert got["grads"][name] == pytest.approx(w, rel=EXACT_RTOL, abs=1e-300), name
    for key in ("prefill", "decode"):
        w = want[key]
        assert got[key].shape == w.shape, (key, got[key].shape, w.shape)
        np.testing.assert_allclose(got[key], w, rtol=EXACT_RTOL,
                                   atol=EXACT_RTOL * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_train_step_matches_repro(sharded, reference, arch):
    _check_scalars(sharded[arch, "float32"], reference[arch, "float32"],
                   reference[arch, "float64"])
    _check_exact(sharded[arch, "float64"], reference[arch, "float64"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_prefill_and_sharded_decode_match_repro(sharded, reference, arch):
    _check_logits(sharded[arch, "float32"], reference[arch, "float32"],
                  reference[arch, "float64"])
