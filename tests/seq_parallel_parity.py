"""The machinery of the sequence-parallel parity tests
(``test_torch_seq_parallel.py``, ``test_torch_heads_whole.py``): a set of
reduced archs (``sharded_ranks.SEQ_PARALLEL`` or ``HEADS_WHOLE``) starts
from ``repro``'s seeded parameters, takes a sharded train step, prefill
and decode on 8 gloo ranks (``sharded_ranks.seq_parallel_steps``), and is
held to ``repro``'s same computations on 8 forced host devices and to the
port's on one device."""

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

#: how far the port's f64 computations may lie from repro's (relative)
EXACT_RTOL = 1e-9


def make_inputs(d, archs: dict) -> dict:
    """Each arch's parameters (``repro``'s leaves, and the port's state
    dict) and batch, saved in ``d`` for the ranks and the ``repro``
    subprocess."""
    leaves, states, trees = {}, {}, {}
    for arch in archs:
        cfg = sharded_ranks.seq_parallel_config(arch, archs)
        jcfg = sharded_ranks.reduced(jax_registry, arch, archs[arch], dtype="float32")
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
    return {"dir": d, "trees": trees, "archs": archs}


def state_of(inputs, arch: str) -> dict:
    with np.load(inputs["dir"] / "port.npz") as f:
        return {k.split("/", 1)[1]: torch.from_numpy(f[k]) for k in f.files
                if k.split("/", 1)[0] == arch}


def run_sharded(inputs, rules=None, s_max: int = 40, capture: bool = False) -> dict:
    """The ranks' computations (``sharded_ranks.seq_parallel_steps``; with
    ``capture``, the f32 decode step's collectives too), given 60 s an
    arch."""
    return run_ranks(sharded_ranks.seq_parallel_steps, 8, backend="gloo",
                     args=(str(inputs["dir"] / "port.npz"), inputs["archs"], rules, s_max,
                           capture),
                     timeout_s=60 * len(inputs["archs"]))


#: repro's computations of each arch on the (2, 4) mesh under its default
#: plan (with ``rules`` over it), in f32 and exact (f64, its f32 islands
#: lifted as ``train_parity._exact`` does): the loss and gradients, and the
#: prefill's logits, with the sequence split; a prefill into caches of
#: ``s_max`` and a decode step of the prompt's last token at position 32
#: without it
_JAX = """
import contextlib
from dataclasses import replace
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
            fields = dict(over)
            group = fields.pop("moe_group", None)
            cfg = registry.get(arch.split("@")[0]).reduced(**fields, dtype=dtype)
            if group is not None:
                cfg = replace(cfg, moe=replace(cfg.moe, group_size=group))
            loss_fn, model = S.make_loss_fn(cfg)
            prefill = jax.jit(S.make_prefill_step(cfg, {s_max})[0])
            treedef = jax.tree.structure(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
            leaves = [f[f"{{arch}}/p{{i}}"].astype(dtype) for i in range(treedef.num_leaves)]
            base = default_plan(cfg, mesh_shape_dict(mesh)).override(**{rules!r})
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


def run_reference(inputs, rules=None, s_max: int = 40) -> dict:
    """arch -> dtype -> repro's loss, gradient norm, each parameter's
    gradient norm (by the port's names), prefill and decode logits."""
    archs = inputs["archs"]
    out = inputs["dir"] / "reference.npz"
    run_with_devices(_JAX.format(inputs=str(inputs["dir"] / "repro.npz"), archs=archs,
                                 rules=rules or {}, s_max=s_max, output=str(out)))
    ref = {}
    with np.load(out) as f:
        for arch in archs:
            cfg = sharded_ranks.seq_parallel_config(arch, archs)
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


def one_device(inputs, arch: str, exact: bool = False, s_max: int = 40) -> dict:
    """The same computations on one device, in f32 or (``exact``) f64."""
    cfg = sharded_ranks.seq_parallel_config(arch, inputs["archs"])
    dtype = torch.float64 if exact else torch.float32
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in sharded_ranks._family_batch(cfg).items()}
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    model = build_model(cfg, device="cpu").float()
    model.load_state_dict(state_of(inputs, arch))
    model = model.to(dtype)
    out = {}
    with sharded_ranks.exact_f64(exact):
        with torch.no_grad():
            out["prefill"] = model.prefill(prompt, s_max)[0].numpy()
            _, caches = model.prefill(prompt, s_max)
            out["decode"] = model.decode(caches, batch["tokens"][:, -1:], 32)[0].numpy()
        loss, _ = steps.make_loss_fn(cfg)(model.requires_grad_(True), batch)
        loss.backward()
    out["loss"] = float(loss.detach())
    out["grads"] = {n: float(p.grad.double().norm()) for n, p in model.named_parameters()}
    out["grad_norm"] = float(np.sqrt(sum(x * x for x in out["grads"].values())))
    return out


def check_scalars(got: dict, want: dict, exact: dict, keys=("loss", "grad_norm")):
    for key in keys:
        rule = max(P.SCALAR_RTOL, P.YARDSTICK * abs(want[key] / exact[key] - 1))
        assert got[key] == pytest.approx(want[key], rel=rule), (key, got[key], want[key])


def check_logits(got: dict, want: dict, exact: dict):
    for key in ("prefill", "decode"):
        w = want[key]
        assert got[key].shape == w.shape, (key, got[key].shape, w.shape)
        atol = max(1e-4 * np.abs(w).max(), P.YARDSTICK * np.abs(w - exact[key]).max())
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=atol, err_msg=key)


def check_exact(got: dict, want: dict):
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
