"""The ``run_ranks`` targets of ``test_torch_sharded_train.py``,
``test_torch_seq_parallel.py`` and ``test_torch_pipeline.py``, in a module of their own so that the spawned ranks import them without the test module
(the ranks inherit the parent's ``sys.path``)."""

import contextlib
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import compat
from repro_torch.core.hlo import capture_graph_collectives
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch
from repro_torch.models.model import build_model
from repro_torch.models.params import distribute_params
from repro_torch.optim import adamw
from repro_torch.parallel.context import parallel_context
from repro_torch.parallel.pipeline import run_pipeline
from repro_torch.parallel.sharding import ShardingPlan
from repro_torch.train import steps

#: the launcher's run: the reduced olmo-1b on a (2, 4) mesh, 3 steps
RUN = dict(arch="olmo-1b", steps=3, seq_len=32, global_batch=8, ckpt_every=3,
           warmup_steps=1, device="cpu", data_mesh=(2, 4))
#: the config fields the test sets over the reduced one: four query and four
#: KV heads, each layer recomputed in the backward (remat "full", the
#: published configs')
CONFIG = {"n_heads": 4, "n_kv_heads": 4, "remat": "full"}
#: the plan rules over the launcher's: heads on ``model``, no sequence
#: sharding (``repro``'s ``test_real_sharded_train_step_runs``)
PLAN = {"heads": "model", "kv_heads": "model", "seq": None}


def run_config(run: launch.RunConfig):
    """The reduced config of ``run.arch`` with ``CONFIG``."""
    return registry.get(run.arch).reduced(**CONFIG)


@contextlib.contextmanager
def as_tested(record=None):
    """``launch.train`` as the test runs it: ``run_config``'s model, its
    parameters in f32, the launcher's plan with ``PLAN``'s rules, and
    ``record(model, opt_state, metrics)`` after each step."""
    make_plan, make_step = launch.mesh_and_plan, steps.make_train_step

    def mesh_and_plan(run, cfg):
        mesh, plan = make_plan(run, cfg)
        return mesh, plan.override(**PLAN)

    def make_train_step(cfg, opt_cfg):
        step = make_step(cfg, opt_cfg)

        def recorded(model, opt, batch):
            opt, metrics = step(model, opt, batch)
            if record is not None:
                record(model, opt, metrics)
            return opt, metrics
        return recorded

    with mock.patch.object(launch, "run_config", run_config), \
            mock.patch.object(launch, "mesh_and_plan", mesh_and_plan), \
            mock.patch.object(launch, "build_model",
                              lambda cfg, **kw: build_model(cfg, **kw).float()), \
            mock.patch.object(steps, "make_train_step", make_train_step):
        yield


def _whole(tensors: dict) -> dict:
    """Each DTensor gathered whole (every rank takes part), as a NumPy array
    (tensors would cross the process boundary through shared memory that
    dies with the rank)."""
    return {n: t.detach().full_tensor().numpy().copy() for n, t in tensors.items()}


def _captured_step(run: launch.RunConfig) -> list:
    """One sharded step of ``run`` captured as the compiled layer:
    (region, kind, result bytes, group size, groups) a collective."""
    cfg = run_config(run)
    with as_tested():
        mesh, plan = launch.mesh_and_plan(run, cfg)
    opt_cfg = adamw.OptConfig(lr=3e-4, warmup_steps=run.warmup_steps,
                              total_steps=run.steps)
    step_fn = steps.make_train_step(cfg, opt_cfg)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=run.seq_len,
                                global_batch=run.global_batch))
    with parallel_context(mesh, plan):
        model = build_model(cfg, device="cpu").float()
        distribute_params(model, mesh, plan)
        opt = adamw.init_state(dict(model.named_parameters()))
        batch = ds.global_batch_on(0, mesh, plan)
        buf = capture_graph_collectives(lambda: step_fn(model, opt, batch),
                                        device_mesh=mesh)
    return [(op.region, op.kind, op.result_bytes, op.group_size, op.n_groups)
            for op in buf.to_ops()]


def _elastic_restore(ckpt_dir: str) -> dict:
    """Save a (8, 8) array sharded by rows over a (8,) mesh, restore it onto
    a (2, 4) mesh with rows on ``model`` and columns on ``data``."""
    mesh1 = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
    mesh2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    whole = torch.arange(64.0).reshape(8, 8)
    tree = {"w": distribute_tensor(whole, mesh1, ShardingPlan(
        rules={"batch": "data"}).placements(mesh1, "batch", None))}
    mgr = CheckpointManager(ckpt_dir, retain=1)
    mgr.save(5, tree, blocking=True)
    dist.barrier()
    sh2 = ShardingPlan(rules={"vocab": "model", "embed": "data"}).sharding(
        mesh2, "vocab", "embed")
    restored, step = mgr.restore(tree, shardings={"w": sh2})
    w = restored["w"]
    rank = dist.get_rank()
    data, model = divmod(rank, 4)
    local_ok = torch.equal(w.to_local(), whole[2 * model:2 * model + 2,
                                                4 * data:4 * data + 4])
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, local_ok)
    return {"step": step, "placements": [repr(p) for p in w.placements],
            "mesh": list(w.device_mesh.mesh_dim_names),
            "whole": w.full_tensor().numpy(), "local_ok": flags}


#: the families also trained one step sharded in the test: the hybrid (the
#: SSD kernel and the shared block under local_map), the mLSTM, MLA and MoE
FAMILIES = ["zamba2-1.2b", "xlstm-1.3b", "minicpm3-4b", "granite-moe-3b-a800m"]


def sharded_train(ckpt_dir: str, restore_dir: str) -> dict:
    """On each of 8 gloo ranks: the launcher's mesh path for ``RUN`` (the
    losses, and after each step the gathered parameters and AdamW state and
    the step's metrics), one more step captured as the compiled layer, the
    elastic restore, and one step of each of ``FAMILIES``."""
    run = launch.RunConfig(ckpt_dir=ckpt_dir, **RUN)
    gathered = []

    def record(model, opt, metrics):
        gathered.append({
            "params": _whole(dict(model.named_parameters())),
            "m": _whole(opt["m"]), "v": _whole(opt["v"]), "step": int(opt["step"]),
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
        })

    with as_tested(record):
        losses, _ = launch.train(run, verbose=False)
    return {"losses": losses, "steps": gathered, "collectives": _captured_step(run),
            "elastic": _elastic_restore(restore_dir), "families": family_steps(FAMILIES)}


def pipeline_4_stages(ws, mbs):
    """The port's ``run_pipeline`` of ``tanh(x @ w_s)`` over a (4,) ``pod``
    mesh of the 4 ranks; the outputs as a NumPy array."""
    mesh = compat.make_mesh((4,), ("pod",))
    out = run_pipeline(lambda w, x: torch.tanh(x @ w), torch.from_numpy(ws),
                       torch.from_numpy(mbs), mesh)
    return out.numpy()


def _family_batch(cfg, seed: int = 1) -> dict:
    """The global batch of a family step: the synthetic tokens (8 x 32),
    and the VLM's 16 stub vision embeddings or the encoder's 16 frames."""
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)).batch(0)
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm":
        batch["vision_embeds"] = 0.01 * torch.randn(8, 16, cfg.d_model, generator=g)
    if cfg.family in ("encdec", "audio"):
        batch["frames"] = 0.1 * torch.randn(8, 16, cfg.d_model, generator=g)
    return batch


def family_steps(archs: list) -> dict:
    """On each of 8 ranks: one f32 train step of each reduced arch on the
    launcher's (2, 4) mesh and plan (batch on ``data``; FFN and vocab on
    ``model``); arch -> (loss, grad norm), or ("failed", the error's last
    line, the port's frames) where DTensor cannot run it."""
    import traceback

    from torch.distributed.tensor import distribute_tensor

    out = {}
    for arch in archs:
        run = launch.RunConfig(arch=arch, device="cpu", data_mesh=(2, 4))
        cfg = launch.run_config(run)
        try:
            mesh, plan = launch.mesh_and_plan(run, cfg)
            step = steps.make_train_step(cfg, adamw.OptConfig(lr=1e-3, warmup_steps=1,
                                                              total_steps=4))
            with parallel_context(mesh, plan):
                model = build_model(cfg, device="cpu").float()
                distribute_params(model, mesh, plan)
                opt = adamw.init_state(dict(model.named_parameters()))
                batch = {k: distribute_tensor(v, mesh, plan.placements(
                    mesh, "batch", "seq", *(None,) * (v.dim() - 2)), src_data_rank=None)
                    for k, v in _family_batch(cfg).items()}
                _, metrics = step(model, opt, batch)
            out[arch] = (float(metrics["loss"]), float(metrics["grad_norm"]))
        except Exception:  # reported: the op DTensor cannot run
            lines = traceback.format_exc().strip().splitlines()
            out[arch] = ("failed", lines[-1],
                         [ln.strip() for ln in lines if "repro_torch" in ln][-2:])
    return out


#: the reduced archs held under ``repro``'s default plan (the sequence split
#: over ``model`` between layers), with the config fields set over the
#: reduced one
SEQ_PARALLEL = {"olmo-1b": {"n_heads": 4, "n_kv_heads": 4}, "zamba2-1.2b": {},
                "granite-moe-3b-a800m": {}, "seamless-m4t-medium": {}}


#: the reduced archs whose heads do not divide the (2, 4) mesh's model axis,
#: at 2 layers, held under ``repro``'s default plan with the published
#: configs' FSDP rule (``embed`` over ``data``), which reduced configs fall
#: below: the query heads (deepseek-coder-33b, xlstm-1.3b, minicpm3-4b), or
#: only the KV heads (gemma-2b with 8 query and 2 KV heads); and xlstm-1.3b
#: with 4 heads, which divide the axis (a key ``arch@variant`` names a
#: second config of one arch)
HEADS_WHOLE = {"deepseek-coder-33b": {"n_heads": 6, "n_kv_heads": 2, "n_layers": 2},
               # 2 heads of 128: at 32 rows over 4 model ranks each chunk
               # of 16 splits its rows (8 a rank); decode splits C's value
               # columns (32 a rank)
               "xlstm-1.3b": {"n_heads": 2, "n_layers": 2},
               "minicpm3-4b": {"n_heads": 6, "n_layers": 2},
               "gemma-2b": {"n_heads": 8, "n_kv_heads": 2, "n_layers": 2},
               "xlstm-1.3b@4": {"n_heads": 4, "n_layers": 2}}
#: the plan rules over ``repro``'s default plan for ``HEADS_WHOLE``
HEADS_WHOLE_RULES = {"embed": "data"}

#: the reduced grok-1-314b (8 query heads on ``model``, 2 KV heads whole)
#: at 2 layers, its MoE groups of 16 tokens, which tile the (2, 4) mesh's
#: rows (8 a model rank: each group over 2 ranks), held under ``repro``'s
#: default plan with ``HEADS_WHOLE_RULES`` (FSDP: the expert weights'
#: ``embed`` over ``data``)
MOE_SPLIT = {"grok-1-314b": {"n_heads": 8, "n_kv_heads": 2, "n_layers": 2,
                             "moe_group": 16}}


def arch_of(key: str) -> str:
    """The registry's name of an arch set's key (``arch`` or ``arch@variant``)."""
    return key.split("@")[0]


def reduced(registry_, arch: str, over: dict, **kw):
    """``registry_``'s reduced config of ``arch`` with the fields ``over``
    sets, where ``"moe_group"`` sets the MoE's group size (both packages'
    registries)."""
    import dataclasses

    over = dict(over)
    group = over.pop("moe_group", None)
    cfg = registry_.get(arch_of(arch)).reduced(**over, **kw)
    if group is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, group_size=group))
    return cfg


def seq_parallel_config(arch: str, archs=None):
    return reduced(registry, arch, (archs or SEQ_PARALLEL)[arch])


@contextlib.contextmanager
def exact_f64(on: bool):
    """f64 throughout: the port's f32 islands (``.float()`` in its norms,
    scores and logits, ``torch.float32`` where it names it) lifted to f64,
    as ``train_parity._exact`` lifts repro's; the scans' plain versions
    take f64 too."""
    if not on:
        yield
        return
    from repro_torch.kernels import mlstm_scan, ssd_scan

    with mock.patch.object(torch, "float32", torch.float64), \
            mock.patch.object(torch.Tensor, "float", lambda t: t.double()), \
            mock.patch.object(ssd_scan, "DTYPES", ssd_scan.DTYPES + (torch.float64,)), \
            mock.patch.object(mlstm_scan, "DTYPES", mlstm_scan.DTYPES + (torch.float64,)):
        yield


def seq_parallel_steps(params_path: str, archs=None, rules=None, s_max: int = 40) -> dict:
    """On each of 8 ranks, each of ``archs``' archs (``SEQ_PARALLEL``'s by
    default) on a (2, 4) mesh under ``repro``'s default plan with ``rules``
    over it, from the parameters saved in ``params_path``
    (``{arch}/{name}``, the port's state dict), in f32 and in f64
    (``exact_f64``): (arch, dtype name) -> ``_seq_parallel_arch``."""
    from repro_torch.parallel.sharding import default_plan

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = {}
    with np.load(params_path) as f:
        for arch in archs or SEQ_PARALLEL:
            cfg = seq_parallel_config(arch, archs)
            state = {k.split("/", 1)[1]: torch.from_numpy(f[k]) for k in f.files
                     if k.split("/", 1)[0] == arch}
            plan = default_plan(cfg, {"data": 2, "model": 4}).override(**(rules or {}))
            for exact in (False, True):
                with exact_f64(exact):
                    out[arch, "float64" if exact else "float32"] = _seq_parallel_arch(
                        cfg, mesh, plan, state, s_max)
    return out


def _seq_parallel_arch(cfg, mesh, plan, state: dict, s_max: int = 40) -> dict:
    """One train step (loss, gradient norm, and each parameter's gradient
    norm as the step's optimizer receives it) and a prefill's logits with
    the sequence split over ``model``; then, without the split (the dry
    run's decode plan), a prefill into caches of ``s_max`` and one decode
    step of the prompt's last token at position 32, its logits gathered
    whole.  The model and the batch in ``torch.float32`` (f64 under
    ``exact_f64``)."""
    apply_updates = adamw.apply_updates
    batch = {k: v.to(torch.float32) if v.is_floating_point() else v
             for k, v in _family_batch(cfg).items()}
    res = {}

    def recorded(opt_cfg, params, grads, *rest):
        res["grads"] = {n: float(g.full_tensor().double().norm())
                        for n, g in grads.items()}
        return apply_updates(opt_cfg, params, grads, *rest)

    for name, p in (("seq", plan), ("decode", plan.override(seq=None))):
        with parallel_context(mesh, p):
            model = build_model(cfg, device="cpu").to(torch.float32)
            model.load_state_dict(state)
            distribute_params(model, mesh, p)
            dt = {k: distribute_tensor(v, mesh, p.placements(
                mesh, "batch", "seq", *(None,) * (v.dim() - 2)), src_data_rank=None)
                for k, v in batch.items()}
            prompt = {k: v for k, v in dt.items() if k != "labels"}
            if name == "seq":
                step = steps.make_train_step(cfg, adamw.OptConfig(
                    lr=1e-3, warmup_steps=1, total_steps=4))
                with torch.no_grad():
                    res["prefill"] = model.prefill(prompt, s_max)[0].full_tensor().numpy()
                opt = adamw.init_state(dict(model.named_parameters()))
                with mock.patch.object(adamw, "apply_updates", recorded):
                    _, m = step(model, opt, dt)
                res["loss"], res["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
            else:
                with torch.no_grad():
                    _, caches = model.prefill(prompt, s_max)
                    token = distribute_tensor(
                        batch["tokens"][:, -1:].contiguous(), mesh,
                        p.placements(mesh, "batch", "seq"), src_data_rank=None)
                    res["decode"] = model.decode(caches, token, 32)[0].full_tensor().numpy()
    return res
