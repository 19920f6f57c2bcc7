"""Training launcher: one device, or a device mesh across ranks.

The port of ``repro/launch/train.py``:

  * asynchronous checkpoints of (parameters, optimizer state) every
    ``ckpt_every`` steps (atomic + checksummed; ``ckpt/manager.py``);
  * automatic resume from the latest checkpoint, the restored tensors
    copied into the model's parameters;
  * deterministic data: batch = f(seed, step), so resume is exact;
  * a straggler monitor: per-step wall times feed an EWMA, and steps slower
    than ``straggler_factor`` x the EWMA are logged;
  * preemption: SIGTERM requests a final blocking checkpoint.

The model runs on ``RunConfig.device``, the CUDA card by default (no
fallback to the host: ``--device cpu`` asks for it).  When a
``torch.distributed`` process group is set up (``torchrun``, or
``core.ranks.run_ranks``), every rank trains on the ``(data, model)``
:class:`DeviceMesh` of ``data_mesh`` (``--data-mesh D M``) under the
reference's plan: batch over ``data``, and the FFN and vocab dims over
``model`` when it has more than one rank.  Each rank builds the same seeded parameters and keeps its
shard of them and of the AdamW state (DTensors), feeds its shard of the
global batch, and the checkpoints restore onto whatever mesh the run has.
With no process group, ``data_mesh`` must be (1, 1): one process.

    python -m repro_torch.launch.train --arch olmo-1b --steps 50
    python -m repro_torch.launch.train --arch olmo-1b --full-size \\
        --seq-len 4096 --global-batch 2 --steps 5 --warmup-steps 2
    torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \\
        --device cpu --data-mesh 2 4
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import tempfile
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_debug_mesh, mesh_shape_dict
from repro_torch.models.lm import resolve_device
from repro_torch.models.model import build_model
from repro_torch.models.params import distribute_params
from repro_torch.optim import adamw
from repro_torch.parallel.context import parallel_context
from repro_torch.parallel.sharding import default_plan
from repro_torch.train import steps as S


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class RunConfig:
    arch: str = "olmo-1b"
    reduced: bool = True            # the CPU-sized config; False: published
    steps: int = 50
    seq_len: int = 128
    global_batch: int = 8
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=default_ckpt_dir)
    straggler_factor: float = 3.0
    data_mesh: tuple = (1, 1)
    warmup_steps: int = 10
    device: str = "cuda"


class StragglerMonitor:
    """Flags steps slower than ``factor`` x the EWMA of the step times; keeps
    every (step, seconds) it observed in ``times``."""

    def __init__(self, factor: float):
        self.factor = factor
        self.ewma = None
        self.flagged: list = []
        self.times: list = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append((step, dt))
        slow = self.ewma is not None and dt > self.factor * self.ewma
        self.ewma = dt if self.ewma is None else 0.9 * self.ewma + 0.1 * dt
        if slow:
            self.flagged.append((step, dt))
        return slow


def mesh_and_plan(run: RunConfig, cfg) -> tuple:
    """(the DeviceMesh, the ShardingPlan) of a run across ranks: the
    reference's launcher plan (no sequence or head sharding; the FFN and
    vocab dims on ``model`` when it has more than one rank)."""
    data, model = run.data_mesh
    mesh = make_debug_mesh(data, model, device=torch.device(run.device).type)
    tp = "model" if model > 1 else None
    plan = default_plan(cfg, mesh_shape_dict(mesh)).override(
        seq=None, heads=None, kv_heads=None, mlp=tp, vocab=tp)
    return mesh, plan


def run_config(run: RunConfig):
    """The model config a run trains: the arch's reduced or published one."""
    cfg = registry.get(run.arch)
    return cfg.reduced() if run.reduced else cfg


def train(run: RunConfig, *, verbose: bool = True) -> tuple:
    """Train ``run.steps`` steps (resuming from ``run.ckpt_dir``'s latest
    checkpoint); (the losses of the steps taken, the straggler monitor).

    Across ranks (an initialized process group) every rank calls it with
    the same ``run``; the losses are the global ones on every rank."""
    device = resolve_device(run.device)
    cfg = run_config(run)
    mesh = plan = None
    if dist.is_available() and dist.is_initialized():
        mesh, plan = mesh_and_plan(run, cfg)
    elif tuple(run.data_mesh) != (1, 1):
        raise ValueError(
            f"data_mesh {tuple(run.data_mesh)} without a process group: one process "
            "trains on one device; start the ranks with torchrun or "
            "core.ranks.run_ranks")
    opt_cfg = adamw.OptConfig(lr=3e-4, warmup_steps=run.warmup_steps,
                              total_steps=run.steps)
    step_fn = S.make_train_step(cfg, opt_cfg)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=run.seq_len,
                                global_batch=run.global_batch))
    mgr = CheckpointManager(run.ckpt_dir, retain=2)
    mon = StragglerMonitor(run.straggler_factor)

    stop = {"now": False}

    def _sigterm(signum, frame):
        stop["now"] = True

    try:
        previous = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        previous = None  # not on the main thread (tests)

    verbose = verbose and (mesh is None or dist.get_rank() == 0)
    context = parallel_context(mesh, plan) if mesh else contextlib.nullcontext()
    with context:
        try:
            model = build_model(cfg, device=device)
            shardings = None
            if mesh is not None:
                shardings = distribute_params(model, mesh, plan)
            params = dict(model.named_parameters())
            opt = adamw.init_state(params)
            start = 0
            if mgr.latest_step() is not None:
                where = None
                if shardings is not None:
                    where = (shardings, {"m": shardings, "v": shardings, "step": None})
                (saved, opt), start = mgr.restore((params, opt), shardings=where)
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(saved[name])
                if verbose:
                    print(f"resumed from step {start}")
            losses = []
            for step in range(start, run.steps):
                t0 = time.perf_counter()
                if mesh is None:
                    batch = {k: v.to(device) for k, v in ds.batch(step).items()}
                else:
                    batch = ds.global_batch_on(step, mesh, plan)
                opt, metrics = step_fn(model, opt, batch)
                loss = float(metrics["loss"])  # waits for the step
                losses.append(loss)
                dt = time.perf_counter() - t0
                if mon.observe(step, dt) and verbose:
                    print(f"[straggler] step {step} took {dt:.2f}s "
                          f"(ewma {mon.ewma:.2f}s)")
                if verbose and (step % 10 == 0 or step == run.steps - 1):
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"lr {float(metrics['lr']):.2e} ({dt:.2f}s)")
                if (step + 1) % run.ckpt_every == 0 or stop["now"]:
                    mgr.save(step + 1, (params, opt), blocking=stop["now"])
                    if stop["now"]:
                        if verbose:
                            print(f"preempted at {step}; checkpoint saved")
                        break
            mgr.wait()
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
    return losses, mon


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(
        description="Train an LM on one device, or across the ranks of torchrun.")
    ap.add_argument("--arch", default="olmo-1b", choices=list(registry.ARCH_IDS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--warmup-steps", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: %(default)s)")
    ap.add_argument("--full-size", action="store_true",
                    help="the published config (default: the reduced one)")
    ap.add_argument("--data-mesh", type=int, nargs=2, default=(1, 1),
                    metavar=("D", "M"),
                    help="the (data, model) mesh across the ranks (default: 1 1)")
    args = ap.parse_args(argv)
    run = RunConfig(arch=args.arch, reduced=not args.full_size,
                    steps=args.steps, seq_len=args.seq_len,
                    global_batch=args.global_batch,
                    warmup_steps=args.warmup_steps, ckpt_dir=args.ckpt_dir,
                    device=args.device, data_mesh=tuple(args.data_mesh))
    # torchrun sets the ranks' environment; the group is joined here
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        cuda = resolve_device(run.device).type == "cuda"
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if cuda else "gloo")
    try:
        losses, mon = train(run)
    finally:
        if joined:
            dist.destroy_process_group()
    if losses and (not dist.is_initialized() or dist.get_rank() == 0):
        print(f"final loss {losses[-1]:.4f} (started {losses[0]:.4f}); "
              f"{len(mon.flagged)} straggler events")
    return losses, mon


if __name__ == "__main__":
    main()
