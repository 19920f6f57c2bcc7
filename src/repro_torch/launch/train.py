"""Training launcher: one process, one device.

The port of ``repro/launch/train.py``'s single-process path:

  * asynchronous checkpoints of (parameters, optimizer state) every
    ``ckpt_every`` steps (atomic + checksummed; ``ckpt/manager.py``);
  * automatic resume from the latest checkpoint, the restored tensors
    copied into the model's parameters;
  * deterministic data: batch = f(seed, step), so resume is exact;
  * a straggler monitor: per-step wall times feed an EWMA, and steps slower
    than ``straggler_factor`` x the EWMA are logged;
  * preemption: SIGTERM requests a final blocking checkpoint.

The model runs on ``RunConfig.device``, the CUDA card by default (no
fallback to the host: ``--device cpu`` asks for it).  Sharded training
(``data_mesh`` other than (1, 1)) waits for the port of ``parallel/``.

    python -m repro_torch.launch.train --arch olmo-1b --steps 50
    python -m repro_torch.launch.train --arch olmo-1b --full-size \\
        --seq-len 4096 --global-batch 2 --steps 5 --warmup-steps 2
"""

from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time
from dataclasses import dataclass, field

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.lm import resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
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


def train(run: RunConfig, *, verbose: bool = True) -> tuple:
    """Train ``run.steps`` steps (resuming from ``run.ckpt_dir``'s latest
    checkpoint); (the losses of the steps taken, the straggler monitor)."""
    if tuple(run.data_mesh) != (1, 1):
        raise ValueError(
            f"data_mesh {tuple(run.data_mesh)}: the port trains on one device; "
            "sharded training waits for the port of parallel/"
        )
    device = resolve_device(run.device)
    cfg = registry.get(run.arch)
    if run.reduced:
        cfg = cfg.reduced()
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

    try:
        model = build_model(cfg, device=device)
        params = dict(model.named_parameters())
        opt = adamw.init_state(params)
        start = 0
        if mgr.latest_step() is not None:
            (saved, opt), start = mgr.restore((params, opt))
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(saved[name])
            if verbose:
                print(f"resumed from step {start}")
        losses = []
        for step in range(start, run.steps):
            t0 = time.perf_counter()
            batch = {k: v.to(device) for k, v in ds.batch(step).items()}
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
    ap = argparse.ArgumentParser(description="Train an LM on one device.")
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
    args = ap.parse_args(argv)
    run = RunConfig(arch=args.arch, reduced=not args.full_size,
                    steps=args.steps, seq_len=args.seq_len,
                    global_batch=args.global_batch,
                    warmup_steps=args.warmup_steps, ckpt_dir=args.ckpt_dir,
                    device=args.device)
    losses, mon = train(run)
    if losses:
        print(f"final loss {losses[-1]:.4f} (started {losses[0]:.4f}); "
              f"{len(mon.flagged)} straggler events")
    return losses, mon


if __name__ == "__main__":
    main()
