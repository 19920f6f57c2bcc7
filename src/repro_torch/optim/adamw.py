"""AdamW + cosine schedule + global-norm clipping (no torch.optim).

The port of ``repro/optim/adamw.py``.  Parameters are a dict of name ->
tensor (``dict(model.named_parameters())``) and are updated in place; the
state mirrors them: ``m`` / ``v`` in f32 whatever the parameter's dtype
(``torch.optim.AdamW`` keeps bf16 moments for bf16 parameters), plus a
scalar ``step``.  The update runs in f32 and is cast back to the
parameter's dtype.  The step's scalars (``step``, ``lr``, the bias
corrections, the clip scale) are f32 tensors on the parameters' device, so
a step neither waits for the host nor rounds in f64.

Weight decay follows the reference's mask, ``p.ndim >= 2`` *of the
reference's tree*, where each layer group is stacked on a leading
``layers`` axis: a layer's 1-D norm scale is 2-D there and is decayed.
The port keeps one module per layer, so :func:`decay_mask` reads the rank
from the model's stacked parameter definitions, not from the tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.params import param_def


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac; f32 like ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
        0.0,
        1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params: dict) -> dict:
    """Zero f32 moments for every parameter (laid out as the parameter: a
    DTensor's moments are DTensors with its placements) and a step of 0
    (int32), on the parameters' devices."""
    device = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple:
    """(grads scaled to a global norm of at most ``max_norm``, the norm).

    Each gradient keeps its dtype; the norm and the scale are f32 tensors.
    """
    leaves = list(grads.values())
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    clipped = {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}
    return clipped, gn


def decay_mask(model) -> dict:
    """name -> whether AdamW decays the parameter: the reference's
    ``p.ndim >= 2`` over its stacked tree, read from ``model.defs``."""
    return {
        name: len(param_def(model.defs, name).shape) >= 2
        for name, _ in model.named_parameters()
    }


@torch.no_grad()
def apply_updates(
    cfg: OptConfig, params: dict, grads: dict, state: dict, decay_mask=None
) -> tuple:
    """One AdamW step on ``params`` in place.  Returns (new_state, metrics).

    ``grads`` maps the same names to gradients; ``decay_mask`` maps names to
    bools (by default the parameter's own ``ndim >= 2``).  ``metrics``
    holds ``grad_norm`` and ``lr``, f32 tensors on the device.
    """
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)
    if decay_mask is None:
        decay_mask = {n: p.ndim >= 2 for n, p in params.items()}
    new_m, new_v = {}, {}
    for name, p in params.items():
        gf = grads[name].float()
        m = b1 * state["m"][name] + (1 - b1) * gf
        v = b2 * state["v"][name] + (1 - b2) * gf * gf
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decay_mask[name]:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        new_m[name], new_v[name] = m, v
    return {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm, "lr": lr}
