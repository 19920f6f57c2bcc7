"""The train step: loss, gradients and AdamW, with communication regions.

The port of ``repro/train/steps.py``'s training half: ``softmax_xent``,
``make_loss_fn`` and ``make_train_step``, with the reference's regions
nested as it nests them (``fwd`` inside ``grad``, then ``optimizer``).
Serving steps are the models' ``prefill`` / ``decode``.  The model holds
its parameters (an ``nn.Module``); the step sets ``requires_grad_(True)``
on them, runs the loss's backward and updates them in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.regions import comm_region
from repro_torch.optim import adamw
from repro_torch.parallel.context import replicate


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, vocab_real: int):
    """Mean token cross-entropy; padded vocab ids masked out.

    logits (B,S,V_pad) f32; labels (B,S) int (may contain -1 = ignore).
    The label logit is taken by comparing with a vocab iota, not by a
    gather, as the reference does for its vocab-sharded logits.
    """
    vpad = logits.shape[-1]
    iota = replicate(torch.arange(vpad, device=logits.device).view(1, 1, vpad))
    if vpad > vocab_real:
        logits = torch.where(iota >= vocab_real, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    sel = iota == labels.clamp_min(0)[..., None]
    ll = torch.where(sel, logits, 0.0).sum(dim=-1)
    valid = (labels >= 0).to(torch.float32)
    nll = (lse - ll) * valid
    return nll.sum() / valid.sum().clamp_min(1.0)


def make_loss_fn(cfg):
    """loss_fn(model, batch) -> (loss, {"xent", "aux"}), as the reference's
    (whose ``xent`` already holds the MoE aux term)."""

    def loss_fn(model, batch: dict) -> tuple:
        with comm_region("fwd"):
            logits, aux = model.train_logits(batch)
        shift_logits = logits[:, :-1]
        labels = batch["labels"][:, 1:]
        if cfg.family == "vlm" and "vision_embeds" in batch:
            shift_logits = shift_logits[:, batch["vision_embeds"].shape[1]:]
        loss = softmax_xent(shift_logits, labels, cfg.vocab)
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_coef * aux
        return loss, {"xent": loss, "aux": aux}

    return loss_fn


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A metric's value on every rank: a DTensor (a partial sum, say) made
    whole; a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def make_train_step(cfg, opt_cfg: Optional[adamw.OptConfig] = None):
    """step(model, opt_state, batch) -> (opt_state, metrics).

    The model's parameters are updated in place and their ``.grad`` is
    ``None`` after each step.  ``metrics`` holds ``loss``, ``xent``, ``aux``,
    ``grad_norm`` and ``lr`` as tensors on the model's device (reading one
    waits for the step); on a device mesh they are whole on every rank.
    """
    opt_cfg = opt_cfg or adamw.OptConfig()
    loss_fn = make_loss_fn(cfg)

    def step(model, opt_state: dict, batch: dict) -> tuple:
        params = dict(model.named_parameters())
        model.requires_grad_(True)
        with comm_region("grad"):
            loss, metrics = loss_fn(model, batch)
            loss.backward()
            # whole on every rank under a mesh (the loss is a partial sum)
            metrics = {k: _whole(v.detach()) for k, v in
                       dict(metrics, loss=loss).items()}
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()
        }
        for p in params.values():
            p.grad = None
        with comm_region("optimizer"):
            opt_state, opt_metrics = adamw.apply_updates(
                opt_cfg, params, grads, opt_state, adamw.decay_mask(model)
            )
        return opt_state, dict(metrics, **{k: _whole(v) for k, v in opt_metrics.items()})

    return step

