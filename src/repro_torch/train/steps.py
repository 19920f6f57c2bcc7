"""Train / serve step functions with communication regions, and their inputs.

The port of ``repro/train/steps.py``.  ``make_train_step`` runs the loss,
its gradients and AdamW, with the reference's regions nested as it nests
them (``fwd`` inside ``grad``, then ``optimizer``); ``make_prefill_step``
and ``make_decode_step`` run the models' ``prefill`` / ``decode`` inside
``prefill`` / ``decode``.  The model holds its parameters (an
``nn.Module``); the train step sets ``requires_grad_(True)`` on them, runs
the loss's backward and updates them in place.

The dry run (:mod:`repro_torch.launch.dryrun`) captures these steps for
every (arch x shape) cell: :func:`batch_specs`, :func:`cache_specs`,
:func:`decode_token_specs` and :func:`abstract_opt_state` give their
inputs as ``meta`` tensors (the reference's ``ShapeDtypeStruct``s), or,
with ``(mesh, plan)``, as DTensors whose local ``meta`` tensors carry the
plan's shard shapes; :func:`abstract_model` gives the model with fake
parameters.  None of them allocates memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.regions import comm_region
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw
from repro_torch.parallel.context import replicate

# Default stub frontend sizes (the modality frontends are stubs supplying
# precomputed embeddings, as in the reference).
VLM_PATCHES = 1024
AUDIO_FRAMES = 2048


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



def make_prefill_step(cfg, s_max: int):
    """step(model, batch) -> (last position's logits, caches padded to
    ``s_max``), inside the ``prefill`` region."""

    def step(model, batch: dict) -> tuple:
        with comm_region("prefill"):
            return model.prefill(batch, s_max)

    return step


def make_decode_step(cfg):
    """step(model, caches, token, pos) -> (logits, caches), inside the
    ``decode`` region; the caches are written in place at ``pos``."""

    def step(model, caches, token: torch.Tensor, pos: int) -> tuple:
        with comm_region("decode"):
            return model.decode(caches, token, pos)

    return step


# ---------------------------------------------------------------------------
# Abstract inputs per (arch x shape): meta tensors, or meta-local DTensors
# ---------------------------------------------------------------------------


def _spec(shape: tuple, dtype: torch.dtype, axes: tuple, mesh=None, plan=None):
    """A ``meta`` tensor of ``shape``; with ``(mesh, plan)`` a DTensor on
    ``mesh`` with the placements of ``axes`` whose local ``meta`` tensor has
    this rank's shard shape."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    if mesh is None:
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, plan.placements(mesh, *axes), src_data_rank=None)


def batch_specs(cfg, shape, mesh=None, plan=None) -> dict:
    """Train/prefill batch specs (tokens/labels + stub modalities)."""
    B, S = shape.global_batch, shape.seq_len
    s_text = S
    batch = {}
    if cfg.family == "vlm":
        v = min(VLM_PATCHES, S // 2)
        s_text = S - v
        batch["vision_embeds"] = _spec((B, v, cfg.d_model), torch.bfloat16,
                                       ("batch", "seq", "act_embed"), mesh, plan)
    if cfg.family == "audio":
        batch["frames"] = _spec((B, AUDIO_FRAMES, cfg.d_model), torch.bfloat16,
                                ("batch", "frames", "act_embed"), mesh, plan)
    batch["tokens"] = _spec((B, s_text), torch.int32, ("batch", "seq"), mesh, plan)
    batch["labels"] = _spec((B, s_text), torch.int32, ("batch", "seq"), mesh, plan)
    return batch


def cache_specs(cfg, shape, mesh=None, plan=None) -> tuple:
    """Decode-cache specs for one serving cell, laid out as the port's
    ``decode`` takes them: a stacked group (the reference's leading
    ``layers`` axis) becomes a list of per-layer dicts.  f32 for the
    ``ssm`` / ``hybrid`` families, bf16 otherwise."""
    B, S = shape.global_batch, shape.seq_len
    dtype = torch.float32 if cfg.family in ("ssm", "hybrid") else torch.bfloat16
    if cfg.family == "audio":
        shapes = encdec.cache_shapes(cfg, B, S, AUDIO_FRAMES)
    else:
        shapes = lm.cache_shapes(cfg, B, S)

    def group(entry: dict):
        stacked = {k: sh for k, (sh, axes) in entry.items() if axes[:1] == ("layers",)}
        if not stacked:
            return {k: _spec(sh, dtype, axes, mesh, plan) for k, (sh, axes) in entry.items()}
        n = next(iter(stacked.values()))[0]
        return [{k: _spec(sh[1:], dtype, axes[1:], mesh, plan)
                 for k, (sh, axes) in entry.items()} for _ in range(n)]

    return tuple(group(entry) for entry in shapes)


def decode_token_specs(cfg, shape, mesh=None, plan=None):
    """The (B, 1) int32 token of one decode step."""
    return _spec((shape.global_batch, 1), torch.int32, ("batch", "seq"), mesh, plan)


def _meta_like(p: torch.Tensor, dtype: torch.dtype):
    """A meta tensor of ``p``'s shape in ``dtype``; for a DTensor, a DTensor
    with its placements over a local meta tensor of its shard's shape."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return torch.empty(p.shape, dtype=dtype, device="meta")
    local = torch.empty(p.to_local().shape, dtype=dtype, device="meta")
    return DTensor.from_local(local, p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())


def abstract_opt_state(cfg, mesh=None, plan=None) -> dict:
    """AdamW state specs: f32 moments laid out as the parameters (sharded
    as they are under ``(mesh, plan)``), keyed by parameter name, and an
    int32 step."""
    params = dict(abstract_model(cfg, mesh, plan).named_parameters())
    return {"m": {n: _meta_like(p, torch.float32) for n, p in params.items()},
            "v": {n: _meta_like(p, torch.float32) for n, p in params.items()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def abstract_model(cfg, mesh=None, plan=None):
    """The model of ``cfg`` built under a ``FakeTensorMode``: its parameters
    are fake tensors (on ``mesh``'s device type, else the CPU) and take no
    memory, even at grok-1-314b's size.  With ``(mesh, plan)`` they are
    DTensors with the plan's placements (``distribute_params``).  A step
    runs on it inside the same fake mode (:func:`fake_mode_of`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build_model
    from repro_torch.models.params import distribute_params

    device = mesh.device_type if mesh is not None else "cpu"
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = build_model(cfg, device=device)
        if mesh is not None:
            distribute_params(model, mesh, plan)
    return model


def fake_mode_of(model):
    """The ``FakeTensorMode`` that :func:`abstract_model` built ``model`` in."""
    p = next(model.parameters())
    return getattr(p, "_local_tensor", p).fake_mode
