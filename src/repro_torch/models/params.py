"""Parameter definitions and their initialisation on an explicit device.

Models declare parameters as :class:`ParamDef` trees (shape + logical axes +
init), as the reference does.  :func:`init_tree` turns a tree into tensors
with a ``torch.Generator`` on the target device; :class:`ParamTree` holds
them as an ``nn.Module`` that also answers ``p["name"]`` and ``p.get``, so
the block functions read parameters the way the reference's do.

A stacked layer group (:func:`stack_defs`) is initialised whole, so the
reference's rule (:func:`_init_one`: normal x 1/sqrt(``shape[-2]``) of the
stacked shape, bf16 by default) holds unchanged, and is then split into one
module per layer (an ``nn.ModuleList``).

On a device mesh (:func:`distribute_params`), every rank holds the same
seeded parameters and keeps its shard of each: a DTensor with the
placements of its logical axes under the plan (:func:`param_shardings`).
A stacked def's leading ``layers`` axis is dropped there, since the port
holds each layer's tensor on its own.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


@dataclass(frozen=True)
class StackedDef(ParamDef):
    """A ParamDef that :func:`stack_defs` made: its leading ``layers`` axis
    is the port's list of per-layer tensors, not a dim of one."""


def stack_defs(defs: dict, n: int) -> dict:
    """Add a leading ``layers`` axis of size n to every ParamDef in a tree."""
    return {
        k: stack_defs(d, n)
        if isinstance(d, dict)
        else StackedDef((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale, d.dtype)
        for k, d in defs.items()
    }


def _init_one(d: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    dt = _DTYPES[d.dtype]
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(1, d.shape[-1])
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=device)
    return (x * scale).to(dt)


def init_tree(defs: dict, generator: torch.Generator, device) -> dict:
    """Tensors for every ParamDef of ``defs``, drawn in sorted key order."""
    return {
        k: init_tree(d, generator, device)
        if isinstance(d, dict)
        else _init_one(d, generator, device)
        for k, d in sorted(defs.items())
    }


def unstack(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (a copy, so layers do not share storage)."""
    return {
        k: unstack(v, i) if isinstance(v, dict) else v[i].clone()
        for k, v in tree.items()
    }


class ParamTree(nn.Module):
    """A nested dict of tensors as frozen parameters and sub-modules."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def get(self, key: str, default=None):
        return getattr(self, key, default)


def param_def(defs, name: str) -> ParamDef:
    """The ParamDef of the parameter at dotted ``name`` in a model whose
    definitions are ``defs``: a layer index that is not a key (the port's
    per-layer modules of a stacked group) is skipped."""
    node, parts = defs, name.split(".")
    for part in parts:
        if isinstance(node, (tuple, list)):
            node = node[int(part)]
        elif part in node:
            node = node[part]
        elif not part.isdigit():
            raise KeyError(f"no parameter definition at {name}")
    return node


def _layer_axes(d: ParamDef) -> tuple:
    """The logical axes of the tensor the port holds for ``d``."""
    return d.axes[1:] if isinstance(d, StackedDef) else d.axes


def param_shardings(defs, mesh, plan):
    """The tree of ``defs`` with each ParamDef replaced by the
    :class:`~repro_torch.parallel.sharding.NamedSharding` of its tensor on
    ``mesh`` (a DeviceMesh) under ``plan``; a stacked group's sharding is
    that of one layer's tensor."""
    if isinstance(defs, ParamDef):
        return plan.sharding(mesh, *_layer_axes(defs))
    if isinstance(defs, dict):
        return {k: param_shardings(d, mesh, plan) for k, d in defs.items()}
    return type(defs)(param_shardings(d, mesh, plan) for d in defs)


def distribute_params(model: nn.Module, mesh, plan) -> dict:
    """Replace each parameter of ``model`` in place by a DTensor on ``mesh``
    (a DeviceMesh) with its plan's placements; every rank keeps its own
    shard of the full tensor it holds (no bytes move: the ranks built the
    same parameters from the seed).  Returns name -> NamedSharding."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for name, p in list(model.named_parameters()):
        sh = plan.sharding(mesh, *_layer_axes(param_def(model.defs, name)))
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        module._parameters[leaf] = nn.Parameter(
            distribute_tensor(p.detach(), mesh, sh.placements, src_data_rank=None),
            requires_grad=p.requires_grad)
        out[name] = sh
    return out
