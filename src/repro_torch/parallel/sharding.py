"""Logical-axis sharding: DP / FSDP / TP / SP / EP over (pod, data, model).

The port of ``repro/parallel/sharding.py``.  Every parameter and
activation dimension in the model stack carries a *logical* axis name; a
:class:`ShardingPlan` maps logical names to mesh axes.  The rules and the
specs are the reference's, value for value (``spec`` returns the port's
:class:`~repro_torch.core.compat.PartitionSpec`).  Where ``repro`` turns a
spec into a ``NamedSharding``, the port turns it into DTensor placements
over a ``torch.distributed`` :class:`DeviceMesh`, one per mesh dimension
(:meth:`ShardingPlan.placements`); the collectives DTensor inserts between
placements are the analog of the ones GSPMD inserts.

Logical axes used by the models:

  batch      global batch            -> (pod, data)   [DP]
  seq        sequence                -> None, or model [SP when heads don't
                                        divide the TP axis]
  embed      d_model                 -> None, or (pod, data) [FSDP weights]
  mlp        FFN hidden / d_ff       -> model          [TP]
  heads      attention query heads   -> model (when divisible)
  kv_heads   KV heads                -> model (when divisible)
  vocab      vocabulary (padded)     -> model          [TP embedding/LM head]
  experts    MoE expert dim          -> None (TP-MoE default) or model [EP]
  expert_mlp per-expert hidden       -> model
  kv_seq     KV-cache sequence       -> None, or model [decode seq-sharding]
  state      SSM/mLSTM state dims    -> None
  layers     stacked-layer leading   -> None (never sharded)
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.core.compat import PartitionSpec

LOGICAL_AXES = ("batch", "seq", "embed", "act_embed", "mlp", "heads",
                "kv_heads", "vocab", "experts", "expert_mlp", "moe_cap",
                "moe_groups", "kv_seq", "state", "layers", "conv",
                "frames")


def _names(axes) -> tuple:
    """A spec entry's mesh axes: () for None, (a,) for a name."""
    return (axes,) if isinstance(axes, str) else tuple(axes or ())


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a device mesh: one DTensor placement per mesh
    dimension (the port's ``jax.sharding.NamedSharding``)."""

    mesh: object
    placements: tuple


@dataclass(frozen=True)
class ShardingPlan:
    """Mapping logical axis -> mesh axis (str), tuple of axes, or None."""

    rules: dict = field(default_factory=dict)
    mesh_axes: tuple = ("data", "model")

    def get(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical not in LOGICAL_AXES:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.rules.get(logical)

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        """PartitionSpec for a dim list; a mesh axis may appear only once
        per spec, so later duplicates degrade to None (e.g. under sequence
        parallelism ("batch","seq","vocab") -> (dp, model, None): the seq
        sharding wins and the vocab dim of that activation replicates)."""
        used: set = set()
        out = []
        for logical_name in logical:
            axes = self.get(logical_name)
            tup = _names(axes)
            if any(a in used for a in tup):
                out.append(None)
                continue
            used.update(tup)
            out.append(axes)
        return PartitionSpec(*out)

    def placements(self, device_mesh, *logical: Optional[str]) -> tuple:
        """The spec of ``logical`` as DTensor placements on ``device_mesh``,
        one per mesh dimension: ``Shard(d)`` on each mesh dimension that
        tensor dim ``d`` maps to, ``Replicate()`` on the others.  A dim over
        several mesh axes (``("pod", "data")``) is split over them in the
        order given, the major axis first, as a ``NamedSharding`` splits it."""
        from torch.distributed.tensor import Replicate, Shard

        dims = tuple(device_mesh.mesh_dim_names or ())
        out = [Replicate() for _ in dims]
        for d, axes in enumerate(self.spec(*logical)):
            for a in _names(axes):
                if a not in dims:
                    raise ValueError(
                        f"logical axis {logical[d]!r} maps to mesh axis {a!r}, "
                        f"which the device mesh {dims} does not have")
                out[dims.index(a)] = Shard(d)
        return tuple(out)

    def sharding(self, device_mesh, *logical) -> NamedSharding:
        return NamedSharding(device_mesh, self.placements(device_mesh, *logical))

    def override(self, **rules) -> "ShardingPlan":
        merged = dict(self.rules)
        merged.update(rules)
        return replace(self, rules=merged)

    def describe(self) -> str:
        return ", ".join(f"{k}->{v}" for k, v in sorted(
            self.rules.items(), key=lambda kv: kv[0]) if v is not None)


def default_plan(cfg, mesh_shape: dict) -> ShardingPlan:
    """Construct the baseline plan for a model config on a mesh.

    ``mesh_shape``: dict axis name -> size (e.g. {"data":16,"model":16} or
    {"pod":2,"data":16,"model":16}).

    Rules (the reference's):
      * batch over (pod, data).
      * mlp / vocab / expert_mlp over model (all assigned d_ff and padded
        vocab sizes divide 16).
      * heads over model when q-head count divides the model axis; otherwise
        attention falls back to sequence parallelism (seq -> model) and
        heads stay unsharded.
      * kv_heads sharded only when they divide the model axis.
      * embed FSDP over (pod, data) for models above ~7B params.
      * experts: TP-MoE (replicated expert dim, expert_mlp over model) —
        avoids padding 40- or 8-expert dims onto a 16-way axis.
    """
    has_pod = "pod" in mesh_shape
    dp = ("pod", "data") if has_pod else ("data",)
    model_n = mesh_shape.get("model", 1)

    heads = getattr(cfg, "n_heads", 0) or 0
    kv_heads = getattr(cfg, "n_kv_heads", 0) or 0
    heads_divisible = heads % model_n == 0 if heads else False
    kv_divisible = kv_heads % model_n == 0 if kv_heads else False

    rules = {
        "batch": dp if len(dp) > 1 else dp[0],
        # sequence parallelism at layer boundaries (Megatron-SP), and the
        # attention fallback for archs whose head count doesn't divide the
        # TP axis
        "seq": "model",
        "embed": None,        # weight d_model dim (FSDP target)
        "act_embed": None,    # activation hidden dim (kept unsharded)
        "mlp": "model",
        "vocab": "model",
        "experts": None,
        "expert_mlp": "model",
        "moe_cap": None,     # alternative MoE plan: shard capacity slots
        # dispatch groups follow the DP axes (a None constraint would mean
        # "replicate", not "unspecified")
        "moe_groups": dp if len(dp) > 1 else dp[0],
        "heads": "model" if heads_divisible else None,
        "kv_heads": "model" if kv_divisible else None,
        # decode caches: shard the cache sequence over the TP axis when KV
        # heads can't use it (flash-decoding-style partial attention)
        "kv_seq": None if kv_divisible else "model",
        "state": None,
        "layers": None,
        "conv": None,
        "frames": None,
    }

    # FSDP for large models: shard the embed dim of weights over DP axes
    if getattr(cfg, "param_count", lambda: 0)() >= 7e9:
        rules["embed"] = dp if len(dp) > 1 else dp[0]

    return ShardingPlan(rules=rules, mesh_axes=tuple(mesh_shape))


def _tree_map(fn, tree):
    """``fn`` over a tree of dicts and lists whose leaves are tuples of
    logical axis names (a tuple is a leaf, as in the reference)."""
    if isinstance(tree, tuple):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    raise TypeError(f"not a tree of logical axes: {type(tree).__name__}")


def tree_shardings(device_mesh, axes_tree, plan: ShardingPlan):
    """Map a tree of logical-axis tuples to :class:`NamedSharding` leaves
    (each the DTensor placements of its spec on ``device_mesh``)."""
    return _tree_map(lambda axes: plan.sharding(device_mesh, *axes), axes_tree)


def tree_specs(axes_tree, plan: ShardingPlan):
    return _tree_map(lambda axes: plan.spec(*axes), axes_tree)
