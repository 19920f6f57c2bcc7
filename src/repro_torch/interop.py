"""Carry the reference package's state into the port.

The state that crosses is a recorded trace, an app configuration, or a
model's parameters.  All arrive as plain Python / NumPy values, so the port
never sees an object of the JAX package; the tests do the extraction on that
side (``RegionEvent.to_dicts()``, ``dataclasses.asdict``, ``np.asarray`` of
each parameter).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.amg import AMGConfig
from repro_torch.apps.beatnik import BeatnikConfig
from repro_torch.apps.kripke import KripkeConfig
from repro_torch.apps.laghos import LaghosConfig
from repro_torch.apps.stencil import Decomp3D
from repro_torch.configs import base
from repro_torch.core.regions import RegionEvent, RegionRecorder
from repro_torch.models.lm import layer_plan


def recorder_from_event_dicts(events, instances) -> RegionRecorder:
    """A recorder holding ``events`` in order, with region ``instances``.

    Each event is a dict with ``region``, ``region_path``, ``kind``,
    ``is_collective`` and ``axis_name`` plus the fields of
    ``RegionEvent.to_dicts()`` (``sends_per_rank`` … ``bytes_recv``), and
    optionally ``n_ranks``.  ``instances`` maps region -> times entered.
    """
    rec = RegionRecorder()
    rec.instances = {str(k): int(v) for k, v in instances.items()}
    for ev in events:
        rec.record(
            RegionEvent.from_dicts(
                region=ev["region"],
                region_path=tuple(ev["region_path"]),
                kind=ev["kind"],
                sends_per_rank=ev["sends_per_rank"],
                recvs_per_rank=ev["recvs_per_rank"],
                dest_ranks=ev["dest_ranks"],
                src_ranks=ev["src_ranks"],
                bytes_sent=ev["bytes_sent"],
                bytes_recv=ev["bytes_recv"],
                is_collective=int(ev["is_collective"]),
                axis_name=ev["axis_name"],
                n_ranks=ev.get("n_ranks"),
            )
        )
    return rec


def _app_config(cls, d: dict, **fix):
    d = dict(d)
    decomp = d.pop("decomp")
    if not isinstance(decomp, Decomp3D):
        decomp = Decomp3D(**decomp)
    d.update({k: f(d[k]) for k, f in fix.items()})
    return cls(decomp=decomp, **d)


def kripke_config_from_dict(d: dict) -> KripkeConfig:
    """A :class:`KripkeConfig` from ``dataclasses.asdict`` of the reference's."""
    return _app_config(KripkeConfig, d, w=tuple)


def amg_config_from_dict(d: dict) -> AMGConfig:
    """An :class:`AMGConfig` from ``dataclasses.asdict`` of the reference's."""
    return _app_config(AMGConfig, d)


def laghos_config_from_dict(d: dict) -> LaghosConfig:
    """A :class:`LaghosConfig` from ``dataclasses.asdict`` of the reference's."""
    return _app_config(LaghosConfig, d)


def beatnik_config_from_dict(d: dict) -> BeatnikConfig:
    """A :class:`BeatnikConfig` from ``dataclasses.asdict`` of the reference's."""
    return _app_config(BeatnikConfig, d)


def model_config_from_dict(d: dict):
    """A :class:`ModelConfig` from ``dataclasses.asdict`` of the reference's."""
    d = dict(d)
    subs = {
        "mla": base.MLAConfig,
        "moe": base.MoEConfig,
        "ssm": base.SSMConfig,
        "mlstm": base.MLSTMConfig,
    }
    for key, cls in subs.items():
        if isinstance(d.get(key), dict):
            d[key] = cls(**d[key])
    if d.get("mrope_sections") is not None:
        d["mrope_sections"] = tuple(d["mrope_sections"])
    return base.ModelConfig(**d)


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor of ``arr``; bf16 (dtype name ``bfloat16``) crosses as bits.

    ``torch.from_numpy`` refuses the ``bfloat16`` dtype that JAX arrays
    carry, so its 16-bit patterns are viewed as ``uint16`` and reinterpreted.
    """
    arr = np.array(arr, order="C")  # a writable copy that the tensor owns
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def lm_params_from_numpy(cfg, tree: dict) -> dict:
    """The port's ``LM`` state dict from the reference's parameter tree.

    ``tree`` is the reference ``LM``'s parameters as nested dicts of NumPy
    arrays (``{"embed": {...}, "groups": (stacked, ...)}``, and a hybrid
    model's ``"shared"`` block); each group's leading ``layers`` axis is
    unstacked into one module per layer, and the shared block's ``down``
    stays stacked by invocation.  Load the result with ``LM.load_state_dict``.
    """
    state = {}

    def put(prefix: str, sub: dict, layer=None) -> None:
        for k, v in sub.items():
            name = f"{prefix}.{k}"
            if isinstance(v, dict):
                put(name, v, layer)
            else:
                state[name] = tensor_from_numpy(v if layer is None else v[layer])

    put("embed", tree["embed"])
    if "shared" in tree:
        put("shared", tree["shared"])
    groups = tree["groups"]
    plan = layer_plan(cfg)
    if len(groups) != len(plan):
        raise ValueError(f"{len(groups)} layer groups given, the plan has {len(plan)}")
    for gi, ((_, n), stacked) in enumerate(zip(plan, groups)):
        for i in range(n):
            put(f"groups.{gi}.{i}", stacked, i)
    return state
