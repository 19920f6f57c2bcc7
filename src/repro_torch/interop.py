"""Carry the reference package's state into the port.

There are no weights here: the state that crosses is a recorded trace and
an app configuration.  Both arrive as plain Python / NumPy values, so the
port never sees an object of the JAX package; the tests do the extraction
on that side (``RegionEvent.to_dicts()``, ``dataclasses.asdict``).
"""

from __future__ import annotations

from repro_torch.apps.kripke import KripkeConfig
from repro_torch.apps.stencil import Decomp3D
from repro_torch.core.regions import RegionEvent, RegionRecorder


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


def kripke_config_from_dict(d: dict) -> KripkeConfig:
    """A :class:`KripkeConfig` from ``dataclasses.asdict`` of the reference's."""
    d = dict(d)
    decomp = d.pop("decomp")
    if not isinstance(decomp, Decomp3D):
        decomp = Decomp3D(**decomp)
    d["w"] = tuple(d["w"])
    return KripkeConfig(decomp=decomp, **d)
