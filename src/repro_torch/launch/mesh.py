"""Production and debug meshes.

The port of ``repro/launch/mesh.py``.  :func:`make_production_mesh` names
the axes of the reference's pods as a :class:`~repro_torch.core.compat.Mesh`
(sizes only: it touches no device and needs no process group), for the
plans and the traced profiles.  :func:`make_debug_mesh` is a real
``torch.distributed`` :class:`DeviceMesh` over the ranks of the process
group that is already set up (``core.ranks.run_ranks`` or ``torchrun``),
on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from repro_torch.core import compat


def make_production_mesh(*, multi_pod: bool = False) -> compat.Mesh:
    """16x16 single-pod (256 chips) or 2x16x16 two-pod (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes)


def mesh_shape_dict(mesh) -> dict:
    """Axis name -> size, of a ``compat.Mesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, compat.Mesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_debug_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A (data, model) DeviceMesh over the initialized process group, whose
    world size must be ``data * model``; rank r sits at (r // model, r %
    model).  ``device`` is the ranks' device type: the card by default,
    ``"cpu"`` for gloo ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a ({data}, {model}) device mesh needs an initialized "
            "torch.distributed process group (start the ranks with "
            "repro_torch.core.ranks.run_ranks or torchrun)")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(
            f"mesh ({data}, {model}) needs {data * model} ranks, but the process "
            f"group has {world}")
    return init_device_mesh(device, (data, model), mesh_dim_names=("data", "model"))
