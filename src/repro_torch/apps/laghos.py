"""Laghos analog — Lagrangian compressible hydrodynamics (strong scaling).

Laghos (paper §III-A, §IV-C) advances a compressible-gas state with
high-order finite elements; its communication is dominated by halo exchanges
during force assembly plus the timestep control's reduction/broadcast pair
(the two green-dot levels in paper Fig. 4).  Under strong scaling the local
block shrinks with rank count, so bytes-per-rank fall while message rate
rises (paper Table IV / Fig. 5).

This analog keeps that structure on a 2-D grid with a simplified
compressible update (pressure gradient + artificial viscosity), colocated
fields, and the paper's annotated regions:

  halo_exchange     ghost exchange of (rho, e, vx, vy) before force assembly
  force_compute     pure-compute corner-force analog
  timestep          CFL dt: pmin reduction + broadcast from rank 0
  main              whole step loop

The per-rank step takes its communication from a :class:`_Comm`: the
instrumented collectives under :func:`run_steps` (traced on meta tensors by
:func:`profile`, or run across the ranks of a process group), or zero
Dirichlet ghosts and no collective in the single-domain oracle
:func:`reference_steps`, which runs the same arithmetic on the
undecomposed grid and needs no process group.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.apps.stencil import (
    Decomp3D,
    card_device,
    halo_exchange,
    pad_with_halo,
    zero_pad,
)
from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.backend import TorchBackend
from repro_torch.core.profiler import CommProfile, profile_traced
from repro_torch.core.regions import comm_region

AXES_2D = ("x", "y")
FIELDS = ("rho", "e", "vx", "vy")


@dataclass(frozen=True)
class LaghosConfig:
    """Strong-scaling config: nx/ny are the fixed *global* grid."""

    decomp: Decomp3D = field(default_factory=lambda: Decomp3D(2, 2, 1))
    nx: int = 256  # global cells (strong scaling: fixed)
    ny: int = 256
    gamma: float = 1.4
    cfl: float = 0.3
    q_visc: float = 0.1  # artificial-viscosity coefficient
    n_steps: int = 2
    dtype: str = "float32"

    @property
    def local_shape(self) -> tuple:
        assert self.nx % self.decomp.px == 0 and self.ny % self.decomp.py == 0
        return (self.nx // self.decomp.px, self.ny // self.decomp.py)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class _Comm:
    """The step's communication over the decomposition (instrumented)."""

    def __init__(self, cfg: LaghosConfig):
        self.cfg = cfg

    def exchange(self, state: dict) -> dict:
        """Halo-exchange each field's 1-wide faces in x and y."""
        with comm_region("halo_exchange"):
            padded = {}
            for k, v in state.items():
                ghosts = halo_exchange(v, self.cfg.decomp, dims=(0, 1))
                padded[k] = pad_with_halo(v, ghosts, dims=(0, 1))
        return padded

    def timestep(self, dt_local):
        with comm_region("timestep"):
            dt = coll.pmin(dt_local, AXES_2D)  # Reduction phase
            return coll.pbroadcast(dt, AXES_2D, root=0)  # Broadcast phase


class _OneDomain(_Comm):
    """The single-domain oracle's: zero ghosts, one rank, no collective."""

    def exchange(self, state: dict) -> dict:
        return {k: zero_pad(v) for k, v in state.items()}

    def timestep(self, dt_local):
        return dt_local


def _grad_x(p):  # central difference on padded array -> interior
    return 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])


def _grad_y(p):
    return 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])


def _div(vx_p, vy_p):
    return _grad_x(vx_p) + _grad_y(vy_p)


def _lap(p):
    return p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, 2:] + p[1:-1, :-2] - 4.0 * p[1:-1, 1:-1]


def hydro_step(state: dict, cfg: LaghosConfig, comm: _Comm | None = None):
    """One Lagrangian-flavored explicit step.  Runs inside ``shard_map``."""
    comm = _Comm(cfg) if comm is None else comm
    rho, e, vx, vy = state["rho"], state["e"], state["vx"], state["vy"]

    # --- timestep control: reduction + broadcast (paper Fig. 4 phases) ---
    cs = torch.sqrt(cfg.gamma * (cfg.gamma - 1.0) * torch.clamp(e, min=1e-12))
    vmag = torch.sqrt(vx * vx + vy * vy)
    dt_local = cfg.cfl / torch.clamp(cs + vmag, min=1e-6).max()
    dt = comm.timestep(dt_local)

    # --- halo exchange + force assembly ---
    padded = comm.exchange(dict(rho=rho, e=e, vx=vx, vy=vy))
    with comm_region("force_compute"):
        p = (cfg.gamma - 1.0) * padded["rho"] * padded["e"]
        fx = -_grad_x(p) + cfg.q_visc * _lap(padded["vx"])
        fy = -_grad_y(p) + cfg.q_visc * _lap(padded["vy"])
        div_v = _div(padded["vx"], padded["vy"])

    # --- update (Lagrangian energy / momentum, simplified EOS) ---
    rho_safe = torch.clamp(rho, min=1e-12)
    vx = vx + dt * fx / rho_safe
    vy = vy + dt * fy / rho_safe
    pr = (cfg.gamma - 1.0) * rho * e
    e = torch.clamp(e - dt * pr * div_v / rho_safe, min=0.0)
    rho = torch.clamp(rho * (1.0 - dt * div_v), min=1e-12)
    return dict(rho=rho, e=e, vx=vx, vy=vy), dt


def _steps(state: dict, cfg: LaghosConfig, comm: _Comm) -> tuple:
    with comm_region("main"):
        dts = []
        for _ in range(cfg.n_steps):
            state, dt = hydro_step(state, cfg, comm)
            dts.append(dt)
        return state, torch.stack(dts)


def run_steps(cfg: LaghosConfig, mesh: compat.Mesh):
    """The steps over global arrays (shards dims 0, 1): traced on meta
    tensors, or run across the ranks of a process group of the mesh's size
    on real ones (``compat.shard_map``)."""
    spec = compat.PartitionSpec("x", "y")
    specs = {k: spec for k in FIELDS}

    def run(state):
        def inner(state):
            return _steps(state, cfg, _Comm(cfg))

        return compat.shard_map(
            inner,
            mesh=mesh,
            in_specs=(specs,),
            out_specs=(specs, compat.PartitionSpec()),
        )(state)

    return run


def reference_steps(cfg: LaghosConfig):
    """Single-domain oracle: the same step on the undecomposed grid, with
    zero Dirichlet ghosts at the physical boundary and no collective.  Runs
    on the device of the state it is given."""

    def run(state):
        return _steps(state, cfg, _OneDomain(cfg))

    return run


def make_state(cfg: LaghosConfig, *, device=None) -> dict:
    """Deterministic blast-wave-flavored initial condition (global).

    Built on the CUDA card unless ``device`` says otherwise; raises
    ``BackendUnavailable`` when the card is asked for and there is none.
    """
    device = card_device(device, "make_state")
    dtype = cfg.torch_dtype
    x, y = torch.meshgrid(
        torch.linspace(0, 1, cfg.nx, dtype=torch.float32, device=device),
        torch.linspace(0, 1, cfg.ny, dtype=torch.float32, device=device),
        indexing="ij",
    )
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
    rho = torch.ones_like(x)
    e = 0.1 + 2.0 * torch.exp(-r2 / 0.01)
    vx = torch.zeros_like(x)
    vy = torch.zeros_like(x)
    return dict(rho=rho.to(dtype), e=e.to(dtype), vx=vx.to(dtype), vy=vy.to(dtype))


def topology_ctx(cfg: LaghosConfig):
    return cfg.decomp.topology()


def profile(
    cfg: LaghosConfig,
    *,
    name: str = "laghos",
    meta: dict | None = None,
    device=None,
) -> CommProfile:
    """Communication profile of ``cfg.n_steps`` steps (trace-only).

    The steps are traced once on meta tensors; the trace is reduced on the
    default backend (torch on the CUDA card), or on
    ``TorchBackend(device=device)`` when ``device`` is given.
    """
    backend = None if device is None else TorchBackend(device=device)
    t = torch.empty((cfg.nx, cfg.ny), dtype=cfg.torch_dtype, device="meta")
    state = {k: t for k in FIELDS}
    with topology_ctx(cfg):
        return profile_traced(
            run_steps(cfg, cfg.decomp.make_mesh()),
            state,
            name=name,
            meta=dict(meta or {}, app="laghos", decomp=cfg.decomp.shape),
            backend=backend,
        )
