"""Beatnik analog — Z-model interface dynamics with global far-field coupling.

Beatnik (Stewart & Bridges, PAPERS.md) benchmarks Rayleigh–Taylor interface
dynamics whose *cutoff/far-field* force evaluation couples every rank to
every other rank — the adversarial opposite of kripke/amg/laghos's localized
halo traffic, and the worst case for a structure-interning trace store: its
communication structure *mutates per step* (particle migration shifts data
an increasing rank distance each step), so almost nothing dedups.

This analog keeps that communication signature on a 2-D interface grid:

  halo_exchange      ghost exchange of the interface height (local BR term)
  vorticity_compute  pure-compute vortex-sheet strength update
  far_field          all-gather of a subsampled interface over *all* ranks
                     (the global far-field force — every rank couples)
  migrate            whole-shard ppermute whose shift distance/axis changes
                     every step (structure mutates; interning cannot help)
  reduce_norm        global interface-energy psum (convergence diagnostic)
  main               whole step loop

Weak-scaling config: ``nx``/``ny`` are *per-rank* interface points (the
global grid grows with the decomposition).  :func:`reference_steps` runs the
same step on the undecomposed global grid: Dirichlet-zero ghosts at the
physical boundary, the far-field subsample union equal to the global
``[::k, ::k]`` stride (``k`` divides the local extents, asserted in the
config), and shard migration as a global ``torch.roll`` by whole local
tiles.
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


@dataclass(frozen=True)
class BeatnikConfig:
    """Weak-scaling config: nx/ny are per-rank interface points."""

    decomp: Decomp3D = field(default_factory=lambda: Decomp3D(2, 2, 1))
    nx: int = 32  # per-rank interface points (weak scaling)
    ny: int = 32
    atwood: float = 0.5  # Atwood number (density contrast)
    dt: float = 0.05
    far_subsample: int = 8  # far-field samples every k-th point per axis
    n_steps: int = 4
    dtype: str = "float32"

    @property
    def global_shape(self) -> tuple:
        return (self.nx * self.decomp.px, self.ny * self.decomp.py)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def __post_init__(self):
        assert self.decomp.pz == 1, "beatnik interface is 2-D"
        k = self.far_subsample
        # subsample-union == global stride requires k | local extents
        assert self.nx % k == 0 and self.ny % k == 0


def _migration(cfg: BeatnikConfig, step: int) -> tuple:
    """(axis index, rank shift) of the step's migration permute.

    The axis alternates per step and the shift distance cycles through
    ``1..n-1``, so consecutive steps (and revisits of the same axis) issue
    *different* permutations — each is a fresh structure in the trace.
    """
    axis = step % 2
    n = cfg.decomp.shape[axis]
    s = 1 + step % (n - 1) if n > 1 else 0
    return axis, s


def _surface_laplacian(zp, z):
    return zp[2:, 1:-1] + zp[:-2, 1:-1] + zp[1:-1, 2:] + zp[1:-1, :-2] - 4.0 * z


def zmodel_step(z, w, cfg: BeatnikConfig, step: int):
    """One Z-model-flavored step.  Runs inside ``compat.shard_map``."""
    # --- local Birkhoff-Rott term: halo exchange + surface Laplacian ---
    with comm_region("halo_exchange"):
        ghosts = halo_exchange(z, cfg.decomp, dims=(0, 1))
        zp = pad_with_halo(z, ghosts, dims=(0, 1))
    with comm_region("vorticity_compute"):
        w = w + cfg.dt * cfg.atwood * _surface_laplacian(zp, z)

    # --- far-field force: every rank gathers every rank's subsample ---
    with comm_region("far_field"):
        k = cfg.far_subsample
        far_pts = coll.all_gather(z[::k, ::k], AXES_2D)
        far = far_pts.mean()
    z = z + cfg.dt * (w + cfg.atwood * (far - z))

    # --- interface migration: whole-shard shift, new structure per step ---
    axis, s = _migration(cfg, step)
    if s:
        n = cfg.decomp.shape[axis]
        perm = [(i, (i + s) % n) for i in range(n)]
        with comm_region("migrate"):
            z = coll.ppermute(z, AXES_2D[axis], perm)
            w = coll.ppermute(w, AXES_2D[axis], perm)

    # --- global diagnostic ---
    with comm_region("reduce_norm"):
        nrm = coll.psum((z * z).sum(), AXES_2D)
    return z, w, nrm


def run_steps(cfg: BeatnikConfig, mesh: compat.Mesh):
    """The steps over global arrays (shards dims 0, 1; trace-only: meta)."""
    spec = compat.PartitionSpec("x", "y")

    def run(state):
        def inner(state):
            z, w = state
            with comm_region("main"):
                nrms = []
                for step in range(cfg.n_steps):
                    z, w, nrm = zmodel_step(z, w, cfg, step)
                    nrms.append(nrm)
                return (z, w), torch.stack(nrms)

        return compat.shard_map(
            inner,
            mesh=mesh,
            in_specs=((spec, spec),),
            out_specs=((spec, spec), compat.PartitionSpec()),
        )(state)

    return run


def reference_steps(cfg: BeatnikConfig):
    """Single-domain oracle of the same decomposed algorithm.

    Mirrors the distributed step on the undecomposed global grid:
    Dirichlet-zero ghosts at the physical boundary (matching
    ``pad_with_halo``), the identical far-field subsample stride, and shard
    migration as a global roll by whole local tiles.  Runs on the device of
    the state it is given.
    """
    tiles = (cfg.nx, cfg.ny)
    k = cfg.far_subsample

    def run(state):
        z, w = state
        nrms = []
        for step in range(cfg.n_steps):
            w = w + cfg.dt * cfg.atwood * _surface_laplacian(zero_pad(z), z)
            far = z[::k, ::k].mean()
            z = z + cfg.dt * (w + cfg.atwood * (far - z))
            axis, s = _migration(cfg, step)
            if s:
                z = torch.roll(z, s * tiles[axis], dims=axis)
                w = torch.roll(w, s * tiles[axis], dims=axis)
            nrms.append((z * z).sum())
        return (z, w), torch.stack(nrms)

    return run


def make_state(cfg: BeatnikConfig, *, device=None) -> tuple:
    """Deterministic single-mode initial interface (global arrays).

    Built on the CUDA card unless ``device`` says otherwise; raises
    ``BackendUnavailable`` when the card is asked for and there is none.
    """
    device = card_device(device, "make_state")
    gx, gy = cfg.global_shape
    x, y = torch.meshgrid(
        torch.linspace(0.0, 1.0, gx, dtype=torch.float32, device=device),
        torch.linspace(0.0, 1.0, gy, dtype=torch.float32, device=device),
        indexing="ij",
    )
    z = 0.1 * torch.sin(2.0 * torch.pi * x) * torch.cos(2.0 * torch.pi * y)
    w = torch.zeros_like(z)
    return (z.to(cfg.torch_dtype), w.to(cfg.torch_dtype))


def profile(
    cfg: BeatnikConfig,
    *,
    name: str = "beatnik",
    meta: dict | None = None,
    device=None,
) -> CommProfile:
    """Communication profile of ``cfg.n_steps`` steps (trace-only).

    The steps are traced once on meta tensors; the trace is reduced on the
    default backend (torch on the CUDA card), or on
    ``TorchBackend(device=device)`` when ``device`` is given.
    """
    backend = None if device is None else TorchBackend(device=device)
    t = torch.empty(cfg.global_shape, dtype=cfg.torch_dtype, device="meta")
    with cfg.decomp.topology():
        return profile_traced(
            run_steps(cfg, cfg.decomp.make_mesh()),
            (t, t),
            name=name,
            meta=dict(meta or {}, app="beatnik", decomp=cfg.decomp.shape),
            backend=backend,
        )
