"""AMG2023 analog — multigrid solver with per-level communication regions.

AMG2023 (paper §III-A) is an algebraic multigrid solver on top of hypre; its
communication is a hierarchy of halo exchanges whose character changes with
the multigrid level: fine levels move the most data between few neighbors,
coarse levels involve many ranks with little data (paper Figs. 2-3 — over
100 source ranks at MG level 6+ on 512 processes).

This is the geometric analog: a 3-D 7-point Poisson V-cycle over the same
block decomposition the paper uses.  Distributed levels coarsen by 2 while
the global grid stays ≥ ``min_global``; below that the problem is gathered
to every rank (``coarse_solve`` region — the all-ranks participation the
paper observes at coarse levels) and solved redundantly.

Regions:
  mg_level_<k>   smoother halo exchanges on level k (Figs. 2-3)
  MatVecComm     residual matvec halo (hypre's MatVecComm analog, paper §III-B)
  coarse_solve   gather of the coarse problem
  reduce_norm    residual-norm reduction

Weak scaling mirrors the paper: per-rank fine block fixed (default 32x32x16),
global problem grows with ranks — more ranks ⇒ a deeper distributed
hierarchy, matching "runs on Dane had more levels".

The per-rank V-cycle takes its communication from a :class:`_Comm`: the
instrumented collectives under :func:`solve` (traced on meta tensors by
:func:`profile`), or zero Dirichlet ghosts, one rank and no collective in
the single-domain oracle :func:`reference_solve`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from repro_torch.apps.stencil import (
    AXIS_NAMES,
    Decomp3D,
    card_device,
    halo_exchange,
    laplacian_7pt,
    pad_with_halo,
    zero_pad,
)
from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.backend import TorchBackend
from repro_torch.core.profiler import CommProfile, profile_traced
from repro_torch.core.regions import comm_region


@dataclass(frozen=True)
class AMGConfig:
    decomp: Decomp3D = field(default_factory=lambda: Decomp3D(2, 2, 2))
    nx: int = 32  # per-rank fine-grid block (paper: 32x32x16)
    ny: int = 32
    nz: int = 16
    n_pre: int = 2  # pre-smoothing sweeps
    n_post: int = 2  # post-smoothing sweeps
    n_coarse_iters: int = 8
    omega: float = 0.8  # weighted-Jacobi damping
    min_global: int = 8  # gather when a *global* dim would drop below this
    n_cycles: int = 1
    dtype: str = "float32"

    @property
    def local_shape(self) -> tuple:
        return (self.nx, self.ny, self.nz)

    @property
    def global_shape(self) -> tuple:
        return (
            self.nx * self.decomp.px,
            self.ny * self.decomp.py,
            self.nz * self.decomp.pz,
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_dist_levels(self) -> int:
        """Distributed levels before the gathered coarse solve.

        Level count depends on the *global* grid so the distributed solver
        and the single-domain reference run identical hierarchies — and more
        ranks (weak scaling) means more levels, as the paper observes."""
        n, lvl = min(self.global_shape), 0
        while n // 2 >= self.min_global:
            n //= 2
            lvl += 1
        return lvl


class _Comm:
    """The V-cycle's communication over the decomposition (instrumented)."""

    def __init__(self, cfg: AMGConfig):
        self.cfg = cfg

    def padded(self, u, region: str):
        """``u`` with its neighbors' faces as width-1 ghosts."""
        with comm_region(region):
            ghosts = halo_exchange(u, self.cfg.decomp)
        return pad_with_halo(u, ghosts)

    def gather(self, x):
        """all_gather a per-rank block into the replicated global array."""
        dc = self.cfg.decomp
        g = coll.all_gather(x, AXIS_NAMES, axis=0)  # (n_ranks, lx, ly, lz)
        lx, ly, lz = x.shape
        g = g.reshape(dc.px, dc.py, dc.pz, lx, ly, lz)
        g = g.permute(0, 3, 1, 4, 2, 5)
        return g.reshape(dc.px * lx, dc.py * ly, dc.pz * lz)

    def my_block(self, g, local_shape):
        """This rank's block of the global array.

        The offsets come from ``compat.axis_index`` as device tensors, never
        read on the host: under tracing they are meta scalars, and only the
        block's local shape matters.
        """
        for dim, (name, size) in enumerate(zip(AXIS_NAMES, local_shape)):
            start = compat.axis_index(name) * size
            idx = start + torch.arange(size, dtype=torch.int64, device=g.device)
            g = torch.index_select(g, dim, idx)
        return g

    def psum(self, x):
        return coll.psum(x, AXIS_NAMES)


class _OneDomain(_Comm):
    """The single-domain oracle's: zero ghosts, one rank, no collective."""

    def padded(self, u, region: str):
        return zero_pad(u)

    def gather(self, x):
        return x

    def my_block(self, g, local_shape):
        return g

    def psum(self, x):
        return x


def _jacobi(u, f, cfg: AMGConfig, comm: _Comm, region: str):
    """One weighted-Jacobi sweep: u += ω/6 (f - A u), A = -Δ (7-point)."""
    au = -laplacian_7pt(comm.padded(u, region))  # A = -Δ, h = 1 at every level
    return u + (cfg.omega / 6.0) * (f - au)


def _residual(u, f, comm: _Comm):
    return f + laplacian_7pt(comm.padded(u, "MatVecComm"))


def _restrict(r):
    """Full-weighting 2x coarsening (local: blocks stay rank-aligned)."""
    s = r.shape
    r = r.reshape(s[0] // 2, 2, s[1] // 2, 2, s[2] // 2, 2)
    return r.mean(dim=(1, 3, 5))


def _prolong(e):
    """Piecewise-constant 2x refinement (local)."""
    return e.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)


def _coarse_solve(f, cfg: AMGConfig, comm: _Comm):
    """Gather the coarse problem to every rank; solve redundantly.

    This is the all-ranks-involved pattern the paper measures at coarse MG
    levels (src ranks ≈ everyone, little data).
    """
    with comm_region("coarse_solve"):
        fg = comm.gather(f)
    u = torch.zeros_like(fg)
    for _ in range(cfg.n_coarse_iters):
        au = -laplacian_7pt(zero_pad(u))
        u = u + (cfg.omega / 6.0) * (fg - au)
    return comm.my_block(u, tuple(f.shape))


def v_cycle(u, f, cfg: AMGConfig, level: int = 0, comm: _Comm | None = None):
    comm = _Comm(cfg) if comm is None else comm
    region = f"mg_level_{level}"
    global_min = min(s * p for s, p in zip(u.shape, cfg.decomp.shape))
    if global_min // 2 < cfg.min_global:
        return _coarse_level(u, f, cfg, comm)
    for _ in range(cfg.n_pre):
        u = _jacobi(u, f, cfg, comm, region)
    r = _residual(u, f, comm)
    f_c = _restrict(r)
    e_c = v_cycle(torch.zeros_like(f_c), f_c, cfg, level + 1, comm)
    u = u + _prolong(e_c)
    for _ in range(cfg.n_post):
        u = _jacobi(u, f, cfg, comm, region)
    return u


def _coarse_level(u, f, cfg: AMGConfig, comm: _Comm):
    r = _residual(u, f, comm)
    return u + _coarse_solve(r, cfg, comm)


def _cycles(f, cfg: AMGConfig, comm: _Comm) -> tuple:
    with comm_region("main"):
        u = torch.zeros_like(f)
        for _ in range(cfg.n_cycles):
            u = v_cycle(u, f, cfg, 0, comm)
        r = _residual(u, f, comm)
        with comm_region("reduce_norm"):
            rn = torch.sqrt(comm.psum((r * r).sum()))
        return u, rn


def solve(cfg: AMGConfig, mesh: compat.Mesh):
    """``n_cycles`` V-cycles + residual norm over global arrays (trace-only:
    meta tensors)."""
    spec = compat.PartitionSpec(*AXIS_NAMES)

    def run(f):
        def inner(f):
            return _cycles(f, cfg, _Comm(cfg))

        return compat.shard_map(
            inner, mesh=mesh, in_specs=spec, out_specs=(spec, compat.PartitionSpec())
        )(f)

    return run


def reference_solve(cfg: AMGConfig):
    """Single-domain oracle: the same V-cycles on the global grid, with zero
    Dirichlet ghosts, one rank and no collective.  Returns ``(run, single)``
    as the JAX package does; ``run(f)`` runs on ``f``'s device."""
    single = replace(
        cfg,
        decomp=Decomp3D(1, 1, 1),
        nx=cfg.nx * cfg.decomp.px,
        ny=cfg.ny * cfg.decomp.py,
        nz=cfg.nz * cfg.decomp.pz,
    )

    def run(f):
        return _cycles(f, single, _OneDomain(single))

    return run, single


def make_rhs(cfg: AMGConfig, *, device=None) -> torch.Tensor:
    """Deterministic smooth RHS on the global grid.

    Built on the CUDA card unless ``device`` says otherwise; raises
    ``BackendUnavailable`` when the card is asked for and there is none.
    """
    device = card_device(device, "make_rhs")
    nx, ny, nz = cfg.global_shape
    x, y, z = torch.meshgrid(
        torch.arange(nx, dtype=torch.float32, device=device),
        torch.arange(ny, dtype=torch.float32, device=device),
        torch.arange(nz, dtype=torch.float32, device=device),
        indexing="ij",
    )
    f = (
        torch.sin(2 * torch.pi * x / nx)
        * torch.sin(2 * torch.pi * y / ny)
        * torch.sin(2 * torch.pi * z / nz)
    )
    return f.to(cfg.torch_dtype)


def profile(
    cfg: AMGConfig,
    *,
    name: str = "amg",
    meta: dict | None = None,
    device=None,
) -> CommProfile:
    """Communication profile of ``cfg.n_cycles`` V-cycles (trace-only).

    The solve is traced once on meta tensors; the trace is reduced on the
    default backend (torch on the CUDA card), or on
    ``TorchBackend(device=device)`` when ``device`` is given.
    """
    backend = None if device is None else TorchBackend(device=device)
    f = torch.empty(cfg.global_shape, dtype=cfg.torch_dtype, device="meta")
    with cfg.decomp.topology():
        return profile_traced(
            solve(cfg, cfg.decomp.make_mesh()),
            f,
            name=name,
            meta=dict(meta or {}, app="amg", decomp=cfg.decomp.shape),
            backend=backend,
        )
