"""Domain decomposition + halo-exchange machinery shared by the apps.

The paper's benchmarks (AMG2023, Kripke, Laghos) are domain-decomposed
codes whose dominant communication pattern is the halo (ghost-cell)
exchange.  A 3-D halo exchange is six point-to-point permutes (±x, ±y,
±z) — exactly the kind of logical group the paper's communication regions
were designed to bracket.

Everything here runs *inside* ``compat.shard_map`` and uses the
instrumented collectives so profiling sees it.  Mesh construction goes
through :mod:`repro_torch.core.compat`, the port's SPMD shim.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.topology import topology

AXIS_NAMES = ("x", "y", "z")


@dataclass(frozen=True)
class Decomp3D:
    """A px × py × pz process decomposition."""

    px: int
    py: int
    pz: int

    @property
    def shape(self) -> tuple:
        return (self.px, self.py, self.pz)

    @property
    def n_ranks(self) -> int:
        return self.px * self.py * self.pz

    def axes(self) -> tuple:
        return tuple(zip(AXIS_NAMES, self.shape))

    def topology(self):
        return topology(*self.axes())

    def make_mesh(self) -> compat.Mesh:
        """Named-axis mesh of the decomposition (trace-only, no devices)."""
        return compat.make_mesh(self.shape, AXIS_NAMES)


def fwd_perm(n: int, periodic: bool = False) -> list:
    """(i -> i+1) pairs; edge pair dropped unless periodic (Dirichlet ghost)."""
    pairs = [(i, i + 1) for i in range(n - 1)]
    if periodic and n > 1:
        pairs.append((n - 1, 0))
    return pairs


def bwd_perm(n: int, periodic: bool = False) -> list:
    pairs = [(i + 1, i) for i in range(n - 1)]
    if periodic and n > 1:
        pairs.append((0, n - 1))
    return pairs


def _face(u: torch.Tensor, dim: int, side: str, width: int) -> torch.Tensor:
    n = u.shape[dim]
    return u.narrow(dim, 0 if side == "lo" else n - width, width)


def halo_exchange(
    u: torch.Tensor,
    decomp: Decomp3D,
    *,
    width: int = 1,
    dims: tuple = (0, 1, 2),
    periodic: bool = False,
) -> dict:
    """Exchange ghost faces along each decomposed dimension.

    Returns {dim: (ghost_lo, ghost_hi)}: ``ghost_lo`` is the neighbor's high
    face arriving at our low side, and vice versa.  Edge ranks receive
    zeros (homogeneous Dirichlet ghosts) in the non-periodic case.

    Call inside ``compat.shard_map``, inside a ``comm_region``.
    """
    sizes = decomp.shape
    out = {}
    for dim in dims:
        n = sizes[dim]
        axis = AXIS_NAMES[dim]
        hi_face = _face(u, dim, "hi", width)  # travels to the right (+)
        lo_face = _face(u, dim, "lo", width)  # travels to the left  (-)
        ghost_lo = coll.ppermute(hi_face, axis, fwd_perm(n, periodic))
        ghost_hi = coll.ppermute(lo_face, axis, bwd_perm(n, periodic))
        out[dim] = (ghost_lo, ghost_hi)
    return out


def laplacian_7pt(u_padded: torch.Tensor, h2: float = 1.0) -> torch.Tensor:
    """7-point Laplacian of interior (expects width-1 padding on dims 0-2)."""
    c = u_padded[1:-1, 1:-1, 1:-1]
    return (
        u_padded[:-2, 1:-1, 1:-1]
        + u_padded[2:, 1:-1, 1:-1]
        + u_padded[1:-1, :-2, 1:-1]
        + u_padded[1:-1, 2:, 1:-1]
        + u_padded[1:-1, 1:-1, :-2]
        + u_padded[1:-1, 1:-1, 2:]
        - 6.0 * c
    ) / h2
