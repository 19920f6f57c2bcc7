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
import torch.nn.functional as F

from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.backend import BackendUnavailable
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
        """Named-axis mesh of the decomposition (no devices attached: a real
        run takes its ranks from the process group)."""
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


def pad_with_halo(
    u: torch.Tensor, ghosts: dict, *, width: int = 1, dims: tuple = (0, 1, 2)
) -> torch.Tensor:
    """Concatenate exchanged ghosts onto u → a tensor padded by ``width`` on
    the exchanged dims (ghosts of ghost corners are zero; adequate for
    7-point stencils, which never read corners)."""
    for dim in dims:
        lo, hi = ghosts[dim]

        # lo/hi were sliced from the *unpadded* tensor; pad their other dims
        # to match the progressively padded u (F.pad lists the last dim first)
        def fit(g):
            pads = []
            for d in reversed(range(u.dim())):
                diff = 0 if d == dim else u.shape[d] - g.shape[d]
                pads += [diff // 2, diff - diff // 2]
            return F.pad(g, pads)

        u = torch.cat([fit(lo), u, fit(hi)], dim=dim)
    return u


def zero_pad(u: torch.Tensor, width: int = 1) -> torch.Tensor:
    """``u`` padded by ``width`` zeros on every dim: the single-domain
    oracles' homogeneous Dirichlet ghosts."""
    return F.pad(u, [width] * (2 * u.dim()))


def card_device(device, what: str) -> torch.device:
    """``device``, or the CUDA card when it is None.

    Raises ``BackendUnavailable`` when the card is asked for and there is
    none: the apps' states and oracles never fall back to the host in
    silence (the CPU tests pass ``device="cpu"``).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise BackendUnavailable(
            f"{what} runs on a CUDA device and none is available; "
            "pass device='cpu' to run it on the host"
        )
    return device


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
