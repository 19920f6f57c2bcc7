"""Kripke analog — deterministic Sn transport sweep (KBA wavefront).

Kripke (paper §III-A) decomposes a 3-D spatial grid over ranks; the *sweep*
region propagates angular flux in dependency order across subdomains: each
wavefront stage, ranks on the active diagonal receive upwind faces, solve
their local block, and send downwind faces.  Its communication is highly
localized (3 partners for corner ranks, 6 in the interior — paper §IV-A) and
each communication phase carries one message per (direction-set × group-set)
pair (the paper observes 36).

``fuse_messages`` selects between the paper-faithful message granularity
(False — reproduces the 36-messages finding and lets the profiler quantify
aggregation) and one fused permute per axis (True).

The local solve is the diamond-difference recurrence
``psi_i = (q_i + w * psi_{i-1}) / (sigma_t + w)`` applied along x, then y,
then z (operator-split).  It is a *linear* recurrence, so blocks chain
exactly across ranks through the exchanged faces.  The JAX package solves
it with an associative scan; here it is a loop over the swept axis, which
sums in another order (the tests compare the two within a float32
tolerance).  Under :func:`profile` the loop runs on meta tensors, where
only shapes matter.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import lru_cache

import numpy as np
import torch

from repro_torch.apps.stencil import (
    AXIS_NAMES,
    Decomp3D,
    bwd_perm,
    card_device,
    fwd_perm,
)
from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.backend import TorchBackend
from repro_torch.core.profiler import CommProfile, profile_traced
from repro_torch.core.regions import comm_region, tag_structure

# Sweep order interleaves opposing corners so that even a 2-octant run
# exercises both directions of an axis (paper §IV-A: interior ranks have 6
# communication partners, corner ranks 3).
OCTANT_ORDER = (7, 0, 6, 1, 5, 2, 4, 3)


@dataclass(frozen=True)
class KripkeConfig:
    """Weak-scaling config: zones are per-rank (paper smallest 16x32x32)."""

    decomp: Decomp3D = field(default_factory=lambda: Decomp3D(2, 2, 2))
    nx: int = 16  # per-rank zones
    ny: int = 32
    nz: int = 32
    n_dirsets: int = 6
    n_groupsets: int = 6  # 6 x 6 = 36 messages per phase (paper §IV-A)
    dirs_per_set: int = 4
    groups_per_set: int = 4
    sigma_t: float = 1.0
    w: tuple = (0.4, 0.35, 0.25)  # directional weights (wx, wy, wz)
    n_octants: int = 1  # sweep corners to run (1..8)
    fuse_messages: bool = True  # one fused message per axis phase
    dtype: str = "float32"

    @property
    def zones(self) -> tuple:
        return (self.nx, self.ny, self.nz)

    @property
    def angular(self) -> tuple:
        return (
            self.n_dirsets,
            self.n_groupsets,
            self.dirs_per_set,
            self.groups_per_set,
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _octant_signs(octant: int) -> tuple:
    return (1 if octant & 1 else -1, 1 if octant & 2 else -1, 1 if octant & 4 else -1)


def _axis_recurrence(src, inflow, axis: int, w: float, sig: float, sign: int):
    """psi_i = a * psi_{i-1} + b_i with a = w/(sig+w), b = src/(sig+w);
    descending directions sweep the axis in reverse.  ``inflow`` enters at
    the upwind end."""
    a = w / (sig + w)
    b = src / (sig + w)
    n = src.shape[axis]
    out = [None] * n
    psi = inflow
    for i in range(n) if sign > 0 else range(n - 1, -1, -1):
        psi = a * psi + b.narrow(axis, i, 1)
        out[i] = psi
    return torch.cat(out, dim=axis)


def _out_face(psi, axis: int, sign: int):
    """Downwind face of ``psi`` along ``axis`` (the swept dim kept, size 1)."""
    return psi.narrow(axis, psi.shape[axis] - 1 if sign > 0 else 0, 1)


def _local_sweep(q, in_x, in_y, in_z, cfg: KripkeConfig, signs=(1, 1, 1)):
    """Operator-split diamond-difference solve of one local block.

    q, psi: (nds, ngs, nx, ny, nz, d, g).  in_*: upwind ghost faces with the
    swept dim of size 1.  Returns (psi, out_x, out_y, out_z); out faces are
    the downwind faces for the given sweep direction signs.
    """
    sig = cfg.sigma_t
    sx, sy, sz = signs
    psi = _axis_recurrence(q, in_x, 2, cfg.w[0], sig, sx)
    psi = _axis_recurrence(psi, in_y, 3, cfg.w[1], sig, sy)
    psi = _axis_recurrence(psi, in_z, 4, cfg.w[2], sig, sz)
    return (psi, _out_face(psi, 2, sx), _out_face(psi, 3, sy), _out_face(psi, 4, sz))


@lru_cache(maxsize=None)
def _active_pairs(dc: Decomp3D, stage: int, axis: int, signs):
    """Global-rank (src, dst) pairs logically active at one pass stage,
    as an ``(P, 2)`` int64 array.

    MPI Kripke only posts sends from ranks on the active plane of the
    current axis pass; the profiler records these while the SPMD program
    runs the full (dense) permute.  The active plane is a single coordinate
    slab along ``axis``, so the pair set is the row-major enumeration of
    the other two axes broadcast against the slab/neighbor offsets — no
    Python loop over ranks.

    Memoized: every (dirset x groupset) message of a phase and every
    octant revisiting the stage reuses the cached array (the recording
    path fingerprints it without mutating), so the pair set is built once
    per unique (decomp, stage, axis, signs).

    The result is tagged (``tag_structure``) with the generator key
    ``("kripke-plane", stage, axis, signs[axis])`` under extent
    ``dc.shape`` — the pair set depends on the *axis* sign only, so
    octants sharing a direction along ``axis`` normalize to one struct
    even though lru_cache holds distinct arrays per full sign tuple.
    """
    sizes = dc.shape
    step = 1 if signs[axis] > 0 else -1
    gen = ("kripke-plane", int(stage), int(axis), int(signs[axis]))
    c = stage if signs[axis] > 0 else sizes[axis] - 1 - stage
    nc = c + step
    if not (0 <= c < sizes[axis] and 0 <= nc < sizes[axis]):
        return tag_structure(np.zeros((0, 2), np.int64), gen, sizes)
    strides = (sizes[1] * sizes[2], sizes[2], 1)
    others = [i for i in range(3) if i != axis]
    oa, ob = others
    base = (
        np.arange(sizes[oa], dtype=np.int64)[:, None] * strides[oa]
        + np.arange(sizes[ob], dtype=np.int64)[None, :] * strides[ob]
    ).reshape(-1)
    src = base + c * strides[axis]
    out = np.stack([src, src + step * strides[axis]], axis=1)
    return tag_structure(np.ascontiguousarray(out), gen, sizes)


def _send_downwind(face, axis: int, cfg: KripkeConfig, stage: int, signs):
    """One communication phase along the sweep direction of one axis:
    fused (one message) or per-(ds,gs) messages (paper-faithful 36/phase)."""
    dc = cfg.decomp
    n = dc.shape[axis]
    axis_name = AXIS_NAMES[axis]
    perm = fwd_perm(n) if signs[axis] > 0 else bwd_perm(n)
    rec = _active_pairs(dc, stage, axis, signs)
    if cfg.fuse_messages:
        return coll.ppermute(face, axis_name, perm, record_pairs=rec)
    nds, ngs = cfg.n_dirsets, cfg.n_groupsets
    cols = []
    for ds in range(nds):
        rows = []
        for gs in range(ngs):
            msg = coll.ppermute(
                face[ds : ds + 1, gs : gs + 1], axis_name, perm, record_pairs=rec
            )
            rows.append(msg)
        cols.append(torch.cat(rows, dim=1))
    return torch.cat(cols, dim=0)


def _axis_solve(src, inflow, axis: int, cfg: KripkeConfig, signs):
    """One axis of the operator-split recurrence + its downwind face."""
    sign = signs[axis]
    psi = _axis_recurrence(src, inflow, 2 + axis, cfg.w[axis], cfg.sigma_t, sign)
    return psi, _out_face(psi, 2 + axis, sign)


def sweep_octant(q, cfg: KripkeConfig, octant: int = 7):
    """One sweep of the given octant.  Runs inside ``compat.shard_map``.

    Octant bits select the sweep direction per axis (bit set = ascending);
    octant 7 is the (+,+,+) corner sweep.  The operator-split recurrence is
    swept as three sequential axis passes; within each pass, ranks along the
    axis form a pipeline chained by downwind face exchanges — the per-axis
    wavefront of the KBA schedule.
    """
    dc = cfg.decomp
    signs = _octant_signs(octant)
    psi = q
    for axis in (0, 1, 2):
        n = dc.shape[axis]
        coord = compat.axis_index(AXIS_NAMES[axis])
        t = coord if signs[axis] > 0 else n - 1 - coord
        fshape = list(psi.shape)
        fshape[2 + axis] = 1
        in_face = torch.zeros(fshape, dtype=psi.dtype, device=psi.device)
        new_psi = psi
        for stage in range(n):
            active = t == stage
            with comm_region("solve"):
                cand, out_face = _axis_solve(psi, in_face, axis, cfg, signs)
            new_psi = torch.where(active, cand, new_psi)
            out_face = torch.where(active, out_face, torch.zeros_like(out_face))
            if stage == n - 1:
                break
            with comm_region("sweep_comm"):
                g = _send_downwind(out_face, axis, cfg, stage, signs)
            # a valid face arrives exactly once (senders are masked to zero
            # at all other stages), so accumulation preserves it
            in_face = in_face + g
        psi = new_psi
    return psi


def make_source(cfg: KripkeConfig, *, global_shape: bool = False, device=None):
    """Deterministic smooth source term (per-rank local shape by default).

    Built on the CUDA card unless ``device`` says otherwise (the CPU tests
    pass ``device="cpu"``); raises ``BackendUnavailable`` when the card is
    asked for and there is none.  :func:`reference_sweep` runs on the
    device of the source it is given.
    """
    device = card_device(device, "make_source")
    nds, ngs, d, g = cfg.angular
    if global_shape:
        nx = cfg.nx * cfg.decomp.px
        ny = cfg.ny * cfg.decomp.py
        nz = cfg.nz * cfg.decomp.pz
    else:
        nx, ny, nz = cfg.zones
    shape = (nds, ngs, nx, ny, nz, d, g)
    dtype = cfg.torch_dtype
    q = torch.ones(shape, dtype=dtype, device=device)
    for i, s in enumerate(shape):
        view = [1] * len(shape)
        view[i] = s
        ax = torch.arange(s, dtype=dtype, device=device).reshape(view)
        q = q + torch.sin(0.1 * (i + 1) * ax)
    return q


def distributed_sweep(cfg: KripkeConfig, mesh: compat.Mesh):
    """Global-array sweep over the given mesh (trace-only: meta tensors)."""
    spec = compat.PartitionSpec(None, None, *AXIS_NAMES, None, None)

    def run(q):
        def inner(q):
            with comm_region("main"):
                out = torch.zeros_like(q)
                for o in range(cfg.n_octants):
                    out = out + sweep_octant(q, cfg, OCTANT_ORDER[o])
                return out

        return compat.shard_map(inner, mesh=mesh, in_specs=spec, out_specs=spec)(q)

    return run


def reference_sweep(cfg: KripkeConfig):
    """Single-domain oracle: same recurrence on the undecomposed grid."""
    single = replace(cfg, decomp=Decomp3D(1, 1, 1))

    def run(q):
        shape = tuple(q.shape)
        kw = dict(dtype=q.dtype, device=q.device)
        in_x = torch.zeros((shape[0], shape[1], 1) + shape[3:], **kw)
        in_y = torch.zeros(shape[:3] + (1,) + shape[4:], **kw)
        in_z = torch.zeros(shape[:4] + (1,) + shape[5:], **kw)
        out = torch.zeros_like(q)
        for o in range(cfg.n_octants):
            psi, *_ = _local_sweep(
                q, in_x, in_y, in_z, single, _octant_signs(OCTANT_ORDER[o])
            )
            out = out + psi
        return out

    return run


def profile(
    cfg: KripkeConfig,
    *,
    name: str = "kripke",
    meta: dict | None = None,
    device=None,
) -> CommProfile:
    """Communication profile of one sweep at cfg's scale (trace-only).

    The sweep is traced once on meta tensors; the trace is reduced on the
    default backend (torch on the CUDA card), or on
    ``TorchBackend(device=device)`` when ``device`` is given (the CPU
    tests pass ``device="cpu"``).
    """
    backend = None if device is None else TorchBackend(device=device)
    q = torch.empty(
        (
            cfg.n_dirsets,
            cfg.n_groupsets,
            cfg.nx * cfg.decomp.px,
            cfg.ny * cfg.decomp.py,
            cfg.nz * cfg.decomp.pz,
            cfg.dirs_per_set,
            cfg.groups_per_set,
        ),
        dtype=cfg.torch_dtype,
        device="meta",
    )
    with cfg.decomp.topology():
        return profile_traced(
            distributed_sweep(cfg, cfg.decomp.make_mesh()),
            q,
            name=name,
            meta=dict(meta or {}, app="kripke", decomp=cfg.decomp.shape),
            backend=backend,
        )
