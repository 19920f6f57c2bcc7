"""Modeled network layer — unique communication structures on fabric models.

The traced layer records *logical* traffic (who sends what to whom per
region) and the HLO layer records *compiled* traffic; this module adds the
layer below both: map each unique structure in a
:class:`~repro_torch.core.regions.StructTable` onto a parameterized fabric model
(ring / fat-tree / dragonfly latency-bandwidth with link contention from
overlapping peer pairs) and reduce the per-struct costs to per-region rows
— modeled wire time, hop counts, and per-link congestion (the multi-layer
view of ucTrace / the OSU cross-layer visualizations; see PAPERS.md).

Cost evaluation is **O(unique structs), never O(events)**: the per-pair hop
and link assignments run once over the struct table's
``reduction_view()`` CSR peer pairs (collective structs synthesize a ring
over their members), and per-region aggregation reuses the profiler idiom —
``(G, S)`` multiplicity-weighted weight matrices against per-struct cost
vectors / the ``(S, L)`` link grid, contracted through the exact int64
:meth:`~repro_torch.core.backend.ReduceBackend.matmul` (on the torch backend,
f64-limb ``torch.matmul`` on the card), so numpy and torch backends stay
bit-identical (the float wire-time/congestion columns derive from the
identical int64 aggregates with identical host arithmetic).  The per-struct
costs and the weight scatters are host NumPy on every backend.  Structures
interned by ``(generator, extent)`` fingerprint (tagged topology /
kripke-plane producer arrays — see :func:`~repro_torch.core.regions.tag_structure`)
are surfaced per region through :func:`struct_fingerprints`, so 100k-rank
traces annotate their modeled rows without touching payload bytes.

The rows land in :class:`~repro_torch.core.thicket.Frame` as ``layer="network"``
beside ``traced`` / ``hlo`` (``Frame.from_network``), join per region in
``reports.network_vs_traced``, and feed the paper's halo-exchange peer-pair
heatmaps (:func:`peer_heatmap`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from repro_torch.core.backend import ReduceBackend, resolve_backend

#: Default per-link bandwidth of the *modeled* fabric (50 GB/s).  It is a
#: parameter of the model, not a property of any card or of NVLink; it
#: equals the JAX package's default so the two packages' modeled rows
#: compare byte for byte.
DEFAULT_LINK_BW = 50e9
DEFAULT_LATENCY_S = 1e-6


@dataclass(frozen=True)
class FabricModel:
    """A parameterized latency-bandwidth fabric.

    ``hops`` / ``link_ids`` are vectorized over directed ``(src, dst)``
    rank-pair arrays and return exact int64 — every modeled quantity built
    from them stays integral until the final wire-time division, which is
    what keeps numpy/torch reductions bit-identical.

    Link model (one bottleneck link per message, so contention is literally
    "overlapping peer pairs on the same link"):

    ring       2n directed neighbor links; a message occupies its source's
               egress link in the shorter travel direction and pays one hop
               per ring step.
    fat-tree   ``radix`` ranks per leaf switch; intra-leaf messages occupy
               the source's injection link (2 hops), inter-leaf messages the
               leaf's shared uplink (4 hops: host-leaf-spine-leaf-host).
    dragonfly  ``group_size`` ranks per group; intra-group messages take the
               source's local link (1 hop), inter-group messages the group's
               shared global link (3 hops: local-global-local, minimal
               routing).
    """

    name: str
    latency_s: float = DEFAULT_LATENCY_S
    bandwidth_Bps: float = DEFAULT_LINK_BW
    radix: int = 16  # fat-tree: ranks per leaf switch
    group_size: int = 16  # dragonfly: ranks per group

    def hops(self, src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if self.name == "ring":
            d = (dst - src) % max(n, 1)
            return np.minimum(d, n - d)
        if self.name == "fat-tree":
            same_leaf = (src // self.radix) == (dst // self.radix)
            return np.where(src == dst, 0, np.where(same_leaf, 2, 4)).astype(np.int64)
        if self.name == "dragonfly":
            same_grp = (src // self.group_size) == (dst // self.group_size)
            return np.where(src == dst, 0, np.where(same_grp, 1, 3)).astype(np.int64)
        raise ValueError(f"unknown fabric: {self.name!r}")

    def link_ids(self, src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if self.name == "ring":
            d = (dst - src) % max(n, 1)
            return 2 * src + (2 * d > n)
        if self.name == "fat-tree":
            same_leaf = (src // self.radix) == (dst // self.radix)
            return np.where(same_leaf, src, n + src // self.radix)
        if self.name == "dragonfly":
            same_grp = (src // self.group_size) == (dst // self.group_size)
            return np.where(same_grp, src, n + src // self.group_size)
        raise ValueError(f"unknown fabric: {self.name!r}")

    def n_links(self, n: int) -> int:
        if self.name == "ring":
            return 2 * n
        if self.name == "fat-tree":
            return n + -(-n // self.radix)
        if self.name == "dragonfly":
            return n + -(-n // self.group_size)
        raise ValueError(f"unknown fabric: {self.name!r}")


RING = FabricModel("ring")
FAT_TREE = FabricModel("fat-tree")
DRAGONFLY = FabricModel("dragonfly")

#: Name -> default-parameterized fabric (``FabricModel`` instances are
#: frozen dataclasses — ``dataclasses.replace`` customizes parameters).
FABRICS = {f.name: f for f in (RING, FAT_TREE, DRAGONFLY)}


def resolve_fabric(fabric: Union[FabricModel, str, None]) -> FabricModel:
    if fabric is None:
        return RING
    if isinstance(fabric, FabricModel):
        return fabric
    try:
        return FABRICS[fabric]
    except KeyError:
        raise ValueError(
            f"unknown fabric {fabric!r}; expected one of {sorted(FABRICS)}"
        ) from None


def struct_fingerprints(tab) -> dict:
    """``{struct_id: (generator, extent)}`` for fingerprint-tagged structs.

    Inverts the table's ``(kind, n, (generator, extent))`` fingerprint keys
    (see :func:`~repro_torch.core.regions.tag_structure`), so consumers — the
    per-region ``net_generators`` annotation, heatmap labeling — read a
    struct's producing generator (kripke-plane stencils, topology axis
    perms/groups) directly, without touching payload bytes.
    """
    out: dict = {}
    for key, sid in getattr(tab, "_fp", {}).items():
        if len(key) == 3 and isinstance(key[2], tuple):
            out[int(sid)] = key[2]
    return out


def _struct_pairs(view, include_collectives: bool = True) -> tuple:
    """Directed ``(struct_id, src, dst)`` pair columns for every struct.

    Point-to-point / raw structs contribute their CSR dest peer pairs
    verbatim (vectorized, no per-pair work).  Collective structs carry no
    pairs, so each synthesizes a ring over its member ranks — the standard
    ring-algorithm wire pattern for all-gather/all-reduce — from the
    ``participants`` slab (an O(members) loop per *unique* collective
    struct, never per event).
    """
    lens = view.dest_lens
    S = len(lens)
    sid = np.repeat(np.arange(S, dtype=np.int64), lens)
    src = view.dest_rows
    dst = view.dest_peers
    if not include_collectives:
        return sid, src, dst
    rip = view.rank_indptr()
    extra_sid, extra_src = [], []
    for s in np.flatnonzero(lens == 0):
        members = np.flatnonzero(view.participants[rip[s] : rip[s + 1]])
        if len(members) >= 2:
            extra_sid.append(np.full(len(members), s, np.int64))
            extra_src.append(members.astype(np.int64))
    if extra_sid:
        ring_src = np.concatenate(extra_src)
        ring_dst = np.concatenate([np.roll(m, -1) for m in extra_src])
        sid = np.concatenate([sid, np.concatenate(extra_sid)])
        src = np.concatenate([src, ring_src])
        dst = np.concatenate([dst, ring_dst])
    return sid, src, dst


@dataclass(frozen=True)
class StructCosts:
    """Per-unique-struct fabric costs (all exact int64; shapes O(S x L))."""

    fabric: FabricModel
    n_ranks: int
    n_links: int
    pair_count: np.ndarray  # (S,) directed messages per struct instance
    hops_total: np.ndarray  # (S,) sum of per-message hop counts
    hops_max: np.ndarray  # (S,) deepest single message
    link_grid: np.ndarray  # (S, L) messages per link per struct instance


def struct_costs(
    view_or_table, fabric: Union[FabricModel, str, None] = None
) -> StructCosts:
    """Evaluate ``fabric`` over every unique struct of a table/view.

    One vectorized pass over the ``reduction_view()`` CSR peer pairs —
    O(total unique pairs), independent of event count or multiplicity.
    """
    fabric = resolve_fabric(fabric)
    view = (
        view_or_table.reduction_view()
        if hasattr(view_or_table, "reduction_view")
        else view_or_table
    )
    lens = view.rank_lens
    S = len(lens)
    n = int(lens.max()) if S else 0
    L = fabric.n_links(n) if n else 0
    pair_count = np.zeros(S, np.int64)
    hops_total = np.zeros(S, np.int64)
    hops_max = np.zeros(S, np.int64)
    link_grid = np.zeros((S, L), np.int64)
    sid, src, dst = _struct_pairs(view)
    if len(sid):
        h = fabric.hops(src, dst, n)
        lk = fabric.link_ids(src, dst, n)
        np.add.at(pair_count, sid, 1)
        np.add.at(hops_total, sid, h)
        np.maximum.at(hops_max, sid, h)
        np.add.at(link_grid, (sid, lk), 1)
    return StructCosts(
        fabric=fabric,
        n_ranks=n,
        n_links=L,
        pair_count=pair_count,
        hops_total=hops_total,
        hops_max=hops_max,
        link_grid=link_grid,
    )


class NetworkModeledProfiler:
    """Modeled-fabric sibling of the traced/HLO profilers.

    Reduces a recorder's :class:`~repro_torch.core.regions.TraceBuffer` against a
    :class:`FabricModel` into per-region ``layer="network"`` row dicts,
    keyed like ``Frame.from_profiles`` rows (``profile`` / ``n_ranks`` /
    ``region``) so frames and reports join all three layers per region.

    Shapes are bounded by (regions x unique structs x links): rows collapse
    into ``(G, S)`` multiplicity/byte weight matrices (``np.add.at`` over
    the scalar row columns), per-struct costs come from one
    :func:`struct_costs` pass, and every contraction is an exact int64
    ``ReduceBackend.matmul`` — no per-event array is ever materialized, and
    numpy/torch produce bit-identical rows.  The default backend is torch
    on the CUDA card, which raises ``BackendUnavailable`` without one.
    """

    @staticmethod
    def region_rows(
        rec,
        *,
        fabric: Union[FabricModel, str, None] = None,
        name: str = "network",
        n_ranks: int = 0,
        meta: Optional[dict] = None,
        backend: Union[ReduceBackend, str, None] = None,
    ) -> list:
        """One row dict per region, in first-appearance order."""
        be = resolve_backend(backend)
        fabric = resolve_fabric(fabric)
        buf = getattr(rec, "buffer", rec)
        R = buf.n_rows
        rids = buf.region_ids
        if R:
            uniq, first = np.unique(rids, return_index=True)
            ordered = uniq[np.argsort(first, kind="stable")]
        else:
            ordered = np.zeros(0, np.int64)
        G = len(ordered)
        gid_of_rid = np.zeros(max(len(buf.region_names), 1), np.int64)
        gid_of_rid[ordered] = np.arange(G)
        g_of_row = gid_of_rid[rids]

        tab = buf.structs
        S = tab.n_structs
        costs = struct_costs(tab, fabric)
        gens = struct_fingerprints(tab)

        sid = buf.struct_ids
        mult = buf.multiplicity
        scale = buf.nbytes
        wc = np.zeros((G, S), np.int64)
        wb = np.zeros((G, S), np.int64)
        if R and S:
            np.add.at(wc, (g_of_row, sid), mult)
            np.add.at(wb, (g_of_row, sid), mult * scale)

        L = costs.n_links
        if G and S and L:
            lg_msgs = be.matmul(wc, costs.link_grid)  # (G, L) messages/link
            lg_bytes = be.matmul(wb, costs.link_grid)  # (G, L) bytes/link
            msgs = be.matmul(wc, costs.pair_count[:, None])[:, 0]
            wire_bytes = be.matmul(wb, costs.pair_count[:, None])[:, 0]
            hops_total = be.matmul(wc, costs.hops_total[:, None])[:, 0]
            lat_units = be.matmul(wc, costs.hops_max[:, None])[:, 0]
        else:
            lg_msgs = lg_bytes = np.zeros((G, max(L, 1)), np.int64)
            msgs = wire_bytes = hops_total = lat_units = np.zeros(G, np.int64)
        link_msgs_max = lg_msgs.max(axis=1) if L else np.zeros(G, np.int64)
        link_bytes_max = lg_bytes.max(axis=1) if L else np.zeros(G, np.int64)
        links_used = (lg_msgs > 0).sum(axis=1).astype(np.int64)
        hops_max = (
            np.max(np.where(wc > 0, costs.hops_max[None, :], 0), axis=1)
            if G and S
            else np.zeros(G, np.int64)
        )
        structs_per_g = (wc > 0).sum(axis=1).astype(np.int64)

        rows = []
        for g, rid in enumerate(ordered):
            tagged = sorted(
                {
                    str(gens[int(s)][0][0])
                    for s in np.flatnonzero(wc[g])
                    if int(s) in gens and isinstance(gens[int(s)][0], tuple)
                }
            )
            m, used = int(msgs[g]), int(links_used[g])
            # hottest-link share over a balanced spread (1.0 = no overlap
            # hotspot); exact-int ratio -> identical floats on all backends
            congestion = int(link_msgs_max[g]) * used / m if m and used else 0.0
            wire_s = (
                fabric.latency_s * int(lat_units[g])
                + int(link_bytes_max[g]) / fabric.bandwidth_Bps
            )
            row = {
                "profile": name,
                "n_ranks": n_ranks or costs.n_ranks,
                "region": buf.region_names[int(rid)],
                "layer": "network",
                "net_fabric": fabric.name,
                "net_structs": int(structs_per_g[g]),
                "net_msgs": m,
                "net_wire_bytes": int(wire_bytes[g]),
                "net_hops_total": int(hops_total[g]),
                "net_hops_max": int(hops_max[g]),
                "net_links_used": used,
                "net_link_msgs_max": int(link_msgs_max[g]),
                "net_link_bytes_max": int(link_bytes_max[g]),
                "net_congestion": congestion,
                "net_wire_s": wire_s,
                "net_generators": ";".join(tagged),
            }
            row.update({f"meta_{k}": v for k, v in (meta or {}).items()})
            rows.append(row)
        return rows


def peer_heatmap(
    rec,
    *,
    region: Optional[str] = None,
    bins: Optional[int] = None,
    include_collectives: bool = True,
) -> np.ndarray:
    """The paper's halo-exchange heatmap: messages per (src, dst) rank pair.

    ``H[i, j]`` counts modeled messages rank ``i`` sent rank ``j`` —
    multiplicity-weighted over the rows of ``region`` (all regions when
    None), with each row's pair set read once from the unique struct
    (O(unique pairs + rows), never O(events)).  ``bins`` buckets the full
    ``(n, n)`` matrix down to ``(bins, bins)`` by rank-range sums, which is
    how 8192-rank sweeps emit a plottable artifact.  Host NumPy on every
    backend.  Collective structs
    contribute their synthesized member ring unless disabled.
    """
    buf = getattr(rec, "buffer", rec)
    tab = buf.structs
    view = tab.reduction_view()
    S = tab.n_structs
    n = int(view.rank_lens.max()) if S else 0
    sel = np.ones(buf.n_rows, bool)
    if region is not None:
        try:
            rid = buf.region_names.index(region)
        except ValueError:
            rid = -1
        sel = buf.region_ids == rid
    w = np.zeros(S, np.int64)
    np.add.at(w, buf.struct_ids[sel], buf.multiplicity[sel])
    sid, src, dst = _struct_pairs(view, include_collectives)
    if bins is not None and 0 < bins < n:
        bs = -(-n // bins)
        H = np.zeros((bins, bins), np.int64)
        if len(sid):
            np.add.at(H, (src // bs, dst // bs), w[sid])
    else:
        H = np.zeros((n, n), np.int64)
        if len(sid):
            np.add.at(H, (src, dst), w[sid])
    return H


_SHADES = " .:-=+*#%@"


def ascii_heatmap(H: np.ndarray, *, width: int = 32, title: str = "") -> str:
    """Terminal rendering of a heatmap matrix (log-shaded, downsampled)."""
    n = len(H)
    if n == 0 or not H.any():
        return f"## {title}\n(no traffic)"
    b = min(width, n)
    bs = -(-n // b)
    nb = -(-n // bs)
    D = np.zeros((nb, nb), np.int64)
    idx = np.arange(n) // bs
    np.add.at(D, (idx[:, None], idx[None, :]), H)
    logd = np.log1p(D.astype(np.float64))
    top = logd.max() or 1.0
    levels = np.minimum(
        (logd / top * (len(_SHADES) - 1)).astype(int), len(_SHADES) - 1
    )
    lines = [f"## {title}", f"(rows=src, cols=dst, {bs} rank(s)/cell, max={H.max()})"]
    lines += ["".join(_SHADES[v] for v in row) for row in levels]
    return "\n".join(lines)


def heatmap_csv(H: np.ndarray) -> str:
    """CSV artifact form: header of dst indices, one row per src index."""
    n = len(H)
    lines = ["src\\dst," + ",".join(str(j) for j in range(n))]
    for i in range(n):
        lines.append(f"{i}," + ",".join(str(int(v)) for v in H[i]))
    return "\n".join(lines)
