"""The port's modeled-network layer and reports against the JAX package's.

Each app is traced by both packages at the same configuration; the port's
fabric models, peer heatmaps (and the golden fixtures of
``tests/test_network_layer.py``), ``region_rows`` on its ``NumpyBackend``
and on ``TorchBackend(device="cpu")``, the three-layer frame and every
report must equal the reference's: rows as Python values, frames and
reports as CSV and markdown, byte for byte.
"""

import json

import numpy as np
import pytest
import torch

from repro.apps import amg as ref_amg
from repro.apps import beatnik as ref_beatnik
from repro.apps import kripke as ref_kripke
from repro.apps import laghos as ref_laghos
from repro.apps.stencil import Decomp3D as RefDecomp
from repro.core import network as ref_network
from repro.core import reports as ref_reports
from repro.core.backend import use_backend as ref_use_backend
from repro.core.hlo import scan_hlo_collectives as ref_scan
from repro.core.profiler import CommProfile as RefCommProfile
from repro.core.profiler import trace_observer as ref_trace_observer
from repro.core.thicket import Frame as RefFrame
from repro_torch.apps import amg, beatnik, kripke, laghos
from repro_torch.apps.stencil import Decomp3D
from repro_torch.core import network, reports
from repro_torch.core.backend import BackendUnavailable, NumpyBackend, TorchBackend
from repro_torch.core.hlo import scan_hlo_collectives
from repro_torch.core.profiler import CommProfile, trace_observer
from repro_torch.core.thicket import Frame

CPU = TorchBackend(device="cpu")
BACKENDS = {"numpy": NumpyBackend(), "torch-cpu": CPU}

#: (reference module, port module, config class name, decomp, params)
APPS = {
    "kripke": (
        ref_kripke,
        kripke,
        "KripkeConfig",
        (2, 2, 2),
        dict(nx=4, ny=4, nz=4, n_octants=1),
    ),
    "amg": (ref_amg, amg, "AMGConfig", (2, 2, 2), dict(nx=4, ny=4, nz=4)),
    "laghos": (ref_laghos, laghos, "LaghosConfig", (2, 2, 1), dict(nx=16, ny=16)),
    "beatnik": (
        ref_beatnik,
        beatnik,
        "BeatnikConfig",
        (2, 2, 1),
        dict(nx=8, ny=8, far_subsample=8, n_steps=3),
    ),
    "amg-dane-64": (ref_amg, amg, "AMGConfig", (4, 4, 4), dict(nx=8, ny=8, nz=8)),
}


def _observe(trace_obs, fn):
    holder = {}

    def keep(rec, *, name, replication, meta):
        holder["rec"] = rec
        return None

    with trace_obs(keep):
        prof = fn()
    return prof, holder["rec"]


def _traces(case, name="t"):
    """(port profile, port recorder, reference profile, reference recorder)."""
    ref_mod, mod, cls, shape, params = APPS[case]
    ref_cfg = getattr(ref_mod, cls)(decomp=RefDecomp(*shape), **params)
    cfg = getattr(mod, cls)(decomp=Decomp3D(*shape), **params)
    prof, rec = _observe(
        trace_observer, lambda: mod.profile(cfg, name=name, device="cpu")
    )
    ref_prof, ref_rec = _observe(
        ref_trace_observer, lambda: ref_mod.profile(ref_cfg, name=name)
    )
    assert prof.to_json() == ref_prof.to_json()
    return prof, rec, ref_prof, ref_rec


# ---------------------------------------------------------------------------
# Fabric models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fabric", ["ring", "fat-tree", "dragonfly"])
@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_fabric_models_match_reference(fabric, n):
    rng = np.random.default_rng(n)
    src = rng.integers(0, n, 500)
    dst = rng.integers(0, n, 500)
    got, want = network.FABRICS[fabric], ref_network.FABRICS[fabric]
    assert np.array_equal(got.hops(src, dst, n), want.hops(src, dst, n))
    assert np.array_equal(got.link_ids(src, dst, n), want.link_ids(src, dst, n))
    assert got.n_links(n) == want.n_links(n)
    assert (got.latency_s, got.bandwidth_Bps) == (want.latency_s, want.bandwidth_Bps)


def test_fabric_goldens():
    src = np.array([0, 0, 0, 7, 3])
    dst = np.array([1, 7, 4, 0, 3])
    assert network.RING.hops(src, dst, 8).tolist() == [1, 1, 4, 1, 0]
    assert network.RING.n_links(8) == 16
    assert network.RING.link_ids(np.array([2]), np.array([1]), 8).tolist() == [5]
    src, dst = np.array([0, 0, 0, 17]), np.array([0, 15, 16, 40])
    assert network.FAT_TREE.hops(src, dst, 64).tolist() == [0, 2, 4, 4]
    assert network.FAT_TREE.link_ids(src, dst, 64).tolist() == [0, 0, 64, 65]
    assert network.DRAGONFLY.hops(src[:3], dst[:3], 64).tolist() == [0, 1, 3]


def test_resolve_fabric_names():
    assert network.resolve_fabric(None) is network.RING
    assert network.resolve_fabric("fat-tree") is network.FAT_TREE
    assert network.resolve_fabric(network.DRAGONFLY) is network.DRAGONFLY
    assert set(network.FABRICS) == {"ring", "fat-tree", "dragonfly"}
    with pytest.raises(ValueError):
        network.resolve_fabric("torus")


# ---------------------------------------------------------------------------
# Heatmaps: the golden fixtures of tests/test_network_layer.py
# ---------------------------------------------------------------------------

_KRIPKE_8 = [
    [0, 1, 1, 0, 1, 0, 0, 0],
    [0, 0, 0, 1, 0, 1, 0, 0],
    [0, 0, 0, 1, 0, 0, 1, 0],
    [0, 0, 0, 0, 0, 0, 0, 1],
    [0, 0, 0, 0, 0, 1, 1, 0],
    [0, 0, 0, 0, 0, 0, 0, 1],
    [0, 0, 0, 0, 0, 0, 0, 1],
    [0, 0, 0, 0, 0, 0, 0, 0],
]
_AMG_8 = [
    [0, 2, 2, 0, 2, 0, 0, 0],
    [2, 0, 0, 2, 0, 2, 0, 0],
    [2, 0, 0, 2, 0, 0, 2, 0],
    [0, 2, 2, 0, 0, 0, 0, 2],
    [2, 0, 0, 0, 0, 2, 2, 0],
    [0, 2, 0, 0, 2, 0, 0, 2],
    [0, 0, 2, 0, 2, 0, 0, 2],
    [0, 0, 0, 2, 0, 2, 2, 0],
]
_LAGHOS_4 = [[0, 8, 8, 0], [8, 0, 0, 8], [8, 0, 0, 8], [0, 8, 8, 0]]
GOLDEN = {
    "kripke": ("sweep_comm", _KRIPKE_8),
    "amg": ("MatVecComm", _AMG_8),
    "laghos": ("halo_exchange", _LAGHOS_4),
}


@pytest.mark.parametrize("case", list(GOLDEN))
def test_golden_heatmaps(case):
    region, golden = GOLDEN[case]
    _, rec, _, ref_rec = _traces(case)
    H = network.peer_heatmap(rec, region=region)
    assert H.tolist() == golden
    assert np.array_equal(H, ref_network.peer_heatmap(ref_rec, region=region))


@pytest.mark.parametrize("case", list(APPS))
@pytest.mark.parametrize("include_collectives", [True, False])
def test_heatmaps_match_reference(case, include_collectives):
    _, rec, ref_prof, ref_rec = _traces(case)
    kw = dict(include_collectives=include_collectives)
    for region in [None, *ref_prof.regions, "no-such-region"]:
        H = network.peer_heatmap(rec, region=region, **kw)
        want = ref_network.peer_heatmap(ref_rec, region=region, **kw)
        assert H.dtype == np.int64 and np.array_equal(H, want), region
    for bins in (2, 3):
        B = network.peer_heatmap(rec, bins=bins, **kw)
        assert np.array_equal(B, ref_network.peer_heatmap(ref_rec, bins=bins, **kw))
        assert B.sum() == network.peer_heatmap(rec, **kw).sum()


def test_heatmap_renderers_match_reference():
    _, rec, _, ref_rec = _traces("kripke")
    H = network.peer_heatmap(rec, region="sweep_comm")
    ref_H = ref_network.peer_heatmap(ref_rec, region="sweep_comm")
    for width in (32, 3):
        want = ref_network.ascii_heatmap(ref_H, width=width, title="k")
        assert network.ascii_heatmap(H, width=width, title="k") == want
    assert network.heatmap_csv(H) == ref_network.heatmap_csv(ref_H)
    empty = np.zeros((0, 0), np.int64)
    assert network.ascii_heatmap(empty, title="e") == ref_network.ascii_heatmap(
        empty, title="e"
    )
    art = network.ascii_heatmap(H, title="kripke")
    assert art.splitlines()[0] == "## kripke"
    assert len(art.splitlines()) == 2 + H.shape[0]


def test_struct_fingerprints_surface_generators():
    _, rec, _, ref_rec = _traces("kripke")
    fps = network.struct_fingerprints(rec.buffer.structs)
    assert fps == ref_network.struct_fingerprints(ref_rec.buffer.structs)
    gens = {fp[0][0] for fp in fps.values() if isinstance(fp[0], tuple)}
    assert "kripke-plane" in gens


@pytest.mark.parametrize("case", list(APPS))
def test_struct_costs_match_reference(case):
    _, rec, _, ref_rec = _traces(case)
    for name in network.FABRICS:
        got = network.struct_costs(rec.buffer.structs, name)
        want = ref_network.struct_costs(ref_rec.buffer.structs, name)
        assert (got.n_ranks, got.n_links) == (want.n_ranks, want.n_links)
        for field in ("pair_count", "hops_total", "hops_max", "link_grid"):
            assert np.array_equal(getattr(got, field), getattr(want, field)), field


# ---------------------------------------------------------------------------
# Modeled region rows on both of the port's backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("case", list(APPS))
def test_region_rows_byte_identical(case, backend):
    _, rec, _, ref_rec = _traces(case)
    for fab in network.FABRICS:
        kw = dict(fabric=fab, name=case, n_ranks=0, meta={"app": case})
        got = network.NetworkModeledProfiler.region_rows(
            rec, backend=BACKENDS[backend], **kw
        )
        want = ref_network.NetworkModeledProfiler.region_rows(
            ref_rec, backend="numpy", **kw
        )
        assert got and json.dumps(got) == json.dumps(want), fab


def test_region_rows_kripke_ring_golden():
    _, rec, _, _ = _traces("kripke")
    rows = network.NetworkModeledProfiler.region_rows(
        rec, fabric=network.RING, name="k8", backend=CPU
    )
    r = {row["region"]: row for row in rows}["sweep_comm"]
    assert r["layer"] == "network" and r["net_fabric"] == "ring"
    assert r["net_structs"] == 3 and r["net_msgs"] == 12
    assert r["net_hops_total"] == 28 and r["net_hops_max"] == 4
    assert r["net_links_used"] == 7 and r["net_link_msgs_max"] == 3
    assert r["net_congestion"] == 1.75
    assert r["net_wire_s"] == 9.21184e-06
    assert r["net_generators"] == "kripke-plane"


def test_region_rows_fabrics_differ():
    _, rec, _, _ = _traces("kripke")
    wire = {}
    for fab in network.FABRICS.values():
        rows = network.NetworkModeledProfiler.region_rows(rec, fabric=fab, backend=CPU)
        wire[fab.name] = {r["region"]: r["net_wire_s"] for r in rows}
    assert wire["ring"]["sweep_comm"] > wire["fat-tree"]["sweep_comm"]
    assert wire["fat-tree"]["sweep_comm"] > wire["dragonfly"]["sweep_comm"]


class _SpyBackend(NumpyBackend):
    """Records every matmul operand shape flowing through the reduction."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def matmul(self, a, b):
        self.shapes.append((tuple(np.shape(a)), tuple(np.shape(b))))
        return super().matmul(a, b)


def test_network_rows_scale_by_unique_structs_at_8192_ranks():
    cfg = kripke.KripkeConfig(
        decomp=Decomp3D(32, 32, 8), nx=16, ny=32, nz=32, n_octants=1, fuse_messages=True
    )
    prof, rec = _observe(trace_observer, lambda: kripke.profile(cfg, device="cpu"))
    S = rec.buffer.structs.n_structs
    total_sends = sum(s.total_sends for s in prof.regions.values())
    assert prof.n_ranks == 8192 and total_sends >= 50 * S
    spy = _SpyBackend()
    rows = network.NetworkModeledProfiler.region_rows(rec, fabric="ring", backend=spy)
    assert rows and any(r["net_msgs"] for r in rows)
    bound = max(len(rec.buffer.region_names), S, network.RING.n_links(8192))
    assert spy.shapes
    for a_shape, b_shape in spy.shapes:
        for dim in a_shape + b_shape:
            assert dim <= bound and dim < total_sends, (a_shape, b_shape)
    on_torch = network.NetworkModeledProfiler.region_rows(rec, fabric="ring", backend=CPU)
    assert rows == on_torch


# ---------------------------------------------------------------------------
# Frames and reports against the reference's, as CSV and markdown
# ---------------------------------------------------------------------------

_HLO_TEXT = """HloModule m
%add.r (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main (p0: f32[64,4]) -> f32[64,4] {
  %p0 = f32[64,4]{1,0} parameter(0)
  ROOT %ar = f32[64,4]{1,0} all-reduce(f32[64,4]{1,0} %p0), channel_id=1, \
replica_groups=[1,8]<=[8], to_apply=%add.r, \
metadata={op_name="jit(f)/commr::sweep_comm/psum"}
}
"""


def _layers(cases=("kripke", "amg", "laghos", "beatnik")):
    """Port and reference (profiles, network entries, hlo entries)."""
    got, want = ([], [], []), ([], [], [])
    for case in cases:
        prof, rec, ref_prof, ref_rec = _traces(case, name=f"{case}-run")
        got[0].append(prof)
        want[0].append(ref_prof)
        for fab in ("ring", "fat-tree"):
            got[1].append((prof.name, prof.n_ranks, rec, fab, {"app": case}))
            want[1].append((prof.name, prof.n_ranks, ref_rec, fab, {"app": case}))
    got[2].append(("kripke-run", 8, scan_hlo_collectives(_HLO_TEXT, 8)))
    want[2].append(("kripke-run", 8, ref_scan(_HLO_TEXT, 8)))
    return got, want


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_three_layer_frame_renders_identically(backend):
    (profiles, net, hlo), (ref_profiles, ref_net, ref_hlo) = _layers()
    be = BACKENDS[backend]
    got = Frame.concat(
        [
            Frame.from_profiles(profiles),
            Frame.from_network(net, backend=be),
            Frame.from_hlo(hlo, backend=be),
        ]
    )
    with ref_use_backend("numpy"):
        want = RefFrame.concat(
            [
                RefFrame.from_profiles(ref_profiles),
                RefFrame.from_network(ref_net),
                RefFrame.from_hlo(ref_hlo),
            ]
        )
    assert set(got.column("layer")) == {"traced", "network", "hlo"}
    assert got.columns() == want.columns()
    assert got.to_csv() == want.to_csv()
    assert got.to_markdown() == want.to_markdown()
    agg = {"n": ("region", len), "w": ("net_wire_s", lambda v: sum(x or 0 for x in v))}
    assert (
        got.agg(("layer", "profile"), agg, backend=be).to_csv()
        == want.agg(("layer", "profile"), agg, backend="numpy").to_csv()
    )


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_network_and_hlo_vs_traced_match_reference(backend):
    (profiles, net, hlo), (ref_profiles, ref_net, ref_hlo) = _layers()
    be = BACKENDS[backend]
    with ref_use_backend("numpy"):
        want_net = ref_reports.network_vs_traced(
            ref_profiles, ref_net, hlo_entries=ref_hlo
        )
        want_net2 = ref_reports.network_vs_traced(ref_profiles, ref_net)
        want_hlo = ref_reports.hlo_vs_traced(ref_profiles, ref_hlo)
    got_net = reports.network_vs_traced(profiles, net, hlo_entries=hlo, backend=be)
    assert got_net == want_net
    assert reports.network_vs_traced(profiles, net, backend=be) == want_net2
    assert reports.hlo_vs_traced(profiles, hlo, backend=be) == want_hlo
    row = next(ln for ln in got_net.splitlines() if "| kripke-run | sweep_comm |" in ln)
    traced = profiles[0].regions["sweep_comm"].total_bytes_sent
    assert f"| {traced} |" in row and "| 24 |" in row  # 12 msgs x 2 fabrics
    assert f"| {hlo[0][2].summarize().total_wire_bytes} |" in row
    assert reports.network_vs_traced([], [], backend=be).count("\n") == 1
    assert reports.hlo_vs_traced([], [], backend=be).count("\n") == 1


def _sweep(app, shapes, params, **meta):
    """Port and reference profiles of one app over several decompositions."""
    ref_mod, mod, cls = APPS[app][:3]
    got, want = [], []
    for shape in shapes:
        name = f"{app}-{shape}"
        m = dict(meta, app=app)
        ref_cfg = getattr(ref_mod, cls)(decomp=RefDecomp(*shape), **params)
        cfg = getattr(mod, cls)(decomp=Decomp3D(*shape), **params)
        want.append(ref_mod.profile(ref_cfg, name=name, meta=m))
        got.append(mod.profile(cfg, name=name, meta=m, device="cpu"))
    return got, want


#: the emitters that group or pivot, and so take ``backend=``
_REDUCING = {"table4_metrics", "per_level_report", "bandwidth_msgrate_report"}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_reports_match_reference(backend):
    small = dict(nx=4, ny=4, nz=4)
    kr, ref_kr = _sweep("kripke", [(2, 2, 2), (2, 2, 4)], small, seconds=0.1)
    am, ref_am = _sweep("amg", [(2, 2, 2), (2, 2, 4)], {}, seconds=0.25)
    la, ref_la = _sweep("laghos", [(2, 2, 1), (4, 4, 1)], dict(nx=32, ny=32), seconds=0.5)
    profs, ref_profs = kr + am + la, ref_kr + ref_am + ref_la

    def lost(cls):  # a degraded sweep point: no regions, listed in a footer
        meta = {"app": "kripke", "degraded": True, "retries": 3}
        return [cls(name="kripke-lost", n_ranks=64, meta=meta)]

    calls = [  # (emitter, port arguments, reference arguments, keywords)
        ("table4_metrics", (profs,), (ref_profs,), {}),
        ("table4_metrics", (profs,), (ref_profs,), dict(region="halo_exchange")),
        ("per_level_report", (am,), (ref_am,), {}),
        ("per_level_report", (am,), (ref_am,), dict(metric="dest_ranks_max")),
        (
            "bandwidth_msgrate_report",
            (profs + lost(CommProfile),),
            (ref_profs + lost(RefCommProfile),),
            {},
        ),
        ("scaling_report", (profs, "sweep_comm"), (ref_profs, "sweep_comm"), {}),
        (
            "scaling_report",
            (la, "halo_exchange"),
            (ref_la, "halo_exchange"),
            dict(metric="bytes_sent_max", title="t"),
        ),
        ("region_stats_table", (am[1],), (ref_am[1],), {}),
        ("table4_metrics", ([],), ([],), {}),
        ("per_level_report", ([],), ([],), {}),
        ("bandwidth_msgrate_report", ([],), ([],), {}),
    ]
    out = []
    for emitter, args, ref_args, kw in calls:
        extra = {"backend": BACKENDS[backend]} if emitter in _REDUCING else {}
        got = getattr(reports, emitter)(*args, **kw, **extra)
        with ref_use_backend("numpy"):
            assert got == getattr(ref_reports, emitter)(*ref_args, **kw), emitter
        out.append(got)
    assert "degraded points" in out[4] and "| 8 |" in out[2]


def test_table1_schema_and_ascii_plot():
    rows = [ln.split("|")[1] for ln in reports.table1_schema().splitlines()]
    assert rows == [ln.split("|")[1] for ln in ref_reports.table1_schema().splitlines()]
    assert "| Sends |" in reports.table1_schema()
    unsorted = ([512, 64, 256, 128], [4.0, 1.0, 3.0, 2.0])
    for xs, ys in [unsorted, ([1, 2], [0.0, 0.0]), ([], [])]:
        want = ref_reports.ascii_scaling_plot(xs, ys, title="t")
        assert reports.ascii_scaling_plot(xs, ys, title="t") == want
    xlab = reports.ascii_scaling_plot([512, 64], [4.0, 1.0], title="t").splitlines()[-1]
    assert xlab.strip().startswith("64") and xlab.rstrip().endswith("512")


def test_default_backend_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    prof, rec, _, _ = _traces("laghos")
    with pytest.raises(BackendUnavailable):
        network.NetworkModeledProfiler.region_rows(rec)
    with pytest.raises(BackendUnavailable):
        Frame.from_network([(prof.name, prof.n_ranks, rec, "ring")])
    for emit in (
        lambda: reports.table4_metrics([prof]),
        lambda: reports.per_level_report([prof]),
        lambda: reports.bandwidth_msgrate_report([prof]),
        lambda: reports.hlo_vs_traced([prof], []),
        lambda: reports.network_vs_traced([prof], []),
    ):
        with pytest.raises(BackendUnavailable):
            emit()
