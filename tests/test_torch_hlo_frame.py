"""The port's HLO layer and Thicket Frame against the JAX package's.

Every module of the golden HLO corpus is scanned by both packages and
reduced to per-region rows: the port on ``TorchBackend(device="cpu")``
(the CUDA segmented-reduce kernel's plain version), the reference on its
NumPy backend; the rows must serialize identically.  Frames built from the
same kripke profiles and HLO modules must render identical CSV and
markdown, through the relational and grouping operations too.
"""

import glob
import json
import os

import pytest

from repro.apps import kripke as ref_kripke
from repro.apps.stencil import Decomp3D as RefDecomp
from repro.core.backend import use_backend
from repro.core.hlo import scan_hlo_collectives as ref_scan
from repro.core.profiler import HloCollectiveProfiler as RefHlo
from repro.core.thicket import Frame as RefFrame
from repro_torch.apps import kripke
from repro_torch.apps.stencil import Decomp3D
from repro_torch.core.backend import TorchBackend
from repro_torch.core.hlo import scan_hlo_collectives
from repro_torch.core.profiler import HloCollectiveProfiler
from repro_torch.core.thicket import Frame

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "hlo")
FIXTURES = sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.txt")))
IDS = [os.path.basename(p)[: -len(".txt")] for p in FIXTURES]
CPU = TorchBackend(device="cpu")


def _load(path):
    with open(path) as f:
        text = f.read()
    with open(path[: -len(".txt")] + ".expected.json") as f:
        td = json.load(f)["total_devices"]
    return text, td


def test_corpus_is_complete():
    assert len(FIXTURES) == 7


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_hlo_region_rows_identical(path):
    text, td = _load(path)
    ref = RefHlo.region_rows(
        ref_scan(text, td, with_loops=True), name="g", n_ranks=8, backend="numpy"
    )
    buf = scan_hlo_collectives(text, td, with_loops=True)
    got = HloCollectiveProfiler.region_rows(buf, name="g", n_ranks=8, backend=CPU)
    assert got
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)


def _frames():
    """(port frame, reference frame): traced kripke rows + hlo rows."""
    shapes = [(2, 2, 2), (4, 2, 2)]
    params = dict(nx=4, ny=4, nz=4, n_octants=2, fuse_messages=False)
    ref_profiles, profiles = [], []
    for s in shapes:
        ref_cfg = ref_kripke.KripkeConfig(decomp=RefDecomp(*s), **params)
        ref_profiles.append(ref_kripke.profile(ref_cfg))
        cfg = kripke.KripkeConfig(decomp=Decomp3D(*s), **params)
        profiles.append(kripke.profile(cfg, device="cpu"))
    entries, ref_entries = [], []
    for path, name in zip(FIXTURES, IDS):
        text, td = _load(path)
        meta = {"module": name}
        buf = scan_hlo_collectives(text, td, with_loops=True)
        entries.append((name, 8, buf, meta))
        ref_entries.append((name, 8, ref_scan(text, td, with_loops=True), meta))
    got = Frame.concat([Frame.from_profiles(profiles), Frame.from_hlo(entries, CPU)])
    with use_backend("numpy"):
        ref_hlo = RefFrame.from_hlo(ref_entries)
    want = RefFrame.concat([RefFrame.from_profiles(ref_profiles), ref_hlo])
    return got, want


def test_frames_render_identically():
    got, want = _frames()
    assert len(got) == len(want) > 0
    assert got.columns() == want.columns()
    assert got.to_csv() == want.to_csv()
    assert got.to_markdown() == want.to_markdown()
    assert got.rows == want.rows


def test_frame_operations_identical():
    got, want = _frames()
    for g, w in [
        (got.where(layer="hlo"), want.where(layer="hlo")),
        (
            got.select("profile", "region", "hlo_ops"),
            want.select("profile", "region", "hlo_ops"),
        ),
        (got.sort("n_ranks", "region"), want.sort("n_ranks", "region")),
        (
            got.agg(("layer",), {"n": ("region", len)}, backend=CPU),
            want.agg(("layer",), {"n": ("region", len)}, backend="numpy"),
        ),
        (
            got.pivot("region", "n_ranks", "total_sends", backend=CPU),
            want.pivot("region", "n_ranks", "total_sends", backend="numpy"),
        ),
    ]:
        assert g.to_csv() == w.to_csv()
        assert g.to_markdown() == w.to_markdown()
    g_groups = got.group_by("layer", "n_ranks", backend=CPU)
    w_groups = want.group_by("layer", "n_ranks", backend="numpy")
    assert list(g_groups) == list(w_groups)
    for key in w_groups:
        assert g_groups[key].to_csv() == w_groups[key].to_csv()
