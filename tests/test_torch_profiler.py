"""The port's profiler against the JAX package's, byte for byte.

Randomized event streams are built by the reference's own generator
(``test_profiler_parity._random_recorder``: sparse, misaligned dicts,
ragged rank extents, collectives and point-to-point events), carried into
the port as plain dicts through ``repro_torch.interop``, and reduced by
both packages.  ``CommProfile.to_json()`` must be identical for both
implementations (``numpy`` and ``reference``) and on both of the port's
backends.
"""

import pytest

from test_profiler_parity import _random_recorder

from repro.core.profiler import CommPatternProfiler as RefProfiler
from repro.core.regions import RegionRecorder as RefRecorder
from repro_torch.core.backend import NumpyBackend, TorchBackend
from repro_torch.core.profiler import CommPatternProfiler, CommProfile
from repro_torch.core.regions import RegionRecorder
from repro_torch.interop import recorder_from_event_dicts

SEEDS = [0, 1, 2, 7, 42, 1234, 20260808, 999_999]


def _event_dicts(rec) -> list:
    return [
        dict(
            region=ev.region,
            region_path=ev.region_path,
            kind=ev.kind,
            is_collective=ev.is_collective,
            axis_name=ev.axis_name,
            n_ranks=ev.n_ranks,
            **ev.to_dicts(),
        )
        for ev in rec.events
    ]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("impl", ["numpy", "reference"])
def test_random_stream_profiles_byte_identical(seed, impl):
    ref_rec = _random_recorder(seed)
    rec = recorder_from_event_dicts(_event_dicts(ref_rec), ref_rec.instances)
    repl = (seed % 3) + 1
    want = RefProfiler.from_recorder(
        ref_rec, name="p", replication=repl, impl=impl, backend="numpy"
    ).to_json()
    backends = [TorchBackend(device="cpu"), NumpyBackend()]
    for be in backends if impl == "numpy" else [None]:
        got = CommPatternProfiler.from_recorder(
            rec, name="p", replication=repl, impl=impl, backend=be
        )
        assert got.to_json() == want
        assert CommProfile.from_json(got.to_json()).to_json() == want


def test_event_views_round_trip():
    ref_rec = _random_recorder(5)
    dicts = _event_dicts(ref_rec)
    rec = recorder_from_event_dicts(dicts, ref_rec.instances)
    assert rec.instances == ref_rec.instances
    assert rec.buffer.n_events == ref_rec.buffer.n_events
    assert _event_dicts(rec) == dicts


def test_empty_recorder():
    got = CommPatternProfiler.from_recorder(
        RegionRecorder(), backend=TorchBackend(device="cpu")
    )
    want = RefProfiler.from_recorder(RefRecorder(), backend="numpy")
    assert got.to_json() == want.to_json()
    assert got.n_ranks == 0 and got.regions == {}
