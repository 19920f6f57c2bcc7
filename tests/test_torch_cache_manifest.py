"""The port's shared cache manifest: exact per-directory accounting across
processes (``tests/test_cache_manifest.py`` re-pointed at ``repro_torch``;
every sweep reduces on ``NumpyBackend``, named)."""

import os
import signal
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

from repro_torch.benchpark.runner import (
    QUARANTINE_DIRNAME,
    CacheManifest,
    ProfileCache,
    run_experiment,
)
from repro_torch.benchpark.spec import ExperimentSpec, ScalePoint
from repro_torch.core.profiler import CommProfile

BACKEND = "numpy"


def _spec():
    return ExperimentSpec(
        name="kripke-manifest-test",
        app="kripke",
        scaling="weak",
        points=(
            ScalePoint((1, 1, 2)),
            ScalePoint((1, 2, 2)),
            ScalePoint((2, 2, 2)),
        ),
        app_params=dict(nx=4, ny=4, nz=4, n_octants=1),
    )


def _mini_profile(name):
    return CommProfile(name=name, n_ranks=2, meta={"pad": "x" * 512})


def _counts(m):
    """Call-count fields only (byte counters are size-dependent)."""
    return {k: m[k] for k in ("hits", "misses", "puts", "evictions")}


def test_manifest_reads_zero_when_absent(tmp_path):
    m = CacheManifest(str(tmp_path / "nonexistent"))
    assert m.read() == {k: 0 for k in CacheManifest.FIELDS}


def test_manifest_bump_accumulates_across_handles(tmp_path):
    root = str(tmp_path / "cache")
    CacheManifest(root).bump(hits=2, misses=1)
    post = CacheManifest(root).bump(hits=1, puts=4, put_bytes=100)
    assert _counts(post) == {"hits": 3, "misses": 1, "puts": 4, "evictions": 0}
    read = CacheManifest(root).read()
    assert read == post
    assert read["put_bytes"] == 100 and read["evicted_bytes"] == 0


def test_manifest_concurrent_bumps_are_exact(tmp_path):
    """No lost updates: 64 concurrent handles each add exactly one hit."""
    root = str(tmp_path / "cache")
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(lambda _: CacheManifest(root).bump(hits=1), range(64)))
    assert CacheManifest(root).read()["hits"] == 64


def test_stale_lock_is_broken_and_bump_proceeds(tmp_path):
    """A lock abandoned by a crashed holder must not deadlock bump()."""
    root = str(tmp_path / "cache")
    m = CacheManifest(root)
    os.makedirs(root, exist_ok=True)
    with open(m._lock_path, "w"):
        pass
    old = time.time() - 60
    os.utime(m._lock_path, (old, old))
    m.bump(hits=1)
    assert m.read()["hits"] == 1
    assert not os.path.exists(m._lock_path)


_HOLDER = """\
import sys
import time

sys.path.insert(0, {src!r})

from repro_torch.benchpark.runner import CacheManifest

m = CacheManifest(sys.argv[1])
import os
os.makedirs(m.root, exist_ok=True)
fd = m._acquire_lock()
print("LOCKED", flush=True)
time.sleep(600)  # hold the lock until SIGKILLed
"""


def test_sigkilled_lock_holder_is_taken_over_exactly_once(tmp_path):
    """Regression for the wedge: a holder SIGKILLed mid-critical-section
    leaves its ``O_EXCL`` lock behind; the next acquirer must expire it
    after ``REPRO_MANIFEST_LOCK_TIMEOUT_S`` and proceed — with the
    takeover counted and the subsequent accounting still exact."""
    src = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"
    )
    root = str(tmp_path / "cache")
    holder_py = tmp_path / "holder.py"
    holder_py.write_text(_HOLDER.format(src=src))
    proc = subprocess.Popen(
        [sys.executable, str(holder_py), root],
        stdout=subprocess.PIPE,
        text=True,
        env=dict(os.environ, PYTHONPATH=src),
    )
    try:
        assert proc.stdout.readline().strip() == "LOCKED"
    finally:
        proc.kill()  # SIGKILL: no release path runs
    proc.wait(timeout=60)

    m = CacheManifest(root, stale_lock_seconds=0.5)
    assert os.path.exists(m._lock_path)  # the orphan is really there
    t0 = time.monotonic()
    m.bump(hits=1)
    elapsed = time.monotonic() - t0
    assert elapsed < 10.0  # waited out (at most) the timeout, not wedged
    got = m.read()
    assert got["hits"] == 1  # the bump that broke the lock still landed
    assert got["lock_takeovers"] == 1  # counted exactly once
    assert not os.path.exists(m._lock_path)
    # follow-up traffic is unaffected and does not re-count the takeover
    m.bump(misses=1)
    got = m.read()
    assert got["lock_takeovers"] == 1 and got["misses"] == 1


def test_truncated_cache_entry_is_quarantined_miss(tmp_path):
    """Satellite: a torn/corrupt entry must read as a miss (re-trace),
    never a crash — moved to ``quarantine/`` and counted as ``corrupt``."""
    cache = ProfileCache(str(tmp_path / "cache"))
    cache.put("k", _mini_profile("p"))
    path = cache._path("k")
    size = os.path.getsize(path)
    with open(path, "r+") as f:
        f.truncate(size // 2)  # hand-torn write
    assert cache.get("k") is None
    m = cache.manifest.read()
    assert m["corrupt"] == 1 and m["misses"] == 1 and m["hits"] == 0
    qdir = os.path.join(cache.root, QUARANTINE_DIRNAME)
    assert len(os.listdir(qdir)) == 1
    assert not os.path.exists(path)  # the poison can never be served
    # a re-put heals the entry; the quarantined file stays aside
    cache.put("k", _mini_profile("p"))
    assert cache.get("k") is not None
    m = cache.manifest.read()
    assert m["hits"] == 1 and m["corrupt"] == 1
    assert len(os.listdir(qdir)) == 1


def test_cache_ops_update_manifest(tmp_path):
    cache = ProfileCache(str(tmp_path / "cache"))
    assert cache.get("absent") is None
    cache.put("k", _mini_profile("p"))
    assert cache.get("k") is not None
    m = cache.manifest.read()
    assert _counts(m) == {"hits": 1, "misses": 1, "puts": 1, "evictions": 0}
    assert m["put_bytes"] == len(_mini_profile("p").to_json())


def test_manifest_file_never_evicted(tmp_path):
    root = str(tmp_path / "cache")
    entry = len(_mini_profile("p").to_json())
    cache = ProfileCache(root, max_bytes=int(entry * 1.5))
    cache.put("k0", _mini_profile("p0"))
    cache.put("k1", _mini_profile("p1"))
    cache._evict()
    m = cache.manifest.read()
    assert m["puts"] == 2 and m["evictions"] >= 1
    assert m["evicted_bytes"] > 0
    assert cache.get("k1") is not None  # newest entry survives


class _ScanCountingCache(ProfileCache):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.scans = 0

    def _evict(self):
        self.scans += 1
        super()._evict()


def test_only_the_crossing_put_scans_the_directory(tmp_path):
    """Eviction coordination: once the manifest exists, only the handle
    whose put crossed REPRO_PROFILE_CACHE_MAX_BYTES (per the shared
    manifest byte totals) pays the directory scan; every other put skips
    it entirely.  The very first writer of a fresh manifest performs one
    safety sync scan (re-anchoring against reset manifests)."""
    root = str(tmp_path / "cache")
    entry = len(_mini_profile("p0").to_json())
    cap = int(entry * 4.5)
    handles = [_ScanCountingCache(root, max_bytes=cap) for _ in range(4)]
    # first writer of a fresh manifest: one sync scan, nothing evicted
    handles[0].put("k0", _mini_profile("p0"))
    assert handles[0].scans == 1
    assert handles[0].manifest.read()["evictions"] == 0
    # under-cap puts — first or later, any handle — never scan
    handles[1].put("k1", _mini_profile("p1"))
    handles[2].put("k2", _mini_profile("p2"))
    handles[0].put("k3", _mini_profile("p3"))
    assert [h.scans for h in handles] == [1, 0, 0, 0]
    # the put that crosses the cap scans — and only that one
    handles[3].put("k4", _mini_profile("p4"))
    assert [h.scans for h in handles] == [1, 0, 0, 1]
    m = handles[3].manifest.read()
    assert m["evictions"] >= 1 and m["evicted_bytes"] > 0
    # newest entry always survives the LRU sweep
    assert handles[3].get("k4") is not None


def test_lowered_cap_on_existing_directory_still_enforced(tmp_path):
    """A cap set (or lowered) after the directory already grew past it
    never sees a crossing — the handle's first over-cap put must scan
    once anyway, or the cap would be permanently unenforced."""
    root = str(tmp_path / "cache")
    big = ProfileCache(root, max_bytes=0)  # uncapped growth
    for i in range(6):
        big.put(f"k{i}", _mini_profile(f"p{i}"))
    entry = len(_mini_profile("p0").to_json())
    capped = _ScanCountingCache(root, max_bytes=int(entry * 2.5))
    capped.put("k6", _mini_profile("p6"))
    assert capped.scans == 1
    m = capped.manifest.read()
    assert m["evictions"] >= 4
    files = [n for n in os.listdir(root) if n != "manifest.json"]
    assert sum(os.path.getsize(os.path.join(root, n)) for n in files) <= int(
        entry * 2.5
    )
    # steady state after the sync scan: under-cap puts stay scan-free
    capped.put("k7", _mini_profile("p7"))
    assert capped.scans <= 2


def test_reset_manifest_over_full_directory_reanchors_and_evicts(tmp_path):
    """Deleting manifest.json under a full directory zeroes the byte
    counters; the next writer's fresh-manifest sync scan must re-anchor
    the estimate to the real size (signed fold) and enforce the cap
    instead of trusting the reset counters."""
    root = str(tmp_path / "cache")
    entry = len(_mini_profile("p0").to_json())
    cap = int(entry * 2.5)
    seed = ProfileCache(root, max_bytes=0)
    for i in range(6):
        seed.put(f"k{i}", _mini_profile(f"p{i}"))
    os.remove(os.path.join(root, CacheManifest.FILENAME))

    cache = _ScanCountingCache(root, max_bytes=cap)
    cache.put("k6", _mini_profile("p6"))
    assert cache.scans == 1  # fresh-manifest sync
    m = cache.manifest.read()
    assert m["evictions"] >= 4
    # estimate re-anchored to reality: put_bytes - evicted_bytes equals
    # the surviving directory bytes (the signed fold went negative)
    files = [n for n in os.listdir(root) if n != CacheManifest.FILENAME]
    total = sum(os.path.getsize(os.path.join(root, n)) for n in files)
    assert total <= cap
    assert m["put_bytes"] - m["evicted_bytes"] == total


def test_process_sweep_twice_reports_exact_accounting(tmp_path):
    """A process-pool sweep run twice: the shared manifest must account for
    every worker's traffic exactly — 3 misses + 3 puts cold, 3 hits warm.

    Runs with fork-related warnings promoted to errors: the pool uses a
    forkserver (or spawn) start method, so even with torch's thread pools
    live in this parent the sweep must not fork a multi-threaded process
    (the ``os.fork() ... may lead to deadlocks`` RuntimeWarning).
    """
    import torch  # noqa: F401  — the parent is multi-threaded for real
    root = str(tmp_path / "cache")
    cache = ProfileCache(root)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*fork.*")
        run_experiment(
            _spec(), verbose=False, backend=BACKEND, cache=cache,
            executor="process", max_workers=3,
        )
    m1 = cache.manifest.read()
    assert _counts(m1) == {"hits": 0, "misses": 3, "puts": 3, "evictions": 0}
    assert m1["put_bytes"] > 0

    cache2 = ProfileCache(root)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*fork.*")
        run_experiment(
            _spec(), verbose=False, backend=BACKEND, cache=cache2,
            executor="process", max_workers=3,
        )
    m2 = cache2.manifest.read()
    assert _counts(m2) == {"hits": 3, "misses": 3, "puts": 3, "evictions": 0}
    assert m2["put_bytes"] == m1["put_bytes"]  # hits do not re-put


def test_pool_start_method_env_override_and_fallback(monkeypatch):
    """REPRO_POOL_START_METHOD selects the pool context; unknown names
    fall back to spawn instead of crashing (or silently forking), and
    ``fork`` is refused: CUDA does not survive a fork after init."""
    import pytest

    from repro_torch.benchpark.runner import POOL_START_METHOD_ENV, _pool_mp_context

    monkeypatch.delenv(POOL_START_METHOD_ENV, raising=False)
    assert _pool_mp_context().get_start_method() == "forkserver"
    monkeypatch.setenv(POOL_START_METHOD_ENV, "spawn")
    assert _pool_mp_context().get_start_method() == "spawn"
    monkeypatch.setenv(POOL_START_METHOD_ENV, "no-such-method")
    assert _pool_mp_context().get_start_method() == "spawn"
    monkeypatch.setenv(POOL_START_METHOD_ENV, "fork")
    with pytest.raises(ValueError, match="CUDA"):
        _pool_mp_context()


def test_run_experiment_emits_aggregated_frame_csv(tmp_path):
    path = tmp_path / "sweep" / "frame.csv"
    profs = run_experiment(
        _spec(), verbose=False, backend=BACKEND, frame_csv=str(path)
    )
    lines = path.read_text().splitlines()
    header = lines[0].split(",")
    assert "region" in header and "total_bytes_sent" in header
    assert len(lines) == 1 + sum(len(p.regions) for p in profs)
