"""The port's benchpark runner: profile cache hit/miss/invalidation +
concurrency (``tests/test_benchpark_cache.py`` re-pointed at
``repro_torch``; every sweep reduces on ``NumpyBackend``, named)."""

from repro_torch.benchpark import runner
from repro_torch.benchpark.runner import ProfileCache, run_experiment
from repro_torch.benchpark.spec import ExperimentSpec, ScalePoint

BACKEND = "numpy"


def _spec():
    return ExperimentSpec(
        name="kripke-cache-test", app="kripke", scaling="weak",
        points=(ScalePoint((1, 1, 2)), ScalePoint((1, 2, 2)),
                ScalePoint((2, 2, 2))),
        app_params=dict(nx=4, ny=4, nz=4, n_octants=1))


def _bomb(*a, **kw):
    raise AssertionError("re-traced a point that should have been cached")


def test_cache_miss_then_hit(tmp_path, monkeypatch):
    cache = ProfileCache(str(tmp_path / "cache"))
    first = run_experiment(_spec(), verbose=False, backend=BACKEND, cache=cache)
    assert cache.misses == 3 and cache.hits == 0
    assert len(first) == 3

    # Second invocation must be served entirely from disk: arm a bomb in
    # place of the tracer and require identical profiles.
    from repro_torch.apps import kripke
    monkeypatch.setattr(kripke, "profile", _bomb)
    cache2 = ProfileCache(str(tmp_path / "cache"))
    second = run_experiment(_spec(), verbose=False, backend=BACKEND, cache=cache2)
    assert cache2.hits == 3 and cache2.misses == 0
    for a, b in zip(first, second):
        assert a.to_json() == b.to_json()


def test_cache_key_covers_config_and_code_version(tmp_path, monkeypatch):
    cache = ProfileCache(str(tmp_path / "cache"))
    spec = _spec()
    _, cfg = spec.configs()[0]
    k1 = cache.key("kripke", cfg, (1, 1, 2))
    # config change -> different key
    from dataclasses import replace
    assert cache.key("kripke", replace(cfg, nx=8), (1, 1, 2)) != k1
    # decomp change -> different key
    assert cache.key("kripke", cfg, (2, 1, 1)) != k1
    # code change -> different key (fingerprint participates)
    monkeypatch.setattr(runner, "_code_fingerprint", lambda: "deadbeef")
    assert cache.key("kripke", cfg, (1, 1, 2)) != k1


def test_code_change_invalidates_cache(tmp_path, monkeypatch):
    cache = ProfileCache(str(tmp_path / "cache"))
    run_experiment(_spec(), verbose=False, backend=BACKEND, cache=cache)
    assert cache.misses == 3

    # Simulate an edit to a fingerprinted module: every key changes, the
    # old entries can never be served, and the sweep re-traces.
    monkeypatch.setattr(runner, "_code_fingerprint", lambda: "other-code")
    cache2 = ProfileCache(str(tmp_path / "cache"))
    run_experiment(_spec(), verbose=False, backend=BACKEND, cache=cache2)
    assert cache2.hits == 0 and cache2.misses == 3


def test_cache_hit_restamps_experiment_labels(tmp_path):
    """Two experiments sharing a physics point share the cache entry but
    keep their own names/meta."""
    cache = ProfileCache(str(tmp_path / "cache"))
    a = run_experiment(_spec(), verbose=False, backend=BACKEND, cache=cache)
    spec_b = ExperimentSpec(
        name="kripke-cache-test-b", app="kripke", scaling="weak",
        points=_spec().points, app_params=_spec().app_params)
    b = run_experiment(spec_b, verbose=False, backend=BACKEND, cache=cache)
    assert cache.hits == 3
    assert b[0].name == "kripke-cache-test-b-2"
    assert b[0].meta["experiment"] == "kripke-cache-test-b"
    assert a[0].meta["experiment"] == "kripke-cache-test"
    # physics identical
    assert {r: s.to_dict() for r, s in a[0].regions.items()} == \
        {r: s.to_dict() for r, s in b[0].regions.items()}


def test_concurrent_points_match_serial(tmp_path):
    serial = run_experiment(_spec(), verbose=False, backend=BACKEND, max_workers=1)
    concur = run_experiment(_spec(), verbose=False, backend=BACKEND, max_workers=3)
    assert [p.name for p in serial] == [p.name for p in concur]
    for a, b in zip(serial, concur):
        assert a.to_json() == b.to_json()


def test_process_executor_matches_serial_and_shares_cache(tmp_path):
    """Process-pool sweeps must be byte-identical to serial execution and
    populate the same on-disk cache (workers publish via atomic rename)."""
    cache = ProfileCache(str(tmp_path / "cache"))
    par = run_experiment(_spec(), verbose=False, backend=BACKEND, cache=cache,
                         executor="process", max_workers=3)
    assert cache.misses == 3 and cache.hits == 0
    ser = run_experiment(_spec(), verbose=False, backend=BACKEND, executor="serial")
    assert [p.name for p in par] == [p.name for p in ser]
    for a, b in zip(par, ser):
        assert a.to_json() == b.to_json()
    # a second process-pool run is served from the shared directory
    cache2 = ProfileCache(str(tmp_path / "cache"))
    again = run_experiment(_spec(), verbose=False, backend=BACKEND, cache=cache2,
                           executor="process", max_workers=3)
    assert cache2.hits == 3 and cache2.misses == 0
    for a, b in zip(par, again):
        assert a.to_json() == b.to_json()


def test_unknown_executor_rejected():
    import pytest
    with pytest.raises(ValueError):
        run_experiment(_spec(), verbose=False, backend=BACKEND, executor="gpu")


def _mini_profile(name):
    from repro_torch.core.profiler import CommProfile
    return CommProfile(name=name, n_ranks=2, meta={"pad": "x" * 512})


def test_cache_eviction_lru_by_mtime(tmp_path):
    import os
    root = str(tmp_path / "cache")
    entry = len(_mini_profile("p").to_json())
    # room for two entries, not three
    cache = ProfileCache(root, max_bytes=int(entry * 2.5))
    for i, key in enumerate(["k0", "k1", "k2"]):
        cache.put(key, _mini_profile(f"p{i}"))
        os.utime(cache._path(key), (1000.0 + i, 1000.0 + i))
    cache._evict()
    assert cache.get("k0") is None          # oldest mtime evicted
    assert cache.get("k1") is not None and cache.get("k2") is not None

    # a hit refreshes recency: k1 survives the next eviction, k2 does not
    os.utime(cache._path("k1"), (2000.0, 2000.0))
    os.utime(cache._path("k2"), (1500.0, 1500.0))
    cache.put("k3", _mini_profile("p3"))    # forces eviction down to cap
    assert cache.get("k2") is None
    assert cache.get("k1") is not None and cache.get("k3") is not None


def test_cache_cap_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv(runner.CACHE_MAX_BYTES_ENV, "12345")
    assert ProfileCache(str(tmp_path)).max_bytes == 12345
    monkeypatch.setenv(runner.CACHE_MAX_BYTES_ENV, "0")   # 0 disables the cap
    c = ProfileCache(str(tmp_path))
    c.put("k", _mini_profile("p"))
    c._evict()
    assert c.get("k") is not None


def test_default_cache_dir_env_override(monkeypatch):
    monkeypatch.setenv(runner.CACHE_DIR_ENV, "/tmp/some-shared-cache")
    assert runner.default_cache_dir() == "/tmp/some-shared-cache"
    monkeypatch.delenv(runner.CACHE_DIR_ENV)
    assert runner.default_cache_dir().endswith("repro-torch-profiles")


def test_out_dir_still_written_on_cache_hit(tmp_path):
    cache = ProfileCache(str(tmp_path / "cache"))
    run_experiment(_spec(), verbose=False, backend=BACKEND, cache=cache)
    out = tmp_path / "out"
    run_experiment(_spec(), out_dir=str(out), verbose=False, backend=BACKEND,
                   cache=cache)
    names = sorted(p.name for p in out.iterdir())
    assert names == ["kripke-cache-test-00002.json",
                     "kripke-cache-test-00004.json",
                     "kripke-cache-test-00008.json"]
