"""Scaling-study runner: materialize an ExperimentSpec into CommProfiles.

Profiles are trace-only (each app's per-rank program runs once on ``meta``
tensors, so no rank needs a device) and their traces are reduced on the
CUDA card by default, so paper-scale rank counts (64..512) and far beyond
run on one H100.  Each profile gets a roofline step-seconds estimate from
the app's arithmetic (compute+memory+wire over an H100 system model built
from datasheet values, not from measurements) so the §V bandwidth /
message-rate analysis has a time denominator.

Sweep-scalability features on top of the plain loop:

* **Content-addressed profile cache** (:class:`ProfileCache`): each scaling
  point is keyed by sha256 over (app, full config, decomposition, and a
  fingerprint of the profiling/app source code) and stored as CommProfile
  JSON.  Re-running a paper-scale sweep (64..512 ranks x 3 apps) loads
  from disk instead of re-tracing; editing any fingerprinted module
  invalidates every key, so stale profiles can never be served.  Writes are
  atomic (write-temp + rename), so one cache directory can be shared by
  any number of threads *and processes*; :func:`default_cache_dir` names
  the directory shared by the runner and the figure drivers of
  :mod:`repro_torch.figures`.  The cache is size-capped (LRU by file
  mtime, refreshed on every hit) — see :attr:`ProfileCache.max_bytes`.
* **Shared cache manifest** (:class:`CacheManifest`): one ``manifest.json``
  per cache directory accumulates exact hit/miss/put/eviction totals (and
  put/evicted byte counters) across every handle — including process-pool
  workers — so concurrent sweeps can report per-directory accounting
  instead of mirroring process-local counters.  Updates publish via
  write-temp + atomic rename, serialized by an ``O_CREAT|O_EXCL`` sidecar
  lock (stale locks from crashed holders are broken after a timeout), so
  no increment is ever lost.  The byte counters also *coordinate
  eviction*: only the handle whose put crossed
  ``REPRO_PROFILE_CACHE_MAX_BYTES`` pays the directory scan (see
  :meth:`ProfileCache.put`); every other concurrent writer skips it.
* **Concurrent scaling points**: independent points of a sweep trace under
  ``executor="thread"`` (recorder/topology state is thread-local, see
  ``repro_torch.core.regions`` / ``repro_torch.core.topology``) or ``"process"`` — a
  process pool sidesteps the GIL entirely since the columnar TraceBuffer
  and profiles pickle cheaply, giving true multi-core trace throughput;
  ``"serial"`` keeps the plain loop.  All three produce byte-identical
  profiles.
* **Aggregated sweep frames**: ``run_experiment(..., frame_csv=...)`` also
  emits the whole sweep as one NumPy-backed Thicket
  :class:`~repro_torch.core.thicket.Frame` CSV (one row per profile x region),
  the form the paper's scaling analysis consumes.
* **Live mode** (``run_experiment(..., live_dir=...)``): every traced point
  streams through the incremental profiler
  (:meth:`CommPatternProfiler.incremental
  <repro_torch.core.profiler.CommPatternProfiler.incremental>`) instead of the
  batch reduction, and the resulting mergeable summary deltas are
  published as shard files (atomic O_EXCL + rename, ``live_shards`` per
  point; cache hits publish their finished JSON as a single shard) that a
  concurrently running :class:`~repro_torch.benchpark.aggregator.SweepAggregator`
  merges and serves while the sweep is still in flight.  Live profiles are
  byte-identical to batch ones — the live smoke pass asserts it.
* **Backend resolved once, in the caller**: :func:`run_experiment`
  resolves the reduction backend before any point is submitted, so
  :class:`~repro_torch.core.backend.BackendUnavailable` (the default torch
  backend without a CUDA device) propagates under every executor instead
  of turning into retries and degraded placeholders; the resolved backend
  travels to every worker.
* **Supervised execution**: every scaling point runs under per-point
  timeouts (``REPRO_POINT_TIMEOUT_S``), bounded retries with exponential
  backoff + jitter (``REPRO_POINT_RETRIES`` / ``REPRO_RETRY_BACKOFF_S``),
  and automatic process-pool re-spawn after a ``BrokenProcessPool`` (a
  worker killed mid-point takes down the pool; the supervisor rebuilds it
  and resubmits the lost points).  A point that exhausts its retries is
  carried as an explicit **degraded placeholder** profile — zero regions,
  ``meta["degraded"] = True`` and ``meta["retries"]`` = attempts made —
  so downstream frames show the gap honestly (``meta_degraded`` /
  ``meta_retries`` columns) instead of fabricating zeros or crashing the
  sweep.  Points that succeed (first try or after retries) stay
  byte-identical to the fault-free serial run.
* **Checkpoint/resume** (``run_experiment(..., journal=...)``): completed
  point profiles are journaled through
  :class:`repro_torch.ckpt.manager.SweepJournal` (the checkpoint manager's
  atomic + checksummed publish idiom) as they finish, so a killed sweep
  restarted with the same journal re-traces only unfinished points —
  journal-resumed points generate *no* cache traffic at all (asserted via
  the manifest hit counters in tests).
* **Chaos testing**: the injection sites of
  :mod:`repro_torch.core.faultinject` are threaded through the worker entry
  (``worker_crash`` / ``slow_worker``), cache get/put
  (``cache_corrupt`` / ``cache_put``), and the manifest lock acquire
  (``lock_stale``), so a seeded ``REPRO_FAULT_SPEC`` exercises every
  supervision path deterministically.  Corrupt cache entries are
  quarantined to ``<cache>/quarantine/`` (manifest ``corrupt`` counter)
  and served as misses; stale manifest locks are expired after
  ``REPRO_MANIFEST_LOCK_TIMEOUT_S`` with takeover/generation counters.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import importlib
import json
import multiprocessing
import os
import random
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import asdict, is_dataclass
from typing import Optional

from repro_torch.benchpark.aggregator import publish_shard
from repro_torch.benchpark.spec import ExperimentSpec
from repro_torch.core.backend import ReduceBackend, resolve_backend, use_backend
from repro_torch.core.faultinject import (
    InjectedFault,
    active_plan,
    fault_context,
    fire_worker_faults,
    install_worker_plan,
    maybe_fault,
)
from repro_torch.core.profiler import CommPatternProfiler, CommProfile, trace_observer
from repro_torch.core.thicket import Frame

# The rank's system model: one NVIDIA H100 SXM5 per rank, datasheet values
# (not measurements).
#: dense BF16 tensor-core peak, FLOP/s (the datasheet's 1979e12 is with
#: 2:4 sparsity)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth, B/s
HBM_BW = 3.35e12
#: the rank's wire: one NDR 400 Gb/s InfiniBand port per GPU, as in a
#: DGX H100, B/s
LINK_BW = 50e9

#: Environment knobs for the shared profile cache.
CACHE_DIR_ENV = "REPRO_PROFILE_CACHE_DIR"
CACHE_MAX_BYTES_ENV = "REPRO_PROFILE_CACHE_MAX_BYTES"
_DEFAULT_CACHE_MAX_BYTES = 512 * 1024 * 1024

#: Supervision knobs (per-point timeout / bounded retries with backoff).
POINT_TIMEOUT_ENV = "REPRO_POINT_TIMEOUT_S"
POINT_RETRIES_ENV = "REPRO_POINT_RETRIES"
RETRY_BACKOFF_ENV = "REPRO_RETRY_BACKOFF_S"
_DEFAULT_RETRIES = 2
_DEFAULT_BACKOFF_S = 0.05

#: Stale manifest-lock expiry (seconds a dead holder's lock survives).
MANIFEST_LOCK_TIMEOUT_ENV = "REPRO_MANIFEST_LOCK_TIMEOUT_S"

#: Corrupt/torn files are moved here (a subdirectory of the owning cache
#: or shard directory) instead of being retried forever or crashing.
QUARANTINE_DIRNAME = "quarantine"
_QUARANTINE_KEEP = 64

#: Start method for ``executor="process"`` pools.  The stdlib default on
#: Linux is ``fork``, but by the time a sweep starts this process has
#: imported torch (a multithreaded runtime) and usually holds a CUDA
#: context, which does not survive a fork: a forked worker that touches
#: the card fails or hangs.  Workers rebuild all state from pickled args
#: and open their own CUDA context, so the start method cannot change
#: results — sweeps stay byte-identical to serial on every safe method.
POOL_START_METHOD_ENV = "REPRO_POOL_START_METHOD"


def _pool_mp_context():
    """Fork-safe multiprocessing context for process sweeps.

    Defaults to ``forkserver`` (workers fork from a clean server process
    that never touched the card); ``REPRO_POOL_START_METHOD`` overrides.
    ``fork`` raises ``ValueError``: a forked worker would inherit this
    process's CUDA state.  Unknown / unsupported names fall back to
    ``spawn`` — the portable always-safe method — rather than erroring.
    """
    name = (os.environ.get(POOL_START_METHOD_ENV) or "forkserver").strip()
    if name == "fork":
        raise ValueError(
            f"{POOL_START_METHOD_ENV}=fork is refused: CUDA does not survive "
            "a fork after it is initialised, and the sweep's parent may hold "
            "a CUDA context; use forkserver (the default) or spawn"
        )
    try:
        return multiprocessing.get_context(name)
    except ValueError:
        return multiprocessing.get_context("spawn")


def default_cache_dir() -> str:
    """The profile-cache directory shared by the runner and the figure
    drivers (override via ``REPRO_PROFILE_CACHE_DIR``).  It is not the JAX
    package's directory, so neither package's ``manifest.json`` counts the
    other's traffic."""
    env = os.environ.get(CACHE_DIR_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-torch-profiles")


def _flops_estimate(app: str, cfg) -> float:
    """Per-rank per-step useful FLOPs (napkin model)."""
    if app == "kripke":
        zones = cfg.nx * cfg.ny * cfg.nz
        ang = cfg.n_dirsets * cfg.n_groupsets * cfg.dirs_per_set * cfg.groups_per_set
        return 12.0 * zones * ang * cfg.n_octants
    if app == "amg":
        fine = cfg.nx * cfg.ny * cfg.nz
        sweeps = cfg.n_pre + cfg.n_post + 2
        return 8.0 * fine * sweeps * 1.15 * cfg.n_cycles  # + coarser levels
    if app == "laghos":
        lx, ly = cfg.local_shape
        return 40.0 * lx * ly * cfg.n_steps
    if app == "beatnik":
        return 30.0 * cfg.nx * cfg.ny * cfg.n_steps
    raise ValueError(app)


def _roofline_seconds(app: str, cfg, profile: CommProfile) -> float:
    flops = _flops_estimate(app, cfg)
    mem = flops * 2.0  # ~2 bytes/flop for stencil codes (bandwidth-bound)
    wire = (
        max((st.bytes_sent[1] + st.coll_bytes[1]) for st in profile.regions.values())
        if profile.regions
        else 0
    )
    return max(flops / PEAK_FLOPS, mem / HBM_BW, wire / LINK_BW)


# ---------------------------------------------------------------------------
# Content-addressed profile cache
# ---------------------------------------------------------------------------

#: Modules whose source participates in the cache key.  Any change to the
#: trace/profiling semantics or the app kernels changes the fingerprint and
#: therefore invalidates every cached profile.
_FINGERPRINT_MODULES = (
    "repro_torch.core.backend",
    "repro_torch.core.collectives",
    "repro_torch.core.compat",
    "repro_torch.core.profiler",
    "repro_torch.core.regions",
    "repro_torch.core.streaming",
    "repro_torch.core.topology",
    "repro_torch.apps.stencil",
    "repro_torch.apps.amg",
    "repro_torch.apps.beatnik",
    "repro_torch.apps.kripke",
    "repro_torch.apps.laghos",
)

_fingerprint_memo: dict = {}


def _code_fingerprint() -> str:
    """Joint sha256 of the profiling/app module sources (memoized)."""
    memo = _fingerprint_memo.get("fp")
    if memo is not None:
        return memo
    h = hashlib.sha256()
    for mod_name in _FINGERPRINT_MODULES:
        mod = importlib.import_module(mod_name)
        with open(mod.__file__, "rb") as f:
            h.update(f.read())
    _fingerprint_memo["fp"] = h.hexdigest()
    return _fingerprint_memo["fp"]


def _config_payload(cfg) -> dict:
    if is_dataclass(cfg):
        return asdict(cfg)
    return dict(vars(cfg))


def _truncate_file(path: str) -> None:
    """Tear ``path`` in place (drop its second half) — fault injection."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    except OSError:
        pass  # nothing on disk to corrupt


def _prune_quarantine(qdir: str, keep: int = _QUARANTINE_KEEP) -> None:
    """Bound quarantine retention: drop the oldest files beyond ``keep``."""
    try:
        names = os.listdir(qdir)
    except OSError:
        return
    if len(names) <= keep:
        return
    entries = []
    for fname in names:
        p = os.path.join(qdir, fname)
        try:
            entries.append((os.stat(p).st_mtime, p))
        except OSError:
            continue  # raced with another pruner
    entries.sort()
    for _, p in entries[: max(0, len(entries) - keep)]:
        try:
            os.remove(p)
        except OSError:
            pass


class CacheManifest:
    """Exact shared accounting for one cache directory (single JSON file).

    ``manifest.json`` holds counters
    ``{"hits", "misses", "puts", "evictions", "put_bytes", "evicted_bytes"}``
    covering *every* handle that ever touched the directory — threads and
    process-pool workers alike.  All are monotonic except
    ``evicted_bytes``, which an eviction scan adjusts by the *signed*
    drift between the counter estimate and the listed directory size, so
    ``put_bytes - evicted_bytes`` re-anchors to reality (never below it)
    after every scan (see :meth:`ProfileCache._evict`).
    :meth:`bump` serializes writers on an ``O_CREAT|O_EXCL`` sidecar lock
    and publishes the updated file via write-temp + atomic ``os.replace``,
    so concurrent increments are never lost and readers always see a
    consistent snapshot.  Locks left behind by crashed holders are broken
    after :attr:`STALE_LOCK_SECONDS` via an atomic rename, so exactly one
    waiter wins the break; a *live* holder stalled past that limit can
    momentarily lose exclusion (inherent to timeout-based lock breaking,
    and far beyond a bump's millisecond critical section), but the release
    path verifies lock ownership so the loss cannot cascade further.
    """

    FILENAME = "manifest.json"
    FIELDS = (
        "hits",
        "misses",
        "puts",
        "evictions",
        "put_bytes",
        "evicted_bytes",
        "corrupt",
        "lock_takeovers",
        "generation",
    )
    STALE_LOCK_SECONDS = 10.0

    def __init__(self, root: str, stale_lock_seconds: Optional[float] = None):
        self.root = str(root)
        self.path = os.path.join(self.root, self.FILENAME)
        self._lock_path = self.path + ".lock"
        if stale_lock_seconds is None:
            stale_lock_seconds = float(
                os.environ.get(MANIFEST_LOCK_TIMEOUT_ENV, self.STALE_LOCK_SECONDS)
            )
        #: Seconds after which a lock left by a dead holder is taken over
        #: (``REPRO_MANIFEST_LOCK_TIMEOUT_S``).  Too low risks breaking a
        #: *live* stalled holder; the release path's ownership check stops
        #: that loss from cascading either way.
        self.stale_lock_seconds = float(stale_lock_seconds)
        self._takeovers_unreported = 0
        self._tk_lock = threading.Lock()

    def read(self) -> dict:
        """Current totals (zeros when the manifest does not exist yet)."""
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            raw = {}
        return {k: int(raw.get(k, 0)) for k in self.FIELDS}

    def _acquire_lock(self) -> int:
        # chaos site: plant a pre-aged orphan lock (as if a previous
        # holder was SIGKILLed mid-critical-section) that this acquirer
        # must expire and take over through the normal path below.
        if maybe_fault("lock_stale", key=self.root) is not None:
            try:
                fd = os.open(
                    self._lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY
                )
                os.close(fd)
                old = time.time() - self.stale_lock_seconds - 1.0
                os.utime(self._lock_path, (old, old))
            except OSError:
                pass  # a real holder owns it right now: nothing to plant
        while True:
            try:
                return os.open(self._lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    age = time.time() - os.stat(self._lock_path).st_mtime
                except OSError:
                    continue  # holder released (or broke) it; retry open
                if age > self.stale_lock_seconds:
                    # Break a crashed holder by renaming the lock to a
                    # unique name first: rename is atomic, so exactly one
                    # breaker wins it (the losers see ENOENT and retry),
                    # and nobody can delete a lock a fresh holder just
                    # re-created.
                    stale = (
                        f"{self._lock_path}.stale"
                        f".{os.getpid()}.{threading.get_ident()}"
                    )
                    try:
                        os.rename(self._lock_path, stale)
                        os.remove(stale)
                    except OSError:
                        continue  # another breaker won the rename
                    # we won the break: report it through the next bump so
                    # the shared ``lock_takeovers`` counter stays exact
                    with self._tk_lock:
                        self._takeovers_unreported += 1
                    continue
                time.sleep(0.002)

    def _release_lock(self, fd: int) -> None:
        try:
            # Only remove the lock if it is still *ours*: a holder stalled
            # past STALE_LOCK_SECONDS may have had its lock broken, and
            # deleting the current holder's fresh lock would cascade the
            # mutual-exclusion loss to a third writer.
            if os.fstat(fd).st_ino == os.stat(self._lock_path).st_ino:
                os.remove(self._lock_path)
        except OSError:
            pass  # a stale-lock breaker beat us to it
        finally:
            os.close(fd)

    def bump(self, **deltas: int) -> dict:
        """Atomically add ``deltas`` to the shared counters.

        Returns the post-update totals snapshot — callers coordinating on
        a counter crossing (see :meth:`ProfileCache.put`) decide from this
        atomically-published value, so exactly one handle observes any
        given crossing.  Every publish also advances the ``generation``
        write-sequence counter, and any stale-lock takeovers this handle
        performed while acquiring are folded into ``lock_takeovers`` — so
        lock churn under fault injection is visible in the accounting.
        """
        os.makedirs(self.root, exist_ok=True)
        fd = self._acquire_lock()
        try:
            with self._tk_lock:
                takeovers, self._takeovers_unreported = (
                    self._takeovers_unreported,
                    0,
                )
            data = self.read()
            for k, v in deltas.items():
                data[k] = data.get(k, 0) + int(v)
            data["lock_takeovers"] = data.get("lock_takeovers", 0) + takeovers
            data["generation"] = data.get("generation", 0) + 1
            tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, sort_keys=True)
            os.replace(tmp, self.path)  # atomic publish
        finally:
            self._release_lock(fd)
        return data


class ProfileCache:
    """Content-addressed CommProfile store (one JSON file per key).

    The key covers app + full config + decomposition + code fingerprint;
    experiment *labels* (spec name, scaling kind, free-form meta) are
    deliberately excluded so identical physics shared between experiments
    (e.g. the (4,4,4) point of the dane and tioga kripke sweeps) hits the
    same entry — the runner re-stamps name/meta on every hit.

    Entries publish via write-temp + atomic rename, so a directory can be
    shared by concurrent threads and worker processes.  ``max_bytes`` caps
    the directory size: least-recently-used entries (by mtime; hits
    refresh it) are evicted until under the cap, and the scan is
    manifest-coordinated — only the handle whose put crossed the cap runs
    it (see :meth:`put`).  Default from ``REPRO_PROFILE_CACHE_MAX_BYTES``
    (<= 0 disables the cap).

    ``hits`` / ``misses`` count this handle's traffic only; the directory's
    exact cross-handle totals live in :attr:`manifest` (see
    :class:`CacheManifest`), which every get/put/eviction also updates.
    """

    def __init__(self, root: str, max_bytes: Optional[int] = None):
        self.root = str(root)
        if max_bytes is None:
            max_bytes = int(
                os.environ.get(CACHE_MAX_BYTES_ENV, _DEFAULT_CACHE_MAX_BYTES)
            )
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.manifest = CacheManifest(self.root)
        self._lock = threading.Lock()
        # First cap check of this handle: a pre-existing directory may
        # already sit above a (new or lowered) cap without any put ever
        # "crossing" it — the first over-cap observation scans once.
        self._synced = False

    def key(self, app: str, cfg, decomp) -> str:
        payload = {
            "app": app,
            "config": _config_payload(cfg),
            "decomp": list(decomp),
            "code": _code_fingerprint(),
        }
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def get(self, key: str) -> Optional[CommProfile]:
        """Load a cached profile; a corrupt entry is a quarantined miss.

        A truncated or otherwise unparsable entry (torn copy on a
        non-atomic filesystem, bit rot, fault injection) is **moved to
        ``quarantine/``** and counted in the manifest's ``corrupt``
        counter, then served as an ordinary miss — the sweep re-traces
        the point instead of dying on ``ValueError`` (and the poisoned
        file can never be served again, or retried forever).
        """
        path = self._path(key)
        if maybe_fault("cache_corrupt", key) is not None:
            _truncate_file(path)  # chaos: corrupt the entry on disk
        data = None
        try:
            with open(path) as f:
                data = f.read()
        except OSError:
            data = None  # absent (or unreadable): a plain miss
        prof = None
        corrupt = False
        if data is not None:
            try:
                prof = CommProfile.from_json(data)
            except (ValueError, KeyError, TypeError):
                corrupt = True
        if prof is None:
            if corrupt:
                self._quarantine(path)
                self.manifest.bump(misses=1, corrupt=1)
            else:
                self.manifest.bump(misses=1)
            with self._lock:
                self.misses += 1
            return None
        try:
            os.utime(path)  # LRU: a hit refreshes recency
        except OSError:
            pass
        with self._lock:
            self.hits += 1
        self.manifest.bump(hits=1)
        return prof

    def _quarantine(self, path: str) -> None:
        """Atomically move a corrupt entry aside (bounded retention)."""
        qdir = os.path.join(self.root, QUARANTINE_DIRNAME)
        try:
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(
                qdir,
                f"{os.path.basename(path)}.{os.getpid()}.{threading.get_ident()}",
            )
            os.replace(path, dest)
        except OSError:
            return  # a concurrent getter already moved (or removed) it
        _prune_quarantine(qdir)

    def put(self, key: str, profile: CommProfile) -> None:
        """Publish a profile; manifest-coordinated cap enforcement.

        Every put bumps the shared ``puts`` / ``put_bytes`` counters and
        reads back the atomically-published totals.  The directory size
        estimate is ``put_bytes - evicted_bytes`` (overwrites overcount —
        which only makes a scan fire early), and **only the handle whose
        put crossed a ``max_bytes`` boundary scans the directory**: the
        crossing is observed from the snapshot ``bump`` returns under the
        manifest lock, so among any number of threads and worker
        processes exactly one put sees the estimate pass any given cap
        multiple, and everyone else skips the O(entries) listdir
        entirely.  The winning scan re-anchors the estimate to the real
        directory size (see :meth:`_evict`), arming the next crossing.
        One exception keeps pre-existing oversized directories bounded:
        a handle's first put while the estimate already sits past its cap
        (cap lowered between runs, or differing caps across handles)
        scans once even though no crossing was observed.
        """
        if maybe_fault("cache_put", key) is not None:
            raise InjectedFault("cache_put", key)
        os.makedirs(self.root, exist_ok=True)
        path = self._path(key)
        data = profile.to_json()
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish
        fresh_manifest = not os.path.exists(self.manifest.path)
        totals = self.manifest.bump(puts=1, put_bytes=len(data))
        if self.max_bytes is None or self.max_bytes <= 0:
            return
        est_post = totals.get("put_bytes", 0) - totals.get("evicted_bytes", 0)
        est_pre = est_post - len(data)
        first_check = not self._synced
        self._synced = True
        # The put whose bytes crossed a cap *boundary* (any multiple of
        # max_bytes) scans: the first boundary is the cap itself, and the
        # multiples guarantee that even an estimate parked above the cap
        # (re-put overcounting, concurrent-scan races) arms exactly one
        # new scan per further cap-worth of put bytes — the estimate
        # never undercounts reality, so the directory is bounded by one
        # cap of transient overshoot.  Two safety valves on a handle's
        # first capped put cover counter drift a boundary can't: an
        # estimate already past the cap scans once (cap lowered between
        # runs, mixed-cap handles), and the writer that found no manifest
        # at all scans once (reset/removed manifest over a directory that
        # may still hold entries — the scan re-anchors the estimate to
        # the real size, in either direction).
        if est_pre // self.max_bytes < est_post // self.max_bytes or (
            first_check and (est_post > self.max_bytes or fresh_manifest)
        ):
            self._evict()

    def _evict(self) -> None:
        """Drop least-recently-used entries until under ``max_bytes``.

        Also re-anchors the shared size estimate: after the scan the real
        directory total is known, so any drift accumulated by monotonic
        ``put_bytes`` over-counting (overwrites) is folded into
        ``evicted_bytes`` — the estimate tracks reality and the next cap
        crossing is again observed by exactly one handle.
        """
        if self.max_bytes is None or self.max_bytes <= 0:
            return
        # Snapshot the counters BEFORE listing: the fold below then makes
        # the post-scan estimate exactly (listed total + bytes put since
        # the snapshot) — greater than or equal to the real directory
        # size, so estimate error is always on the safe (early-rescan)
        # side and never disables future crossings.
        snapshot = self.manifest.read()
        entries = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for fname in names:
            if not fname.endswith(".json") or fname == CacheManifest.FILENAME:
                continue
            p = os.path.join(self.root, fname)
            try:
                st = os.stat(p)
            except OSError:
                continue  # raced with another evictor
            entries.append((st.st_mtime, st.st_size, p))
        total = sum(size for _, size, _ in entries)
        evicted = 0
        if total > self.max_bytes:
            for _, size, p in sorted(entries):  # oldest mtime first
                try:
                    os.remove(p)
                except OSError:
                    continue
                evicted += 1
                total -= size
                if total <= self.max_bytes:
                    break
        # Exact re-anchor: fold the *signed* difference between the
        # snapshot estimate and the listed post-eviction total.  Positive
        # fold credits our removals plus any overcount; a negative fold
        # (manifest undercounting reality, e.g. after a reset) raises the
        # estimate back up to the real size.  Clamping here would leave
        # evicted bytes uncredited and latch the crossing trigger off.
        fold = snapshot.get("put_bytes", 0) - snapshot.get("evicted_bytes", 0) - total
        if evicted or fold:
            self.manifest.bump(evictions=evicted, evicted_bytes=fold)


# ---------------------------------------------------------------------------
# Sweep execution
# ---------------------------------------------------------------------------


def point_key(spec: ExperimentSpec, pt) -> str:
    """Shard/aggregator key for one scaling point (zero-padded rank order)."""
    return f"{spec.name}-{pt.n_ranks:05d}"


def _make_live_observer(holder: dict, live_shards: int):
    """A :func:`trace_observer` hook routing the trace through the
    incremental profiler: the recorder is consumed in ``live_shards``
    watermark deltas whose mergeable summaries land in ``holder`` for
    publication (after the roofline stamp), and the *streamed* profile is
    returned as the point's result — so live mode genuinely exercises the
    watermark/merge machinery rather than the batch reduction."""

    def observer(rec, *, name, replication, meta):
        sp = CommPatternProfiler.incremental(rec)
        n = rec.buffer.n_rows
        chunks = max(1, int(live_shards))
        deltas = [sp.update((n * (i + 1)) // chunks) for i in range(chunks)]
        tail = sp.update()  # boundary-row growth / late instance entries
        if tail.regions or tail.instances or tail.n_events:
            deltas.append(tail)
        holder["deltas"] = deltas
        holder["replication"] = replication
        return sp.profile(
            name=name, replication=replication, meta=meta, update=False
        )

    return observer


def app_profile_fns() -> dict:
    """``{app_name: profile_fn}`` for every benchpark app (lazy import —
    shared by the sweep runner and the figure drivers that re-trace single
    points, e.g. :mod:`repro_torch.figures.fig8_halo_heatmap`)."""
    from repro_torch.apps import amg, beatnik, kripke, laghos

    return {
        "kripke": kripke.profile,
        "amg": amg.profile,
        "laghos": laghos.profile,
        "beatnik": beatnik.profile,
    }


def _trace_point(
    spec: ExperimentSpec,
    pt,
    cfg,
    cache: Optional[ProfileCache],
    verbose: bool,
    backend: Optional[ReduceBackend] = None,
    live_dir: Optional[str] = None,
    live_shards: int = 4,
    attempt: int = 0,
    _crash_safe: bool = False,
) -> tuple:
    """Profile (or cache-load) one scaling point.

    Module-level so it pickles into process-pool workers; ``cache``
    hit/miss counters are handle-local, the backing directory and its
    manifest are shared.  ``backend`` is the reduction backend for the
    trace, already resolved by :func:`run_experiment` (installed
    thread-locally via ``use_backend``, so it holds inside pool workers
    without changing the app ``profile()`` signatures; a pickled
    ``TorchBackend`` opens the worker's own CUDA context on first use).
    ``live_dir`` switches the point to the incremental profiler and
    publishes its summary deltas as ``live_shards`` shard files for a
    concurrent :class:`~repro_torch.benchpark.aggregator.SweepAggregator`
    (cache hits publish their finished JSON as one shard).

    The whole body runs under a :func:`fault_context` carrying
    ``<point-key>#a<attempt>``, so every nested injection site (cache
    get/put, manifest lock, shard publish, spill) keys its draws by point
    and attempt — a retried attempt sees an independent, reproducible
    fault schedule.  ``_crash_safe`` marks process-pool workers, where a
    ``worker_crash@hard`` rule may ``os._exit`` instead of raising.
    Returns ``(pt, profile, cached)``.
    """
    point = point_key(spec, pt)
    with fault_context(f"{point}#a{attempt}|"):
        fire_worker_faults(point, crash_safe=_crash_safe)
        profile_fns = app_profile_fns()
        meta = {
            "app": spec.app,
            "scaling": spec.scaling,
            "experiment": spec.name,
            "decomp": list(pt.decomp),
            "system": spec.system,
        }
        key = cache.key(spec.app, cfg, pt.decomp) if cache else None
        prof = cache.get(key) if cache else None
        cached = prof is not None
        holder: dict = {}
        if cached:
            # identical physics, this experiment's labels
            prof.name = f"{spec.name}-{pt.n_ranks}"
            prof.meta = meta
        else:
            ctx = use_backend(backend) if backend is not None else nullcontext()
            obs = (
                trace_observer(_make_live_observer(holder, live_shards))
                if live_dir
                else nullcontext()
            )
            with ctx, obs:
                prof = profile_fns[spec.app](
                    cfg, name=f"{spec.name}-{pt.n_ranks}", meta=meta
                )
        prof.meta["seconds"] = _roofline_seconds(spec.app, cfg, prof)
        if live_dir:
            # Publish only after the roofline stamp so shard meta finalizes
            # to exactly the batch pipeline's profile bytes.
            deltas = holder.get("deltas")
            if deltas is None:  # cache hit (or an app bypassing tracing)
                publish_shard(
                    live_dir,
                    point=point,
                    seq=0,
                    total=1,
                    profile_json=prof.to_json(),
                    name=prof.name,
                    meta=prof.meta,
                )
            else:
                for i, delta in enumerate(deltas):
                    publish_shard(
                        live_dir,
                        point=point,
                        seq=i,
                        total=len(deltas),
                        summary=delta,
                        name=prof.name,
                        replication=holder["replication"],
                        meta=prof.meta,
                    )
        if cache and not cached:
            cache.put(key, prof)
    if verbose:  # stream progress as points finish
        tot = sum(s.total_bytes_sent for s in prof.regions.values())
        tag = " [cached]" if cached else ""
        print(
            f"  {spec.name} @ {pt.n_ranks:4d} ranks: "
            f"{len(prof.regions)} regions, "
            f"{tot:.3e} bytes sent{tag}",
            flush=True,
        )
    return pt, prof, cached


def _trace_point_in_worker(args) -> tuple:
    """Process-pool entry: rebuild a cache handle on the shared directory.

    The sweep's fault spec/seed travel in the pickled args (environment
    changes do not reliably reach warm forkserver workers) and install
    idempotently, so one warm worker serving many tasks keeps a single
    plan instance whose ``n``-rule budgets span the whole sweep.
    """
    (
        spec,
        pt,
        cfg,
        cache_root,
        max_bytes,
        verbose,
        backend,
        live_dir,
        live_shards,
        attempt,
        fault_spec,
        fault_seed,
    ) = args
    install_worker_plan(fault_spec, fault_seed)
    cache = ProfileCache(cache_root, max_bytes) if cache_root else None
    return _trace_point(
        spec,
        pt,
        cfg,
        cache,
        verbose,
        backend,
        live_dir,
        live_shards,
        attempt=attempt,
        _crash_safe=True,
    )


# ---------------------------------------------------------------------------
# Supervision: retry log, degraded placeholders, the supervised map
# ---------------------------------------------------------------------------


class RetryLog:
    """Append-only record of supervision events (retries, timeouts, pool
    deaths, degradations) — in memory, and mirrored to a JSONL file when
    constructed with a ``path`` (the chaos smoke keeps it as an
    artifact)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: list = []
        self._lock = threading.Lock()
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)

    def add(self, point: str, attempt: int, kind: str, error="") -> None:
        ev = {
            "point": point,
            "attempt": int(attempt),
            "kind": kind,
            "error": str(error)[:500],
            "t": time.time(),
        }
        with self._lock:
            self.events.append(ev)
            if self.path:
                try:
                    with open(self.path, "a") as f:
                        f.write(json.dumps(ev, sort_keys=True) + "\n")
                except OSError:
                    pass  # logging must never take the sweep down


def _degraded_profile(spec: ExperimentSpec, pt, attempts: int, error) -> CommProfile:
    """Explicit placeholder for a point that exhausted its retries.

    Zero regions — downstream frames carry the row with
    ``meta_degraded`` / ``meta_retries`` and *masked* stats columns, so
    the gap is visible instead of papered over with fabricated zeros.  No
    roofline ``seconds`` is stamped either: an estimate for a point that
    never traced would be exactly the fabricated data this path exists to
    avoid.
    """
    return CommProfile(
        name=f"{spec.name}-{pt.n_ranks}",
        n_ranks=pt.n_ranks,
        regions={},
        meta={
            "app": spec.app,
            "scaling": spec.scaling,
            "experiment": spec.name,
            "decomp": list(pt.decomp),
            "system": spec.system,
            "degraded": True,
            "retries": int(attempts),
            "error": str(error)[:300],
        },
    )


def _drain_pool(ex, force: bool) -> None:
    """Shut an executor down; ``force`` abandons queued/running work
    (and terminates process-pool workers so an abandoned hung task cannot
    block interpreter exit)."""
    if force:
        ex.shutdown(wait=False, cancel_futures=True)
        procs = getattr(ex, "_processes", None) or {}
        for p in list(procs.values()):
            try:
                p.terminate()
            except Exception:
                pass
    else:
        ex.shutdown(wait=True)


def _supervised_map(
    indices,
    make_executor,
    submit_one,
    *,
    timeout_s: Optional[float],
    retries: int,
    backoff_s: float,
    retry_log: RetryLog,
    point_name,
    make_degraded,
    on_result,
) -> dict:
    """Run ``submit_one(ex, idx, attempt)`` for every index under
    supervision; returns ``{idx: result}`` with **every** index present.

    The contract that makes chaos survivable:

    * a task *running* longer than ``timeout_s`` is abandoned (its
      eventual result is ignored; publishes are idempotent) and the point
      retries — the clock starts when the pool begins executing the task,
      so queueing and worker cold-start (a respawned forkserver pool
      imports the world before its first task) don't count against the
      point;
    * a task raising anything retries with exponential backoff + jitter,
      up to ``retries`` extra attempts, then degrades via
      ``make_degraded(idx, attempts, kind, err)``;
    * a dead pool (``BrokenProcessPool`` — e.g. a hard-killed worker)
      charges an attempt to every in-flight point (so respawns are
      bounded by the total retry budget) and is rebuilt;
    * termination is guaranteed: every attempt either completes, times
      out, or dies with the pool, and attempts per point are bounded.

    ``on_result`` fires exactly once per index as its result lands
    (success or degraded) — the journal hook, so a kill mid-sweep keeps
    every point finished so far.
    """
    out: dict = {}
    inflight: dict = {}  # future -> (idx, attempt, deadline)
    delayed: list = []  # (ready_t, idx, next_attempt)
    abandoned = False
    ex = make_executor()

    def record(idx, res):
        out[idx] = res
        on_result(idx, res)

    def failed(idx, attempt, kind, err):
        retry_log.add(point_name(idx), attempt, kind, err)
        if attempt < retries:
            delay = backoff_s * (2.0**attempt) * (1.0 + 0.25 * random.random())
            delayed.append((time.monotonic() + delay, idx, attempt + 1))
        else:
            record(idx, make_degraded(idx, attempt + 1, kind, err))

    def launch(idx, attempt):
        fut = submit_one(ex, idx, attempt)
        # deadline None = not observed running yet (clock not started);
        # without a timeout the deadline is simply never
        inflight[fut] = (idx, attempt, None if timeout_s else float("inf"))

    try:
        for idx in indices:
            launch(idx, 0)
        while inflight or delayed:
            now = time.monotonic()
            if delayed:
                due = [d for d in delayed if d[0] <= now]
                if due:
                    delayed[:] = [d for d in delayed if d[0] > now]
                    for _, idx, attempt in due:
                        launch(idx, attempt)
            if not inflight:  # only backoff waits remain
                time.sleep(
                    max(0.0, min(d[0] for d in delayed) - time.monotonic())
                )
                continue
            if timeout_s:
                # start the clock for tasks the pool has picked up
                for fut, (idx, attempt, dl) in list(inflight.items()):
                    if dl is None and (fut.running() or fut.done()):
                        inflight[fut] = (idx, attempt, now + timeout_s)
            dls = [dl for (_, _, dl) in inflight.values()]
            horizon = min(
                [dl for dl in dls if dl is not None]
                + [d[0] for d in delayed]
                + [float("inf")]
            )
            if any(dl is None for dl in dls):
                horizon = min(horizon, now + 0.05)  # poll for run-start
            wait_s = (
                None
                if horizon == float("inf")
                else max(0.0, horizon - time.monotonic()) + 0.01
            )
            done, _ = cf.wait(
                list(inflight), timeout=wait_s, return_when=cf.FIRST_COMPLETED
            )
            broken = False
            for fut in done:
                idx, attempt, _ = inflight.pop(fut)
                try:
                    res = fut.result()
                except cf.BrokenExecutor as e:
                    broken = True
                    failed(idx, attempt, "pool_broken", e)
                except Exception as e:
                    failed(idx, attempt, "error", e)
                else:
                    record(idx, res)
            if broken:
                # the dead pool takes every in-flight future with it:
                # charge each an attempt (bounds respawns by the total
                # retry budget) and rebuild the pool for the retries
                for _, (idx, attempt, _) in list(inflight.items()):
                    failed(idx, attempt, "pool_broken", "pool died")
                inflight.clear()
                _drain_pool(ex, force=True)
                ex = make_executor()
                continue
            now = time.monotonic()
            timed_out = [
                (fut, v)
                for fut, v in inflight.items()
                if v[2] is not None and v[2] <= now
            ]
            if timed_out:
                for fut, (idx, attempt, _) in timed_out:
                    del inflight[fut]
                    fut.cancel()
                    failed(idx, attempt, "timeout", f"exceeded {timeout_s}s")
                # A timed-out task may be hung *inside* a worker, where it
                # would keep absorbing pool capacity and queue every retry
                # behind itself (so the retries would "time out" too,
                # having never run).  Abandon the whole pool — terminating
                # process workers, orphaning thread ones — and resubmit
                # the unaffected in-flight attempts with fresh deadlines;
                # re-runs are safe (publishes are idempotent, tracing is
                # deterministic) and rebuilds are bounded because every
                # one charges at least one point an attempt.
                survivors = list(inflight.values())
                inflight.clear()
                _drain_pool(ex, force=True)
                abandoned = True  # orphaned tasks may still be running
                ex = make_executor()
                for idx, attempt, _ in survivors:
                    launch(idx, attempt)
    finally:
        _drain_pool(ex, force=abandoned)
    return out


def run_experiment(
    spec: ExperimentSpec,
    out_dir: Optional[str] = None,
    verbose: bool = True,
    *,
    cache: Optional[ProfileCache] = None,
    cache_dir: Optional[str] = None,
    max_workers: Optional[int] = None,
    executor: str = "thread",
    frame_csv: Optional[str] = None,
    backend=None,
    live_dir: Optional[str] = None,
    live_shards: int = 4,
    point_timeout_s: Optional[float] = None,
    retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
    journal=None,
    retry_log: Optional[RetryLog] = None,
) -> list:
    """Profile every scaling point of ``spec`` (cached + concurrent +
    supervised).

    ``cache`` / ``cache_dir``: enable the content-addressed profile cache
    (``cache`` wins if both are given).  ``executor``: ``"thread"``
    (default), ``"process"`` (true multi-core tracing; the columnar trace
    buffers and profiles pickle cheaply, workers share the cache directory
    and its manifest via atomic renames), or ``"serial"``.
    ``max_workers``: pool width for independent points; defaults to
    min(4, n_points).  ``frame_csv``: also write the sweep as one
    aggregated Thicket-frame CSV (one row per profile x region).
    ``backend``: reduction backend (name or instance) for every traced
    point (see ``repro_torch.core.backend``; default resolves from a
    ``use_backend`` scope, then ``REPRO_BACKEND``, then torch on the CUDA
    card) — all backends produce byte-identical profiles.  It is resolved
    here, once, before any point runs: without a CUDA device the default
    raises :class:`~repro_torch.core.backend.BackendUnavailable` under
    every executor (never a sweep of degraded placeholders), and the
    resolved instance travels to every worker.  ``live_dir`` enables live
    mode: each point is profiled incrementally and its mergeable summary
    deltas (``live_shards`` per traced point) are published to that
    directory for a concurrent
    :class:`~repro_torch.benchpark.aggregator.SweepAggregator`; returned
    profiles stay byte-identical to batch mode.

    Supervision (see the module docstring): ``point_timeout_s`` /
    ``retries`` / ``backoff_s`` default from ``REPRO_POINT_TIMEOUT_S`` /
    ``REPRO_POINT_RETRIES`` / ``REPRO_RETRY_BACKOFF_S``; a point that
    exhausts its attempts is returned as a degraded placeholder (never an
    exception, never a fabricated profile).  The per-point timeout
    applies to pool executors only — a serial in-process call cannot be
    preempted, so ``"serial"`` honors retries/backoff but not the
    timeout.  The clock starts when the pool reports the task running;
    that is exact for ``"thread"``, but a process pool marks tasks
    running at dispatch, so for ``"process"`` choose a timeout that
    comfortably exceeds worker cold-start (a respawned worker imports
    the tracing stack before its first task) — a too-tight timeout
    degrades points that merely started slowly.  ``journal`` (a directory path or a
    :class:`repro_torch.ckpt.manager.SweepJournal`) enables checkpoint/resume:
    completed points are journaled as they finish and a rerun re-traces
    only the missing ones (journal-resumed points touch neither the cache
    nor the shard directory — their shards were published by the run that
    completed them).  ``retry_log`` collects supervision events
    (:class:`RetryLog`; pass one with a ``path`` to mirror to JSONL).

    Results keep the spec's point order regardless of completion order;
    all executors produce byte-identical profiles, and a point that
    succeeds after retries is byte-identical to a fault-free run.
    """
    if executor not in ("thread", "process", "serial"):
        raise ValueError(f"unknown executor: {executor!r}")
    # Once, in the caller: the supervisor below turns a point's exception
    # into retries and then a degraded placeholder, so a missing card must
    # raise here instead of hiding behind a sweep of placeholders.
    backend = resolve_backend(backend)
    if cache is None and cache_dir is not None:
        cache = ProfileCache(cache_dir)
    if point_timeout_s is None:
        env = os.environ.get(POINT_TIMEOUT_ENV)
        point_timeout_s = float(env) if env else None
    if retries is None:
        retries = int(os.environ.get(POINT_RETRIES_ENV, _DEFAULT_RETRIES))
    if backoff_s is None:
        backoff_s = float(os.environ.get(RETRY_BACKOFF_ENV, _DEFAULT_BACKOFF_S))
    if retry_log is None:
        retry_log = RetryLog()
    if isinstance(journal, str):
        from repro_torch.ckpt.manager import SweepJournal

        journal = SweepJournal(journal)

    points = spec.configs()
    if max_workers is None:
        max_workers = min(4, len(points)) or 1

    # -- checkpoint/resume: journal-resumed points skip execution entirely
    results: list = [None] * len(points)
    todo = []
    completed_keys = set(journal.completed()) if journal is not None else set()
    for i, (pt, cfg) in enumerate(points):
        if point_key(spec, pt) in completed_keys:
            payload = journal.load(point_key(spec, pt))
            prof = None
            if payload is not None:
                try:
                    prof = CommProfile.from_json(payload)
                except (ValueError, KeyError, TypeError):
                    prof = None  # torn record: redo the point
            if prof is not None:
                results[i] = (pt, prof, None)  # None: no cache traffic
                if verbose:
                    print(
                        f"  {spec.name} @ {pt.n_ranks:4d} ranks: [journal]",
                        flush=True,
                    )
                continue
        todo.append(i)

    def on_result(i, res):
        _, prof, _ = res
        if journal is not None and not prof.meta.get("degraded"):
            journal.record(point_key(spec, points[i][0]), prof.to_json())

    def degraded(i, attempts, kind, err):
        pt = points[i][0]
        if verbose:
            print(
                f"  {spec.name} @ {pt.n_ranks:4d} ranks: DEGRADED "
                f"after {attempts} attempts ({kind})",
                flush=True,
            )
        # cached=None: no (known) cache traffic to mirror for this point
        return pt, _degraded_profile(spec, pt, attempts, f"{kind}: {err}"), None

    plan = active_plan()
    fault_spec = plan.spec if plan is not None else None
    fault_seed = plan.seed if plan is not None else 0

    concurrent = executor != "serial" and max_workers > 1 and len(todo) > 1

    if concurrent and executor == "process":

        def make_executor():
            return ProcessPoolExecutor(
                max_workers=max_workers, mp_context=_pool_mp_context()
            )

        def submit_one(ex, i, attempt):
            pt, cfg = points[i]
            return ex.submit(
                _trace_point_in_worker,
                (
                    spec,
                    pt,
                    cfg,
                    cache.root if cache else None,
                    cache.max_bytes if cache else None,
                    verbose,
                    backend,
                    live_dir,
                    live_shards,
                    attempt,
                    fault_spec,
                    fault_seed,
                ),
            )

        done = _supervised_map(
            todo,
            make_executor,
            submit_one,
            timeout_s=point_timeout_s,
            retries=retries,
            backoff_s=backoff_s,
            retry_log=retry_log,
            point_name=lambda i: point_key(spec, points[i][0]),
            make_degraded=degraded,
            on_result=on_result,
        )
        for i, res in done.items():
            results[i] = res
        if cache:
            # mirror worker-local counters so caller-visible accounting
            # matches thread/serial execution (the directory manifest
            # holds the exact cross-process totals); degraded points
            # (cached=None) had their traffic counted by the workers that
            # attempted them, which this handle cannot see
            for i in todo:
                cached = results[i][2]
                if cached is True:
                    cache.hits += 1
                elif cached is False:
                    cache.misses += 1
    elif concurrent:

        def submit_one(ex, i, attempt):
            pt, cfg = points[i]
            return ex.submit(
                _trace_point,
                spec,
                pt,
                cfg,
                cache,
                verbose,
                backend,
                live_dir,
                live_shards,
                attempt,
            )

        done = _supervised_map(
            todo,
            lambda: ThreadPoolExecutor(max_workers=max_workers),
            submit_one,
            timeout_s=point_timeout_s,
            retries=retries,
            backoff_s=backoff_s,
            retry_log=retry_log,
            point_name=lambda i: point_key(spec, points[i][0]),
            make_degraded=degraded,
            on_result=on_result,
        )
        for i, res in done.items():
            results[i] = res
    else:
        for i in todo:
            pt, cfg = points[i]
            attempt = 0
            while True:
                try:
                    res = _trace_point(
                        spec,
                        pt,
                        cfg,
                        cache,
                        verbose,
                        backend,
                        live_dir,
                        live_shards,
                        attempt=attempt,
                    )
                except Exception as e:
                    retry_log.add(point_key(spec, pt), attempt, "error", e)
                    if attempt >= retries:
                        res = degraded(i, attempt + 1, "error", e)
                    else:
                        attempt += 1
                        time.sleep(
                            backoff_s
                            * (2.0 ** (attempt - 1))
                            * (1.0 + 0.25 * random.random())
                        )
                        continue
                break
            results[i] = res
            on_result(i, res)

    profiles = []
    for pt, prof, _ in results:
        profiles.append(prof)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            prof.save(os.path.join(out_dir, f"{spec.name}-{pt.n_ranks:05d}.json"))
    if frame_csv:
        parent = os.path.dirname(frame_csv)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(frame_csv, "w") as f:
            f.write(Frame.from_profiles(profiles).to_csv())
    return profiles
