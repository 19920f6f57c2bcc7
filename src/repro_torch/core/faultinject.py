"""Deterministic, seeded fault injection for the sweep substrate.

The paper's scaling curves are only trustworthy if every point survives
node flakiness — so the distributed pieces of this reproduction (the
process-pool sweep runner, the shard-publishing live aggregator, the
manifest-locked profile cache, the mmap spill pool) are each threaded
with an *injection site*: a named choke point that consults the active
:class:`FaultPlan` and, when a rule fires, simulates the corresponding
infrastructure failure (a crashing worker, a torn shard file, a corrupt
cache entry, a stale manifest lock, a slow node, a failing spill disk).
The supervision layers built around those sites (see
``repro_torch.benchpark.runner``) then have something adversarial to survive —
Beatnik-style chaos for the *failure* domain instead of the
communication domain.

Fault specs
-----------

A spec is a ``;``-separated list of rules, each ``site`` optionally
followed by ``@`` and a ``,``-separated parameter list::

    worker_crash@p=0.2;shard_torn@n=3;cache_corrupt@key~kripke;lock_stale;slow_worker@s=5

Parameters:

``p=<float>``
    Fire each eligible check independently with probability ``p``.  The
    draw is a pure function of ``(seed, site, key, draw-index)`` — same
    spec + seed + call sequence, same schedule.
``n=<int>``
    Fire the first ``n`` eligible checks seen by this plan instance (a
    per-process budget).  A rule with neither ``p`` nor ``n`` defaults to
    ``n=1``.
``key~<substring>``
    Only checks whose key contains ``substring`` are eligible.  Runner
    sites key checks by ``<point-key>#a<attempt>`` (see
    :func:`fault_context`), so ``key~kripke-weak-dane-00256#a0`` pins a
    fault to one point's first attempt.
``s=<float>``
    Seconds to sleep when a ``slow_worker`` rule fires.
``hard`` / ``hard=1``
    A ``worker_crash`` rule kills the worker process outright
    (``os._exit``) instead of raising :class:`InjectedFault` — but only
    at sites that declare themselves crash-safe (process-pool workers);
    in-process executors always get the exception form.

Sites
-----

========================  ====================================================
``worker_crash``          sweep worker entry (``runner._trace_point``)
``slow_worker``           sweep worker entry — sleeps ``s`` seconds
``cache_corrupt``         ``ProfileCache.get`` — truncates the entry on disk
``cache_put``             ``ProfileCache.put`` — raises before publishing
``lock_stale``            ``CacheManifest._acquire_lock`` — plants a
                          pre-aged orphan lock the acquirer must take over
``shard_torn``            ``publish_shard`` — writes a truncated shard file
``shard_ingest``          ``SweepAggregator.ingest`` — fails one load
``spill_torn``            ``regions._SpillPool.allocate`` — raises OSError
========================  ====================================================

The active plan resolves from ``REPRO_FAULT_SPEC`` / ``REPRO_FAULT_SEED``
(or an explicitly installed plan, see :func:`install_plan`); with no spec
every site is a no-op costing one dict lookup.  Worker processes receive
the spec/seed through their pickled task args (environment propagation
through a warm forkserver is unreliable), so a plan travels with the
sweep that configured it.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

FAULT_SPEC_ENV = "REPRO_FAULT_SPEC"
FAULT_SEED_ENV = "REPRO_FAULT_SEED"

#: Every legal injection site.  Parsing rejects unknown names: a typo in a
#: chaos spec must fail loudly, not silently inject nothing.
SITES = frozenset(
    {
        "worker_crash",
        "slow_worker",
        "cache_corrupt",
        "cache_put",
        "lock_stale",
        "shard_torn",
        "shard_ingest",
        "spill_torn",
    }
)


class InjectedFault(RuntimeError):
    """An injected infrastructure failure (never a real one)."""

    def __init__(self, site: str, key: str = ""):
        super().__init__(f"injected fault: {site} @ {key or '<any>'}")
        self.site = site
        self.key = key


@dataclass
class FaultRule:
    """One parsed rule of a fault spec."""

    site: str
    p: Optional[float] = None
    n: Optional[int] = None
    key_substr: Optional[str] = None
    seconds: float = 0.0
    hard: bool = False
    fired: int = 0  # per-plan-instance fire count (bounds n-rules)

    def spec(self) -> str:
        parts = []
        if self.p is not None:
            parts.append(f"p={self.p:g}")
        if self.n is not None:
            parts.append(f"n={self.n}")
        if self.key_substr is not None:
            parts.append(f"key~{self.key_substr}")
        if self.seconds:
            parts.append(f"s={self.seconds:g}")
        if self.hard:
            parts.append("hard=1")
        return self.site + (f"@{','.join(parts)}" if parts else "")


def _draw(seed: int, site: str, key: str, idx: int) -> float:
    """Deterministic uniform in [0, 1): pure function of its arguments."""
    blob = f"{seed}|{site}|{key}|{idx}".encode()
    h = hashlib.sha256(blob).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclass
class FaultEvent:
    """One fired fault, for logs and assertions."""

    site: str
    key: str
    rule: str
    t: float = field(default_factory=time.monotonic)


class FaultPlan:
    """A parsed fault spec plus its per-process firing state.

    ``check(site, key)`` is the decision procedure sites call through
    :func:`maybe_fault`; it returns the fired :class:`FaultRule` or
    ``None`` and appends a :class:`FaultEvent` on fire.  Probability
    rules draw deterministically from ``(seed, site, key, draw-index)``
    where the draw index counts prior checks of the same ``(site, key)``
    in this process — so a retried point (whose key carries the attempt
    number) sees an independent, reproducible draw per attempt.
    """

    def __init__(self, rules: list, seed: int = 0, spec: str = ""):
        self.rules = list(rules)
        self.seed = int(seed)
        self.spec = spec or ";".join(r.spec() for r in self.rules)
        self.events: list = []
        self._by_site: dict = {}
        for r in self.rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._draw_idx: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def parse(spec: str, seed: int = 0) -> "FaultPlan":
        rules = []
        for chunk in (spec or "").split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            site, _, params = chunk.partition("@")
            site = site.strip()
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (valid: {sorted(SITES)})"
                )
            rule = FaultRule(site=site)
            for param in params.split(","):
                param = param.strip()
                if not param:
                    continue
                if "~" in param:
                    k, _, v = param.partition("~")
                    if k.strip() != "key":
                        raise ValueError(f"unknown fault filter {param!r}")
                    rule.key_substr = v
                elif "=" in param:
                    k, _, v = param.partition("=")
                    k = k.strip()
                    if k == "p":
                        rule.p = float(v)
                    elif k == "n":
                        rule.n = int(v)
                    elif k == "s":
                        rule.seconds = float(v)
                    elif k == "hard":
                        rule.hard = v.strip() not in ("0", "false", "")
                    else:
                        raise ValueError(f"unknown fault parameter {k!r}")
                elif param == "hard":
                    rule.hard = True
                else:
                    raise ValueError(f"unknown fault parameter {param!r}")
            rules.append(rule)
        return FaultPlan(rules, seed=seed, spec=spec)

    def check(self, site: str, key: str = "") -> Optional[FaultRule]:
        rules = self._by_site.get(site)
        if not rules:
            return None
        full_key = f"{fault_context()}{key}"
        for rule in rules:
            if rule.key_substr is not None and rule.key_substr not in full_key:
                continue
            with self._lock:
                if rule.p is not None:
                    idx = self._draw_idx.get((site, full_key), 0)
                    self._draw_idx[(site, full_key)] = idx + 1
                    fire = _draw(self.seed, site, full_key, idx) < rule.p
                else:
                    fire = rule.fired < (rule.n if rule.n is not None else 1)
                if fire:
                    rule.fired += 1
                    self.events.append(FaultEvent(site, full_key, rule.spec()))
                    return rule
        return None


# ---------------------------------------------------------------------------
# Active-plan plumbing
# ---------------------------------------------------------------------------

_installed: Optional[FaultPlan] = None
_env_memo: dict = {}
_ctx = threading.local()


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else the env-derived one (memoized per spec)."""
    if _installed is not None:
        return _installed
    spec = os.environ.get(FAULT_SPEC_ENV, "")
    if not spec:
        return None
    seed = int(os.environ.get(FAULT_SEED_ENV, "0"))
    memo = _env_memo.get((spec, seed))
    if memo is None:
        memo = _env_memo[(spec, seed)] = FaultPlan.parse(spec, seed=seed)
    return memo


class install_plan:
    """Context manager installing ``plan`` process-globally (tests, workers).

    ``install_plan(None)`` masks any env-derived plan.  Also usable
    non-contextually via :meth:`set` / :meth:`clear` (worker processes
    install once per process and never uninstall).
    """

    def __init__(self, plan: Optional[FaultPlan]):
        self.plan = plan
        self._prev: Optional[FaultPlan] = None
        self._masked = False

    @staticmethod
    def set(plan: Optional[FaultPlan]) -> None:
        global _installed
        _installed = plan

    @staticmethod
    def clear() -> None:
        global _installed
        _installed = None

    def __enter__(self) -> Optional[FaultPlan]:
        global _installed
        self._prev, self._masked = _installed, True
        if self.plan is None:
            # mask the env plan too for the scope
            os_spec = os.environ.pop(FAULT_SPEC_ENV, None)
            self._env = os_spec
        else:
            self._env = None
        _installed = self.plan
        return self.plan

    def __exit__(self, *exc) -> None:
        global _installed
        _installed = self._prev
        if self._env is not None:
            os.environ[FAULT_SPEC_ENV] = self._env


_worker_plan_key: Optional[tuple] = None


def install_worker_plan(spec: Optional[str], seed: int) -> None:
    """Install the sweep's plan in a pool-worker process (idempotent).

    Keyed on ``(spec, seed)`` so one warm worker serving many tasks keeps
    a single plan instance (its ``n``-rule budgets span the whole sweep),
    while a new sweep with a different spec replaces it.
    """
    global _worker_plan_key
    key = (spec or "", int(seed))
    if key == _worker_plan_key:
        return
    _worker_plan_key = key
    install_plan.set(FaultPlan.parse(spec, seed=seed) if spec else None)


def fault_context(prefix: Optional[str] = None):
    """Get, or (as a context manager) set, the thread-local key prefix.

    Runner sites wrap each point attempt in
    ``with fault_context(f"{point}#a{attempt}|"):`` so nested sites
    (cache get/put, lock acquire, shard publish, spill) inherit the
    point/attempt identity in their keys without plumbing it through
    every signature.
    """
    if prefix is None:
        return getattr(_ctx, "prefix", "")
    return _FaultContext(prefix)


class _FaultContext:
    def __init__(self, prefix: str):
        self.prefix = prefix

    def __enter__(self):
        self._prev = getattr(_ctx, "prefix", "")
        _ctx.prefix = self._prev + self.prefix
        return self

    def __exit__(self, *exc):
        _ctx.prefix = self._prev


def maybe_fault(site: str, key: str = "") -> Optional[FaultRule]:
    """Consult the active plan at an injection site (no-op without one)."""
    plan = active_plan()
    if plan is None:
        return None
    return plan.check(site, key)


def fire_worker_faults(key: str, *, crash_safe: bool = False) -> None:
    """The worker-entry site: ``slow_worker`` sleeps, ``worker_crash``
    raises :class:`InjectedFault` — or hard-kills the process when the
    rule says ``hard`` and the caller declares the site ``crash_safe``
    (a process-pool worker whose death the supervisor can survive).
    """
    slow = maybe_fault("slow_worker", key)
    if slow is not None and slow.seconds > 0:
        time.sleep(slow.seconds)
    crash = maybe_fault("worker_crash", key)
    if crash is not None:
        if crash.hard and crash_safe:
            os._exit(17)  # simulate SIGKILL'd node: no cleanup, no excuse
        raise InjectedFault("worker_crash", key)
