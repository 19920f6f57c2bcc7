"""Live sweep aggregator: merge profile shards while the sweep still runs.

The batch runner traces every scaling point, then reduces, then reports.
This module is the monitoring half of the streaming reduction: concurrent sweep
workers stream each point's trace through the incremental profiler
(:mod:`repro_torch.core.streaming`) and **publish mergeable summary shards** to a
shared directory; a long-running :class:`SweepAggregator` ingests whatever
shards exist *right now*, merges them in a balanced aggregation tree, and
serves :class:`~repro_torch.core.thicket.Frame` queries over the partial sweep —
so the fleet is observable in flight instead of archived post-hoc.

Aggregator lifecycle
--------------------

1. Workers publish shards with the cache machinery's publish idiom
   (:func:`publish_shard`): the payload is written to a unique temp file
   opened ``O_CREAT | O_EXCL`` (no two writers ever share a temp), fsynced,
   and atomically ``os.replace``-d to its final name — a shard file is
   either absent or complete, never torn.
2. The aggregator (any process that can see the directory) calls
   :meth:`SweepAggregator.ingest` whenever it likes; each call picks up
   newly published shards.  A file that fails to load (torn copy on a
   non-atomic filesystem, foreign junk) is *skipped and retried* on the
   next ingest — up to ``REPRO_AGG_MAX_RETRIES`` failed loads (default
   3), after which the file is **quarantined** to ``<root>/quarantine/``
   and given up on — it degrades the view, never corrupts it and never
   wedges ingest in a retry-forever loop.  Shards whose ``NNNNofNNNN``
   total disagrees with the other shards of the same point (conflicting
   publishers) are resolved by majority vote: the minority total's files
   are quarantined and logged, the majority's are served.
3. :meth:`SweepAggregator.frame` / :meth:`profile` serve the current view.
   Points with missing shards (a crashed worker, a sweep still running)
   produce well-formed **partial** profiles from the shards that did
   arrive, tagged with the ingest watermark
   (``meta["ingest_shards"] / ["ingest_total"] / ["complete"]``), so a
   consumer can always tell a converged row from an in-flight one.
4. Once every shard of a point has arrived, the merged result is
   **byte-identical** (``to_json()``) to the batch ``from_recorder``
   profile of that point — the merge is associative/commutative and exact
   (see the merge contract in :mod:`repro_torch.core.streaming`), so shard
   arrival order, interleaving, and tree shape are all irrelevant.

Shards come in two kinds: ``"summary"`` (a pickled mergeable
:class:`~repro_torch.core.streaming.ProfileSummary` delta plus the point's
name/replication/meta labels) and ``"profile"`` (a finished profile's JSON
verbatim — what a cache hit publishes, since a cached point has no
recorder to stream).  A summary holds NumPy arrays only (never a torch
tensor), so a shard that a worker reduced on the CUDA card loads in any
process, with or without a card.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import threading
from typing import Optional

from repro_torch.core.faultinject import maybe_fault
from repro_torch.core.profiler import CommProfile
from repro_torch.core.streaming import ProfileSummary, merge_tree
from repro_torch.core.thicket import Frame

log = logging.getLogger(__name__)

#: Shard filenames: ``<point>.<seq>of<total>.shard`` (zero-padded so a
#: lexicographic listing is point-major, seq-ordered).
_SHARD_RE = re.compile(r"^(?P<point>.+)\.(?P<seq>\d{4})of(?P<total>\d{4})\.shard$")

#: Failed loads of one shard file before it is quarantined.
AGG_MAX_RETRIES_ENV = "REPRO_AGG_MAX_RETRIES"
_DEFAULT_AGG_MAX_RETRIES = 3

_QUARANTINE_DIRNAME = "quarantine"
_QUARANTINE_KEEP = 64


def _quarantine_file(root: str, fname: str) -> Optional[str]:
    """Atomically move ``root/fname`` into ``root/quarantine/`` (bounded
    retention); returns the destination or None if the move lost a race."""
    qdir = os.path.join(root, _QUARANTINE_DIRNAME)
    dest = os.path.join(qdir, f"{fname}.{os.getpid()}.{threading.get_ident()}")
    try:
        os.makedirs(qdir, exist_ok=True)
        os.replace(os.path.join(root, fname), dest)
    except OSError:
        return None  # someone else moved (or removed) it first
    try:
        names = sorted(
            (os.stat(os.path.join(qdir, n)).st_mtime, n)
            for n in os.listdir(qdir)
        )
        for _, n in names[: max(0, len(names) - _QUARANTINE_KEEP)]:
            os.remove(os.path.join(qdir, n))
    except OSError:
        pass
    return dest


def shard_filename(point: str, seq: int, total: int) -> str:
    if not (0 <= seq < total <= 9999):
        raise ValueError(f"bad shard coordinates: {seq}/{total}")
    return f"{point}.{seq:04d}of{total:04d}.shard"


def publish_shard(
    root: str,
    *,
    point: str,
    seq: int,
    total: int,
    summary: Optional[ProfileSummary] = None,
    profile_json: Optional[str] = None,
    name: str = "profile",
    replication: int = 1,
    meta: Optional[dict] = None,
) -> str:
    """Atomically publish one shard of a point's profile.

    Exactly one of ``summary`` (a mergeable delta) / ``profile_json`` (a
    finished profile, e.g. from a cache hit — ``total`` must be 1) is
    given.  The write is torn-proof: unique ``O_CREAT | O_EXCL`` temp,
    fsync, atomic rename — concurrent workers never collide and an
    aggregator never observes a half-written shard.  Returns the final
    path.
    """
    if (summary is None) == (profile_json is None):
        raise ValueError("exactly one of summary/profile_json is required")
    if profile_json is not None and total != 1:
        raise ValueError("a finished-profile shard must be the point's only one")
    payload = {
        "kind": "summary" if summary is not None else "profile",
        "summary": summary,
        "profile_json": profile_json,
        "name": name,
        "replication": int(replication),
        "meta": dict(meta or {}),
    }
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, shard_filename(point, seq, total))
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)  # atomic publish
    if maybe_fault("shard_torn", point) is not None:
        # chaos: tear the published file in place — exactly the artifact a
        # non-atomic network filesystem (or a dying writer on one) leaves
        try:
            with open(path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(path) // 2))
        except OSError:
            pass
    return path


class _PointState:
    """Everything ingested so far for one sweep point.

    ``votes`` counts ingested files per claimed ``NNNNofNNNN`` total;
    ``total`` is the current majority (ties keep the incumbent), and only
    majority-total shards are held in ``shards`` — see
    :meth:`SweepAggregator.ingest` for the conflict-eviction protocol.
    """

    def __init__(self, total: int):
        self.total = total
        self.votes: dict = {}  # claimed total -> distinct-file count
        self.voted: set = set()  # fnames already counted in ``votes``
        self.shards: dict = {}  # seq -> ProfileSummary
        self.files: dict = {}  # seq -> fname (for minority eviction)
        self.final_json: Optional[str] = None  # kind="profile" payload
        self.final_file: Optional[str] = None
        self.name = "profile"
        self.replication = 1
        self.meta: dict = {}

    @property
    def ingested(self) -> int:
        return 1 if self.final_json is not None else len(self.shards)

    @property
    def complete(self) -> bool:
        return self.ingested >= self.total

    def majority_total(self) -> int:
        """The total with the most ingested files (ties keep incumbent)."""
        if not self.votes:
            return self.total
        best = max(self.votes.values())
        if self.votes.get(self.total, 0) == best:
            return self.total
        return max(t for t, c in self.votes.items() if c == best)


class SweepAggregator:
    """Long-running in-process merge service over a shard directory.

    Ingests shards published by concurrent sweep workers and serves
    merged profiles / partial frames while the sweep is still running.
    All state is in-memory and rebuilt from the directory, so an
    aggregator can start (or restart) at any time — including in a
    different process from every worker.  See the module docstring for
    the lifecycle and crash-tolerance contract.
    """

    def __init__(self, root: str, max_load_retries: Optional[int] = None):
        self.root = str(root)
        self._points: dict = {}  # point -> _PointState
        self._seen: set = set()  # ingested (or given-up-on) filenames
        self._fail_counts: dict = {}  # fname -> failed-load count
        if max_load_retries is None:
            max_load_retries = int(
                os.environ.get(AGG_MAX_RETRIES_ENV, _DEFAULT_AGG_MAX_RETRIES)
            )
        #: Failed loads of one file before it is quarantined
        #: (``REPRO_AGG_MAX_RETRIES``).  A torn shard gets this many
        #: ingest passes to be atomically overwritten by a healthy
        #: publisher before the aggregator gives up on it.
        self.max_load_retries = max(1, int(max_load_retries))
        self.quarantined: list = []  # destination paths, for reporting

    # -- ingest --------------------------------------------------------------

    def _give_up(self, fname: str, reason: str) -> None:
        """Quarantine a poisoned file and stop retrying it."""
        dest = _quarantine_file(self.root, fname)
        self._seen.add(fname)
        self._fail_counts.pop(fname, None)
        if dest is not None:
            self.quarantined.append(dest)
        log.warning("quarantined shard %s (%s) -> %s", fname, reason, dest)

    def ingest(self) -> int:
        """Pick up newly published shards; returns how many were ingested.

        A file that fails to parse or unpickle is left un-ingested and
        retried on the next call — bounded by :attr:`max_load_retries`
        failed loads, after which it is quarantined (a healthy publisher's
        atomic overwrite heals it sooner; a permanently torn file cannot
        wedge ingest forever).  A crashed worker's never-published shard
        simply stays missing (partial view), and foreign files are
        ignored.

        Conflicting publishers — shards of one point disagreeing on the
        ``NNNNofNNNN`` total — resolve by majority vote over ingested
        files: minority-total files are quarantined and logged (including
        retroactively, when a later majority flips), and the view is
        served from the majority's shards only.
        """
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return 0
        new = 0
        for fname in names:
            if fname in self._seen:
                continue
            m = _SHARD_RE.match(fname)
            if m is None:
                continue
            try:
                if maybe_fault("shard_ingest", fname) is not None:
                    raise OSError(f"injected fault: shard_ingest @ {fname}")
                with open(os.path.join(self.root, fname), "rb") as f:
                    payload = pickle.load(f)
                kind = payload["kind"]
            except Exception:
                fails = self._fail_counts.get(fname, 0) + 1
                self._fail_counts[fname] = fails
                if fails >= self.max_load_retries:
                    self._give_up(fname, f"unreadable after {fails} loads")
                continue  # torn/corrupt: retry on a future ingest
            point = m.group("point")
            seq, total = int(m.group("seq")), int(m.group("total"))
            st = self._points.get(point)
            if st is None:
                st = self._points[point] = _PointState(total)
            if fname not in st.voted:
                st.voted.add(fname)
                st.votes[total] = st.votes.get(total, 0) + 1
            majority = st.majority_total()
            if majority != st.total:
                # majority flipped: retroactively evict the old total's
                # ingested shards — they describe a different sharding of
                # the point and must not merge with the new majority's
                evicted = [
                    (s, fn)
                    for s, fn in st.files.items()
                    if f"of{majority:04d}." not in fn
                ]
                for s, fn in evicted:
                    st.shards.pop(s, None)
                    st.files.pop(s, None)
                    self._give_up(fn, f"minority total (majority {majority})")
                if st.final_file is not None and (
                    f"of{majority:04d}." not in st.final_file
                ):
                    self._give_up(
                        st.final_file, f"minority total (majority {majority})"
                    )
                    st.final_json = st.final_file = None
                st.total = majority
            if total != majority:
                # Deferred, not dropped: a later majority flip (more of
                # this file's total arriving) would make it ingestable, so
                # leave it un-seen and re-judge next pass — bounded by the
                # same retry budget as unreadable files, then quarantined.
                fails = self._fail_counts.get(fname, 0) + 1
                self._fail_counts[fname] = fails
                if fails >= self.max_load_retries:
                    self._give_up(
                        fname, f"minority total (majority {majority})"
                    )
                continue
            # accepted: only now does the retry budget reset (a load that
            # merely *parsed* must not refresh a deferred file's budget,
            # or a parseable minority-total straggler would retry forever)
            self._fail_counts.pop(fname, None)
            if kind == "profile":
                st.final_json = payload["profile_json"]
                st.final_file = fname
            else:
                st.shards[seq] = payload["summary"]
                st.files[seq] = fname
            st.name = payload.get("name", st.name)
            st.replication = payload.get("replication", st.replication)
            st.meta = payload.get("meta", st.meta)
            self._seen.add(fname)
            new += 1
        return new

    # -- views ---------------------------------------------------------------

    def points(self) -> list:
        """Known point keys, sorted (the zero-padded rank order)."""
        return sorted(self._points)

    def watermark(self, point: Optional[str] = None):
        """Ingest watermark: ``(ingested, total)``, or a dict over points."""
        if point is not None:
            st = self._points[point]
            return (st.ingested, st.total)
        return {p: self.watermark(p) for p in self.points()}

    def complete(self, point: Optional[str] = None) -> bool:
        """Whether every shard of ``point`` (default: all points) arrived."""
        if point is not None:
            return self._points[point].complete
        return bool(self._points) and all(
            st.complete for st in self._points.values()
        )

    def merged(self, point: str) -> ProfileSummary:
        """The point's current merged summary (balanced aggregation tree)."""
        st = self._points[point]
        return merge_tree(st.shards[s] for s in sorted(st.shards))

    def profile(self, point: str) -> CommProfile:
        """The point's profile from the shards ingested so far.

        Complete points are byte-identical to the batch reduction;
        incomplete points are the well-formed profile of the events the
        arrived shards cover (a lost shard narrows the view, it never
        corrupts it).
        """
        st = self._points[point]
        if st.final_json is not None:
            return CommProfile.from_json(st.final_json)
        return self.merged(point).finalize(
            name=st.name, replication=st.replication, meta=st.meta
        )

    def profiles(self) -> list:
        """One profile per known point, in point order."""
        return [self.profile(p) for p in self.points()]

    def frame(self, include_partial: bool = True) -> Frame:
        """The current sweep view as a Thicket frame.

        Every row carries the ingest watermark in its meta columns
        (``meta_ingest_shards`` / ``meta_ingest_total`` /
        ``meta_complete``); ``include_partial=False`` restricts to points
        whose shards have all arrived.  The watermark is stamped on frame
        copies only — :meth:`profile` outputs stay byte-comparable to the
        batch pipeline.
        """
        profs = []
        for point in self.points():
            st = self._points[point]
            if not include_partial and not st.complete:
                continue
            prof = self.profile(point)
            prof.meta = dict(prof.meta)
            prof.meta["ingest_shards"] = st.ingested
            prof.meta["ingest_total"] = st.total
            prof.meta["complete"] = st.complete
            profs.append(prof)
        return Frame.from_profiles(profs)
