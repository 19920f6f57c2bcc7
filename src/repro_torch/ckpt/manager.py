"""Fault-tolerant checkpointing: async, atomic, checksummed.

Production posture:
  * atomic publish — write to ``step_N.tmp/``, fsync, rename to ``step_N/``;
    a crash mid-write never corrupts the latest checkpoint;
  * SHA-256 manifest — every array file is checksummed; restore verifies;
  * async — ``save`` snapshots tensors to the host (``.detach().cpu()``)
    then hands the write to a background thread (training continues);
  * retain-k sweep of old checkpoints;
  * elastic restore — arrays are saved whole on the host (a DTensor is
    gathered with ``full_tensor()`` on every rank and written by rank 0),
    so a restore distributes each one onto whatever mesh this run has
    (``restore(..., shardings=)``), or places it on the device asked for
    (``device=``) or where the matching leaf of the template lies;
  * deterministic resume — the manifest records the step.

The on-disk format is the JAX package's: one ``.npy`` per leaf, named by
the leaf's tree path (``.layer.w`` for ``tree["layer"]["w"]``, ``.0`` for a
list's first item), and a manifest of file, SHA-256, shape and dtype.  A
bfloat16 leaf, which NumPy has no dtype for, is written as its bits
(``int16``) with ``"bfloat16"`` in the manifest; files the JAX package
wrote for it (raw 2-byte void) read back bit for bit too.  Checkpoints of
dicts and lists therefore cross between the two packages both ways.

:class:`SweepJournal` applies the same atomic + checksummed idiom to the
benchpark sweep runner's checkpoint/resume: each completed scaling point
is journaled as one self-verifying record file, so a killed sweep
restarts exactly where it left off (see ``run_experiment(journal=...)``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree


class SweepJournal:
    """Atomic, checksummed journal of completed sweep points.

    One record file per point key, published with the checkpoint
    manager's idiom (write-temp, fsync, atomic rename) and carrying a
    SHA-256 of its payload — a record is either absent, or complete and
    verified; a crash mid-write never corrupts prior records.  A resumed
    sweep loads :meth:`completed` and re-traces only the missing points;
    records that fail to parse or verify are ignored (and that point is
    simply redone), so a torn journal degrades to extra work, never to a
    wrong profile.
    """

    SUFFIX = ".point.json"

    def __init__(self, directory: str):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, key: str) -> str:
        # point keys are fs-safe (spec names + zero-padded rank counts);
        # anything else is hashed so a hostile key cannot escape the dir.
        if not all(c.isalnum() or c in "-_." for c in key):
            key = hashlib.sha256(key.encode()).hexdigest()
        return os.path.join(self.dir, key + self.SUFFIX)

    def record(self, key: str, payload: str) -> None:
        """Durably journal one completed point (atomic publish)."""
        body = {
            "key": key,
            "sha256": hashlib.sha256(payload.encode()).hexdigest(),
            "payload": payload,
        }
        path = self._path(key)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(body, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)

    def load(self, key: str) -> Optional[str]:
        """The journaled payload for ``key``, or None (absent/corrupt)."""
        try:
            with open(self._path(key)) as f:
                body = json.load(f)
            payload = body["payload"]
            if hashlib.sha256(payload.encode()).hexdigest() != body["sha256"]:
                return None
            if body.get("key", key) != key:
                return None
            return payload
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def completed(self) -> list:
        """Keys of every verified record in the journal directory."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for fname in sorted(names):
            if not fname.endswith(self.SUFFIX):
                continue
            try:
                with open(os.path.join(self.dir, fname)) as f:
                    body = json.load(f)
                payload, key = body["payload"], body["key"]
                digest = hashlib.sha256(payload.encode()).hexdigest()
            except (OSError, ValueError, KeyError, TypeError):
                continue  # torn record: the point is simply redone
            if digest == body.get("sha256"):
                out.append(key)
        return out


def _flatten(tree) -> tuple:
    """(paths, leaves, spec); ``None`` leaves are kept for the unflatten
    but are not arrays (the JAX package's trees have no ``None`` leaf)."""
    with_path, spec = pytree.tree_flatten_with_path(tree)
    paths = [p for p, _ in with_path]
    leaves = [leaf for _, leaf in with_path]
    return paths, leaves, spec


def _key_name(path) -> str:
    # stable leaf naming via tree path strings, as the JAX package names
    # them (``['layer']['w']`` -> ``.layer.w``)
    name = "".join(str(k) for k in path).replace("/", "_").replace("'", "")
    return name.replace("[", ".").replace("]", "")


def _to_host(x) -> tuple:
    """(host array, manifest dtype name) for one leaf; a DTensor whole."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if hasattr(t, "full_tensor"):  # a DTensor: gathered on every rank
            t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:  # NumPy has no bf16: store its bits
            return t.contiguous().view(torch.int16).numpy().copy(), "bfloat16"
        arr = t.numpy().copy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor a stored array holds, bit for bit."""
    if dtype == "bfloat16":
        # the port's files hold int16, the JAX package's raw 2-byte void
        arr = arr.view(np.int16)
        return torch.from_numpy(arr.copy(order="C")).view(torch.bfloat16)
    want = np.dtype(dtype)
    if arr.dtype != want:
        arr = (arr.view(want) if arr.dtype.itemsize == want.itemsize
               else arr.astype(want))
    return torch.from_numpy(arr.copy(order="C"))


def _writes() -> bool:
    """Whether this process writes checkpoints: the only process, or rank 0
    of the process group (every rank holds the whole arrays)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, retain: int = 3):
        self.dir = directory
        self.retain = retain
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Snapshot to host, then write in the background."""
        self.wait()
        paths, leaves, _ = _flatten(tree)
        host, names = [], []
        for path, x in zip(paths, leaves):
            if x is not None:
                host.append(_to_host(x))
                names.append(_key_name(path))
        if not _writes():
            return

        def write():
            try:
                self._write(step, host, names)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _write(self, step: int, host: list, names: list) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "arrays": {}}
        for name, (arr, dtype) in zip(names, host):
            fn = f"{name}.npy"
            path = os.path.join(tmp, fn)
            np.save(path, arr)
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["arrays"][name] = {
                "file": fn, "sha256": digest,
                "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._sweep()

    def _sweep(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.retain]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e

    def list_steps(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, tree_like, step: Optional[int] = None, device=None,
                shardings=None):
        """Restore into the structure of ``tree_like``.

        ``shardings``: a tree of the same structure whose leaves are
        :class:`~repro_torch.parallel.sharding.NamedSharding` (or None): each
        such array is distributed onto that sharding's device mesh with its
        placements, every rank keeping its own shard.  ``device``: where
        every other restored tensor goes; by default each goes to the
        device of the matching tensor leaf of ``tree_like`` (the host for
        any other leaf).  Arrays were saved whole, so the saving run's mesh
        and devices do not matter.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        paths, leaves, spec = _flatten(tree_like)
        shards = [None] * len(leaves)
        if shardings is not None:
            shards = pytree.tree_flatten(
                shardings, is_leaf=lambda x: x is None or hasattr(x, "placements"))[0]
            if len(shards) != len(leaves):
                raise ValueError(f"{len(shards)} shardings for {len(leaves)} leaves")
        out = []
        for path, ref, sh in zip(paths, leaves, shards):
            if ref is None:
                out.append(None)
                continue
            name = _key_name(path)
            meta = manifest["arrays"][name]
            fpath = os.path.join(d, meta["file"])
            with open(fpath, "rb") as f:
                data = f.read()
            if hashlib.sha256(data).hexdigest() != meta["sha256"]:
                raise IOError(f"checksum mismatch for {name} in {d}")
            t = _from_host(np.load(fpath), meta["dtype"])
            if sh is not None:
                from torch.distributed.tensor import distribute_tensor

                out.append(distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                             sh.placements, src_data_rank=None))
                continue
            where = device
            if where is None:
                where = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            out.append(t.to(where))
        return pytree.tree_unflatten(out, spec), step
