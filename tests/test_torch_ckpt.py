"""The port's checkpoint manager and sweep journal against the JAX package's.

The four single-mesh ``test_ckpt_*`` tests of ``tests/test_substrate.py``
on ``repro_torch.ckpt.manager`` (host tensors, seeded with NumPy), then
checkpoints and journal records crossing between the two packages both
ways: a dict of f32, int32 and bf16 arrays written by one restores bit for
bit in the other, under the same manifest leaf names.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as RefCheckpointManager
from repro.ckpt.manager import SweepJournal as RefSweepJournal
from repro_torch.ckpt.manager import CheckpointManager, SweepJournal


def _arrays(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((8, 4)).astype(np.float32),
        "hb": rng.standard_normal((4, 4)).astype(np.float32),
        "b": np.zeros((4,), np.float32),
        "ids": rng.integers(-1000, 1000, (6,)).astype(np.int32),
    }


def _tree(seed=0) -> dict:
    a = _arrays(seed)
    return {
        "layer": {
            "w": torch.from_numpy(a["w"]),
            "hb": torch.from_numpy(a["hb"]).to(torch.bfloat16),
            "b": torch.from_numpy(a["b"]),
        },
        "ids": [torch.from_numpy(a["ids"])],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _ref_tree(seed=0) -> dict:
    a = _arrays(seed)
    return {
        "layer": {
            "w": jnp.asarray(a["w"]),
            "hb": jnp.asarray(a["hb"]).astype(jnp.bfloat16),
            "b": jnp.asarray(a["b"]),
        },
        "ids": [jnp.asarray(a["ids"])],
        "step": jnp.int32(7),
    }


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as an integer array (bf16 through int16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.int16) if arr.dtype == jnp.bfloat16 else arr


def _flat(tree) -> dict:
    return {
        "layer.w": tree["layer"]["w"],
        "layer.hb": tree["layer"]["hb"],
        "layer.b": tree["layer"]["b"],
        "ids.0": tree["ids"][0],
        "step": tree["step"],
    }


def _assert_bit_equal(got, want) -> None:
    for name, g in _flat(got).items():
        w = _flat(want)[name]
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, name
        np.testing.assert_array_equal(gb, wb, err_msg=name)


def _manifest(directory, step) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=2)
    tree = _tree()
    mgr.save(3, tree, blocking=True)
    restored, step = mgr.restore(tree)
    assert step == 3
    np.testing.assert_array_equal(restored["layer"]["w"].numpy(),
                                  tree["layer"]["w"].numpy())
    # bf16 leaves survive the numpy round-trip (stored as their bits)
    assert restored["layer"]["hb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        restored["layer"]["hb"].float().numpy(), tree["layer"]["hb"].float().numpy())
    assert restored["step"].shape == () and int(restored["step"]) == 7
    _assert_bit_equal(restored, tree)


def test_ckpt_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert mgr.list_steps() == [3, 4]


def test_ckpt_checksum_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retain=2)
    tree = _tree()
    mgr.save(1, tree, blocking=True)
    d = os.path.join(str(tmp_path), "step_00000001")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(tree)


def test_ckpt_no_partial_publish(tmp_path):
    """A .tmp directory is never visible as a restorable step."""
    mgr = CheckpointManager(str(tmp_path), retain=2)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert mgr.list_steps() == []


def test_ckpt_written_by_jax_package_restores_bit_for_bit(tmp_path):
    RefCheckpointManager(str(tmp_path), retain=2).save(5, _ref_tree(), blocking=True)
    restored, step = CheckpointManager(str(tmp_path)).restore(_tree(1))
    assert step == 5
    assert restored["layer"]["hb"].dtype == torch.bfloat16
    assert restored["ids"][0].dtype == torch.int32
    _assert_bit_equal(restored, _tree())


def test_ckpt_written_by_port_restores_bit_for_bit_in_jax_package(tmp_path):
    CheckpointManager(str(tmp_path), retain=2).save(6, _tree(), blocking=True)
    restored, step = RefCheckpointManager(str(tmp_path)).restore(_ref_tree(1))
    assert step == 6
    assert restored["layer"]["hb"].dtype == jnp.bfloat16
    _assert_bit_equal(restored, _ref_tree())


def test_ckpt_manifests_name_the_same_leaves(tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RefCheckpointManager(ref_dir).save(1, _ref_tree(), blocking=True)
    CheckpointManager(port_dir).save(1, _tree(), blocking=True)
    ref, port = _manifest(ref_dir, 1)["arrays"], _manifest(port_dir, 1)["arrays"]
    assert sorted(ref) == sorted(port) == [
        ".ids.0", ".layer.b", ".layer.hb", ".layer.w", ".step"]
    for name in ref:
        for key in ("file", "shape", "dtype"):
            assert ref[name][key] == port[name][key], (name, key)
    assert port[".layer.hb"]["dtype"] == "bfloat16"


def test_ckpt_restore_places_leaves_on_the_device_asked_for(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _tree(), blocking=True)
    restored, _ = mgr.restore(_tree(), device="cpu")
    assert all(t.device.type == "cpu" for t in _flat(restored).values())
    restored, _ = mgr.restore(_tree(), device="meta")
    assert all(t.device.type == "meta" for t in _flat(restored).values())


@pytest.mark.parametrize(
    "writer,reader",
    [(RefSweepJournal, SweepJournal), (SweepJournal, RefSweepJournal)],
    ids=["jax-to-port", "port-to-jax"],
)
def test_sweep_journal_records_cross_packages(tmp_path, writer, reader):
    payload = json.dumps({"name": "kripke-weak-dane-64", "n_ranks": 64})
    w = writer(str(tmp_path))
    w.record("kripke-weak-dane-00064", payload)
    w.record("bad key/../x", payload)  # hashed into the directory
    r = reader(str(tmp_path))
    assert sorted(r.completed()) == sorted(["kripke-weak-dane-00064", "bad key/../x"])
    assert r.load("kripke-weak-dane-00064") == payload
    assert r.load("bad key/../x") == payload
    assert r.load("absent") is None
