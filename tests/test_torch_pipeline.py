"""The GPipe pipeline over the ``pod`` axis, against ``repro``'s.

The port of ``tests/test_pipeline.py``.  Four stages of ``tanh(x @ w_s)``
(D 8) over six microbatches of two rows, the weights and microbatches made
with numpy from a seed:

* on 4 gloo ranks (``run_ranks``), the port's ``run_pipeline`` equals the
  sequential product of the four stages and ``repro``'s ``run_pipeline`` on
  4 forced host devices from the same inputs (rtol = atol = 1e-6, as
  ``repro``'s test holds it);
* its traced profile on meta tensors has ``pipeline_shift`` with 27 sends
  (9 steps x 3 forward pairs) to dest ranks (0, 1) a rank, and one
  ``pipeline_collect`` collective, and its ``CommProfile.to_json()`` is
  byte-identical to ``repro``'s ``profile_traced`` of the same function.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

import sharded_ranks
from helpers import run_with_devices
from repro_torch.core import compat
from repro_torch.core.profiler import profile_traced
from repro_torch.core.ranks import run_ranks
from repro_torch.core.topology import topology
from repro_torch.parallel.pipeline import run_pipeline

S, M, MB, D = 4, 6, 2, 8

_JAX = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.core import compat, profile_traced
from repro.core.topology import topology
from repro.parallel.pipeline import run_pipeline

mesh = compat.make_mesh((4,), ("pod",))
with np.load({inputs!r}) as f:
    ws, mbs = jnp.asarray(f["ws"]), jnp.asarray(f["mbs"])
out = run_pipeline(lambda w, x: jnp.tanh(x @ w), ws, mbs, mesh)
with topology(("pod", 4)):
    prof = profile_traced(
        lambda w, m: run_pipeline(lambda w, x: x @ w, w, m, mesh),
        jnp.zeros((4, 8, 8)), jnp.zeros((6, 2, 8)))
np.save({out!r}, np.asarray(out))
print(json.dumps({{"profile": prof.to_json()}}))
"""


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    mbs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return ws, mbs


@pytest.fixture(scope="module")
def reference():
    """repro's pipeline outputs and traced profile JSON (4 host devices)."""
    ws, mbs = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"inputs": os.path.join(tmp, "in.npz"),
                 "out": os.path.join(tmp, "out.npy")}
        np.savez(paths["inputs"], ws=ws, mbs=mbs)
        stdout = run_with_devices(_JAX.format(**paths), n_devices=4)
        out = np.load(paths["out"])
    return {"out": out, **json.loads(stdout.strip().splitlines()[-1])}


def test_pipeline_matches_sequential_4stages(reference):
    ws, mbs = _inputs()
    got = run_ranks(sharded_ranks.pipeline_4_stages, 4, backend="gloo",
                    args=(ws, mbs))
    ref = torch.from_numpy(mbs)
    for s in range(S):
        ref = torch.tanh(ref @ torch.from_numpy(ws[s]))
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, reference["out"], rtol=1e-6, atol=1e-6)


def test_pipeline_comm_profile(reference):
    mesh = compat.make_mesh((4,), ("pod",))
    with topology(("pod", 4)):
        prof = profile_traced(
            lambda w, m: run_pipeline(lambda w, x: x @ w, w, m, mesh),
            torch.zeros((4, 8, 8)), torch.zeros((6, 2, 8)), backend="numpy")
    sh = prof.regions["pipeline_shift"]
    assert sh.total_sends == 27, sh.total_sends
    assert sh.dest_ranks == (0, 1)
    assert prof.regions["pipeline_collect"].coll == 1
    assert prof.to_json() == reference["profile"]


def test_pipeline_runs_on_meta_tensors_only_inside_its_mesh():
    mesh = compat.make_mesh((4,), ("pod",))
    out = run_pipeline(lambda w, x: x @ w, torch.zeros((4, 8, 8), device="meta"),
                       torch.zeros((6, 2, 8), device="meta"), mesh)
    assert out.shape == (6, 2, 8) and out.device.type == "meta"
    with pytest.raises(RuntimeError, match="process group"):
        run_pipeline(lambda w, x: x @ w, torch.zeros((4, 8, 8)),
                     torch.zeros((6, 2, 8)), mesh)
