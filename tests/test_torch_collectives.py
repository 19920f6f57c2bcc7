"""The instrumented collectives executed over ``torch.distributed`` against
the JAX package's under ``shard_map``.

One 2×2×2 mesh.  Each case's global input comes from numpy with a fixed
seed and is split over the eight ranks along dim 0; each rank's result is
gathered back in rank order.  The port runs every case on 8 gloo ranks
(one spawn for the file); ``repro`` runs them on 8 forced host devices
(one subprocess, arrays through an ``.npz``).  Ints must be equal, float32
within ``rtol=atol=1e-6``.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro_torch.apps import multirank
from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.ranks import run_ranks

SEED = 20261017

#: (name, op, axis, kwargs, local shape, dtype)
CASES = [
    ("ppermute-full", "ppermute", "x", {"perm": [[0, 1], [1, 0]]}, (3, 5), "float32"),
    ("ppermute-partial", "ppermute", "y", {"perm": [[0, 1]]}, (3, 5), "float32"),
    ("ppermute-empty", "ppermute", "z", {"perm": []}, (3, 5), "float32"),
    ("ppermute-periodic", "ppermute", "z", {"perm": [[1, 0], [0, 1]]}, (3, 5), "int32"),
    ("ppermute-self", "ppermute", "y", {"perm": [[0, 0], [1, 1]]}, (3, 5), "float32"),
    ("ppermute-tuple", "ppermute", ["x", "y"], {"perm": [[0, 3], [3, 1], [1, 2]]},
     (2, 4), "float32"),
    ("psum-x", "psum", "x", {}, (3, 5), "float32"),
    ("psum-yz", "psum", ["y", "z"], {}, (3, 5), "float32"),
    ("psum-int", "psum", ["x", "z"], {}, (3, 5), "int32"),
    ("pmean-y", "pmean", "y", {}, (3, 5), "float32"),
    ("pmean-xz", "pmean", ["x", "z"], {}, (3, 5), "float32"),
    ("pmax-z", "pmax", "z", {}, (3, 5), "float32"),
    ("pmax-xy", "pmax", ["x", "y"], {}, (3, 5), "int32"),
    ("pmin-x", "pmin", "x", {}, (3, 5), "float32"),
    ("pmin-zy", "pmin", ["z", "y"], {}, (3, 5), "float32"),
    ("all_gather-x-untiled", "all_gather", "x", {"axis": 0, "tiled": False}, (2, 3),
     "float32"),
    ("all_gather-y-tiled", "all_gather", "y", {"axis": 1, "tiled": True}, (2, 3),
     "float32"),
    ("all_gather-xy-untiled", "all_gather", ["x", "y"], {"axis": 1, "tiled": False},
     (2, 3), "int32"),
    ("all_gather-zx-tiled", "all_gather", ["z", "x"], {"axis": 0, "tiled": True},
     (2, 3), "float32"),
    ("all_gather-zyx-untiled", "all_gather", ["z", "y", "x"],
     {"axis": 0, "tiled": False}, (2, 3), "float32"),
    ("psum_scatter-x-untiled", "psum_scatter", "x",
     {"scatter_dimension": 0, "tiled": False}, (2, 3), "float32"),
    ("psum_scatter-yz-tiled", "psum_scatter", ["y", "z"],
     {"scatter_dimension": 1, "tiled": True}, (2, 8), "float32"),
    ("psum_scatter-zx-tiled", "psum_scatter", ["z", "x"],
     {"scatter_dimension": 0, "tiled": True}, (4, 3), "int32"),
    ("all_to_all-y-untiled", "all_to_all", "y",
     {"split_axis": 0, "concat_axis": 1, "tiled": False}, (2, 3), "float32"),
    ("all_to_all-xz-tiled", "all_to_all", ["x", "z"],
     {"split_axis": 1, "concat_axis": 0, "tiled": True}, (4, 8), "float32"),
    ("all_to_all-zy-tiled", "all_to_all", ["z", "y"],
     {"split_axis": 0, "concat_axis": 1, "tiled": True}, (4, 2), "int32"),
    ("pbroadcast-x", "pbroadcast", "x", {"root": 1}, (3, 5), "float32"),
    ("pbroadcast-yx", "pbroadcast", ["y", "x"], {"root": 2}, (3, 5), "float32"),
]
NAMES = [c[0] for c in CASES]

_JAX = """
import json, numpy as np, jax
from repro.core import collectives as coll
from repro.core import compat
from jax.sharding import PartitionSpec as P
cases = json.load(open({cases!r}))
inputs = np.load({inputs!r})
mesh = compat.make_mesh((2, 2, 2), ("x", "y", "z"))
every = P(("x", "y", "z"))
out = {{}}
for case in cases:
    axis = case["axis"] if isinstance(case["axis"], str) else tuple(case["axis"])
    kw = dict(case["kwargs"])
    if "perm" in kw:
        kw["perm"] = [tuple(p) for p in kw["perm"]]
    op = getattr(coll, case["op"])
    fn = compat.shard_map(lambda x, op=op, axis=axis, kw=kw: op(x, axis, **kw)[None],
                          mesh=mesh, in_specs=every, out_specs=every)
    out[case["name"]] = np.asarray(jax.jit(fn)(inputs[case["name"]]))
np.savez({out!r}, **out)
print("OK")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(SEED)
    out = {}
    for name, _op, _axis, _kw, shape, dtype in CASES:
        full = (8 * shape[0], *shape[1:])
        if dtype == "float32":
            out[name] = rng.standard_normal(full).astype(np.float32)
        else:
            out[name] = rng.integers(-50, 50, size=full).astype(dtype)
    return out


def _specs() -> list:
    return [dict(name=n, op=op, axis=axis, kwargs=kw)
            for n, op, axis, kw, _s, _d in CASES]


@pytest.fixture(scope="module")
def results():
    """(inputs, the port's results on 8 gloo ranks, repro's on 8 devices)."""
    inputs = _inputs()
    port = run_ranks(multirank.run_collective_cases, 8, backend="gloo",
                     args=(_specs(), inputs))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.{ext}") for k, ext in
                 (("cases", "json"), ("inputs", "npz"), ("out", "npz"))}
        with open(paths["cases"], "w") as f:
            json.dump(_specs(), f)
        np.savez(paths["inputs"], **inputs)
        run_with_devices(_JAX.format(**paths))
        with np.load(paths["out"]) as data:
            ref = {k: data[k] for k in data.files}
    return inputs, port, ref


@pytest.mark.parametrize("name", NAMES)
def test_collective_matches_repro_on_8_ranks(name, results):
    _inputs_, port, ref = results
    got, want = port[name], ref[name]
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_partial_perm_gives_zeros_where_there_is_no_source(results):
    """``lax.ppermute`` semantics: the ranks at y = 0 receive nothing."""
    inputs, port, _ref = results
    got = port["ppermute-partial"]
    blocks = inputs["ppermute-partial"].reshape(8, 3, 5)
    for rank in range(8):
        x, y, z = rank // 4, (rank // 2) % 2, rank % 2
        want = blocks[rank - 2] if y == 1 else np.zeros((3, 5), np.float32)
        np.testing.assert_array_equal(got[rank], want)


def test_every_rank_reported(results):
    _inputs_, port, _ref = results
    assert [r["rank"] for r in port["ranks"]] == list(range(8))


def test_real_tensors_without_a_process_group_raise():
    mesh = compat.make_mesh((2, 2, 2), ("x", "y", "z"))
    fn = compat.shard_map(lambda a: coll.psum(a, "x"), mesh=mesh,
                          in_specs=compat.PartitionSpec("x"),
                          out_specs=compat.PartitionSpec("x"))
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        fn(torch.ones(8, 3))
    with pytest.raises(RuntimeError, match="inside shard_map"):
        coll.all_gather(torch.ones(3), "x")


def test_world_size_mismatch_raises(tmp_path):
    """A group of one rank does not run a mesh of eight: no fallback."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        mesh = compat.make_mesh((2, 2, 2), ("x", "y", "z"))
        fn = compat.shard_map(lambda a: coll.psum(a, "x"), mesh=mesh,
                              in_specs=compat.PartitionSpec("x"),
                              out_specs=compat.PartitionSpec("x"))
        with pytest.raises(RuntimeError, match="world size is 1"):
            fn(torch.ones(8, 3))
    finally:
        dist.destroy_process_group()


def test_meta_trace_keeps_shapes_through_the_custom_ops():
    """On meta tensors every wrapper runs its op's fake implementation."""
    mesh = compat.make_mesh((2, 2, 2), ("x", "y", "z"))
    every = compat.PartitionSpec(("x", "y", "z"))
    for name, op, axis, kw, shape, dtype in CASES:
        axis = axis if isinstance(axis, str) else tuple(axis)
        kw = dict(kw, perm=[tuple(p) for p in kw["perm"]]) if "perm" in kw else kw
        fn = compat.shard_map(lambda a, op=op, axis=axis, kw=kw:
                              getattr(coll, op)(a, axis, **kw)[None],
                              mesh=mesh, in_specs=every, out_specs=every)
        x = torch.empty((8 * shape[0], *shape[1:]), dtype=getattr(torch, dtype),
                        device="meta")
        got = fn(x)
        assert got.device.type == "meta", name
        assert got.dtype == x.dtype, name


def test_ppermute_rejects_a_perm_that_is_not_a_permutation():
    mesh = compat.make_mesh((2, 2, 2), ("x", "y", "z"))
    x = torch.empty(8, 3, device="meta")
    for perm in ([(0, 1), (0, 0)], [(0, 2)]):
        fn = compat.shard_map(lambda a, perm=perm: coll.ppermute(a, "x", perm),
                              mesh=mesh, in_specs=compat.PartitionSpec(("x", "y", "z")),
                              out_specs=compat.PartitionSpec(("x", "y", "z")))
        with pytest.raises(ValueError, match="perm"):
            fn(x)


def test_run_ranks_raises_what_a_rank_raised():
    """A mesh of 8 on a group of 2 fails on every rank; the run raises with
    the ranks' tracebacks."""
    with pytest.raises(RuntimeError, match="world size is 2"):
        run_ranks(multirank.run_apps, 2, backend="gloo", args=({
            "laghos": multirank.PARITY_PARAMS["laghos"]}, "cpu"), timeout_s=120)


def test_run_ranks_kills_a_rank_that_outlasts_the_timeout():
    import time

    t = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        run_ranks(time.sleep, 2, backend="gloo", args=(600,), timeout_s=8)
    assert time.monotonic() - t < 40
