"""The port's reduction backend against the JAX package's NumPy reference.

``TorchBackend(device="cpu")`` runs the port's device code on host
tensors, with the segmented reductions on the CUDA kernel's plain PyTorch
version.  The reference's ``JaxBackend`` cannot be built on the installed
jax, so every case is held to ``repro.core.backend.NumpyBackend``, the
reference's own plain path.  Integer results must be equal element for
element and in dtype; float sums agree to 1e-12 relative (the plain
version sums in another order than ``np.add.reduceat``).
"""

import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend
from repro.core.backend import NumpyBackend as RefNumpy
from repro.core.backend import segment_spans as ref_segment_spans
from repro_torch.core import backend as B
from repro_torch.core.backend import BackendUnavailable, TorchBackend
from repro_torch.kernels import segment_reduce as seg

UFUNCS = [np.add, np.maximum, np.minimum]
CPU = TorchBackend(device="cpu")


def _spans_case(kind: str, rng):
    """(key, col) for: sorted keys, unsorted keys (order not None), and a
    single span holding almost all rows."""
    n = 500
    col = rng.integers(0, 1 << 40, n).astype(np.int64)
    if kind == "sorted":
        key = np.sort(rng.integers(0, 9, n)).astype(np.int64)
    elif kind == "unsorted":
        key = rng.integers(0, 9, n).astype(np.int64)
    else:  # one giant span between two short ones
        key = np.ones(n, np.int64)
        key[:3] = 0
        key[-2:] = 2
    return key, col


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "giant"])
@pytest.mark.parametrize("ufunc", UFUNCS, ids=lambda u: u.__name__)
def test_segment_reduce_matches_reference(ufunc, kind):
    key, col = _spans_case(kind, np.random.default_rng(21))
    order, _, starts, _ = ref_segment_spans(key)
    assert (order is None) == (kind != "unsorted")
    want = RefNumpy().segment_reduce(col, order, starts, ufunc)
    got = CPU.segment_reduce(col, order, starts, ufunc)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ufunc", UFUNCS, ids=lambda u: u.__name__)
def test_block_reduce_matches_reference(ufunc):
    rng = np.random.default_rng(22)
    key = np.sort(rng.integers(0, 6, 300)).astype(np.int64)
    grid = rng.integers(0, 1 << 30, (300, 5)).astype(np.int64)
    _, _, starts, ends = ref_segment_spans(key)
    want = RefNumpy().block_reduce(grid, starts, ends, ufunc)
    got = CPU.block_reduce(grid, starts, ends, ufunc)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_plain_kernel_version_matches_numpy(op, dtype):
    """The kernel's plain version on every dtype the kernel takes, with
    33 columns (more than one 32-wide column tile on the card)."""
    rng = np.random.default_rng(23)
    vals = (rng.random((400, 33)) * 1000).astype(dtype)
    starts = np.array([0, 5, 6, 200, 399], np.int64)
    ends = np.append(starts[1:], 400)
    ufunc = {"sum": np.add, "max": np.maximum, "min": np.minimum}[op]
    want = ufunc.reduceat(vals, starts, axis=0, dtype=vals.dtype)
    got = seg.segment_reduce(
        torch.from_numpy(vals), torch.from_numpy(starts), torch.from_numpy(ends), op
    ).numpy()
    assert got.dtype == want.dtype
    if op == "sum" and dtype in (np.float32, np.float64):
        rtol = 1e-5 if dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol)
    else:
        np.testing.assert_array_equal(got, want)


def test_plain_kernel_version_empty_span_is_identity():
    vals = torch.arange(12, dtype=torch.int64).reshape(6, 2)
    starts = torch.tensor([0, 3, 3])
    ends = torch.tensor([3, 3, 6])
    out = seg.segment_reduce(vals, starts, ends, "max")
    assert out[1].tolist() == [torch.iinfo(torch.int64).min] * 2
    assert out[2].tolist() == [10, 11]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    vals = torch.zeros((4, 2), dtype=torch.int16)
    starts, ends = torch.tensor([0]), torch.tensor([4])
    with pytest.raises(TypeError):
        seg.segment_reduce(vals, starts, ends, "sum")
    with pytest.raises(ValueError):
        seg.segment_reduce(vals.long()[:, 0], starts, ends, "sum")
    with pytest.raises(ValueError):
        seg.segment_reduce(vals.long(), starts, ends, "prod")
    with pytest.raises(ValueError):
        seg.segment_reduce(vals.long().t(), starts, torch.tensor([2]), "sum")
    with pytest.raises(TypeError):
        seg.segment_reduce(vals.long(), starts.int(), ends, "sum")


def test_non_kernel_ufunc_takes_the_host_path_and_small_ints_widen():
    rng = np.random.default_rng(24)
    col = rng.integers(1, 50, 64).astype(np.int64)
    starts = np.array([0, 10, 40], np.int64)
    np.testing.assert_array_equal(
        CPU.segment_reduce(col, None, starts, np.multiply),
        RefNumpy().segment_reduce(col, None, starts, np.multiply),
    )
    for dtype in (np.int16, np.int32):  # NumPy sums these in int64
        small = col.astype(dtype)
        got = CPU.segment_reduce(small, None, starts, np.add)
        want = RefNumpy().segment_reduce(small, None, starts, np.add)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        grid = np.stack([small, small], axis=1)
        got = CPU.block_reduce(grid, starts, np.append(starts[1:], 64), np.add)
        want = RefNumpy().block_reduce(grid, starts, np.append(starts[1:], 64), np.add)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):  # the kernel's dtypes only: no host detour
        CPU.segment_reduce(col.astype(np.int16), None, starts, np.maximum)


@pytest.mark.parametrize(
    "amax,bmax,s",
    [
        (1 << 20, 1, 300),  # single f64 product
        (1 << 40, 1 << 20, 300),  # weights split into limbs
        (1 << 8, 1 << 52, 4),  # both sides split
    ],
)
def test_matmul_exact_on_every_limb_plan(amax, bmax, s):
    plan = B._limb_plan(amax - 1, bmax, s)
    assert plan == ref_backend._limb_plan(amax - 1, bmax, s)
    rng = np.random.default_rng(amax % 97 + s)
    w = rng.integers(0, amax, (7, s)).astype(np.int64)
    grid = rng.integers(0, bmax + 1, (s, 129)).astype(np.int64)
    want = RefNumpy().matmul(w, grid)
    got = CPU.matmul(w, grid)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_limb_plans_cover_all_three_regimes():
    kinds = set()
    cases = [(1 << 20, 1, 300), (1 << 40, 1 << 20, 300), (256, 1 << 52, 4)]
    for amax, bmax, s in cases:
        ta, ka, tb, kb = B._limb_plan(amax, bmax, s)
        kinds.add((ka > 1, tb < 64))  # weights split / slab side split
    assert kinds == {(False, False), (True, False), (False, True)}


def _pairs(rng, n_groups: int, rank_extent: int, m: int) -> tuple:
    group_ids = np.sort(rng.integers(0, n_groups, m)).astype(np.int64)
    rows = rng.integers(0, rank_extent, m).astype(np.int64)
    rows[-1] = rank_extent - 1
    peers = (rows + rng.integers(-3, 4, m)) % rank_extent
    return group_ids, rows, peers.astype(np.int64)


@pytest.mark.parametrize("rank_extent", [4096, (1 << 16) + 4096])
def test_pair_counts_and_codes_match_reference(rank_extent):
    rng = np.random.default_rng(rank_extent)
    gids, rows, peers = _pairs(rng, 3, rank_extent, 20000)
    want = RefNumpy().pair_counts(gids, rows, peers, 3, rank_extent)
    got = CPU.pair_counts(gids, rows, peers, 3, rank_extent)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    want_ptr, want_codes = RefNumpy().pair_codes(gids, rows, peers, 3)
    got_ptr, got_codes = CPU.pair_codes(gids, rows, peers, 3)
    np.testing.assert_array_equal(got_ptr, want_ptr)
    np.testing.assert_array_equal(got_codes, want_codes)


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.bool_, np.uint8])
def test_factorize_matches_reference(dtype):
    rng = np.random.default_rng(25)
    col = rng.integers(0, 7, 200).astype(dtype)
    for got, want in zip(CPU.factorize(col), RefNumpy().factorize(col)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_torch_without_cuda_raises_and_never_falls_back(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-device rule is moot")
    monkeypatch.delenv(B.BACKEND_ENV, raising=False)
    with pytest.raises(BackendUnavailable):
        B.resolve_backend("torch")
    with pytest.raises(BackendUnavailable):
        B.resolve_backend(None)  # the default is torch on the card
    monkeypatch.setenv(B.BACKEND_ENV, "torch")
    with pytest.raises(BackendUnavailable):
        B.resolve_backend(None)
    with pytest.raises(BackendUnavailable):
        TorchBackend()
    assert isinstance(B.resolve_backend("numpy"), B.NumpyBackend)
    assert B.resolve_backend(CPU) is CPU
    with pytest.raises(ValueError):
        B.resolve_backend("jax")
