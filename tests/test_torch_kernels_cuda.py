"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip with the
reason.  The module imports nothing of the JAX package, so it also runs on
a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.backend import TorchBackend
from repro_torch.kernels import segment_reduce as seg

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no host mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n_cols", [1, 3, 8, 33])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_kernel_matches_plain_version(card, dtype, n_cols):
    rng = np.random.default_rng(n_cols)
    n = 5000
    vals = torch.from_numpy(rng.random((n, n_cols)) * 1000).to(card, dtype)
    starts = torch.tensor([0, 1, 1, 2000, 4999], device=card)
    ends = torch.tensor([1, 1, 2000, 4999, 5000], device=card)
    for op in seg.OPS:
        before = seg.launch_count()
        got = seg.segment_reduce(vals, starts, ends, op)
        assert seg.launch_count() == before + 1
        want = seg.segment_reduce_plain(vals, starts, ends, op)
        if dtype.is_floating_point and op == "sum":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        else:
            assert torch.equal(got, want)


def test_int64_sums_are_exact_and_wrap_like_numpy(card):
    big = np.full((4, 1), np.iinfo(np.int64).max, np.int64)
    vals = torch.from_numpy(big).to(card)
    starts, ends = torch.tensor([0], device=card), torch.tensor([4], device=card)
    got = seg.segment_reduce(vals, starts, ends, "sum").cpu().numpy()
    with np.errstate(over="ignore"):
        want = np.add.reduceat(big, [0], axis=0)
    np.testing.assert_array_equal(got, want)


def test_wrapper_raises_on_mixed_devices(card):
    vals = torch.zeros((4, 1), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        seg.segment_reduce(vals, torch.tensor([0]), torch.tensor([4]), "sum")


def test_backend_segment_reduce_on_card_matches_host(card):
    rng = np.random.default_rng(7)
    key = rng.integers(0, 50, 10_000).astype(np.int64)
    col = rng.integers(0, 1 << 40, 10_000).astype(np.int64)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    starts = np.concatenate(([0], np.flatnonzero(np.diff(sk)) + 1))
    for ufunc in (np.add, np.maximum, np.minimum):
        want = ufunc.reduceat(col[order], starts)
        got = TorchBackend().segment_reduce(col, order, starts, ufunc)
        np.testing.assert_array_equal(got, want)
