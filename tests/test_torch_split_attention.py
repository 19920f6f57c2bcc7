"""The attention entries a split sequence or cache takes, on the CPU.

A rank's query rows at an offset of the keys (``ops.flash_attention_rows``:
the plain version over the whole K, masked at the offset) give the rows of
causal attention over the whole sequence, and the same as attention over
K/V cut to the rows' end (what the card's kernel runs).  A rank's query
heads over all KV heads (``ops.flash_attention_heads``) give those heads'
rows of the whole attention, whether its heads group evenly or not.  The
decode attention's log-sum-exp (``return_lse``) is that of its scores; a
cache's slices (``ops.decode_attention_slice``, ``kv_len`` clamped to each)
merged by their log-sum-exp give the attention over the whole cache, a
slice past ``kv_len`` giving out 0 and lse -inf.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("offset", [0, 8, 24])
def test_rows_at_an_offset_are_rows_of_causal_attention(offset):
    rng = np.random.default_rng(offset)
    q, k, v = _randn(rng, 2, 6, 32, 16), _randn(rng, 2, 2, 32, 16), _randn(rng, 2, 2, 32, 16)
    rows = q[:, :, offset:offset + 8]
    whole = fa.flash_attention_plain(q, k, v, causal=True)[:, :, offset:offset + 8]
    got = ops.flash_attention_rows(rows, k, v, offset)
    cut = fa.flash_attention_plain(rows, k[:, :, :offset + 8], v[:, :, :offset + 8],
                                   causal=True)
    torch.testing.assert_close(got, whole)
    torch.testing.assert_close(cut, whole)
    with pytest.raises(ValueError, match="outside"):
        fa.flash_attention_rows_plain(rows, k, v, 25)


@pytest.mark.parametrize("first,n", [(0, 3), (3, 3), (2, 4), (5, 1)])
def test_a_ranks_query_heads_read_their_kv_heads(first, n):
    rng = np.random.default_rng(first + 10 * n)
    q, k, v = _randn(rng, 2, 6, 16, 8), _randn(rng, 2, 2, 16, 8), _randn(rng, 2, 2, 16, 8)
    want = fa.flash_attention_plain(q, k, v, causal=True)[:, first:first + n]
    got = ops.flash_attention_heads(q[:, first:first + n], k, v, first, 6)
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("kv_len", [1, 17, 40])
def test_decode_log_sum_exp_is_that_of_the_scores(kv_len):
    rng = np.random.default_rng(kv_len)
    q, k, v = _randn(rng, 2, 6, 1, 16), _randn(rng, 2, 2, 40, 16), _randn(rng, 2, 2, 40, 16)
    out, lse = dec.decode_attention(q, k, v, kv_len, return_lse=True)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(3, dim=1))[..., :kv_len]
    torch.testing.assert_close(lse, torch.logsumexp(scores / math.sqrt(16), -1))
    torch.testing.assert_close(out, dec.decode_attention(q, k, v, kv_len))
    assert lse.shape == (2, 6, 1)


@pytest.mark.parametrize("kv_len", [5, 20, 33])
def test_slices_merged_by_log_sum_exp_give_the_whole_cache(kv_len):
    rng = np.random.default_rng(kv_len)
    q, k, v = _randn(rng, 2, 6, 1, 16), _randn(rng, 2, 2, 48, 16), _randn(rng, 2, 2, 48, 16)
    parts = [ops.decode_attention_slice(q, k[:, :, s:s + 12], v[:, :, s:s + 12], kv_len - s)
             for s in range(0, 48, 12)]
    for s, (out, lse) in zip(range(0, 48, 12), parts):
        if s >= kv_len:
            assert out.abs().max() == 0 and torch.isneginf(lse).all()
    top = torch.stack([lse for _, lse in parts]).amax(0)
    w = [torch.exp(lse - top)[..., None] for _, lse in parts]
    merged = sum(out * wi for (out, _), wi in zip(parts, w)) / sum(w)
    torch.testing.assert_close(merged, dec.decode_attention_plain(q, k, v, kv_len))


@pytest.mark.parametrize("model", [1, 4])
def test_heads_are_kept_whole_only_where_the_mesh_needs_it(model):
    """The launcher's plan names no heads (``heads=None``): on a model axis
    of one rank, or one the heads divide, the products and attention keep
    the plan's placements; only heads that do not divide a model axis of
    more than one rank are kept whole."""
    from types import SimpleNamespace

    from repro_torch.configs import registry
    from repro_torch.parallel.context import attention_placement, parallel_context
    from repro_torch.parallel.sharding import default_plan

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), size=(2, model).__getitem__)
    for arch, heads in (("olmo-1b", 16), ("deepseek-coder-33b", 6)):
        cfg = registry.get(arch).reduced(n_heads=heads)
        plan = default_plan(cfg, {"data": 2, "model": model}).override(
            seq=None, heads=None, kv_heads=None)
        with parallel_context(mesh, plan):
            placement = attention_placement(cfg.n_heads)
        want = "rows" if heads % model else "plan"
        assert placement.heads == want, (arch, model)
        assert placement.cache_slices == (plan.get("kv_seq") == "model" and model > 1)
