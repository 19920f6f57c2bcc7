"""The flash-attention backward's plain versions against the JAX package.

The backward kernel (``csrc/flash_attention_bwd.cu``) runs only on the card,
where ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` hold it to
its plain versions.  Here those plain versions are held to
``repro.kernels.ref.flash_attention_ref``, the JAX package's oracle: the
gradients to ``jax.vjp`` of it, the stored log-sum-exp to
``jax.nn.logsumexp`` of its masked scores, and the Python side of the GQA
split (the scratch's shape, the sum over a group in head order) to the
gradients of the repeated keys and values.  Inputs are numpy draws from a
seed, f32.  Tolerances: rtol 1e-5 and atol 1e-6 x the tensor's max|ref|
(the two frameworks sum in other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops

#: (B, Hq, Hkv, Sq, Sk, D, causal)
CASES = [
    (1, 4, 4, 24, 40, 32, True),  # causal, Sq < Sk
    (2, 4, 4, 40, 8, 64, False),  # non-causal, Sq > Sk
    (2, 4, 2, 32, 32, 32, True),  # GQA 4:2
    (1, 8, 1, 24, 24, 64, True),  # MQA 8:1
    (1, 8, 1, 20, 36, 32, False),  # MQA 8:1, non-causal
]


def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d))
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _close(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_plain_backward_matches_jax_vjp_of_the_reference(b, hq, hkv, sq, sk, d, causal):
    q, k, v, dout = _inputs(sq * sk + d, b, hq, hkv, sq, sk, d)
    _, vjp = jax.vjp(lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = fab.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, dout)), causal=causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g.numpy(), w)


def _jax_lse(q, k, causal):
    """jax.nn.logsumexp of the scores masked as ref.flash_attention_ref
    masks them."""
    _, hq, sq, d = q.shape
    k = jnp.repeat(jnp.asarray(k), hq // k.shape[1], axis=1)
    scores = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), k) / math.sqrt(d)
    if causal:
        sk = k.shape[2]
        mask = jnp.arange(sq)[:, None] + (sk - sq) >= jnp.arange(sk)[None, :]
        scores = jnp.where(mask[None, None], scores, -1e30)
    return jax.nn.logsumexp(scores, axis=-1)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_plain_lse_matches_jax_logsumexp_of_the_masked_scores(b, hq, hkv, sq, sk, d,
                                                              causal):
    q, k, v, _ = _inputs(sq + sk + d, b, hq, hkv, sq, sk, d)
    got = fa.flash_attention_lse_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert got.shape == (b, hq, sq) and got.dtype == torch.float32
    _close(got.numpy(), _jax_lse(q, k, causal))


def test_wrapper_returns_the_plain_lse_on_the_cpu():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(5, 1, 4, 2, 24, 40, 32))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, causal=True))
    assert torch.equal(lse, fa.flash_attention_lse_plain(q, k, v, causal=True))
    assert torch.equal(fa.flash_attention(q, k, v, causal=True), out)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_group_split_sums_each_query_heads_gradient_in_head_order(
    b, hq, hkv, sq, sk, d, causal
):
    """Each query head's dK and dV (the gradients of keys and values
    repeated for it) fill the scratch of ``group_scratch_shape``; the
    group-sum's plain version gives the plain dK and dV, adding heads in
    order from 0."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(sq * d + sk, b, hq, hkv,
                                                          sq, sk, d))
    shape = fab.group_scratch_shape(q, k)
    if hq == hkv:
        assert shape is None
        return
    assert shape == (2, b, hq, sk, d)
    rep = hq // hkv
    kr, vr = (t.repeat_interleave(rep, dim=1).requires_grad_(True) for t in (k, v))
    out = fa.flash_attention_plain(q, kr, vr, causal=causal)
    scratch = torch.stack(torch.autograd.grad(out, (kr, vr), dout))
    assert scratch.shape == shape
    dk, dv = fab.group_sum_plain(scratch, hkv, torch.float32)
    in_order = scratch.view(2, b, hkv, rep, sk, d)
    want = in_order[:, :, :, 0]
    for g in range(1, rep):
        want = want + in_order[:, :, :, g]
    assert torch.equal(dk, want[0]) and torch.equal(dv, want[1])
    _, plain_dk, plain_dv = fab.flash_attention_bwd_plain(q, k, v, dout, causal=causal)
    for g, w in ((dk, plain_dk), (dv, plain_dv)):
        _close(g.numpy(), w.numpy())
    bf = fab.group_sum_plain(scratch, hkv, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bf)
    assert torch.equal(bf[0], want[0].to(torch.bfloat16))


def test_lse_rows_keep_aligned_rows_and_pad_others():
    """The bf16 route's lse layout: rows a multiple of 4 floats apart are
    read as they are; others are copied into padded rows (and counted)."""
    fab.reset_launch_count()
    lse = torch.randn(2, 3, 64)
    rows, ld = fab.lse_rows(lse)
    assert rows is lse and ld == 64 and fab.copy_count() == 0
    odd = torch.randn(2, 3, 33)
    rows, ld = fab.lse_rows(odd)
    assert ld == 36 and rows.shape == (2, 3, 36) and fab.copy_count() == 1
    assert torch.equal(rows[..., :33], odd) and not rows[..., 33:].any()


def test_tma_ready_copies_only_what_tma_cannot_take():
    fab.reset_launch_count()
    x = torch.randn(2, 40, 64, dtype=torch.float32).to(torch.bfloat16)
    w = torch.randn(64, 4, 32).to(torch.bfloat16)
    view = torch.einsum("bsd,dhk->bhsk", x, w)  # the models' projections
    assert fab._tma_ready(view) is view and fab.copy_count() == 0
    wide = torch.zeros(1, 2, 33, 72, dtype=torch.bfloat16)
    for t in (wide[..., 1:65], wide[:, :, :, :64].transpose(2, 3)):
        got = fab._tma_ready(t)
        assert got is not t and torch.equal(got, t) and got.is_contiguous()
    assert fab.copy_count() == 2


def test_flash_attention_function_saves_the_lse_on_the_cpu():
    """ops.FlashAttention's forward keeps the lse beside q, k, v and out."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(11, 1, 4, 2, 16, 24, 32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.FlashAttention.apply(*leaves, True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    torch.testing.assert_close(saved[4], fa.flash_attention_lse_plain(q, k, v))
    got = torch.autograd.grad(out, leaves, dout)
    want = fab.flash_attention_bwd_plain(q, k, v, dout, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
