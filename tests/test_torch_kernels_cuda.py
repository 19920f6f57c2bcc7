"""The CUDA kernels against their plain PyTorch versions, on the card.

The attention, SSD and mLSTM kernels are also held, inside the reduced models,
against the same models routed through the plain versions
(``ops.plain()``).

These tests need a CUDA device and ``nvcc``; elsewhere they skip with the
reason.  The module imports nothing of the JAX package, so it also runs on
a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.backend import TorchBackend
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as seg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.model import build_model
from repro_torch.serve_lm import serve

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


def _piece_spans(kind, n_cols):
    """(starts, ends, n) at the kernel's own piece size: spans of exactly R
    and R + 1 rows, empty spans among long ones, a giant span, and spans
    with rows in no span between them."""
    r = seg.rows_per_piece(n_cols)
    lens = {
        "exact": [r, 2 * r, r, 3],
        "one-over": [r + 1, 1, r + 1, 2 * r + 1],
        "empty": [0, 3 * r + 7, 0, 0, r, 0],
        "giant": [5, 100, 40 * r + 13, 7, 0, 300],
        "gaps": [3, r + 2, 2 * r, 5, 0, 3 * r + 1],
    }[kind]
    # "gaps": rows in no span between the spans, and past the last
    gaps = [r, 2, r + 3, 0, 1, 2 * r] if kind == "gaps" else [0] * len(lens)
    ends = np.cumsum(np.add(lens, gaps)).astype(np.int64)
    return ends - np.asarray(lens, np.int64), ends, int(ends[-1]) + gaps[-1]


@pytest.mark.parametrize("kind", ["exact", "one-over", "empty", "giant", "gaps"])
@pytest.mark.parametrize("n_cols", [1, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32, torch.float64])
def test_split_spans_match_plain_version(card, kind, n_cols, dtype):
    """Both passes on the card: integers bit-equal (the sums wrap), f32
    max/min propagate NaN, f64 sums within 1e-12 of max|plain|."""
    starts_np, ends_np, n = _piece_spans(kind, n_cols)
    assert n > seg.rows_per_piece(n_cols)  # the two-pass route
    rng = np.random.default_rng(n + n_cols)
    if dtype.is_floating_point:
        vals = torch.from_numpy(rng.standard_normal((n, n_cols)) * 1e3).to(card, dtype)
        if dtype == torch.float32:
            vals[::997, 0] = float("nan")
    else:
        hi = torch.iinfo(dtype).max
        vals = torch.from_numpy(rng.integers(hi // 4, hi, (n, n_cols))).to(card, dtype)
    starts = torch.from_numpy(starts_np).to(card)
    ends = torch.from_numpy(ends_np).to(card)
    for op in seg.OPS:
        got = seg.segment_reduce(vals, starts, ends, op)
        want = seg.segment_reduce_plain(vals, starts, ends, op)
        if dtype == torch.float64 and op == "sum":
            assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        elif dtype == torch.float32 and op == "sum":
            # f32 sums in another order: within 1e-5 of the sum of |values|
            scale = float(vals.abs().nan_to_num().sum())
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale, equal_nan=True)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


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


# ---------------------------------------------------------------------------
# Attention kernels
# ---------------------------------------------------------------------------

def _attn_tol(dtype):
    # bf16 inputs: the kernel's f32 sums run in another order than the
    # plain version's, and the output rounds to bf16 (tests/test_kernels.py)
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(
        rtol=2e-5, atol=2e-5
    )


def _randn(rng, shape, dtype, card):
    x = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(card, dtype)


@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,D",
    [
        (2, 4, 2, 128, 128, 64),
        (1, 8, 1, 96, 96, 64),  # MQA, ragged tiles
        (2, 4, 4, 64, 256, 128),  # queries at the end of the keys
        (1, 2, 2, 33, 33, 32),
        (1, 8, 1, 200, 200, 256),  # gemma's head dim
        (1, 7, 1, 130, 130, 128),  # deepseek's 7-head groups
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_version(card, B, Hq, Hkv, Sq, Sk, D, dtype, causal):
    rng = np.random.default_rng(Sq + D)
    q = _randn(rng, (B, Hq, Sq, D), dtype, card)
    k = _randn(rng, (B, Hkv, Sk, D), dtype, card)
    v = _randn(rng, (B, Hkv, Sk, D), dtype, card)
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_count() == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


def test_flash_kernel_takes_einsum_layouts(card):
    """q/k/v straight from the ``bsd,dhk->bhsk`` projection (not contiguous)."""
    rng = np.random.default_rng(3)
    x = _randn(rng, (2, 40, 64), torch.bfloat16, card)
    w = _randn(rng, (64, 3, 4, 32), torch.bfloat16, card) * 0.2
    q, k, v = (torch.einsum("bsd,dhk->bhsk", x, w[:, i]) for i in range(3))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(torch.bfloat16))


@pytest.mark.parametrize(
    "B,Hq,Hkv,S,D,kv_len",
    [
        (2, 4, 2, 256, 64, 256),
        (1, 8, 1, 512, 128, 101),  # partly filled cache, MQA
        (2, 2, 2, 96, 64, 51),
        (3, 16, 16, 300, 128, 257),
        (1, 56, 8, 700, 128, 650),  # 7-head groups
        (2, 8, 1, 70, 256, 1),
        (1, 4, 1, 64, 32, 64),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(card, B, Hq, Hkv, S, D, kv_len, dtype):
    rng = np.random.default_rng(S + kv_len)
    q = _randn(rng, (B, Hq, 1, D), dtype, card)
    k = _randn(rng, (B, Hkv, S, D), dtype, card)
    v = _randn(rng, (B, Hkv, S, D), dtype, card)
    before = dec.launch_count()
    got = dec.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert dec.launch_count() == before + 1
    want = dec.decode_attention_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))


def _assert_attn_close(got, want, dtype):
    """The kernels' tolerance and, in bf16, the same tolerance scaled to each
    output row's largest |value|: over a long cache the outputs are a few
    hundredths, where an absolute 2e-2 would not see a key range dropped or
    weighted wrongly."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **_attn_tol(dtype))
    if dtype == torch.bfloat16:
        tol = _attn_tol(dtype)["rtol"]
        scale = want.abs().amax(-1, keepdim=True)
        excess = (got - want).abs() - tol * (want.abs() + scale)
        assert float(excess.max()) <= 0, f"past the row-scaled bound by {excess.max()}"


def _flash_once(q, k, v, causal):
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_count() == before + 1
    return got


@pytest.mark.parametrize("S", [127, 128, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_tile_edges(card, S, causal):
    """Sequence lengths around the 128-row query block and 128-key tile."""
    rng = np.random.default_rng(S)
    q = _randn(rng, (1, 4, S, 128), torch.bfloat16, card)
    k = _randn(rng, (1, 2, S, 128), torch.bfloat16, card)
    v = _randn(rng, (1, 2, S, 128), torch.bfloat16, card)
    got = _flash_once(q, k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    _assert_attn_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("Sq,Sk", [(200, 200), (70, 333)])
def test_flash_bf16_every_head_dim(card, D, Sq, Sk):
    """Each head dim's swizzle (64-byte at D 32, 128-byte above) and tile."""
    rng = np.random.default_rng(D + Sq)
    q = _randn(rng, (2, 4, Sq, D), torch.bfloat16, card)
    k = _randn(rng, (2, 2, Sk, D), torch.bfloat16, card)
    v = _randn(rng, (2, 2, Sk, D), torch.bfloat16, card)
    for causal in (True, False):
        got = _flash_once(q, k, v, causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        _assert_attn_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_takes_einsum_views_as_they_are(card, D):
    """The model's bsd,dhk->bhsk views (head stride D, sequence stride H D)
    go to TMA without a copy."""
    rng = np.random.default_rng(D)
    x = _randn(rng, (2, 300, 256), torch.bfloat16, card)
    w = _randn(rng, (256, 3, 4, D), torch.bfloat16, card) * 0.1
    q, k, v = (torch.einsum("bsd,dhk->bhsk", x, w[:, i]) for i in range(3))
    assert q.stride()[1:] == (D, 4 * D, 1)
    got = _flash_once(q, k, v, True)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    _assert_attn_close(got, want, torch.bfloat16)


def test_attention_kernels_refuse_misaligned_views(card):
    """A view 2 bytes past a 16-byte boundary: TMA and the 16-byte copies
    cannot take it, and the wrappers raise rather than copy."""
    flat = torch.zeros(2 * 4 * 64 * 64 + 1, dtype=torch.bfloat16, device=card)
    bad = flat[1:].view(2, 4, 64, 64)
    good = torch.zeros((2, 4, 64, 64), dtype=torch.bfloat16, device=card)
    before = fa.launch_count(), dec.launch_count()
    with pytest.raises(ValueError):
        fa.flash_attention(bad, good, good)
    with pytest.raises(ValueError):
        fa.flash_attention(good, good, bad)
    with pytest.raises(ValueError):
        dec.decode_attention(good[:, :, :1], bad, good, 10)
    assert (fa.launch_count(), dec.launch_count()) == before


def _decode_once(q, k, v, kv_len):
    before = dec.launch_count()
    got = dec.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert dec.launch_count() == before + 1
    return got


#: kv_len = splits * per + offset, where per is a range's length in this
#: card's plan for (B 2, 16 kv heads, MHA, kv_len 1040): 1, and one less,
#: exactly and one more than the first two range boundaries
SPLIT_EDGES = [(0, 1), (1, -1), (1, 0), (1, 1), (2, -1), (2, 0), (2, 1)]


@pytest.mark.parametrize("splits,offset", SPLIT_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_edges(card, splits, offset, dtype):
    rng = np.random.default_rng(10 * splits + offset)
    q = _randn(rng, (2, 16, 1, 128), dtype, card)
    k = _randn(rng, (2, 16, 1100, 128), dtype, card)
    v = _randn(rng, (2, 16, 1100, 128), dtype, card)
    n, per = dec.card_split_plan(q, k, 1040)
    assert n > 1
    kv_len = splits * per + offset
    got = _decode_once(q, k, v, kv_len)
    want = dec.decode_attention_plain(q, k, v, kv_len)
    _assert_attn_close(got, want, dtype)


@pytest.mark.parametrize(
    "B,Hq,Hkv,S,D,kv_len",
    [
        (1, 16, 16, 9216, 128, 9000),  # batch 1: many splits
        (1, 56, 8, 9216, 128, 9000),  # 7-head groups, many splits
        (2, 14, 2, 3000, 64, 2999),  # 7-head groups, a few splits
        (1, 8, 1, 5000, 256, 4097),  # MQA at gemma's head dim, 32-key tiles
        (1, 4, 4, 4096, 32, 4096),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_many_splits(card, B, Hq, Hkv, S, D, kv_len, dtype):
    rng = np.random.default_rng(kv_len + D)
    q = _randn(rng, (B, Hq, 1, D), dtype, card)
    k = _randn(rng, (B, Hkv, S, D), dtype, card)
    v = _randn(rng, (B, Hkv, S, D), dtype, card)
    n_split, _ = dec.card_split_plan(q, k, kv_len)
    assert n_split > 1
    got = _decode_once(q, k, v, kv_len)
    want = dec.decode_attention_plain(q, k, v, kv_len)
    _assert_attn_close(got, want, dtype)


def test_attention_kernels_raise_on_unsupported_head_dim(card):
    q = torch.zeros((1, 2, 8, 48), device=card)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        dec.decode_attention(q[:, :, :1], q, q, 4)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half()[..., :32], q.half()[..., :32], q.half()[..., :32])


def test_ops_plain_routes_the_card_to_plain_versions(card):
    rng = np.random.default_rng(5)
    q = _randn(rng, (1, 2, 16, 64), torch.bfloat16, card)
    xh, la, bm, cm = _ssd_inputs(rng, 1, 40, 2, 32, 16, torch.bfloat16, card)
    mq, mk, mv, lf, li = _mlstm_inputs(rng, 1, 40, 2, 64, torch.bfloat16, card)
    ops.reset_launch_counts()
    with ops.plain():
        ops.flash_attention(q, q, q)
        ops.decode_attention(q[:, :, :1], q, q, 16)
        ops.ssd_scan(xh, la, bm, cm)
        ops.mlstm_scan(mq, mk, mv, lf, li)
    assert ops.launch_counts() == {
        "flash_attention": 0,
        "decode_attention": 0,
        "ssd_scan": 0,
        "mlstm_scan": 0,
    }
    ops.flash_attention(q, q, q)
    ops.decode_attention(q[:, :, :1], q, q, 16)
    ops.ssd_scan(xh, la, bm, cm)
    ops.mlstm_scan(mq, mk, mv, lf, li)
    assert ops.launch_counts() == {
        "flash_attention": 1,
        "decode_attention": 1,
        "ssd_scan": 1,
        "mlstm_scan": 1,
    }


def _launches_per_serve(cfg, n_new: int) -> dict:
    """Kernel launches of one prefill and ``n_new - 1`` decode steps."""
    if cfg.family == "hybrid":
        n_shared = -(-cfg.n_layers // cfg.shared_attn_every) - 1
        return {
            "flash_attention": n_shared,
            "decode_attention": (n_new - 1) * n_shared,
            "ssd_scan": cfg.n_layers,
            "mlstm_scan": 0,
        }
    if cfg.family == "ssm":
        return {
            "flash_attention": 0,
            "decode_attention": 0,
            "ssd_scan": 0,
            "mlstm_scan": cfg.n_layers,
        }
    return {
        "flash_attention": cfg.n_layers,
        "decode_attention": (n_new - 1) * cfg.n_layers,
        "ssd_scan": 0,
        "mlstm_scan": 0,
    }


@pytest.mark.parametrize(
    "arch", ["olmo-1b", "gemma-2b", "deepseek-coder-33b", "zamba2-1.2b", "xlstm-1.3b"]
)
def test_reduced_model_on_card_matches_plain_versions(card, arch):
    cfg = registry.get(arch).reduced()
    model = build_model(cfg, device=card, seed=0)
    if cfg.family == "hybrid":
        # the shared block's attention is one-hot under the reference init,
        # and in bf16 a one-step rounding difference upstream flips it
        model = model.float()
    gen = torch.Generator(device=card).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (2, 40), generator=gen, device=card)
    ops.reset_launch_counts()
    res = serve(model, prompts, 6)
    assert ops.launch_counts() == _launches_per_serve(cfg, 6)
    with ops.plain():
        logits, caches = model.prefill({"tokens": prompts}, s_max=46)
        scale = float(logits.abs().max())
        torch.testing.assert_close(
            res.prefill_logits, logits, rtol=2e-2, atol=0.02 * scale
        )
        for t in range(5):
            logits, caches = model.decode(caches, res.tokens[:, t : t + 1], 40 + t)
            torch.testing.assert_close(
                res.decode_logits[t], logits, rtol=2e-2, atol=0.02 * scale
            )


def test_reduced_zamba2_launch_counts():
    """5 Mamba-2 layers in groups 2+2+1, the shared block after two of them."""
    cfg = registry.get("zamba2-1.2b").reduced()
    assert _launches_per_serve(cfg, 6) == {
        "flash_attention": 2,
        "decode_attention": 10,
        "ssd_scan": 5,
        "mlstm_scan": 0,
    }


def test_reduced_xlstm_launch_counts():
    """4 mLSTM layers: one scan each per prefill, none per decode step."""
    cfg = registry.get("xlstm-1.3b").reduced()
    assert _launches_per_serve(cfg, 6) == {
        "flash_attention": 0,
        "decode_attention": 0,
        "ssd_scan": 0,
        "mlstm_scan": 4,
    }


# ---------------------------------------------------------------------------
# SSD scan kernel
# ---------------------------------------------------------------------------

#: bf16 inputs: y rounds to bf16 and the sums run in another order
#: (tests/test_kernels.py's bf16 tolerance); f32: its 1e-4
SSD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _ssd_inputs(rng, B, S, H, P, N, dtype, card):
    """The scales of tests/test_kernels.py; la (log decays) f32 and <= 0."""
    xh = _randn(rng, (B, S, H, P), dtype, card) * 0.5
    la = -_randn(rng, (B, S, H), torch.float32, card).abs() * 0.3
    bm = _randn(rng, (B, S, N), dtype, card) * 0.5
    cm = _randn(rng, (B, S, N), dtype, card) * 0.5
    return xh, la, bm, cm


def _ssd_close(got, want, dtype):
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "B,S,H,P,N,Q",
    [
        (2, 256, 8, 64, 64, 128),  # zamba2's head and state, fewer heads
        (1, 200, 4, 64, 64, 128),  # a ragged last chunk
        (1, 1, 4, 64, 64, 128),  # one position
        (2, 64, 8, 32, 16, 16),  # the reduced zamba2
        (1, 1000, 2, 64, 32, 128),
        (1, 33, 2, 32, 64, 8),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version(card, B, S, H, P, N, Q, dtype):
    rng = np.random.default_rng(S + P + N)
    xh, la, bm, cm = _ssd_inputs(rng, B, S, H, P, N, dtype, card)
    before = ssd.launch_count()
    got = ssd.ssd_scan(xh, la, bm, cm, block_q=Q)
    torch.cuda.synchronize()
    assert ssd.launch_count() == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _ssd_close(got, ssd.ssd_scan_plain(xh, la, bm, cm, block_q=Q), dtype)


def test_ssd_kernel_takes_strided_b_c_and_an_initial_state(card):
    """Bm / Cm as slices of the conv output, as the model passes them."""
    rng = np.random.default_rng(12)
    B, S, H, P, N = 2, 300, 4, 64, 64
    xh, la, _, _ = _ssd_inputs(rng, B, S, H, P, N, torch.bfloat16, card)
    xbc = _randn(rng, (B, S, H * P + 2 * N), torch.bfloat16, card) * 0.5
    bm, cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    h0 = _randn(rng, (B, H, P, N), torch.float32, card)
    got = ssd.ssd_scan(xh, la, bm, cm, h0)
    want = ssd.ssd_scan_plain(xh, la, bm.contiguous(), cm.contiguous(), h0)
    _ssd_close(got, want, torch.bfloat16)


def test_ssd_kernel_steep_decays_stay_finite(card):
    """Above the diagonal cum_q - cum_j reaches ~1e4: masked, no NaN.

    The prefix sums reach ~1e4 here, so their f32 rounding, which depends
    on the order of the sums, moves exp(cum_q - cum_j) by up to ~1e-3
    relative: the values are held at 1e-2, not at the f32 tolerance.
    """
    rng = np.random.default_rng(13)
    xh, la, bm, cm = _ssd_inputs(rng, 1, 256, 2, 64, 64, torch.float32, card)
    y, hf = ssd.ssd_scan(xh, la * 400.0, bm, cm)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    y_p, hf_p = ssd.ssd_scan_plain(xh, la * 400.0, bm, cm)
    torch.testing.assert_close(y, y_p, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(hf, hf_p, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize(
    "B,S,H,P,N,Q",
    [
        (1, 1000, 12, 64, 64, 128),  # three groups of heads, a ragged last chunk
        (2, 300, 6, 64, 32, 128),  # a ragged group of heads
        (2, 200, 8, 32, 16, 16),  # the reduced zamba2's P, N and chunk
        (1, 4096, 4, 64, 64, 128),  # 32 chunks through the state passing
        (1, 77, 2, 32, 64, 64),  # a chunk of 64 rows: one warpgroup's rows
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
def test_ssd_passes_match_plain_version(card, B, S, H, P, N, Q, dtype, with_h0):
    """The three passes across groups of heads, ragged chunks and groups,
    P 32 with N 16 and chunks of 16, 32 chunks, with and without h0, on
    both routes."""
    rng = np.random.default_rng(S * H + P + N + Q)
    xh, la, bm, cm = _ssd_inputs(rng, B, S, H, P, N, dtype, card)
    h0 = _randn(rng, (B, H, P, N), torch.float32, card) if with_h0 else None
    got = ssd.ssd_scan(xh, la, bm, cm, h0, block_q=Q)
    torch.cuda.synchronize()
    _ssd_close(got, ssd.ssd_scan_plain(xh, la, bm, cm, h0, block_q=Q), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_takes_the_models_layout(card, dtype):
    """Bm / Cm as strided slices of one conv output (row stride H P + 2 N),
    xh dt-scaled, and h0, on both routes."""
    rng = np.random.default_rng(15)
    B, S, H, P, N = 2, 400, 8, 64, 64
    xbc = _randn(rng, (B, S, H * P + 2 * N), dtype, card) * 0.5
    xh = xbc[..., : H * P].reshape(B, S, H, P) * 0.7
    bm, cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    la = -_randn(rng, (B, S, H), torch.float32, card).abs() * 0.3
    h0 = _randn(rng, (B, H, P, N), torch.float32, card)
    assert not bm.is_contiguous() and ssd._vector_rows(bm)
    got = ssd.ssd_scan(xh, la, bm, cm, h0)
    want = ssd.ssd_scan_plain(xh, la, bm.contiguous(), cm.contiguous(), h0)
    _ssd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_copies_rows_off_16_bytes(card, dtype):
    """Inputs whose base lies one element past a 16-byte boundary (a slice
    that starts one element in, strided or contiguous) are copied first."""
    rng = np.random.default_rng(16)
    B, S, H, P, N = 2, 300, 4, 64, 32
    xh0, la, bm0, cm0 = _ssd_inputs(rng, B, S, H, P, N, dtype, card)
    wide = torch.cat([torch.zeros(B, S, 1, dtype=dtype, device=card), bm0, cm0], dim=-1)
    bm, cm = wide[..., 1 : 1 + N], wide[..., 1 + N :]
    flat = torch.zeros(xh0.numel() + 1, dtype=dtype, device=card)
    flat[1:] = xh0.reshape(-1)
    xh = flat[1:].view(xh0.shape)
    h0 = torch.zeros(B * H * P * N + 1, device=card)[1:].view(B, H, P, N)
    h0.copy_(_randn(rng, (B, H, P, N), torch.float32, card))
    assert not any(ssd._vector_rows(t) for t in (xh, bm, cm))
    assert xh.is_contiguous() and h0.data_ptr() % 16
    got = ssd.ssd_scan(xh, la, bm, cm, h0)
    want = ssd.ssd_scan_plain(xh0, la, bm0, cm0, h0.clone())
    _ssd_close(got, want, dtype)


def test_ssd_kernel_raises_on_unsupported_sizes(card):
    rng = np.random.default_rng(14)
    xh, la, bm, cm = _ssd_inputs(rng, 1, 16, 2, 48, 16, torch.float32, card)
    with pytest.raises(ValueError):
        ssd.ssd_scan(xh, la, bm, cm)  # P = 48
    xh, la, bm, cm = _ssd_inputs(rng, 1, 256, 2, 64, 64, torch.float32, card)
    with pytest.raises(ValueError):
        ssd.ssd_scan(xh, la, bm, cm, block_q=256)


# ---------------------------------------------------------------------------
# mLSTM scan kernel
# ---------------------------------------------------------------------------

#: h and the final C, n, m: rtol 1e-3, atol 1e-3 * max|plain| (the sums of
#: the kernel and the plain version run in f32 in another order)
MLSTM_RTOL = 1e-3


def _mlstm_inputs(rng, B, S, H, D, dtype, card, steep=False):
    """tests/test_kernels.py's scales (k scaled by 1/√D); lf, li f32."""
    q = _randn(rng, (B, S, H, D), dtype, card)
    k = (_randn(rng, (B, S, H, D), torch.float32, card) / D**0.5).to(dtype)
    v = _randn(rng, (B, S, H, D), dtype, card)
    z = _randn(rng, (B, S, H), torch.float32, card)
    if steep:
        return q, k, v, -10.0 + 0.1 * z, 4.0 * _randn(rng, (B, S, H), torch.float32, card)
    return q, k, v, torch.nn.functional.logsigmoid(2.0 * z), _randn(
        rng, (B, S, H), torch.float32, card
    )


def _mlstm_close(got, want):
    (h, state), (h_p, state_p) = got, want
    for g, w in zip((h, *state), (h_p, *state_p)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        tol = MLSTM_RTOL * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=MLSTM_RTOL, atol=tol)


@pytest.mark.parametrize(
    "B,S,H,D,Q,kind",
    [
        (1, 256, 2, 1024, 128, None),  # xlstm-1.3b's head dim
        (1, 200, 2, 1024, 128, "state"),  # an initial state, a ragged chunk
        (2, 256, 4, 64, 16, None),  # the reduced xlstm
        (1, 1, 4, 1024, 128, None),  # one position
        (1, 300, 2, 96, 128, "steep"),  # a D tile of 32, steep gates
        (1, 33, 1, 32, 8, None),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernel_matches_plain_version(card, B, S, H, D, Q, kind, dtype):
    rng = np.random.default_rng(S + D)
    q, k, v, lf, li = _mlstm_inputs(rng, B, S, H, D, dtype, card, kind == "steep")
    state = None
    if kind == "state":
        state = (
            0.1 * _randn(rng, (B, H, D, D), torch.float32, card),
            0.1 * _randn(rng, (B, H, D), torch.float32, card),
            _randn(rng, (B, H), torch.float32, card),
        )
    before = ms.launch_count()
    got = ms.mlstm_scan(q, k, v, lf, li, state, block_q=Q)
    torch.cuda.synchronize()
    assert ms.launch_count() == before + 1
    _mlstm_close(got, ms.mlstm_scan_plain(q, k, v, lf, li, state, block_q=Q))


def test_mlstm_kernel_takes_strided_inputs(card):
    """q/k/v as slices of one projection and the gates as slices of one
    tensor, as a model may pass them."""
    rng = np.random.default_rng(21)
    B, S, H, D = 2, 150, 2, 64
    qkv = _randn(rng, (B, S, H, 3 * D), torch.bfloat16, card)
    q, k, v = qkv[..., :D], qkv[..., D : 2 * D] * 0.125, qkv[..., 2 * D :]
    gates = _randn(rng, (B, S, 2 * H), torch.float32, card)
    lf = torch.nn.functional.logsigmoid(gates[..., :H])
    li = gates[..., H:]
    assert not q.is_contiguous() and not li.is_contiguous()
    got = ms.mlstm_scan(q, k, v, lf, li, block_q=64)
    want = ms.mlstm_scan_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), lf, li.contiguous(), block_q=64
    )
    _mlstm_close(got, want)


def test_mlstm_kernel_raises_on_unsupported_sizes(card):
    rng = np.random.default_rng(22)
    q, k, v, lf, li = _mlstm_inputs(rng, 1, 16, 2, 48, torch.float32, card)
    with pytest.raises(ValueError):
        ms.mlstm_scan(q, k, v, lf, li)  # D = 48
    q, k, v, lf, li = _mlstm_inputs(rng, 1, 256, 2, 64, torch.float32, card)
    with pytest.raises(ValueError):
        ms.mlstm_scan(q, k, v, lf, li, block_q=256)


#: head dims of the wgmma route and the cluster each gives (D / 128, or
#: D / 64 where D is an odd multiple of 64)
WGMMA_DIMS = [64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 896, 1024]


@pytest.mark.parametrize("D", WGMMA_DIMS)
@pytest.mark.parametrize(
    "S,Q,kind",
    [(300, 128, None), (1, 128, None), (200, 64, "state"), (130, 16, "steep")],
    ids=["ragged", "one-position", "initial-state", "steep-chunk-16"],
)
def test_mlstm_wgmma_route_matches_plain_version(card, D, S, Q, kind):
    """Every cluster size of the bf16 wgmma route, ragged chunks, S 1, an
    initial state and steep gates, held to MLSTM_RTOL."""
    assert ms.kernel_route(torch.bfloat16, D) == "wgmma"
    B, H = 1, 2
    rng = np.random.default_rng(S * D + Q)
    q, k, v, lf, li = _mlstm_inputs(rng, B, S, H, D, torch.bfloat16, card, kind == "steep")
    state = None
    if kind == "state":
        state = (
            0.1 * _randn(rng, (B, H, D, D), torch.float32, card),
            0.1 * _randn(rng, (B, H, D), torch.float32, card),
            _randn(rng, (B, H), torch.float32, card),
        )
    got = ms.mlstm_scan(q, k, v, lf, li, state, block_q=Q)
    torch.cuda.synchronize()
    _mlstm_close(got, ms.mlstm_scan_plain(q, k, v, lf, li, state, block_q=Q))


@pytest.mark.parametrize("D", [128, 1024])
def test_mlstm_wgmma_route_takes_strided_inputs(card, D):
    """q/k/v as slices of one projection and the gates as slices of one
    tensor, on the wgmma route (TMA reads the strided rows as they lie)."""
    rng = np.random.default_rng(D)
    B, S, H = 2, 150, 2
    qkv = _randn(rng, (B, S, H, 3 * D), torch.bfloat16, card)
    q, k, v = qkv[..., :D], qkv[..., D : 2 * D] * D**-0.5, qkv[..., 2 * D :]
    gates = _randn(rng, (B, S, 2 * H), torch.float32, card)
    lf = torch.nn.functional.logsigmoid(gates[..., :H])
    li = gates[..., H:]
    assert not q.is_contiguous() and ms.kernel_route(q.dtype, D) == "wgmma"
    got = ms.mlstm_scan(q, k, v, lf, li, block_q=64)
    want = ms.mlstm_scan_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), lf, li.contiguous(), block_q=64
    )
    _mlstm_close(got, want)


_APP_CASES = {
    "amg": ((4, 4, 2), dict(nx=8, ny=8, nz=8)),
    "laghos": ((4, 4, 1), dict(nx=64, ny=64, n_steps=2)),
    "beatnik": ((4, 2, 1), dict(nx=8, ny=8, far_subsample=8, n_steps=4)),
}


@pytest.mark.parametrize("app", list(_APP_CASES))
def test_app_profiles_network_rows_and_streams_on_the_card(card, app):
    """An app's profile, its modeled-network rows and its incremental
    profile reduced on the card equal NumpyBackend's, byte for byte."""
    from repro_torch.apps import amg, beatnik, laghos
    from repro_torch.apps.stencil import Decomp3D
    from repro_torch.core.backend import NumpyBackend
    from repro_torch.core.network import FABRICS
    from repro_torch.core.profiler import CommPatternProfiler, trace_observer
    from repro_torch.core.thicket import Frame

    mod = {"amg": amg, "laghos": laghos, "beatnik": beatnik}[app]
    cls = {"amg": "AMGConfig", "laghos": "LaghosConfig", "beatnik": "BeatnikConfig"}[app]
    shape, params = _APP_CASES[app]
    cfg = getattr(mod, cls)(decomp=Decomp3D(*shape), **params)
    held = {}

    def keep(rec, **kw):
        held["rec"] = rec
        return None

    with trace_observer(keep):
        prof = mod.profile(cfg)  # the default backend: torch on the card
    rec = held["rec"]
    want = CommPatternProfiler.from_recorder(
        rec, name=prof.name, meta=prof.meta, backend=NumpyBackend()
    )
    assert prof.to_json() == want.to_json()
    entries = [(prof.name, prof.n_ranks, rec, fab) for fab in FABRICS]
    assert (
        Frame.from_network(entries).to_csv()
        == Frame.from_network(entries, backend=NumpyBackend()).to_csv()
    )
    sp = CommPatternProfiler.incremental(rec)
    for cut in np.linspace(0, rec.buffer.n_rows, 4).astype(int):
        sp.update(int(cut))
    assert sp.profile(name=prof.name, meta=prof.meta).to_json() == want.to_json()


@pytest.mark.parametrize("app", list(_APP_CASES))
def test_app_oracles_on_the_card_match_the_cpu(card, app):
    from repro_torch.apps import amg, beatnik, laghos
    from repro_torch.apps.stencil import Decomp3D

    shape, params = _APP_CASES[app]
    if app == "amg":
        cfg = amg.AMGConfig(decomp=Decomp3D(*shape), **params)
        run = amg.reference_solve(cfg)[0]
        got, want = run(amg.make_rhs(cfg)), run(amg.make_rhs(cfg, device="cpu"))
    elif app == "laghos":
        cfg = laghos.LaghosConfig(decomp=Decomp3D(*shape), **params)
        run = laghos.reference_steps(cfg)
        (s, d), (s0, d0) = run(laghos.make_state(cfg)), run(laghos.make_state(cfg, device="cpu"))
        got, want = [*s.values(), d], [*s0.values(), d0]
    else:
        cfg = beatnik.BeatnikConfig(decomp=Decomp3D(*shape), **params)
        run = beatnik.reference_steps(cfg)
        (zw, n), (zw0, n0) = run(beatnik.make_state(cfg)), run(
            beatnik.make_state(cfg, device="cpu")
        )
        got, want = [*zw, n], [*zw0, n0]
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=5e-5, atol=5e-6)
