"""The port's SSD scan against the JAX package's Pallas kernel and oracles.

The plain PyTorch version (what the wrapper runs on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel to on the card) against
``repro.kernels.ssd_scan`` in interpret mode, ``ref.ssd_chunk_ref`` (the
sequential oracle) and the model's ``_ssd_chunked``, on the cases of
``tests/test_kernels.py``: the same inputs, drawn with numpy from a seed.
Tolerances are those of ``tests/test_kernels.py``: 1e-4 for f32; 2e-2 for
bf16 inputs, where y rounds to bf16 and the sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig, SSMConfig
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro.models.mamba import _ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

CASES = [
    (2, 32, 4, 64, 16, 8),
    (1, 24, 2, 32, 64, 16),
    (2, 128, 4, 64, 64, 128),
    (1, 33, 2, 32, 16, 8),  # padded tail chunk
]
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


def _tol(name):
    tol = 2e-2 if name == "bfloat16" else 1e-4
    return dict(rtol=tol, atol=tol)


def _inputs(seed, B, S, H, P, N, name="float32"):
    """xh, la, Bm, Cm as (jax, torch) pairs holding the same values.

    The scales are those of ``tests/test_kernels.py``; xh, Bm, Cm round to
    the dtype, la (log decays, <= 0) stays f32.
    """
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P), dtype=np.float32) * 0.5
    la = -np.abs(rng.standard_normal((B, S, H), dtype=np.float32)) * 0.3
    bm = rng.standard_normal((B, S, N), dtype=np.float32) * 0.5
    cm = rng.standard_normal((B, S, N), dtype=np.float32) * 0.5
    out = []
    for arr, dt in ((xh, tdt), (la, torch.float32), (bm, tdt), (cm, tdt)):
        t = torch.from_numpy(arr).to(dt)
        jd = jnp.float32 if dt == torch.float32 else jdt
        out.append((jnp.asarray(t.float().numpy()).astype(jd), t))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,S,H,P,N,Q", CASES)
def test_plain_matches_pallas_kernel_and_oracle(B, S, H, P, N, Q, name):
    (xj, xt), (lj, lt), (bj, bt), (cj, ct) = _inputs(S + P + N, B, S, H, P, N, name)
    y, hf = ssd.ssd_scan_plain(xt, lt, bt, ct, block_q=Q)
    assert y.dtype == xt.dtype and tuple(y.shape) == (B, S, H, P)
    assert hf.dtype == torch.float32 and tuple(hf.shape) == (B, H, P, N)
    y_k, h_k = jax_ssd(xj, lj, bj, cj, block_q=Q, interpret=True)
    y_r, h_r = ref.ssd_chunk_ref(xj, lj, bj, cj)
    for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
        np.testing.assert_allclose(_np(y), _np(want_y), **_tol(name))
        np.testing.assert_allclose(_np(hf), _np(want_h), **_tol(name))


def test_plain_matches_model_chunked():
    """The plain version and the XLA-path chunked implementation agree."""
    B, S, H, P, N, Q = 2, 64, 4, 32, 16, 16
    (xj, xt), (lj, lt), (bj, bt), (cj, ct) = _inputs(3, B, S, H, P, N)
    cfg = ModelConfig(
        d_model=H * P // 2,
        n_heads=H,
        n_kv_heads=H,
        ssm=SSMConfig(state=N, headdim=P, chunk=Q),
    )
    y_m, h_m = _ssd_chunked(xj, lj, bj, cj, cfg)
    y, hf = ssd.ssd_scan_plain(xt, lt, bt, ct, block_q=Q)
    np.testing.assert_allclose(_np(y), _np(y_m), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(hf), _np(h_m), rtol=1e-4, atol=1e-4)


def test_plain_carries_an_initial_state():
    B, S, H, P, N = 1, 40, 2, 32, 16
    (xj, xt), (lj, lt), (bj, bt), (cj, ct) = _inputs(5, B, S, H, P, N)
    h0 = np.random.default_rng(6).standard_normal((B, H, P, N), dtype=np.float32)
    y, hf = ssd.ssd_scan_plain(xt, lt, bt, ct, torch.from_numpy(h0), block_q=16)
    y_r, h_r = ref.ssd_chunk_ref(xj, lj, bj, cj, jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), _np(y_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(hf), _np(h_r), rtol=1e-4, atol=1e-4)


def test_plain_takes_strided_b_and_c():
    """Bm / Cm as slices of one wider tensor, as the model passes them."""
    B, S, H, P, N = 2, 48, 4, 32, 16
    (_, xt), (_, lt), (_, bt), (_, ct) = _inputs(8, B, S, H, P, N)
    wide = torch.cat([torch.zeros(B, S, 7), bt, ct, torch.zeros(B, S, 3)], dim=-1)
    bs, cs = wide[..., 7 : 7 + N], wide[..., 7 + N : 7 + 2 * N]
    assert bs.stride(1) == 7 + 2 * N + 3
    want = ssd.ssd_scan_plain(xt, lt, bt, ct, block_q=16)
    got = ssd.ssd_scan_plain(xt, lt, bs, cs, block_q=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)


@pytest.mark.parametrize("S,Q", [(1, 128), (1000, 128), (300, 128)])
def test_plain_chunks_agree_with_the_oracle(S, Q):
    """S = 1 (a one-position chunk) and ragged tails at the model's chunk."""
    B, H, P, N = 1, 2, 32, 16
    (xj, xt), (lj, lt), (bj, bt), (cj, ct) = _inputs(S, B, S, H, P, N)
    y, hf = ssd.ssd_scan_plain(xt, lt, bt, ct, block_q=Q)
    y_r, h_r = ref.ssd_chunk_ref(xj, lj, bj, cj)
    np.testing.assert_allclose(_np(y), _np(y_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(hf), _np(h_r), rtol=1e-4, atol=1e-4)


def test_steep_decays_stay_finite():
    """Above the diagonal cum_q - cum_j is large and positive: masked, no NaN."""
    B, S, H, P, N = 1, 128, 2, 32, 16
    (_, xt), (_, lt), (_, bt), (_, ct) = _inputs(9, B, S, H, P, N)
    y, hf = ssd.ssd_scan_plain(xt, lt * 400.0, bt, ct)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()


def test_wrapper_takes_the_plain_version_on_the_cpu():
    (_, xt), (_, lt), (_, bt), (_, ct) = _inputs(4, 1, 20, 2, 32, 16)
    ops.reset_launch_counts()
    got = ops.ssd_scan(xt, lt, bt, ct, block_q=8)
    want = ssd.ssd_scan_plain(xt, lt, bt, ct, block_q=8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ssd.ssd_scan(xt, lt, bt, ct, block_q=8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize(
    "call",
    [
        lambda x, la, b, c: ssd.ssd_scan(x[..., 0], la, b, c),
        lambda x, la, b, c: ssd.ssd_scan(x, la[:, :-1], b, c),
        lambda x, la, b, c: ssd.ssd_scan(x, la, b, c[..., :-1]),
        lambda x, la, b, c: ssd.ssd_scan(x, la, b.bfloat16(), c),
        lambda x, la, b, c: ssd.ssd_scan(x.double(), la, b.double(), c.double()),
        lambda x, la, b, c: ssd.ssd_scan(x, la.bfloat16(), b, c),
        lambda x, la, b, c: ssd.ssd_scan(x, la, b, c, torch.zeros(1, 2, 32, 8)),
        lambda x, la, b, c: ssd.ssd_scan(x, la, b, c, block_q=0),
        lambda x, la, b, c: ssd.ssd_scan(x[:, :0], la[:, :0], b[:, :0], c[:, :0]),
    ],
    ids=[
        "xh-rank",
        "la-shape",
        "b-c-shapes",
        "mixed-dtypes",
        "float64",
        "la-dtype",
        "h0-shape",
        "block-q",
        "no-positions",
    ],
)
def test_wrapper_refuses_bad_calls(call):
    (_, xt), (_, lt), (_, bt), (_, ct) = _inputs(3, 1, 8, 2, 32, 16)
    with pytest.raises((ValueError, TypeError)):
        call(xt, lt, bt, ct)
