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


# ---------------------------------------------------------------------------
# The three passes the kernel runs, each against the JAX package
# ---------------------------------------------------------------------------

PASS_CASE = (1, 48, 2, 32, 16, 16)  # B, S, H, P, N, Q: three chunks


def _jax_prefix(xj, lj, bj, cj, start, stop, Q):
    """The Pallas kernel (interpret mode) on positions [start, stop) only."""
    sl = slice(start, stop)
    return jax_ssd(xj[:, sl], lj[:, sl], bj[:, sl], cj[:, sl], block_q=Q, interpret=True)


def test_chunk_states_match_pallas_kernel_on_each_chunk():
    """Chunk c's own state is the Pallas kernel's h_final on chunk c alone,
    and its decay is exp of the chunk's summed log decays."""
    B, S, H, P, N, Q = PASS_CASE
    (xj, xt), (lj, lt), (bj, bt), (cj, ct) = _inputs(21, B, S, H, P, N)
    states, decay = ssd.ssd_chunk_states(xt, lt, bt, block_q=Q)
    assert tuple(states.shape) == (B, S // Q, H, P, N)
    for c in range(S // Q):
        _, h_k = _jax_prefix(xj, lj, bj, cj, c * Q, (c + 1) * Q, Q)
        np.testing.assert_allclose(_np(states[:, c]), _np(h_k), rtol=1e-4, atol=1e-4)
        want = np.exp(_np(lt[:, c * Q : (c + 1) * Q]).sum(axis=1))
        np.testing.assert_allclose(_np(decay[:, c]), want, rtol=1e-5)


def test_state_passing_matches_pallas_kernel_on_prefixes():
    """The state entering chunk c is the Pallas kernel's h_final on the first
    c chunks; the final state is the oracle's."""
    B, S, H, P, N, Q = PASS_CASE
    (xj, xt), (lj, lt), (bj, bt), (cj, ct) = _inputs(22, B, S, H, P, N)
    h_enter, h_final = ssd.ssd_state_passing(*ssd.ssd_chunk_states(xt, lt, bt, block_q=Q))
    assert not h_enter[:, 0].any()
    for c in range(1, S // Q):
        _, h_k = _jax_prefix(xj, lj, bj, cj, 0, c * Q, Q)
        np.testing.assert_allclose(_np(h_enter[:, c]), _np(h_k), rtol=1e-4, atol=1e-4)
    _, h_r = ref.ssd_chunk_ref(xj, lj, bj, cj)
    np.testing.assert_allclose(_np(h_final), _np(h_r), rtol=1e-4, atol=1e-4)


def test_state_passing_starts_from_h0():
    B, S, H, P, N, Q = PASS_CASE
    (xj, xt), (lj, lt), (bj, bt), (cj, ct) = _inputs(23, B, S, H, P, N)
    h0 = np.random.default_rng(24).standard_normal((B, H, P, N), dtype=np.float32)
    h_enter, h_final = ssd.ssd_state_passing(
        *ssd.ssd_chunk_states(xt, lt, bt, block_q=Q), torch.from_numpy(h0)
    )
    np.testing.assert_array_equal(_np(h_enter[:, 0]), h0)
    for c in range(1, S // Q):
        _, h_r = ref.ssd_chunk_ref(xj[:, : c * Q], lj[:, : c * Q], bj[:, : c * Q],
                                   cj[:, : c * Q], jnp.asarray(h0))
        np.testing.assert_allclose(_np(h_enter[:, c]), _np(h_r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [48, 41], ids=["whole-chunks", "ragged-tail"])
def test_chunk_outputs_match_pallas_kernel_and_oracle(S):
    """y from each chunk's inputs and the oracle's entering states is the
    Pallas kernel's and the oracle's y."""
    B, _, H, P, N, Q = PASS_CASE
    (xj, xt), (lj, lt), (bj, bt), (cj, ct) = _inputs(25, B, S, H, P, N)
    n_chunks = -(-S // Q)
    enter = [np.zeros((B, H, P, N), np.float32)]
    for c in range(1, n_chunks):
        _, h_r = ref.ssd_chunk_ref(xj[:, : c * Q], lj[:, : c * Q], bj[:, : c * Q],
                                   cj[:, : c * Q])
        enter.append(_np(h_r))
    h_enter = torch.from_numpy(np.stack(enter, axis=1))
    y = ssd.ssd_chunk_outputs(xt, lt, bt, ct, h_enter, block_q=Q)
    assert tuple(y.shape) == (B, S, H, P)
    y_k, _ = jax_ssd(xj, lj, bj, cj, block_q=Q, interpret=True)
    y_r, _ = ref.ssd_chunk_ref(xj, lj, bj, cj)
    for want in (y_k, y_r):
        np.testing.assert_allclose(_np(y), _np(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The bf16 (wgmma) route's rounding plan, emulated on the CPU
# ---------------------------------------------------------------------------


def _bf16_parts(x, parts):
    """``x`` (f32) as the kernel feeds it to the tensor cores: bf16 hi, and
    with two parts + bf16(x - hi), summed back in f32 (exact)."""
    hi = x.bfloat16().float()
    return hi if parts == 1 else hi + (x - hi).bfloat16().float()


def _wgmma_route_emulation(xh, la, Bm, Cm, *, block_q, b_parts=2, h_parts=2, w_parts=2):
    """The bf16 route's arithmetic: the plain passes in f32 with the three
    f32 operands of the products rounded to bf16 parts where the kernel
    rounds them: exp(cum_end - cum_j) B_j (the state product's B), the
    entering state h_c (B of C h_cᵀ) and W = C Bᵀ ⊙ L (A of W xh).  xh, Bm
    and Cm are exact bf16; C Bᵀ, the state passing and every sum stay f32."""
    b, s, h, p = xh.shape
    q = min(block_q, s)
    x, bf, cf = ssd._chunked(xh, q), ssd._chunked(Bm, q), ssd._chunked(Cm, q)
    cum = ssd._chunked(la, q).cumsum(dim=2)  # (B,c,Q,H)
    dte_b = torch.exp(cum[:, :, -1:, :] - cum)[..., None] * bf[:, :, :, None, :]
    states = torch.einsum("bcjhp,bcjhn->bchpn", x, _bf16_parts(dte_b, b_parts))
    h_enter, h_final = ssd.ssd_state_passing(states, torch.exp(cum[:, :, -1, :]))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    L = diff.masked_fill(~tri[None, None, :, :, None], float("-inf")).exp()
    W = torch.einsum("bcqn,bcjn->bcqj", cf, bf)[..., None] * L
    y = torch.einsum("bcqjh,bcjhp->bcqhp", _bf16_parts(W, w_parts), x)
    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", cf, _bf16_parts(h_enter, h_parts),
                         cum.exp())
    return y.reshape(b, -1, h, p)[:, :s].to(xh.dtype), h_final


def _ssd_tol_excess(got, want):
    """How far past chip_smoke.py's SSD_TOL for bf16 (y: rtol = atol = 2e-2;
    h_final: rtol 1e-4, atol 1e-4 * max|h_final|) the worst element lies:
    the rule holds where both are <= 1."""
    (y, h), (y_p, h_p) = got, want
    y, y_p = y.float(), y_p.float()
    ey = float(((y - y_p).abs() / (2e-2 + 2e-2 * y_p.abs())).max())
    eh = float(((h - h_p).abs() / (1e-4 * h_p.abs() + 1e-4 * h_p.abs().max())).max())
    return ey, eh


#: log-decay scales: steep (la ~ -3 |N(0,1)|), tests/test_kernels.py's 0.3,
#: mild (-0.01 |N(0,1)|, the state carries ~100 steps and y is a small
#: difference of large terms)
DECAYS = {"steep": 3.0, "test-scale": 0.3, "mild": 0.01}


def _zamba2_width_inputs(decay):
    """bf16 xh, Bm, Cm and f32 la at zamba2-1.2b's widths (P = N = 64, chunk
    128), a few heads, S 1024."""
    (_, xt), (_, lt), (_, bt), (_, ct) = _inputs(
        int(decay * 1000) + 7, 1, 1024, 4, 64, 64, "bfloat16"
    )
    return xt, lt * (decay / 0.3), bt, ct


@pytest.mark.parametrize("decay", list(DECAYS))
def test_wgmma_rounding_plan_holds_ssd_tol(decay):
    """hi + lo parts of dte ⊙ B, h_c and W hold the card's SSD_TOL at zamba2's
    widths, steep to mild decays."""
    ins = _zamba2_width_inputs(DECAYS[decay])
    want = ssd.ssd_scan_plain(*ins, block_q=128)
    ey, eh = _ssd_tol_excess(_wgmma_route_emulation(*ins, block_q=128), want)
    assert ey <= 1 and eh <= 1, (ey, eh)


@pytest.mark.parametrize(
    "one_part,which",
    [("w_parts", "y"), ("h_parts", "y"), ("b_parts", "h_final")],
    ids=["W", "h_c", "dte-B"],
)
def test_one_bf16_part_breaks_ssd_tol(one_part, which):
    """One bf16 part (8 significant bits) of W, of h_c or of dte ⊙ B, the
    others kept as hi + lo, fails SSD_TOL at mild decays: W and h_c in y,
    where y is a small difference of large terms; dte ⊙ B in h_final."""
    ins = _zamba2_width_inputs(DECAYS["mild"])
    want = ssd.ssd_scan_plain(*ins, block_q=128)
    got = _wgmma_route_emulation(*ins, block_q=128, **{one_part: 1})
    ey, eh = _ssd_tol_excess(got, want)
    assert (ey if which == "y" else eh) > 1, (ey, eh)


@pytest.mark.parametrize("dtype,route", [("bfloat16", "wgmma"), ("float32", "simt")])
def test_kernel_route_by_dtype(dtype, route):
    assert ssd.kernel_route(DTYPES[dtype][1]) == route


def test_wrapper_copies_rows_off_16_bytes():
    """The kernel's 16-byte copies need aligned rows: a slice one element in
    (strided, as a misplaced conv slice, or contiguous) is refused by the
    check, so the wrapper copies it; the model's own slices pass."""
    B, S, H, P, N = 2, 8, 4, 64, 64
    xbc = torch.zeros(B, S, H * P + 2 * N, dtype=torch.bfloat16)
    assert ssd._vector_rows(xbc[..., H * P : H * P + N])
    assert not ssd._vector_rows(xbc[..., H * P + 1 : H * P + 1 + N])
    flat = torch.zeros(B * S * H * P + 1, dtype=torch.bfloat16)
    assert ssd._vector_rows(flat[: B * S * H * P].view(B, S, H, P))
    assert not ssd._vector_rows(flat[1:].view(B, S, H, P))
    # a dim of size 1 is never stepped along: its stride does not count
    assert ssd._vector_rows(torch.zeros(1, S, 3 * N, dtype=torch.bfloat16)[:1, :, :N])
    assert ssd._vector_rows(torch.zeros(S, 1, N).expand(S, 1, N).transpose(0, 1))


@pytest.mark.parametrize(
    "pairs,heads,want",
    [(32, 64, 8), (4, 64, 1), (16, 64, 4), (1024, 64, 8), (256, 8, 8), (3, 6, 1)],
    ids=["zamba2-prefill", "S-1", "16-pairs", "S-16384", "reduced", "tiny"],
)
def test_heads_per_block_keeps_a_block_an_sm(pairs, heads, want):
    """8 heads a block where the (b, chunk) pairs fill the 132 SMs with
    them, fewer where they would not."""
    assert ssd.heads_per_block(8, pairs, heads, 132) == want
