"""The port's mLSTM scan against the JAX package's Pallas kernel and oracles.

The plain PyTorch version (what the wrapper runs on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel to on the card) against
``repro.kernels.mlstm_scan`` in interpret mode and ``ref.mlstm_chunk_ref``
(the sequential oracle) on the cases of ``tests/test_kernels.py``, and
against the model's ``_chunked_mlstm`` for ``h`` and the final ``(C, n,
m)``, with and without an initial state.  The same inputs are drawn with
numpy from a seed.  Tolerances: f32 rtol = atol = 2e-4, the JAX test's own;
2e-2 for bf16 inputs (both sides read the same bf16 values, but the JAX
kernel and oracle compute from them in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLSTMConfig, ModelConfig
from repro.kernels import ref
from repro.kernels.mlstm_scan import mlstm_scan as jax_mlstm
from repro.models.xlstm import _chunked_mlstm
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels import ops

#: tests/test_kernels.py's cases: (B, S, H, D, chunk)
CASES = [(2, 32, 2, 32, 8), (1, 24, 4, 64, 16), (1, 17, 1, 32, 8)]
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _inputs(seed, B, S, H, D, name="float32", steep=False):
    """q, k, v, lf, li as (jax, torch) pairs holding the same values.

    The scales are those of ``tests/test_kernels.py`` (k scaled by 1/√D,
    lf = log_sigmoid(2 z), li = z); q, k, v round to the dtype, the log
    gates stay f32.  ``steep``: lf near -10, li with std 4.
    """
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, H, D), dtype=np.float32) / np.float32(np.sqrt(D))
    v = rng.standard_normal((B, S, H, D), dtype=np.float32)
    z = rng.standard_normal((B, S, H), dtype=np.float32)
    if steep:
        lf = np.float32(-10.0) + np.float32(0.1) * z
        li = np.float32(4.0) * rng.standard_normal((B, S, H), dtype=np.float32)
    else:
        lf = np.array(jax.nn.log_sigmoid(2.0 * z), np.float32)
        li = rng.standard_normal((B, S, H), dtype=np.float32)
    out = []
    for arr, dt in ((q, tdt), (k, tdt), (v, tdt), (lf, torch.float32), (li, torch.float32)):
        t = torch.from_numpy(arr).to(dt)
        jd = jnp.float32 if dt == torch.float32 else jdt
        out.append((jnp.asarray(t.float().numpy()).astype(jd), t))
    return out


def _state(seed, B, H, D):
    """A non-trivial initial (C, n, m) as (numpy, torch) pairs."""
    rng = np.random.default_rng(seed)
    arrs = (
        0.1 * rng.standard_normal((B, H, D, D), dtype=np.float32),
        0.1 * rng.standard_normal((B, H, D), dtype=np.float32),
        rng.standard_normal((B, H), dtype=np.float32),
    )
    return [(a, torch.from_numpy(a.copy())) for a in arrs]


def _cfg(H, D, Q):
    return ModelConfig(d_model=H * D // 2, n_heads=H, n_kv_heads=H, mlstm=MLSTMConfig(chunk=Q))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _recurrence(q, k, v, lf, li, state=None):
    """``ref.mlstm_chunk_ref``'s step-by-step recurrence, in numpy, keeping
    its last C, n and m (and starting from ``state`` where one is given)."""
    q, k, v, lf, li = (np.asarray(_np(t), np.float64) for t in (q, k, v, lf, li))
    B, S, H, D = q.shape
    if state is None:
        C, n, m = np.zeros((B, H, D, D)), np.zeros((B, H, D)), np.full((B, H), -1e30)
    else:
        C, n, m = (np.asarray(a, np.float64) for a in state)
    hs = []
    for t in range(S):
        mn = np.maximum(lf[:, t] + m, li[:, t])
        a, b = np.exp(lf[:, t] + m - mn), np.exp(li[:, t] - mn)
        C = a[..., None, None] * C + b[..., None, None] * np.einsum(
            "bhd,bhe->bhde", k[:, t], v[:, t]
        )
        n = a[..., None] * n + b[..., None] * k[:, t]
        m = mn
        num = np.einsum("bhd,bhde->bhe", q[:, t], C)
        den = np.maximum(np.abs(np.einsum("bhd,bhd->bh", q[:, t], n)), np.exp(-m))
        hs.append(num / den[..., None])
    return np.stack(hs, axis=1), (C, n, m)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,S,H,D,Q", CASES)
def test_plain_matches_pallas_kernel_and_oracle(B, S, H, D, Q, name):
    (qj, qt), (kj, kt), (vj, vt), (fj, ft), (ij, it) = _inputs(S + D, B, S, H, D, name)
    h, (C, n, m) = ms.mlstm_scan_plain(qt, kt, vt, ft, it, block_q=Q)
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, S, H, D)
    assert tuple(C.shape) == (B, H, D, D) and tuple(n.shape) == (B, H, D)
    assert tuple(m.shape) == (B, H) and C.dtype == n.dtype == m.dtype == torch.float32
    h_k = jax_mlstm(qj, kj, vj, fj, ij, block_q=Q, interpret=True)
    h_r = ref.mlstm_chunk_ref(qj, kj, vj, fj, ij)
    _close(h, h_k, TOL[name])
    _close(h, h_r, TOL[name])


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
def test_plain_matches_model_chunked(with_state):
    """h and the final (C, n, m) against ``_chunked_mlstm``."""
    B, S, H, D, Q = 2, 40, 2, 32, 16
    (qj, qt), (kj, kt), (vj, vt), (fj, ft), (ij, it) = _inputs(3, B, S, H, D)
    state_j = state_t = None
    if with_state:
        (cn, ct), (nn, nt), (mn, mt) = _state(4, B, H, D)
        state_j = {"C": jnp.asarray(cn), "n": jnp.asarray(nn), "m": jnp.asarray(mn)}
        state_t = (ct, nt, mt)
    h_m, st_m = _chunked_mlstm(qj, kj, vj, fj, ij, _cfg(H, D, Q), state_j)
    h, (C, n, m) = ms.mlstm_scan_plain(qt, kt, vt, ft, it, state_t, block_q=Q)
    for got, want in ((h, h_m), (C, st_m["C"]), (n, st_m["n"]), (m, st_m["m"])):
        _close(got, want, 2e-4)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
def test_final_state_matches_the_recurrence(with_state):
    """The chunked m equals the sequential max(lf + m, li) in exact
    arithmetic, so the stabilised final state is the recurrence's."""
    B, S, H, D, Q = 1, 37, 2, 32, 8
    ins = _inputs(5, B, S, H, D)
    state_np = state_t = None
    if with_state:
        pairs = _state(6, B, H, D)
        state_np, state_t = [a for a, _ in pairs], tuple(t for _, t in pairs)
    h, (C, n, m) = ms.mlstm_scan_plain(*(t for _, t in ins), state_t, block_q=Q)
    h_r, (C_r, n_r, m_r) = _recurrence(*(t for _, t in ins), state_np)
    for got, want in ((h, h_r), (C, C_r), (n, n_r), (m, m_r)):
        np.testing.assert_allclose(_np(got), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,Q", [(1, 128), (1, 8), (45, 16), (300, 128)])
def test_plain_chunks_agree_with_the_recurrence(S, Q):
    """S = 1 (a one-position chunk) and ragged tails."""
    ins = _inputs(S, 1, S, 2, 32)
    h, (C, n, m) = ms.mlstm_scan_plain(*(t for _, t in ins), block_q=Q)
    h_r, (C_r, n_r, m_r) = _recurrence(*(t for _, t in ins))
    for got, want in ((h, h_r), (C, C_r), (n, n_r), (m, m_r)):
        np.testing.assert_allclose(_np(got), want, rtol=2e-4, atol=2e-4)


def test_steep_gates_stay_finite():
    """lf near -10, li with std 4: exponents of the stabilised weights stay
    <= 0, the masked triangle is never exponentiated, nothing overflows."""
    ins = _inputs(9, 1, 128, 2, 64, steep=True)
    h, (C, n, m) = ms.mlstm_scan_plain(*(t for _, t in ins), block_q=32)
    assert all(bool(torch.isfinite(t).all()) for t in (h, C, n, m))
    h_r, (C_r, n_r, m_r) = _recurrence(*(t for _, t in ins))
    np.testing.assert_allclose(_np(h), h_r, rtol=2e-4, atol=2e-4 * np.abs(h_r).max())
    np.testing.assert_allclose(_np(m), m_r, rtol=2e-4, atol=2e-4)


def test_plain_takes_strided_inputs():
    """q/k/v as slices of one wider tensor and gates as slices, as a model
    may pass them."""
    B, S, H, D = 2, 24, 2, 32
    (_, qt), (_, kt), (_, vt), (_, ft), (_, it) = _inputs(8, B, S, H, D)
    wide = torch.cat([qt, kt, vt], dim=-1)
    qs, ks, vs = wide[..., :D], wide[..., D : 2 * D], wide[..., 2 * D :]
    gates = torch.stack([ft, it], dim=-1)
    assert not qs.is_contiguous() and not gates[..., 0].is_contiguous()
    want = ms.mlstm_scan_plain(qt, kt, vt, ft, it, block_q=8)
    got = ms.mlstm_scan_plain(qs, ks, vs, gates[..., 0], gates[..., 1], block_q=8)
    torch.testing.assert_close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    ins = [t for _, t in _inputs(4, 1, 20, 2, 32)]
    ops.reset_launch_counts()
    want = ms.mlstm_scan_plain(*ins, block_q=8)
    for got in (ops.mlstm_scan(*ins, block_q=8), ms.mlstm_scan(*ins, block_q=8)):
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
    with ops.plain():
        got = ops.mlstm_scan(*ins, block_q=8)
    assert torch.equal(got[0], want[0])
    assert ops.launch_counts()["mlstm_scan"] == 0


@pytest.mark.parametrize(
    "call",
    [
        lambda q, k, v, f, i: ms.mlstm_scan(q[..., 0], k, v, f, i),
        lambda q, k, v, f, i: ms.mlstm_scan(q, k[:, :-1], v, f, i),
        lambda q, k, v, f, i: ms.mlstm_scan(q, k, v, f[:, :-1], i),
        lambda q, k, v, f, i: ms.mlstm_scan(q[..., :16], k[..., :16], v[..., :16], f, i),
        lambda q, k, v, f, i: ms.mlstm_scan(q, k.bfloat16(), v, f, i),
        lambda q, k, v, f, i: ms.mlstm_scan(q.double(), k.double(), v.double(), f, i),
        lambda q, k, v, f, i: ms.mlstm_scan(q, k, v, f.bfloat16(), i),
        lambda q, k, v, f, i: ms.mlstm_scan(
            q, k, v, f, i, (torch.zeros(1, 2, 32, 16), torch.zeros(1, 2, 32), torch.zeros(1, 2))
        ),
        lambda q, k, v, f, i: ms.mlstm_scan(q, k, v, f, i, block_q=0),
        lambda q, k, v, f, i: ms.mlstm_scan(q[:, :0], k[:, :0], v[:, :0], f[:, :0], i[:, :0]),
    ],
    ids=[
        "q-rank",
        "k-shape",
        "gate-shape",
        "head-dim-16",
        "mixed-dtypes",
        "float64",
        "gate-dtype",
        "state-shape",
        "block-q",
        "no-positions",
    ],
)
def test_wrapper_refuses_bad_calls(call):
    q, k, v, f, i = (t for _, t in _inputs(3, 1, 8, 2, 32))
    with pytest.raises((ValueError, TypeError)):
        call(q, k, v, f, i)


def _bf16_parts(x, parts):
    """``x`` (f32) as the kernel feeds it to the tensor cores: bf16 hi, and
    with two parts + bf16(x - hi), summed back in f32 (exact)."""
    hi = x.bfloat16().float()
    return hi if parts == 1 else hi + (x - hi).bfloat16().float()


def _wgmma_route_emulation(q, k, v, lf, li, *, block_q, parts=2):
    """The bf16 ``wgmma`` route's arithmetic on the CPU: ``mlstm_scan_plain``'s
    chunked math in f32, with C̃ (B of q C̃), W (A of W v) and wgt ⊙ v (B of
    the update) rounded to bf16 parts where the kernel rounds them; q, k, v
    are exact bf16, and ñ, q·ñ, the gates and every sum stay f32."""
    b, s, h, d = q.shape
    qn = min(block_q, s)
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    lff, lif = lf.float().permute(0, 2, 1), li.float().permute(0, 2, 1)
    C = torch.zeros((b, h, d, d))
    n = torch.zeros((b, h, d))
    m = torch.full((b, h), ms.NEG_INF)
    tri = torch.ones((qn, qn), dtype=torch.bool).tril()
    out = []
    for c0 in range(0, s, qn):
        sl = slice(c0, c0 + qn)
        qc, kc, vc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl]
        cum = lff[:, :, sl].cumsum(dim=-1)
        u = lif[:, :, sl] - cum
        g = torch.maximum(m[..., None], torch.cummax(u, dim=-1).values)
        diff = u[..., None, :] - g[..., :, None]
        W = (qc @ kc.transpose(-1, -2)) * diff.masked_fill(~tri, float("-inf")).exp()
        carry = torch.exp(m[..., None] - g)
        num = _bf16_parts(W, parts) @ vc + carry[..., None] * (qc @ _bf16_parts(C, parts))
        den = (W.sum(dim=-1) + carry * (qc @ n[..., None])[..., 0]).abs()
        out.append(num / torch.maximum(den, torch.exp(-(cum + g)))[..., None])
        gq = g[..., -1]
        wgt = torch.exp(u - gq[..., None])
        decay = torch.exp(m - gq)
        wv = _bf16_parts(wgt[..., None] * vc, parts)
        C = decay[..., None, None] * C + kc.transpose(-1, -2) @ wv
        n = decay[..., None] * n + (kc * wgt[..., None]).sum(dim=2)
        m = cum[..., -1] + gq
    hs = torch.cat(out, dim=2).permute(0, 2, 1, 3)
    return hs, (C, n, m)


def _holds_mlstm_rule(got, want, rtol=1e-3):
    """chip_smoke.py's MLSTM_RTOL rule: h, C, n, m each within rtol and
    rtol * max|plain|."""
    (h, state), (h_p, state_p) = got, want
    return all(
        torch.allclose(g, w, rtol=rtol, atol=rtol * float(w.abs().max()))
        for g, w in zip((h, *state), (h_p, *state_p))
    )


@pytest.mark.parametrize("steep", [False, True], ids=["gates", "steep-gates"])
def test_wgmma_rounding_plan_holds_the_card_rule(steep):
    """Two bf16 parts of C̃, W and wgt ⊙ v hold the card's rule (rtol 1e-3,
    atol 1e-3 · max|plain|) at xlstm-1.3b's head dim of 1024."""
    ins = [t for _, t in _inputs(31 + steep, 1, 256, 1, 1024, "bfloat16", steep=steep)]
    want = ms.mlstm_scan_plain(*ins, block_q=128)
    got = _wgmma_route_emulation(*ins, block_q=128)
    assert _holds_mlstm_rule(got, want)


def test_one_bf16_part_breaks_the_card_rule():
    """A single bf16 part of C̃, W and wgt ⊙ v (8 significant bits) fails
    the same rule on the same inputs, so the rule sees the second part."""
    ins = [t for _, t in _inputs(32, 1, 256, 1, 1024, "bfloat16", steep=True)]
    want = ms.mlstm_scan_plain(*ins, block_q=128)
    assert not _holds_mlstm_rule(_wgmma_route_emulation(*ins, block_q=128, parts=1), want)


@pytest.mark.parametrize(
    "dtype,head_dim,route",
    [
        ("bfloat16", 1024, "wgmma"),
        ("bfloat16", 64, "wgmma"),
        ("bfloat16", 192, "wgmma"),
        ("bfloat16", 896, "wgmma"),
        ("bfloat16", 96, "mma.sync"),
        ("bfloat16", 576, "mma.sync"),
        ("float32", 1024, "mma.sync"),
    ],
)
def test_kernel_route_by_dtype_and_head_dim(dtype, head_dim, route):
    assert ms.kernel_route(DTYPES[dtype][1], head_dim) == route
