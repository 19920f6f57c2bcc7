"""The scans' contracts under a split: the mLSTM scan with each chunk's rows
split over ranks, the mLSTM decode step on slices of its value columns, and
the SSD scan on slices of its heads.

Where the plan splits the sequence over more ranks than it has chunks
(``context.scan_rows``), ``ops._mlstm_rows`` places the mLSTM scan as GSPMD
places ``repro``'s: the ``j``-th rows of every chunk on the ``j``-th of the
ranks that split a chunk, in three steps (``kernels/mlstm_scan.py``): what
each rank's rows add to each chunk's end state (``chunk_states_plain``),
summed over the ranks; the state entering each chunk (``pass_states``);
the outputs of the rank's rows (``mlstm_chunk_rows_plain``).  The steps over
all the ranks' rows must give the whole scan's h and final state, and
their gradients the whole scan's.  The decode step on a slice of v and of
C gives that slice of h and of C (``xlstm.mlstm_decode``'s value split);
the SSD scan on a slice of its heads gives that slice of y and of the
final state, with the gradients of the whole B and C summed over the
slices (``ops._ssd_heads``).  Inputs are drawn with numpy from a seed.

Tolerances: the split computes each output with the operations of the
whole scan, but for the end states, which it takes as a sum over the
ranks' rows rescaled once more, so outputs agree to f32 rounding
(rtol = atol = 1e-5) and gradients to that of a sum of a few terms
(rtol = atol = 1e-4); ``repro``'s chunked mLSTM and ``ref.py``'s oracle
within 2e-4 (``test_torch_mlstm.py``'s f32 rule).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLSTMConfig, ModelConfig
from repro.kernels import ref
from repro.models.xlstm import _chunked_mlstm
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import xlstm
from repro_torch.parallel.context import parallel_context, scan_rows
from repro_torch.parallel.sharding import ShardingPlan

D = 64
CHUNK = 16
#: how far the split's outputs, and its gradients, may lie from the whole
#: scan's
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
#: repro's and ref.py's rule (test_torch_mlstm.py's f32)
REF_TOL = 2e-4


def _inputs(seed, B, S, H, dv=D, state=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, H, D), dtype=np.float32) / np.float32(np.sqrt(D))
    v = rng.standard_normal((B, S, H, dv), dtype=np.float32)
    z = rng.standard_normal((B, S, H), dtype=np.float32)
    lf = -np.log1p(np.exp(-2.0 * z)).astype(np.float32)  # log_sigmoid(2 z)
    li = rng.standard_normal((B, S, H), dtype=np.float32)
    out = [torch.from_numpy(a) for a in (q, k, v, lf, li)]
    if state:
        out.append((torch.from_numpy(0.1 * rng.standard_normal((B, H, D, dv), dtype=np.float32)),
                    torch.from_numpy(0.1 * rng.standard_normal((B, H, D), dtype=np.float32)),
                    torch.from_numpy(rng.standard_normal((B, H), dtype=np.float32))))
    else:
        out.append(None)
    return out


def _close(got, want, tol):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) else want
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=tol, atol=tol)


def _split_scan(q, k, v, lf, li, state, ranks: int):
    """The three steps of ``ops._mlstm_rows`` over the ``ranks`` that split
    each chunk, in one process: h (B,S,H,D) and the final (C, n, m)."""
    rows = CHUNK // ranks
    parts = [ms.chunk_states_plain(k, v, lf, li, (j * rows, rows), block_q=CHUNK)
             for j in range(ranks)]
    dC, dn = (sum(p[i] for p in parts) for i in (0, 1))
    entering, final = ms.pass_states(dC, dn, lf, li, state, block_q=CHUNK)
    h = torch.cat([ms.mlstm_chunk_rows_plain(q, k, v, lf, li, entering, (j * rows, rows),
                                             block_q=CHUNK) for j in range(ranks)], dim=2)
    return h.reshape(q.shape), final


RANKS = [1, 2, 4]


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
@pytest.mark.parametrize("ranks", RANKS)
def test_row_splits_give_the_whole_scan(ranks, with_state):
    q, k, v, lf, li, state = _inputs(ranks + 10 * with_state, 2, 48, 2, state=with_state)
    h, (C, n, m) = ms.mlstm_scan_plain(q, k, v, lf, li, state, block_q=CHUNK)
    h_s, (C_s, n_s, m_s) = _split_scan(q, k, v, lf, li, state, ranks)
    for got, want in ((h_s, h), (C_s, C), (n_s, n)):
        _close(got, want, OUT_TOL)
    assert torch.equal(m_s, m)  # the stabiliser takes the same max and sums


def _grads(run, q, k, v, lf, li, state, dh, dC):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, lf, li)]
    st = None if state is None else tuple(t.clone().requires_grad_(True) for t in state)
    h, (C, n, m) = run(*leaves, st)
    ((h * dh).sum() + (C * dC).sum()).backward()
    return [t.grad for t in leaves] + ([] if st is None else [t.grad for t in st])


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "given-state"])
@pytest.mark.parametrize("ranks", RANKS)
def test_row_split_gradients_are_the_whole_scans(ranks, with_state):
    """q, k, v, lf, li (and the entering state) through the three steps
    against autograd of the whole plain scan, the final C's gradient
    included."""
    q, k, v, lf, li, state = _inputs(3 * ranks + with_state, 2, 48, 2, state=with_state)
    rng = np.random.default_rng(ranks)
    dh = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32))
    dC = torch.from_numpy(0.1 * rng.standard_normal((2, 2, D, D), dtype=np.float32))
    whole = _grads(lambda *a: ms.mlstm_scan_plain(*a[:5], a[5], block_q=CHUNK),
                   q, k, v, lf, li, state, dh, dC)
    split = _grads(lambda *a: _split_scan(*a[:5], a[5], ranks), q, k, v, lf, li, state, dh, dC)
    for got, want in zip(split, whole):
        _close(got, want, GRAD_TOL)


def test_split_rows_meet_the_recurrence_of_repro():
    """Two ranks a chunk, a sequence of 48 rows in chunks of 16 (the rows of
    a rank's half of each chunk scored against the keys up to them), held to
    repro's chunked mLSTM and to ref.py's oracle."""
    q, k, v, lf, li, _ = _inputs(7, 2, 48, 2)
    h, (C, n, m) = _split_scan(q, k, v, lf, li, None, 2)
    jq, jk, jv, jf, ji = (jnp.asarray(t.numpy()) for t in (q, k, v, lf, li))
    cfg = ModelConfig(d_model=D, n_heads=2, n_kv_heads=2, mlstm=MLSTMConfig(chunk=CHUNK))
    h_m, st = _chunked_mlstm(jq, jk, jv, jf, ji, cfg)
    for got, want in ((h, h_m), (C, st["C"]), (n, st["n"]), (m, st["m"])):
        _close(got, np.asarray(want), REF_TOL)
    _close(h, np.asarray(ref.mlstm_chunk_ref(jq, jk, jv, jf, ji)), REF_TOL)


def _mesh(model: int):
    """What ``scan_rows`` reads of a DeviceMesh of (data 2, model)."""
    return SimpleNamespace(mesh_dim_names=("data", "model"),
                           size=lambda i: (2, model)[i])


@pytest.mark.parametrize("model,seq,chunk,want", [
    (16, 1024, 128, 64),    # repro's cut train_4k: 8 chunks over 16 ranks
    (16, 4096, 128, None),  # train_4k: whole chunks a rank, the scan whole
    (4, 32, 16, 8),         # the gloo tests' (2, 4) mesh
    (4, 40, 16, None),      # not a whole number of chunks
    (1, 32, 16, None),      # a model axis of one rank
])
def test_scan_rows_follows_gspmds_chunks(model, seq, chunk, want):
    plan = ShardingPlan(rules={"batch": "data", "seq": "model"})
    with parallel_context(_mesh(model), plan):
        assert scan_rows(seq, chunk) == want
    with parallel_context(_mesh(model), ShardingPlan(rules={"batch": "data"})):
        assert scan_rows(seq, chunk) is None  # decode: the sequence whole
    assert scan_rows(seq, chunk) is None  # no context


def _slices(t, n):
    return torch.chunk(t, n, dim=-1)


def test_decode_step_on_value_slices():
    """The decode recurrence on a slice of v and of C gives that slice of h
    and of the new C, and the same n and m."""
    q, k, v, lf, li, state = _inputs(11, 2, 1, 2, dv=128, state=True)
    args = (q[:, 0], k[:, 0], v[:, 0], lf[:, 0], li[:, 0])
    whole = [t.clone() for t in state]
    h = xlstm._step(*args, *whole)
    for i in range(4):
        st = [_slices(state[0], 4)[i].clone(), state[1].clone(), state[2].clone()]
        hs = xlstm._step(*args[:2], _slices(args[2], 4)[i], *args[3:], *st)
        _close(hs, _slices(h, 4)[i], OUT_TOL)
        _close(st[0], _slices(whole[0], 4)[i], OUT_TOL)
        assert torch.equal(st[1], whole[1]) and torch.equal(st[2], whole[2])


def _ssd_inputs(seed, B=2, S=40, H=8, P=16, N=8):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, S, H, P), dtype=np.float32),
            -np.abs(0.3 * rng.standard_normal((B, S, H), dtype=np.float32)),
            rng.standard_normal((B, S, N), dtype=np.float32),
            rng.standard_normal((B, S, N), dtype=np.float32),
            0.1 * rng.standard_normal((B, H, P, N), dtype=np.float32))
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("n_slices", [2, 4])
def test_ssd_head_slices_give_the_whole_scan(n_slices):
    """y and the final state by heads; the gradients of xh, la and h0 by
    heads, those of Bm and Cm (read whole by every slice) summed."""
    xh, la, Bm, Cm, h0 = _ssd_inputs(n_slices)
    rng = np.random.default_rng(n_slices + 1)
    dy = torch.from_numpy(rng.standard_normal(xh.shape, dtype=np.float32))
    dhf = torch.from_numpy(rng.standard_normal(h0.shape, dtype=np.float32))

    def run(xh, la, h0, dy, dhf):
        leaves = [t.clone().requires_grad_(True) for t in (xh, la, Bm, Cm, h0)]
        y, hf = ssd.ssd_scan_plain(*leaves, block_q=16)
        ((y * dy).sum() + (hf * dhf).sum()).backward()
        return y.detach(), hf.detach(), [t.grad for t in leaves]

    y, hf, grads = run(xh, la, h0, dy, dhf)
    cut = lambda t, i, d: torch.chunk(t, n_slices, dim=d)[i]  # noqa: E731
    parts = [run(cut(xh, i, 2), cut(la, i, 2), cut(h0, i, 1), cut(dy, i, 2), cut(dhf, i, 1))
             for i in range(n_slices)]
    _close(torch.cat([p[0] for p in parts], dim=2), y, OUT_TOL)
    _close(torch.cat([p[1] for p in parts], dim=1), hf, OUT_TOL)
    for j, d in ((0, 2), (1, 2), (4, 1)):
        _close(torch.cat([p[2][j] for p in parts], dim=d), grads[j], GRAD_TOL)
    for j in (2, 3):
        _close(sum(p[2][j] for p in parts), grads[j], GRAD_TOL)
