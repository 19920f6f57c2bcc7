"""The plain backwards of the port's SSD and mLSTM scans against JAX.

``ssd_scan_bwd_plain`` and ``mlstm_scan_bwd_plain`` (what the wrappers run
on the CPU, and what ``chip_smoke.py`` holds the backward kernels to on the
card) against ``jax.vjp`` of the JAX package's chunked model code
(``repro.models.mamba._ssd_chunked``, ``repro.models.xlstm._chunked_mlstm``)
and of its sequential oracles (``ref.ssd_chunk_ref``,
``ref.mlstm_chunk_ref``); against torch autograd of the port's plain
forwards; and ``ops.SSDScan`` / ``ops.MLSTMScan`` applied on CPU tensors
inside the reduced Mamba-2 and mLSTM layers against autograd of the same
layers.  Inputs are numpy draws from a seed; everything runs in f32.

Tolerance: rtol 1e-4 and atol 1e-5 x each gradient's max|ref|, per tensor:
the two frameworks sum in other orders, and the chunked and sequential
forms of one function round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLSTMConfig, ModelConfig, SSMConfig
from repro.kernels import ref
from repro.models.mamba import _ssd_chunked
from repro.models.xlstm import _chunked_mlstm
from repro_torch.configs import registry
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels import mlstm_scan_bwd as mb
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import ssd_scan_bwd as sb
from repro_torch.models import mamba as TM
from repro_torch.models import xlstm as TX
from repro_torch.models.model import build_model

RTOL, ATOL = 1e-4, 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(name, got, want):
    want = _np(want)
    np.testing.assert_allclose(
        _np(got), want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()), err_msg=name
    )


def _draws(seed, shapes: dict) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

#: (B, S, H, P, N, chunk, h0, dh_final, strided Bm / Cm, and the
#: sequential oracle too)
SSD_CASES = [
    (2, 32, 2, 64, 16, 8, False, False, False, False),
    (1, 33, 3, 32, 16, 16, True, True, True, False),  # a ragged tail
    (1, 13, 2, 32, 16, 4, True, True, True, True),
    (1, 21, 2, 32, 16, 8, False, True, False, False),
]


def _ssd_case(seed, B, S, H, P, N, with_h0, with_dhf, strided):
    """The inputs and output gradients as numpy arrays, and Bm / Cm as torch
    tensors (the model's strided views of one wider tensor where asked)."""
    a = _draws(seed, {"xh": (B, S, H, P), "la": (B, S, H), "bc": (B, S, 2 * N + 5),
                      "h0": (B, H, P, N), "dy": (B, S, H, P), "dhf": (B, H, P, N)})
    a["xh"] *= 0.5
    a["la"] = -np.abs(a["la"]) * 0.3
    a["bc"] *= 0.5
    a["h0"] *= 0.3
    bc = torch.from_numpy(a["bc"])
    if strided:
        bm, cm = bc[..., 3:3 + N], bc[..., 3 + N:3 + 2 * N]
    else:
        bm, cm = bc[..., 3:3 + N].contiguous(), bc[..., 3 + N:3 + 2 * N].contiguous()
    a["bm"], a["cm"] = bm.numpy().copy(), cm.numpy().copy()
    h0 = a["h0"] if with_h0 else None
    dhf = a["dhf"] if with_dhf else None
    return a, bm, cm, h0, dhf


def _ssd_plain(a, bm, cm, h0, dhf, Q):
    t = {k: torch.from_numpy(a[k]) for k in ("xh", "la", "dy")}
    return sb.ssd_scan_bwd_plain(
        t["xh"], t["la"], bm, cm, None if h0 is None else torch.from_numpy(h0), t["dy"],
        None if dhf is None else torch.from_numpy(dhf), block_q=Q,
    )


def _ssd_vjp(fn, a, h0, dhf):
    """jax.vjp of fn(xh, la, Bm, Cm[, h0]) -> (y, h_final), under jit (the
    sequential oracle's steps run eagerly otherwise, op by op)."""
    args = [jnp.asarray(a[k]) for k in ("xh", "la", "bm", "cm")]
    if h0 is not None:
        args.append(jnp.asarray(h0))

    @jax.jit
    def pullback(args, dy, dhf):
        (_, hf), pull = jax.vjp(fn, *args)
        return pull((dy, jnp.zeros_like(hf) if dhf is None else dhf))

    return pullback(args, jnp.asarray(a["dy"]), None if dhf is None else jnp.asarray(dhf))


@pytest.mark.parametrize("B,S,H,P,N,Q,with_h0,with_dhf,strided,oracle", SSD_CASES)
def test_ssd_plain_backward_matches_jax(B, S, H, P, N, Q, with_h0, with_dhf, strided, oracle):
    a, bm, cm, h0, dhf = _ssd_case(S + P, B, S, H, P, N, with_h0, with_dhf, strided)
    got = _ssd_plain(a, bm, cm, h0, dhf, Q)
    assert (got[4] is None) == (h0 is None)
    cfg = ModelConfig(d_model=H * P // 2, n_heads=H, n_kv_heads=H,
                      ssm=SSMConfig(state=N, headdim=P, chunk=Q))

    def model(xh, la, bm_, cm_, h0_=None):
        return _ssd_chunked(xh, la, bm_, cm_, cfg, h0_)

    names = ("dxh", "dla", "dBm", "dCm", "dh0")
    refs = [model] + ([ref.ssd_chunk_ref] if oracle else [])
    for want in (_ssd_vjp(fn, a, h0, dhf) for fn in refs):
        for name, g, w in zip(names, got, want):
            _close(name, g, w)


def test_ssd_plain_backward_matches_autograd():
    a, bm, cm, h0, dhf = _ssd_case(7, 1, 30, 2, 32, 16, True, True, True)
    got = _ssd_plain(a, bm, cm, h0, dhf, 8)
    leaves = [torch.from_numpy(a[k]).requires_grad_(True) for k in ("xh", "la", "bm", "cm", "h0")]
    y, hf = ssd.ssd_scan_plain(*leaves, block_q=8)
    want = torch.autograd.grad(
        (y * torch.from_numpy(a["dy"])).sum() + (hf * torch.from_numpy(dhf)).sum(), leaves
    )
    for name, g, w in zip(("dxh", "dla", "dBm", "dCm", "dh0"), got, want):
        _close(name, g, w)


def test_ssd_backward_wrapper_runs_the_plain_version_on_the_cpu():
    a, bm, cm, h0, dhf = _ssd_case(8, 1, 20, 2, 32, 16, False, False, True)
    t = {k: torch.from_numpy(a[k]) for k in ("xh", "la", "dy")}
    sb.reset_launch_count()
    got = sb.ssd_scan_bwd(t["xh"], t["la"], bm, cm, None, t["dy"], block_q=8)
    want = _ssd_plain(a, bm, cm, None, None, 8)
    assert all(g is w is None or torch.equal(g, w) for g, w in zip(got, want))
    assert sb.launch_count() == 0
    with pytest.raises(ValueError, match="dy"):
        sb.ssd_scan_bwd(t["xh"], t["la"], bm, cm, None, t["dy"][:, 1:], block_q=8)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

#: (B, S, H, D, chunk, entering state, final-state gradients, steep gates)
MLSTM_CASES = [
    (2, 32, 2, 32, 8, False, False, False),
    (1, 33, 2, 64, 16, True, True, False),  # a ragged tail
    (1, 24, 2, 32, 8, True, False, True),  # the stabiliser switches in a chunk
]


def _mlstm_case(seed, B, S, H, D, with_state, with_final, steep):
    a = _draws(seed, {"q": (B, S, H, D), "k": (B, S, H, D), "v": (B, S, H, D),
                      "z": (B, S, H), "li": (B, S, H), "C": (B, H, D, D), "n": (B, H, D),
                      "m": (B, H), "dh": (B, S, H, D), "dC": (B, H, D, D), "dn": (B, H, D),
                      "dm": (B, H)})
    a["k"] /= np.float32(np.sqrt(D))
    if steep:
        a["lf"] = np.float32(-3.0) + np.float32(2.0) * a["z"]
        a["li"] *= np.float32(4.0)
    else:
        a["lf"] = np.array(jax.nn.log_sigmoid(2.0 * a["z"]), np.float32)
    a["C"] *= 0.1
    a["n"] *= 0.1
    state = (a["C"], a["n"], a["m"]) if with_state else None
    final = (a["dC"], a["dn"], a["dm"]) if with_final else (None, None, None)
    return a, state, final


def _mlstm_plain(a, state, final, Q):
    t = {k: torch.from_numpy(a[k]) for k in ("q", "k", "v", "lf", "li", "dh")}
    st = None if state is None else tuple(torch.from_numpy(x) for x in state)
    fin = [None if x is None else torch.from_numpy(x) for x in final]
    dq, dk, dv, dlf, dli, dstate = mb.mlstm_scan_bwd_plain(
        t["q"], t["k"], t["v"], t["lf"], t["li"], st, t["dh"], *fin, block_q=Q
    )
    return [dq, dk, dv, dlf, dli] + (list(dstate) if state is not None else [])


@pytest.mark.parametrize("B,S,H,D,Q,with_state,with_final,steep", MLSTM_CASES)
def test_mlstm_plain_backward_matches_jax_model(B, S, H, D, Q, with_state, with_final, steep):
    a, state, final = _mlstm_case(S + D, B, S, H, D, with_state, with_final, steep)
    got = _mlstm_plain(a, state, final, Q)
    cfg = ModelConfig(d_model=H * D // 2, n_heads=H, n_kv_heads=H, mlstm=MLSTMConfig(chunk=Q))
    args = [jnp.asarray(a[k]) for k in ("q", "k", "v", "lf", "li")]
    if state is not None:
        args += [jnp.asarray(x) for x in state]

    def model(q, k, v, lf, li, C=None, n=None, m=None):
        st = None if C is None else {"C": C, "n": n, "m": m}
        h, fin = _chunked_mlstm(q, k, v, lf, li, cfg, st)
        return h, fin["C"], fin["n"], fin["m"]

    outs, pull = jax.vjp(model, *args)
    cots = [jnp.asarray(a["dh"])] + [
        jnp.zeros_like(o) if x is None else jnp.asarray(x) for o, x in zip(outs[1:], final)
    ]
    want = pull(tuple(cots))
    names = ("dq", "dk", "dv", "dlf", "dli", "dC0", "dn0", "dm0")
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        _close(name, g, w)


def test_mlstm_plain_backward_matches_the_sequential_oracle():
    """At mild gates: at steep ones JAX's own chunked and sequential
    gradients differ by more than the rule (dk by 2.4e-5 of its max at this
    case's steep draw, past atol by 1.9e-3), so the steep case is held to
    ``_chunked_mlstm`` and to autograd above."""
    a, state, final = _mlstm_case(5, 1, 13, 2, 32, False, False, False)
    got = _mlstm_plain(a, state, final, 4)
    args = [jnp.asarray(a[k]) for k in ("q", "k", "v", "lf", "li")]
    _, pull = jax.vjp(ref.mlstm_chunk_ref, *args)
    want = pull(jnp.asarray(a["dh"]))
    for name, g, w in zip(("dq", "dk", "dv", "dlf", "dli"), got, want):
        _close(name, g, w)


@pytest.mark.parametrize("steep", [False, True], ids=["mild", "steep"])
def test_mlstm_plain_backward_matches_autograd(steep):
    a, state, final = _mlstm_case(9, 1, 30, 2, 32, True, True, steep)
    got = _mlstm_plain(a, state, final, 8)
    leaves = [torch.from_numpy(a[k]).requires_grad_(True)
              for k in ("q", "k", "v", "lf", "li", "C", "n", "m")]
    h, (C, n, m) = ms.mlstm_scan_plain(*leaves[:5], tuple(leaves[5:]), block_q=8)
    loss = sum((o * torch.from_numpy(a[k])).sum()
               for o, k in ((h, "dh"), (C, "dC"), (n, "dn"), (m, "dm")))
    want = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(("dq", "dk", "dv", "dlf", "dli", "dC0", "dn0", "dm0"), got, want):
        _close(name, g, w)


def test_mlstm_backward_wrapper_runs_the_plain_version_on_the_cpu():
    a, state, final = _mlstm_case(4, 1, 20, 1, 32, False, False, False)
    t = {k: torch.from_numpy(a[k]) for k in ("q", "k", "v", "lf", "li", "dh")}
    mb.reset_launch_count()
    got = mb.mlstm_scan_bwd(t["q"], t["k"], t["v"], t["lf"], t["li"], None, t["dh"], block_q=8)
    want = _mlstm_plain(a, state, final, 8)
    assert got[5] is None
    assert all(torch.equal(g, w) for g, w in zip(got[:5], want))
    assert mb.launch_count() == 0
    with pytest.raises(ValueError, match="dh"):
        mb.mlstm_scan_bwd(t["q"], t["k"], t["v"], t["lf"], t["li"], None,
                          t["dh"].bfloat16(), block_q=8)


# ---------------------------------------------------------------------------
# The autograd Functions inside the reduced layers
# ---------------------------------------------------------------------------


def _layer_grads(model, layer_fn, cfg, p, x):
    """(output, d output / d x, d output / d each layer parameter)."""
    x = x.clone().requires_grad_(True)
    out = layer_fn(cfg, p, x)
    dout = torch.from_numpy(
        np.random.default_rng(3).standard_normal(tuple(out.shape), dtype=np.float32)
    )
    names = [n for n, _ in p.named_parameters()]
    grads = torch.autograd.grad(out, [x] + [p[k] for k in names], dout)
    return out.detach(), dict(zip(["x"] + names, grads))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_scan_functions_match_autograd_inside_the_layer(arch, monkeypatch):
    """The Functions' plain backward on CPU tensors, in the reduced layer,
    against autograd of the plain forward: the gradients of x and of every
    layer parameter (a_log and dt_bias reach only through dla)."""
    cfg = registry.get(arch).reduced()
    model = build_model(cfg, device="cpu", seed=0).float().requires_grad_(True)
    p = model.groups[0][1]["ssm"]
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 21, cfg.d_model), dtype=np.float32)
    )
    layer_fn = TM.mamba_train if arch == "zamba2-1.2b" else TX.mlstm_train
    out_w, want = _layer_grads(model, layer_fn, cfg, p, x)
    calls = []

    def ssd_fn(xh, la, Bm, Cm, h0=None, *, block_q=128):
        calls.append("ssd")
        return ops.SSDScan.apply(xh, la, Bm, Cm, h0, block_q)

    def mlstm_fn(q, k, v, lf, li, state=None, *, block_q=128):
        calls.append("mlstm")
        h, C, n, m = ops.MLSTMScan.apply(q, k, v, lf, li, *(state or (None,) * 3), block_q)
        return h, (C, n, m)

    monkeypatch.setattr(ops, "ssd_scan", ssd_fn)
    monkeypatch.setattr(ops, "mlstm_scan", mlstm_fn)
    out_g, got = _layer_grads(model, layer_fn, cfg, p, x)
    assert calls == ["ssd" if arch == "zamba2-1.2b" else "mlstm"]
    torch.testing.assert_close(out_g, out_w, rtol=0, atol=0)
    for name in want:
        _close(name, got[name], want[name])


# ---------------------------------------------------------------------------
# The tensor-core routes' precision design, on the plain backwards
# ---------------------------------------------------------------------------

#: BWD_TOL's bf16 rule (chip_smoke.py): rtol, and atol x each gradient's
#: max|unrounded|, per tensor
BF16_RULE = 2e-2


def _parts(t: torch.Tensor) -> tuple:
    """An f32 operand as the kernels feed it to bf16 wgmma: hi = bf16(t),
    lo = bf16(t - hi); an operand that is exact in bf16 has lo = 0."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _rounded_products(monkeypatch):
    """Route every `@` and einsum of the plain backwards through bf16 parts:
    hi·hi + hi·lo + lo·hi, each product and sum in f32 (lo·lo is dropped, as
    the kernels drop it).  A three-operand einsum first folds its first two
    operands (a row scale into an operand, as the kernels fold it before
    the split)."""
    matmul, einsum = torch.matmul, torch.einsum

    def split_product(fn, a, b):
        (ah, al), (bh, bl) = _parts(a.float()), _parts(b.float())
        return fn(ah, bh) + fn(ah, bl) + fn(al, bh)

    def rounded_einsum(eq, *ops):
        if len(ops) == 1:
            return einsum(eq, *ops)
        ins, out = eq.replace(" ", "").split("->")
        terms = ins.split(",")
        if len(ops) == 3:
            union = "".join(dict.fromkeys(terms[0] + terms[1]))
            folded = einsum(f"{terms[0]},{terms[1]}->{union}", ops[0], ops[1])
            return rounded_einsum(f"{union},{terms[2]}->{out}", folded, ops[2])
        eq2 = f"{terms[0]},{terms[1]}->{out}"
        return split_product(lambda a, b: einsum(eq2, a, b), *ops)

    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda a, b: split_product(matmul, a, b))
    monkeypatch.setattr(torch, "einsum", rounded_einsum)


def _rule_excess(got, want) -> float:
    """How far the worst gradient passes the bf16 rule; <= 0 holds."""
    return max(
        float(((g.float() - w.float()).abs()
               - BF16_RULE * (w.float().abs() + w.float().abs().max())).max())
        for g, w in zip(got, want)
    )


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and held in f32: an input the kernels read exactly."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize(
    "kind,shape",
    [
        ("ssd", (1, 40, 3, 32, 16, 16, True, True, False)),
        ("ssd", (2, 33, 2, 64, 32, 8, False, True, True)),
        ("mlstm", (1, 40, 2, 64, 16, True, True, False)),
        ("mlstm", (1, 33, 2, 64, 8, True, False, True)),  # steep gates
    ],
)
def test_split_bf16_products_hold_the_bwd_rule(kind, shape, monkeypatch):
    """The plain backward with every product's operands rounded as the
    tensor-core routes round them (bf16 inputs exact, f32 operands as
    hi + lo, three parts where both are f32, f32 sums) against the same
    plain backward unrounded, by BWD_TOL's bf16 rule; f32 gradients, so the
    margin is the products' rounding alone."""
    if kind == "ssd":
        B, S, H, P, N, Q, with_h0, with_dhf, strided = shape
        a, bm, cm, h0, dhf = _ssd_case(S + P, B, S, H, P, N, with_h0, with_dhf, strided)
        for key in ("xh", "dy"):
            a[key] = _bf16_exact(a[key])
        bm = torch.from_numpy(_bf16_exact(bm.contiguous().numpy()))
        cm = torch.from_numpy(_bf16_exact(cm.contiguous().numpy()))

        def run():
            return [t for t in _ssd_plain(a, bm, cm, h0, dhf, Q) if t is not None]
    else:
        B, S, H, D, Q, with_state, with_final, steep = shape
        a, state, final = _mlstm_case(S + D, B, S, H, D, with_state, with_final, steep)
        for key in ("q", "k", "v"):
            a[key] = _bf16_exact(a[key])

        def run():
            return _mlstm_plain(a, state, final, Q)

    want = run()
    with monkeypatch.context() as m:
        _rounded_products(m)
        got = run()
    excess = _rule_excess(got, want)
    worst = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(got, want))
    print(f"{kind} {shape}: rule excess {excess:.4g} (<= 0 holds), worst error "
          f"{worst:.3g} of a gradient's max")
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert excess <= 0
