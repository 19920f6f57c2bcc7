"""The port's attention against the JAX package's Pallas kernels and oracles.

The plain PyTorch versions (what the wrappers run on the CPU, and what
``chip_smoke.py`` holds the CUDA kernels to on the card) against
``repro.kernels.flash_attention`` / ``decode_attention`` in interpret mode
and ``repro.kernels.ref``, on the cases of ``tests/test_kernels.py``: the
same inputs, drawn with numpy from a seed.  Tolerances are those of
``tests/test_kernels.py``: 2e-2 for bf16 (the output rounds to bf16, and the
kernels sum in another order), 2e-5 for f32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

FLASH_CASES = [
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 96, 96, 64),  # MQA, non-multiple seq
    (2, 4, 4, 64, 256, 128),  # decode-style Sq < Sk
    (1, 2, 2, 33, 33, 32),  # odd sizes
]
DECODE_CASES = [
    (2, 4, 2, 256, 64, 255),
    (1, 8, 1, 512, 128, 100),  # partially-filled cache, MQA
    (2, 2, 2, 96, 64, 50),
]
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


def _tol(name):
    tol = 2e-2 if name == "bfloat16" else 2e-5
    return dict(rtol=tol, atol=tol)


def _inputs(seed, shapes, name):
    """numpy f32 draws, rounded to the dtype; the same values for both sides."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape, dtype=np.float32)
        t = torch.from_numpy(x).to(tdt)
        out.append((jnp.asarray(t.float().numpy()).astype(jdt), t))
    return out


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flash_params():
    for case in FLASH_CASES:
        for name in DTYPES:
            for causal in (True, False):
                # the offset is only defined for causal (tests/test_kernels.py)
                if causal or case[3] == case[4]:
                    ident = f"{case}-{name}-{causal}"
                    yield pytest.param(*case, name, causal, id=ident)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,name,causal", list(_flash_params()))
def test_flash_plain_matches_pallas_and_oracle(B, Hq, Hkv, Sq, Sk, D, name, causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        Sq * 7 + D, [(B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)], name
    )
    got = fa.flash_attention(qt, kt, vt, causal=causal).float().numpy()
    pallas = jax_flash(
        qj, kj, vj, causal=causal, block_q=64, block_k=64, interpret=True
    )
    oracle = ref.flash_attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(got, _np(pallas), **_tol(name))
    np.testing.assert_allclose(got, _np(oracle), **_tol(name))


@pytest.mark.parametrize("B,Hq,Hkv,S,D,pos", DECODE_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_decode_plain_matches_pallas_and_oracle(B, Hq, Hkv, S, D, pos, name):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        S + pos, [(B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D)], name
    )
    # the kernels take an exclusive kv_len, the oracle an inclusive pos
    got = dec.decode_attention(qt, kt, vt, pos + 1).float().numpy()
    pallas = jax_decode(qj, kj, vj, pos + 1, block_k=64, interpret=True)
    oracle = ref.decode_attention_ref(qj, kj, vj, pos)
    np.testing.assert_allclose(got, _np(pallas), **_tol(name))
    np.testing.assert_allclose(got, _np(oracle), **_tol(name))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    (_, q), (_, k) = _inputs(1, [(1, 4, 8, 32), (1, 2, 8, 32)], "float32")
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, k)
    assert torch.equal(out, fa.flash_attention_plain(q, k, k))
    out = ops.decode_attention(q[:, :, :1], k, k, 5)
    assert torch.equal(out, dec.decode_attention_plain(q[:, :, :1], k, k, 5))
    assert ops.launch_counts() == {
        "flash_attention": 0,
        "flash_attention_bwd": 0,
        "decode_attention": 0,
        "ssd_scan": 0,
        "ssd_scan_bwd": 0,
        "mlstm_scan": 0,
        "mlstm_scan_bwd": 0,
    }


def test_plain_versions_take_non_contiguous_layouts():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 24, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 3, 2, 32), dtype=np.float32))
    q, k, v = (torch.einsum("bsd,dhk->bhsk", x, w[:, i]) for i in range(3))
    assert not q.is_contiguous()
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(fa.flash_attention(q, k, v), want)
    q1 = q[:, :, :1].contiguous()
    want = dec.decode_attention(q1, k.contiguous(), v.contiguous(), 9)
    torch.testing.assert_close(dec.decode_attention(q[:, :, :1], k, v, 9), want)


@pytest.mark.parametrize(
    "call",
    [
        lambda q, k: fa.flash_attention(q, k[:, :, :4], k[:, :, :4], causal=True),
        lambda q, k: dec.decode_attention(q[:, :, :1], k, k, 0),
        lambda q, k: dec.decode_attention(q[:, :, :1], k, k, 9),
        lambda q, k: dec.decode_attention(q, k, k, 4),
        lambda q, k: fa.flash_attention(q[:, :3], k, k),
        lambda q, k: fa.flash_attention(q, k.double(), k.double()),
    ],
    ids=[
        "causal-sq-gt-sk",
        "kv-len-0",
        "kv-len-past-cache",
        "decode-two-rows",
        "groups",
        "dtype",
    ],
)
def test_wrappers_refuse_bad_calls(call):
    (_, q), (_, k) = _inputs(3, [(1, 4, 8, 32), (1, 2, 8, 32)], "float32")
    with pytest.raises((ValueError, TypeError)):
        call(q, k)


# ---------------------------------------------------------------------------
# The decode kernel's split plan and its combine, in plain PyTorch
# ---------------------------------------------------------------------------

#: an H100 SXM: 132 SMs, three partial-kernel blocks an SM at bf16 and head
#: dim 128 (what repro_decode_blocks_per_sm reports there; chip_smoke.py
#: phase 7 logs it with every decode case)
H100 = dict(sms=132, blocks_per_sm=3)

PLAN_CASES = [
    (4, 16, 1, 1),  # kv_len 1
    (4, 16, 1, 2 * dec.MIN_SPLIT_KEYS - 1),  # one short of two splits
    (4, 16, 1, 2 * dec.MIN_SPLIT_KEYS),
    (4, 16, 1, 2 * dec.MIN_SPLIT_KEYS + 1),
    (4, 16, 1, 1040),  # olmo-1b's decode
    (8, 8, 7, 30000),  # deepseek-coder-33b's GQA decode
    (1, 16, 1, 16000),  # batch 1 over a long cache
    (4, 32, 1, 1040),  # zamba2-1.2b's shared block
    (64, 16, 1, 4096),  # a batch that fills the card alone
]


def _ranges(kv_len, n_split, per):
    return [(i * per, min((i + 1) * per, kv_len)) for i in range(n_split)]


@pytest.mark.parametrize("B,Hkv,group,kv_len", PLAN_CASES)
def test_split_plan_tiles_the_keys_once(B, Hkv, group, kv_len):
    n_split, per = dec.split_plan(B, Hkv, group, kv_len, **H100)
    ranges = _ranges(kv_len, n_split, per)
    assert per % dec.SPLIT_ALIGN == 0
    assert all(s0 < s1 for s0, s1 in ranges)
    assert [s1 for _, s1 in ranges[:-1]] == [s0 for s0, _ in ranges[1:]]
    assert ranges[0][0] == 0 and ranges[-1][1] == kv_len
    if kv_len <= dec.MIN_SPLIT_KEYS:
        assert n_split == 1
    assert all(s1 - s0 >= dec.MIN_SPLIT_KEYS for s0, s1 in ranges[:-1])
    # no more blocks than one wave of the card holds, unless a batch fills
    # the wave with one range
    blocks = B * Hkv * -(-group // 8) * n_split
    assert n_split == 1 or blocks <= H100["blocks_per_sm"] * H100["sms"]


def test_split_plan_at_the_model_shapes():
    assert dec.split_plan(4, 16, 1, 1040, **H100) == (6, 192)  # olmo-1b
    assert dec.split_plan(8, 8, 7, 30000, **H100) == (6, 5056)  # deepseek-coder-33b
    assert dec.split_plan(1, 16, 1, 16000, **H100) == (23, 704)
    assert dec.split_plan(4, 16, 1, 769, **H100) == (5, 192)  # the last range: 1 key
    assert dec.split_plan(4, 16, 1, 1040, sms=1, blocks_per_sm=3) == (1, 1088)
    # one block an SM (f32 at head dim 256): a third of the wave, fewer splits
    assert dec.split_plan(1, 16, 1, 16000, sms=132, blocks_per_sm=1) == (8, 2048)


def _decode_by_splits(q, k, v, kv_len, fault=None):
    """Each range's (m, l, acc) in f32, then the combine kernel's formula:
    m = max m_s, w_s = exp(m_s - m), out = sum w_s acc_s / max(sum w_s l_s,
    1e-30).  ``fault`` makes the combine wrong: ``"drop first"`` and ``"drop
    middle"`` leave a range out, ``"weight first"`` multiplies the first
    range's w_s by e."""
    B, Hq, _, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    k = k.float().repeat_interleave(rep, dim=1)
    v = v.float().repeat_interleave(rep, dim=1)
    n_split, per = dec.split_plan(B, Hkv, rep, kv_len, **H100)
    parts = []
    for s0, s1 in _ranges(kv_len, n_split, per):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k[:, :, s0:s1]) / D**0.5
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(-1, keepdim=True), p @ v[:, :, s0:s1]))
    if fault in ("drop first", "drop middle"):
        del parts[0 if fault == "drop first" else n_split // 2]
    m = torch.stack([m_s for m_s, _, _ in parts]).amax(0)
    w = [torch.exp(m_s - m) for m_s, _, _ in parts]
    if fault == "weight first":
        w[0] = w[0] * math.e
    l = sum(w_s * l_s for w_s, (_, l_s, _) in zip(w, parts))
    acc = sum(w_s * a_s for w_s, (_, _, a_s) in zip(w, parts))
    return n_split, (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize(
    "B,Hq,Hkv,S,D,kv_len",
    [
        (1, 8, 2, 1200, 64, 1100),
        (2, 4, 4, 600, 32, 599),
        (1, 14, 2, 700, 32, 650),  # 7-head groups
    ],
)
@pytest.mark.parametrize("name", list(DTYPES))
def test_split_combine_matches_plain_and_pallas(B, Hq, Hkv, S, D, kv_len, name):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        kv_len + D, [(B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D)], name
    )
    n_split, got = _decode_by_splits(qt, kt, vt, kv_len)
    assert n_split > 1
    tol = dict(rtol=1e-5, atol=1e-5) if name == "float32" else _tol(name)
    want = dec.decode_attention_plain(qt, kt, vt, kv_len)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **tol)
    pallas = jax_decode(qj, kj, vj, kv_len, block_k=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), _np(pallas), **tol)


def _row_scaled_excess(got, want, tol):
    """The bf16 rule chip_smoke.py phase 7 and the card tests add: |got -
    want| <= tol |want| + tol * the row's largest |want|; > 0 where it fails."""
    got, want = got.float(), want.float()
    scale = want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() - tol * (want.abs() + scale)).max())


@pytest.mark.parametrize("fault", ["drop first", "drop middle", "weight first"])
def test_row_scaled_rule_sees_a_wrong_combine(fault):
    """Over olmo-1b's batch-1 cache of 16000 keys (23 ranges on an H100) an
    output row is a few hundredths: a combine that drops a range or weights
    one wrongly stays inside the absolute bf16 rule (atol 2e-2) but not
    inside the row-scaled one, which the right combine holds."""
    rng = np.random.default_rng(16000)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
        for shape in [(1, 16, 1, 128), (1, 16, 16000, 128), (1, 16, 16000, 128)]
    )
    want = dec.decode_attention_plain(q, k, v, 16000)
    n_split, good = _decode_by_splits(q, k, v, 16000)
    _, bad = _decode_by_splits(q, k, v, 16000, fault)
    assert n_split == 23
    assert _row_scaled_excess(good, want, 2e-2) <= 0
    assert torch.allclose(bad.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert _row_scaled_excess(bad, want, 2e-2) > 0


# ---------------------------------------------------------------------------
# The bf16 flash kernel's P: how far rounding it moves the result
# ---------------------------------------------------------------------------


def _flash_rounded_p(q, k, v, causal, parts):
    """Attention with P entering P V as one bf16 part or as bf16 hi + lo
    (the card kernel's choice); the row sums stay over the f32 P."""
    B, Hq, Sq, D = q.shape
    rep = Hq // k.shape[1]
    k = k.float().repeat_interleave(rep, dim=1)
    v = v.float().repeat_interleave(rep, dim=1)
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / D**0.5
    if causal:
        qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
        s = torch.where(qpos >= torch.arange(Sk)[None, :], s, fa.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    p_used = hi if parts == "bf16" else hi + (p - hi).to(torch.bfloat16).float()
    out = (p_used @ v) / p.sum(-1, keepdim=True)
    return out.to(q.dtype)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", FLASH_CASES)
@pytest.mark.parametrize("parts", ["bf16", "hi+lo"])
def test_rounded_p_stays_within_bf16_tolerance_of_pallas(B, Hq, Hkv, Sq, Sk, D, parts):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        Sq * 7 + D, [(B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)], "bfloat16"
    )
    got = _flash_rounded_p(qt, kt, vt, True, parts).float().numpy()
    pallas = jax_flash(qj, kj, vj, causal=True, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, _np(pallas), **_tol("bfloat16"))
    if parts == "hi+lo":
        # in f32, the split leaves about 16 significant bits of P
        exact = fa.flash_attention_plain(qt.float(), kt.float(), vt.float())
        hilo = _flash_rounded_p(qt.float(), kt.float(), vt.float(), True, parts)
        torch.testing.assert_close(hilo, exact, rtol=1e-4, atol=1e-4)
