"""The port's attention against the JAX package's Pallas kernels and oracles.

The plain PyTorch versions (what the wrappers run on the CPU, and what
``chip_smoke.py`` holds the CUDA kernels to on the card) against
``repro.kernels.flash_attention`` / ``decode_attention`` in interpret mode
and ``repro.kernels.ref``, on the cases of ``tests/test_kernels.py``: the
same inputs, drawn with numpy from a seed.  Tolerances are those of
``tests/test_kernels.py``: 2e-2 for bf16 (the output rounds to bf16, and the
kernels sum in another order), 2e-5 for f32.
"""

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
        "decode_attention": 0,
        "ssd_scan": 0,
        "mlstm_scan": 0,
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
