"""Blocked attention with an online softmax (prefill and teacher forcing).

The port of ``repro/kernels/flash_attention.py::flash_attention`` to a kernel
written by hand for Hopper: ``csrc/flash_attention.cu``, CUDA C++ for
``sm_90a``, built with ``nvcc`` at first use and loaded with ``ctypes``
(see :mod:`repro_torch.kernels._build`).  The kernel is chosen by dtype:

* bf16 runs on the tensor cores: a block owns 128 query rows of one head
  (two warpgroups of 64 rows), TMA brings the query tile once and K/V tiles
  into a ring of two stages, ``wgmma`` computes S = Q K^T from shared memory
  and O += P V with P from registers as two bf16 parts, hi + lo (about 16
  significant bits; the TPU kernel keeps P in f32, and a single bf16 P broke
  the reduced models' end-to-end rule on the card).  TMA needs 16-byte
  aligned bases and (b, h, s) strides: :func:`flash_attention` raises for a
  view that breaks this rather than copying it.
* f32 runs the SIMT kernel of the first port: products on the CUDA cores in
  f32, 64-row query blocks, 32-key tiles.

Both keep the running max, sum and accumulator in f32, and take the kv head
as ``h // (Hq // Hkv)``, so GQA and MQA never repeat K/V.  Asked with
``return_lse=True`` (the training path), both also store each query row's
log-sum-exp, which the backward kernel takes in place of recomputing it
(:func:`flash_attention_lse_plain` is its plain version); the output's bits
are the same either way.

:func:`flash_attention` is the wrapper.  For a tensor on the CPU it runs
:func:`flash_attention_plain`, the plain PyTorch version of the same
function (``repro/kernels/ref.py::flash_attention_ref``); for a CUDA tensor
it launches the kernel or raises: there is no fallback.  Each launch adds
one to :func:`launch_count`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/flash_attention.cu"

#: Head dims the kernel is built for.
HEAD_DIMS = (32, 64, 128, 256)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: dtypes the kernel takes.
DTYPES = tuple(_DTYPE_CODE)

NEG_INF = -1e30

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q (B,Hq,Sq,D) and k/v (B,Hkv,Sk,D) fit one attention."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            "attention takes q (B,Hq,Sq,D) and k, v (B,Hkv,Sk,D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"{q.shape[1]} q heads do not group over {k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")


def kernel_args(q, k, v, out) -> tuple:
    """Tensors with a unit head-dim stride, and their 12 (b, h, s) strides.

    A tensor whose head dim is not contiguous is copied; any other layout
    (e.g. a ``bhsk`` einsum result) goes to the kernel as it is.
    """
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return q, k, v, (ctypes.c_int64 * 12)(*strides)


def is_aligned(t: torch.Tensor) -> bool:
    """Whether the tensor's base and its (b, h, s) strides are whole 16-byte
    units (a stride along a dim of size 1 is never used), as TMA and 16-byte
    copies need."""
    es = t.element_size()
    steps = [s * es for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1]
    return t.data_ptr() % 16 == 0 and not any(s % 16 for s in steps)


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless each tensor :func:`is_aligned`.

    The bf16 flash kernel's TMA copies and the decode kernel's 16-byte
    copies need this; a view that breaks it is refused, not copied.
    """
    for t in tensors:
        if not is_aligned(t):
            raise ValueError(
                f"the {name} kernel needs 16-byte aligned bases and (b, h, s) "
                f"strides; got base {t.data_ptr() % 16} bytes past 16, strides "
                f"{t.stride()} of {t.dtype}"
            )


def check_kernel_inputs(name: str, q: torch.Tensor) -> None:
    """Raise for a device, dtype or head dim the CUDA kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the {name} kernel takes {DTYPES}, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"the {name} kernel takes head dims {HEAD_DIMS}, got {q.shape[-1]}"
        )


def flash_attention_plain(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the direct definition, f32 softmax.

    q (B,Hq,Sq,D); k/v (B,Hkv,Sk,D); GQA by head repetition; queries sit at
    the end of the keys when causal.  Returns q's dtype.
    """
    check_qkv(q, k, v)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        v = v.repeat_interleave(rep, dim=1)
    probs = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def flash_attention_rows_plain(q, k, v, offset: int) -> torch.Tensor:
    """Plain PyTorch version of causal attention of query rows that sit at
    positions ``[offset, offset + Sq)`` of the keys: the scores over the
    whole of k, masked past each row's position (the work GSPMD does for
    each rank's rows of a split sequence).  :func:`flash_attention` on k/v
    cut to ``[0, offset + Sq)`` is the same function."""
    check_qkv(q, k, v)
    if not 0 <= offset <= k.shape[2] - q.shape[2]:
        raise ValueError(f"rows [{offset}, {offset + q.shape[2]}) outside "
                         f"{k.shape[2]} keys")
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        v = v.repeat_interleave(rep, dim=1)
    probs = torch.softmax(_scores(q, k, True, offset), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def _scores(q, k, causal: bool, offset=None) -> torch.Tensor:
    """The scaled f32 scores (B,Hq,Sq,Sk), masked to NEG_INF when causal;
    the queries sit at ``[offset, offset + Sq)`` of the keys, at their end
    unless ``offset`` is given."""
    _, hq, sq, d = q.shape
    rep = hq // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sk = k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None] + (
            sk - sq if offset is None else offset)
        mask = qpos >= torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    return scores


def flash_attention_lse_plain(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the log-sum-exp the kernel stores: each
    query row's natural log-sum-exp of its scaled, masked scores,
    (B,Hq,Sq) f32."""
    check_qkv(q, k, v)
    return torch.logsumexp(_scores(q, k, causal), dim=-1)


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, return_lse: bool = False):
    """Attention of q (B,Hq,Sq,D) over k/v (B,Hkv,Sk,D) -> (B,Hq,Sq,D).

    ``causal`` puts the queries at the end of the keys (``Sq <= Sk``).  A CPU
    tensor runs :func:`flash_attention_plain`; a CUDA tensor launches the
    kernel on the current stream.  With ``return_lse`` the result is
    ``(out, lse)``, lse the (B,Hq,Sq) f32 log-sum-exp of each query row
    (on the CPU, :func:`flash_attention_lse_plain`).
    """
    check_qkv(q, k, v)
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(
            f"causal attention needs Sq <= Sk, got {q.shape[2]} > {k.shape[2]}"
        )
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal)
        if return_lse:
            return out, flash_attention_lse_plain(q, k, v, causal=causal)
        return out
    check_kernel_inputs("flash_attention", q)
    global _launches
    lib = _library()
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if sk == 0:
        raise ValueError("attention over zero keys")
    q, k, v, strides = kernel_args(q, k, v, out)
    if q.dtype == torch.bfloat16:
        check_aligned("flash_attention", q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            ctypes.addressof(strides),
            b,
            hq,
            hkv,
            sq,
            sk,
            d,
            _DTYPE_CODE[q.dtype],
            int(causal),
            stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    return (out, lse) if return_lse else out
