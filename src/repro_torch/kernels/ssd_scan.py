"""The Mamba-2 SSD chunked scan, with the final state (every Mamba-2 prefill).

The port of ``repro/kernels/ssd_scan.py::ssd_scan`` to a kernel written by
hand for Hopper: ``csrc/ssd_scan.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use and loaded with ``ctypes`` (see
:mod:`repro_torch.kernels._build`).  The TPU kernel ran a ``(batch*heads,
chunks)`` grid whose sequential chunk axis carried the ``(N, P)`` state in
VMEM; here one thread block owns one (batch row, head) and loops over the
chunks in order, with the ``(P, N)`` f32 state in shared memory.  Per chunk
it forms the decay-weighted ``C Bᵀ`` (lower triangle only), the outputs and
the next state, all in f32 on the CUDA cores.

The contract is the TPU kernel's: ``xh (B,S,H,P)`` (dt-scaled inputs),
``la (B,S,H)`` f32 log decays, ``Bm``/``Cm (B,S,N)`` shared by all heads ->
``y (B,S,H,P)`` in ``xh``'s dtype and ``h_final (B,H,P,N)`` in f32.  An
optional initial state ``h0 (B,H,P,N)`` is the oracle's
(``repro/kernels/ref.py::ssd_chunk_ref``).

:func:`ssd_scan` is the wrapper.  For tensors on the CPU it runs
:func:`ssd_scan_plain`, the plain PyTorch version of the same chunked math;
for CUDA tensors it launches the kernel or raises: there is no fallback.
Each launch adds one to :func:`launch_count`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/ssd_scan.cu"

#: Head dims P and state sizes N the kernel is built for.
HEAD_DIMS = (32, 64)
STATES = (16, 32, 64)

#: The longest chunk the kernel's shared-memory tiles hold.
MAX_CHUNK = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: dtypes the kernel takes for xh, Bm and Cm (la is always float32).
DTYPES = tuple(_DTYPE_CODE)

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def check_inputs(xh, la, Bm, Cm, h0=None) -> None:
    """Raise unless the arguments fit one SSD scan."""
    if xh.dim() != 4 or la.dim() != 3 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(
            "ssd_scan takes xh (B,S,H,P), la (B,S,H) and Bm, Cm (B,S,N), got "
            f"{tuple(xh.shape)}, {tuple(la.shape)}, {tuple(Bm.shape)}, "
            f"{tuple(Cm.shape)}"
        )
    b, s, h, p = xh.shape
    if s < 1:
        raise ValueError("ssd_scan needs at least one position")
    if tuple(la.shape) != (b, s, h) or tuple(Bm.shape[:2]) != (b, s):
        raise ValueError(
            f"xh {tuple(xh.shape)}, la {tuple(la.shape)} and Bm "
            f"{tuple(Bm.shape)} disagree"
        )
    if xh.dtype not in DTYPES or not (xh.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(
            f"xh, Bm, Cm must share one dtype of {DTYPES}, got "
            f"{xh.dtype}, {Bm.dtype}, {Cm.dtype}"
        )
    if la.dtype != torch.float32:
        raise TypeError(f"la (log decays) must be float32, got {la.dtype}")
    tensors = [xh, la, Bm, Cm]
    if h0 is not None:
        if tuple(h0.shape) != (b, h, p, Bm.shape[2]) or h0.dtype != torch.float32:
            raise ValueError(
                f"h0 must be float32 (B,H,P,N) = {(b, h, p, Bm.shape[2])}, got "
                f"{h0.dtype} {tuple(h0.shape)}"
            )
        tensors.append(h0)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs lie on {[str(t.device) for t in tensors]}")


def _chunk(block_q: int, seq: int) -> int:
    if block_q < 1:
        raise ValueError(f"block_q must be >= 1, got {block_q}")
    return min(block_q, seq)


def ssd_scan_plain(xh, la, Bm, Cm, h0=None, *, block_q: int = 128) -> tuple:
    """Plain PyTorch version: the TPU kernel's chunked math in f32.

    Chunks of ``Q = min(block_q, S)`` positions, vectorised over chunks; a
    padded tail (zero inputs, zero log decay) leaves the state unchanged.
    Within a chunk ``y_q = sum_{j<=q} (C_q . B_j) exp(cum_q - cum_j) xh_j +
    exp(cum_q) C_q . h`` and ``h' = exp(cum_end) h + sum_j exp(cum_end -
    cum_j) xh_j ⊗ B_j``; the chunk-to-chunk recurrence is a loop.
    """
    check_inputs(xh, la, Bm, Cm, h0)
    b, s, h, p = xh.shape
    n = Bm.shape[2]
    q = _chunk(block_q, s)
    pad = (-s) % q
    x, lf, bf, cf = xh.float(), la.float(), Bm.float(), Cm.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        lf = F.pad(lf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    nc = (s + pad) // q
    x = x.reshape(b, nc, q, h, p)
    cum = lf.reshape(b, nc, q, h).cumsum(dim=2)  # (B,c,Q,H)
    bf = bf.reshape(b, nc, q, n)
    cf = cf.reshape(b, nc, q, n)

    # L[q, j] = exp(cum_q - cum_j) for j <= q; above the diagonal the
    # difference may be large and positive, so it is masked before exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,c,Q,Q,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    L = diff.masked_fill(~tri[None, None, :, :, None], float("-inf")).exp()
    W = torch.einsum("bcqn,bcjn->bcqj", cf, bf)[..., None] * L
    y = torch.einsum("bcqjh,bcjhp->bcqhp", W, x)
    del diff, L, W

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,c,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bf, decay_to_end, x)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,c,H)
    state = (
        torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
        if h0 is None
        else h0.float()
    )
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(prev, dim=1)  # (B,c,H,P,N): the state entering each chunk
    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", cf, h_prev, cum.exp())
    return y.reshape(b, nc * q, h, p)[:, :s].to(xh.dtype), state


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan(xh, la, Bm, Cm, h0=None, *, block_q: int = 128) -> tuple:
    """The SSD scan of xh (B,S,H,P) -> (y (B,S,H,P), h_final (B,H,P,N) f32).

    ``la`` (B,S,H) f32 are the per-step log decays, ``Bm``/``Cm`` (B,S,N)
    are shared by the heads and may be strided (the model passes slices of
    its conv output); ``h0`` (B,H,P,N) f32 is an optional initial state.
    Chunks hold ``min(block_q, S)`` positions.  CPU tensors run
    :func:`ssd_scan_plain`; CUDA tensors launch the kernel on the current
    stream.
    """
    check_inputs(xh, la, Bm, Cm, h0)
    if xh.device.type == "cpu":
        return ssd_scan_plain(xh, la, Bm, Cm, h0, block_q=block_q)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {xh.device}")
    b, s, h, p = xh.shape
    n = Bm.shape[2]
    if p not in HEAD_DIMS or n not in STATES:
        raise ValueError(
            f"the ssd_scan kernel takes head dims {HEAD_DIMS} and states "
            f"{STATES}, got P={p}, N={n}"
        )
    q = _chunk(block_q, s)
    if q > MAX_CHUNK:
        raise ValueError(f"the ssd_scan kernel takes chunks up to {MAX_CHUNK}, got {q}")
    global _launches
    lib = _library()
    # the kernel needs a unit stride on P and N; any other layout is copied
    xh, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (xh, Bm, Cm))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((b, s, h, p), dtype=xh.dtype, device=xh.device)
    hf = torch.empty((b, h, p, n), dtype=torch.float32, device=xh.device)
    if y.numel() == 0:
        return y, hf
    strides = [*xh.stride()[:3], *la.stride(), *Bm.stride()[:2], *Cm.stride()[:2]]
    strides += y.stride()[:3]
    strides = (ctypes.c_int64 * 13)(*strides)
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.repro_ssd_scan(
            xh.data_ptr(),
            la.data_ptr(),
            Bm.data_ptr(),
            Cm.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            y.data_ptr(),
            hf.data_ptr(),
            ctypes.addressof(strides),
            b,
            s,
            h,
            p,
            n,
            q,
            _DTYPE_CODE[xh.dtype],
            stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    return y, hf
