"""The Mamba-2 SSD chunked scan, with the final state (every Mamba-2 prefill).

The port of ``repro/kernels/ssd_scan.py::ssd_scan`` to kernels written by
hand for Hopper: ``csrc/ssd_scan.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use and loaded with ``ctypes`` (see
:mod:`repro_torch.kernels._build`).  The TPU kernel ran a ``(batch*heads,
chunks)`` grid whose sequential chunk axis carried the ``(N, P)`` state in
VMEM.  Here one call runs the Mamba-2 decomposition as three CUDA kernels,
each parallel over chunks, and this module's plain version is split the
same way:

1. **chunk states** (:func:`ssd_chunk_states`): each chunk's own state
   ``S_c = sum_j exp(cum_end - cum_j) xh_j ⊗ B_j`` and its decay
   ``exp(cum_end)``, one block per (b, chunk, group of heads);
2. **state passing** (:func:`ssd_state_passing`): the state entering each
   chunk, ``h_{c+1} = exp(cum_end_c) h_c + S_c`` from ``h0`` or zero, and
   ``h_final``; elementwise over the ``P × N`` state, chunks in order;
3. **chunk outputs** (:func:`ssd_chunk_outputs`): ``y = (C Bᵀ ⊙ L) xh +
   exp(cum) ⊙ (C h_cᵀ)``, one block per (b, chunk, group of heads), which
   forms ``C Bᵀ`` once for the group (the heads share Bm and Cm).

The route (:func:`kernel_route`) follows the dtype: bf16 runs its products
on ``wgmma`` (xh, Bm, Cm exact bf16; the f32 operands ``exp(cum_end -
cum_j) B_j``, ``h_c`` and ``W = C Bᵀ ⊙ L`` split into bf16 hi + lo, as
``tests/test_torch_ssd.py``'s emulation of the rounding asks); f32 runs
them on the CUDA cores.

The contract is the TPU kernel's: ``xh (B,S,H,P)`` (dt-scaled inputs),
``la (B,S,H)`` f32 log decays, ``Bm``/``Cm (B,S,N)`` shared by all heads ->
``y (B,S,H,P)`` in ``xh``'s dtype and ``h_final (B,H,P,N)`` in f32.  An
optional initial state ``h0 (B,H,P,N)`` is the oracle's
(``repro/kernels/ref.py::ssd_chunk_ref``).

:func:`ssd_scan` is the wrapper.  For tensors on the CPU it runs
:func:`ssd_scan_plain`, the plain PyTorch version of the same chunked math;
for CUDA tensors it launches the kernels or raises: there is no fallback.
Each call adds one to :func:`launch_count` (one call is three CUDA
kernels).
"""

from __future__ import annotations

import ctypes
import functools

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

#: The scratch chunk states are 64 x 64 f32 tiles, whatever P and N.
_TILE = 64

#: Heads a block of the chunk-states and chunk-outputs passes takes at most
#: (the kernel takes up to 8; fewer where a call has too few (b, chunk)
#: pairs to give every SM a block); the outputs pass forms C Bᵀ once for
#: its group.
HEADS_PER_BLOCK = 8

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


def kernel_route(dtype: torch.dtype) -> str:
    """``"wgmma"`` for bf16 (products on the tensor cores), ``"simt"`` for
    f32 (products on the CUDA cores)."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


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


def _chunked(t: torch.Tensor, q: int) -> torch.Tensor:
    """(B, S, ...) -> (B, chunks, q, ...) in f32, the tail padded with zeros
    (zero input, zero log decay: a padded step leaves the state as it is)."""
    s = t.shape[1]
    pad = (-s) % q
    t = t.float()
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], (s + pad) // q, q, *t.shape[2:])


def ssd_chunk_states(xh, la, Bm, *, block_q: int = 128) -> tuple:
    """Pass 1: each chunk's own state and decay, from a zero entering state.

    -> (states (B, chunks, H, P, N) f32, decay (B, chunks, H) f32) with
    ``states[:, c] = sum_j exp(cum_end - cum_j) xh_j ⊗ B_j`` over chunk c's
    positions and ``decay[:, c] = exp(cum_end)``, ``cum`` the prefix sum of
    ``la`` within the chunk.
    """
    q = _chunk(block_q, xh.shape[1])
    x, bf = _chunked(xh, q), _chunked(Bm, q)
    cum = _chunked(la, q).cumsum(dim=2)  # (B,c,Q,H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bf, decay_to_end, x)
    return states, torch.exp(cum[:, :, -1, :])


def ssd_state_passing(states, decay, h0=None) -> tuple:
    """Pass 2: the state entering each chunk, and the final state.

    ``states`` (B, chunks, H, P, N) and ``decay`` (B, chunks, H) from
    :func:`ssd_chunk_states`; ``h0`` (B, H, P, N) or zero.  -> (h_enter
    (B, chunks, H, P, N) f32, h_final (B, H, P, N) f32) with ``h_enter[:, 0]
    = h0`` and ``h_enter[:, c + 1] = decay[:, c] h_enter[:, c] + states[:, c]``.
    """
    b, nc, h, p, n = states.shape
    state = (
        torch.zeros((b, h, p, n), dtype=torch.float32, device=states.device)
        if h0 is None
        else h0.float()
    )
    enter = []
    for c in range(nc):
        enter.append(state)
        state = state * decay[:, c, :, None, None] + states[:, c]
    return torch.stack(enter, dim=1), state


def ssd_chunk_outputs(xh, la, Bm, Cm, h_enter, *, block_q: int = 128) -> torch.Tensor:
    """Pass 3: y from the chunk's own inputs and the state entering it.

    ``y_q = sum_{j<=q} (C_q . B_j) exp(cum_q - cum_j) xh_j + exp(cum_q) C_q .
    h_c`` for position q of chunk c; ``h_enter`` (B, chunks, H, P, N) from
    :func:`ssd_state_passing`.  -> y (B, S, H, P) in ``xh``'s dtype.
    """
    b, s, h, p = xh.shape
    q = _chunk(block_q, s)
    x, bf, cf = _chunked(xh, q), _chunked(Bm, q), _chunked(Cm, q)
    cum = _chunked(la, q).cumsum(dim=2)  # (B,c,Q,H)
    # L[q, j] = exp(cum_q - cum_j) for j <= q; above the diagonal the
    # difference may be large and positive, so it is masked before exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,c,Q,Q,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    L = diff.masked_fill(~tri[None, None, :, :, None], float("-inf")).exp()
    W = torch.einsum("bcqn,bcjn->bcqj", cf, bf)[..., None] * L
    y = torch.einsum("bcqjh,bcjhp->bcqhp", W, x)
    del diff, L, W
    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", cf, h_enter.float(), cum.exp())
    return y.reshape(b, -1, h, p)[:, :s].to(xh.dtype)


def ssd_scan_plain(xh, la, Bm, Cm, h0=None, *, block_q: int = 128) -> tuple:
    """Plain PyTorch version: the TPU kernel's chunked math in f32.

    The three passes the kernel runs (:func:`ssd_chunk_states`,
    :func:`ssd_state_passing`, :func:`ssd_chunk_outputs`), vectorised over
    chunks except the chunk-to-chunk recurrence, which is a loop.  Chunks
    hold ``Q = min(block_q, S)`` positions; a padded tail (zero inputs, zero
    log decay) leaves the state unchanged.
    """
    check_inputs(xh, la, Bm, Cm, h0)
    states, decay = ssd_chunk_states(xh, la, Bm, block_q=block_q)
    h_enter, h_final = ssd_state_passing(states, decay, h0)
    y = ssd_chunk_outputs(xh, la, Bm, Cm, h_enter, block_q=block_q)
    return y, h_final


def _vector_rows(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` along its last dim starts 16-byte aligned
    with a unit stride there, as the kernel's 16-byte copies need (a dim of
    size 1 is never stepped along, so its stride does not count)."""
    vec = 16 // t.element_size()
    return (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all(st % vec == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "ssd_typed", False):  # once: a call's host cost counts at S 1
        fn = lib.repro_ssd_scan
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.ssd_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def heads_per_block(limit: int, pairs: int, heads: int, sms: int) -> int:
    """Heads a block takes: ``limit``, halved while the ``pairs`` (b, chunk)
    pairs times the groups of heads would give fewer blocks than ``sms``."""
    g = limit
    while g > 1 and pairs * -(-heads // g) < sms:
        g //= 2
    return g


def ssd_scan(xh, la, Bm, Cm, h0=None, *, block_q: int = 128) -> tuple:
    """The SSD scan of xh (B,S,H,P) -> (y (B,S,H,P), h_final (B,H,P,N) f32).

    ``la`` (B,S,H) f32 are the per-step log decays, ``Bm``/``Cm`` (B,S,N)
    are shared by the heads and may be strided (the model passes slices of
    its conv output); ``h0`` (B,H,P,N) f32 is an optional initial state.
    xh, Bm, Cm and h0 are read in 16-byte pieces: a layout whose rows are
    not 16-byte aligned with a unit last stride is copied first.  Chunks
    hold ``min(block_q, S)`` positions.  CPU tensors run
    :func:`ssd_scan_plain`; CUDA tensors launch the kernels on the current
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
    xh, Bm, Cm = (
        t if _vector_rows(t) else t.clone(memory_format=torch.contiguous_format)
        for t in (xh, Bm, Cm)
    )
    if h0 is not None and not (h0.is_contiguous() and h0.data_ptr() % 16 == 0):
        h0 = h0.clone(memory_format=torch.contiguous_format)
    nc = -(-s // q)
    dev = xh.device
    y = torch.empty((b, s, h, p), dtype=xh.dtype, device=dev)
    hf = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    # scratch, one allocation: each chunk's state as a 64 x 64 f32 tile; the
    # state entering each chunk (bf16: a hi and a lo tile, the same bytes;
    # f32: written over the chunk states); each chunk's decay
    tiles = b * h * nc * _TILE * _TILE
    n_enter = tiles if xh.dtype == torch.bfloat16 else 0
    scratch = torch.empty(tiles + n_enter + b * h * nc, dtype=torch.float32, device=dev)
    states = scratch.data_ptr()
    h_enter = states + 4 * n_enter
    decay = states + 4 * (tiles + n_enter)
    strides = [*xh.stride()[:3], *la.stride(), *Bm.stride()[:2], *Cm.stride()[:2]]
    strides += y.stride()[:3]
    strides = (ctypes.c_int64 * 13)(*strides)
    sms = _sms(dev.index if dev.index is not None else torch.cuda.current_device())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_ssd_scan(
            xh.data_ptr(),
            la.data_ptr(),
            Bm.data_ptr(),
            Cm.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            y.data_ptr(),
            hf.data_ptr(),
            states,
            h_enter,
            decay,
            ctypes.addressof(strides),
            b,
            s,
            h,
            p,
            n,
            q,
            _DTYPE_CODE[xh.dtype],
            heads_per_block(HEADS_PER_BLOCK, b * nc, h, sms),
            stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    return y, hf
