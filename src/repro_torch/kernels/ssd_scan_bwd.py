"""The gradient of the Mamba-2 SSD chunked scan (every zamba2 train step).

A kernel of the port with no TPU counterpart: the JAX package's models
never call its Pallas scan, and ``jax.value_and_grad`` differentiates the
plain chunked code (``repro/models/mamba.py::_ssd_chunked``) through XLA.
The port's train step runs the forward kernel
(:mod:`repro_torch.kernels.ssd_scan`), so its gradient is a kernel too:
``csrc/ssd_scan_bwd.cu``, CUDA C++ for ``sm_90a``, built with ``nvcc`` at
first use and loaded with ``ctypes`` (see :mod:`repro_torch.kernels._build`).

For one chunk of ``Q`` positions with ``cum`` the prefix sums of the log
decays ``la``, ``L[q, j] = exp(cum_q - cum_j)`` (j <= q), entering state
``h_c`` and ``dS = D_{c+1}`` the gradient of the state leaving it, one call
runs four passes, and this module's plain version is split the same way:

1. **chunk states** (:func:`bwd_chunk_states`): each chunk's own state
   ``S_c`` and decay ``exp(cum_end)`` as the forward's pass 1 forms them,
   and ``G_c = sum_q exp(cum_q) dy_q ⊗ C_q``, the gradient its outputs
   send to its entering state; one block per (b, chunk, head);
2. **state passing** (:func:`bwd_state_passing`): in chunk order the
   entering states ``h_c`` (recomputed, not saved by the forward), then in
   reverse ``D_c = G_c + exp(cum_end_c) D_{c+1}`` from ``dh_final`` or zero,
   ``dh0 = D_0``, and ``exp(cum_end_c) <D_{c+1}, h_c>``, the decay's share
   of ``dcum``; one block per (b, head);
3. **chunk gradients** (:func:`bwd_chunk_grads`): with ``W = (C Bᵀ) ⊙ L``
   and ``M = L ⊙ (dy xᵀ)``, ``dx = Wᵀ dy + exp(cum_end - cum) ⊙ B dSᵀ``,
   each head's ``dB = Mᵀ C + exp(cum_end - cum) ⊙ x dS`` and ``dC = M B +
   exp(cum) ⊙ dy h_c``, and ``dcum`` from ``L``, the carry term, ``S_c``
   and the decay; ``dla`` is its reverse prefix sum in the chunk;
4. **head sum** (:func:`head_sum_plain`): ``dBm`` and ``dCm`` are the sums
   over heads of the per-head ``dB`` and ``dC`` (the heads share Bm and
   Cm), added in head order from scratch: no atomics, so two calls give
   equal bits.

Two routes (:func:`kernel_route`, reported by :func:`last_route`):

- ``"wgmma"`` (bf16): the products on the tensor cores, bf16 in and f32
  accumulated.  ``C Bᵀ`` and ``dy xᵀ`` are single bf16 products (exact
  inputs); ``Wᵀ dy``, ``Mᵀ C``, ``M B``, ``B dSᵀ``, ``x dS``, ``dy h_c``
  and the chunk states' products split their f32 operand into bf16
  ``hi + lo`` parts (about 16 significant bits; the state passing writes
  ``h_c`` and ``dS`` as those parts).  Pass 3 is one CUDA kernel a (b,
  chunk, group of 8 heads) that keeps ``W`` and then ``M`` on chip as bf16
  parts and never writes them to scratch;
- ``"simt"`` (f32): every product on the CUDA cores in f32, pass 3 as two
  CUDA kernels a (b, chunk, head): one forms ``W`` and ``M`` into scratch
  and the sums of ``(C Bᵀ) ⊙ M`` by row and column, one the products above.

A padded tail (zero input, zero log decay) contributes nothing, and no
padded copy of an input is made.

The contract: the forward's ``xh (B,S,H,P)``, ``la (B,S,H)`` f32,
``Bm``/``Cm (B,S,N)`` (possibly strided), optional ``h0 (B,H,P,N)`` f32,
the gradient ``dy (B,S,H,P)`` of y and optionally ``dh_final (B,H,P,N)``
f32 -> ``(dxh, dla, dBm, dCm, dh0)``, each in its input's dtype (``dla``
and ``dh0`` f32; ``dh0`` None without ``h0``).  The kernel takes the
forward kernel's shapes: P in {32, 64}, N in {16, 32, 64}, chunks up to
128.  The ``"wgmma"`` route reads xh, Bm, Cm and dy in 16-byte pieces: a
layout whose rows are not 16-byte aligned with a unit last stride is
copied first.

:func:`ssd_scan_bwd` is the wrapper.  For tensors on the CPU it runs
:func:`ssd_scan_bwd_plain`; for CUDA tensors it launches the kernels or
raises: there is no fallback.  Each call adds one to :func:`launch_count`
(one call is five CUDA kernels, four on the ``"wgmma"`` route).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import (
    HEAD_DIMS,
    MAX_CHUNK,
    STATES,
    _chunk,
    _chunked,
    _DTYPE_CODE,
    _vector_rows,
    check_inputs,
    ssd_chunk_states,
    ssd_state_passing,
)

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/ssd_scan_bwd.cu"

_launches = 0
_last_route = None


def launch_count() -> int:
    """Wrapper calls that launched the kernels since the last reset."""
    return _launches


def last_route():
    """The route (:func:`kernel_route`) the last launching call took, or None."""
    return _last_route


def reset_launch_count() -> None:
    global _launches, _last_route
    _launches = 0
    _last_route = None


def check_grads(xh, Bm, dy, dh_final) -> None:
    """Raise unless ``dy`` and ``dh_final`` fit the forward's inputs."""
    b, s, h, p = xh.shape
    if dy.shape != xh.shape or dy.dtype != xh.dtype or dy.device != xh.device:
        raise ValueError(
            f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} does not match "
            f"xh {tuple(xh.shape)} {xh.dtype} on {xh.device}"
        )
    want = (b, h, p, Bm.shape[2])
    if dh_final is not None and (
        tuple(dh_final.shape) != want
        or dh_final.dtype != torch.float32
        or dh_final.device != xh.device
    ):
        raise ValueError(
            f"dh_final must be float32 {want} on {xh.device}, got "
            f"{dh_final.dtype} {tuple(dh_final.shape)} on {dh_final.device}"
        )


def _cum(la, q: int) -> torch.Tensor:
    """(B, chunks, Q, H) prefix sums of the log decays within each chunk."""
    return _chunked(la, q).cumsum(dim=2)


def bwd_chunk_states(xh, la, Bm, Cm, dy, *, block_q: int = 128) -> tuple:
    """Pass 1: (states, G, decay); states and decay as the forward's pass 1,
    ``G[:, c] = sum_q exp(cum_q) dy_q ⊗ C_q`` (B, chunks, H, P, N) f32."""
    q = _chunk(block_q, xh.shape[1])
    states, decay = ssd_chunk_states(xh, la, Bm, block_q=block_q)
    ecum = _cum(la, q).exp()
    G = torch.einsum("bcqh,bcqhp,bcqn->bchpn", ecum, _chunked(dy, q), _chunked(Cm, q))
    return states, G, decay


def bwd_state_passing(states, G, decay, h0=None, dh_final=None) -> tuple:
    """Pass 2: (h_enter, dS, dh0, ddecay), all f32.

    ``h_enter[:, c]`` enters chunk c (:func:`ssd_state_passing`); ``dS[:, c]
    = D_{c+1}`` with ``D_nc = dh_final`` (or 0) and ``D_c = G_c + decay_c
    D_{c+1}``; ``dh0 = D_0``; ``ddecay[:, c] = decay_c <D_{c+1}, h_c>``, the
    gradient of ``cum_end`` through the decay (B, chunks, H).
    """
    h_enter, _ = ssd_state_passing(states, decay, h0)
    nc = states.shape[1]
    D = torch.zeros_like(states[:, 0]) if dh_final is None else dh_final.float()
    dS = [None] * nc
    for c in reversed(range(nc)):
        dS[c] = D
        D = G[:, c] + decay[:, c, :, None, None] * D
    dS = torch.stack(dS, dim=1)
    ddecay = decay * torch.einsum("bchpn,bchpn->bch", dS, h_enter)
    return h_enter, dS, D, ddecay


def bwd_chunk_grads(xh, la, Bm, Cm, dy, h_enter, dS, ddecay, *, block_q: int = 128) -> tuple:
    """Pass 3: (dx (B,S,H,P) f32, dB, dC (B,S,H,N) f32 per head, dla (B,S,H)).

    ``h_enter`` and ``dS`` (B, chunks, H, P, N) and ``ddecay`` (B, chunks,
    H) come from :func:`bwd_state_passing`.
    """
    b, s, h, p = xh.shape
    q = _chunk(block_q, s)
    x, dyc = _chunked(xh, q), _chunked(dy, q)
    bf, cf = _chunked(Bm, q), _chunked(Cm, q)
    cum = _cum(la, q)  # (B,c,Q,H)
    ecum = cum.exp()
    e_end = torch.exp(cum[:, :, -1:, :] - cum)  # exp(cum_end - cum_j)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,c,Q,Q,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    L = diff.masked_fill(~tri[None, None, :, :, None], float("-inf")).exp()
    CB = torch.einsum("bcqn,bcjn->bcqj", cf, bf)
    W = CB[..., None] * L
    M = L * torch.einsum("bcqhp,bcjhp->bcqjh", dyc, x)
    T = CB[..., None] * M  # d(loss)/d(log L[q, j])
    del diff, L
    xdS = torch.einsum("bcjhp,bchpn->bcjhn", x, dS)
    dyh = torch.einsum("bcqhp,bchpn->bcqhn", dyc, h_enter)
    dx = torch.einsum("bcqjh,bcqhp->bcjhp", W, dyc)
    dx = dx + e_end[..., None] * torch.einsum("bcjn,bchpn->bcjhp", bf, dS)
    dB = torch.einsum("bcqjh,bcqn->bcjhn", M, cf) + e_end[..., None] * xdS
    dC = torch.einsum("bcqjh,bcjn->bcqhn", M, bf) + ecum[..., None] * dyh
    # dcum: L (rows +, columns -), the carry term exp(cum_q), S_c's
    # exp(cum_end - cum_j), and cum_end through S_c and the decay
    E = ecum * torch.einsum("bcqhn,bcqn->bcqh", dyh, cf)
    F = e_end * torch.einsum("bcjhn,bcjn->bcjh", xdS, bf)
    dcum = T.sum(dim=3) - T.sum(dim=2) + E - F
    dcum[:, :, -1] += F.sum(dim=2) + ddecay
    dla = dcum.flip(2).cumsum(dim=2).flip(2)

    def unchunk(t):
        return t.reshape(b, -1, *t.shape[3:])[:, :s]

    return unchunk(dx), unchunk(dB), unchunk(dC), unchunk(dla)


def head_sum_plain(per_head: torch.Tensor) -> torch.Tensor:
    """Pass 4: (B,S,H,N) -> (B,S,N), the heads added in order from head 0."""
    acc = torch.zeros_like(per_head[:, :, 0])
    for i in range(per_head.shape[2]):
        acc = acc + per_head[:, :, i]
    return acc


def ssd_scan_bwd_plain(xh, la, Bm, Cm, h0, dy, dh_final=None, *, block_q: int = 128) -> tuple:
    """Plain PyTorch version: the explicit chunked backward in f32 (not
    autograd) -> ``(dxh, dla, dBm, dCm, dh0)``, each in its input's dtype."""
    check_inputs(xh, la, Bm, Cm, h0)
    check_grads(xh, Bm, dy, dh_final)
    states, G, decay = bwd_chunk_states(xh, la, Bm, Cm, dy, block_q=block_q)
    h_enter, dS, dh0, ddecay = bwd_state_passing(states, G, decay, h0, dh_final)
    dx, dB, dC, dla = bwd_chunk_grads(
        xh, la, Bm, Cm, dy, h_enter, dS, ddecay, block_q=block_q
    )
    dt = xh.dtype
    return (
        dx.to(dt),
        dla,
        head_sum_plain(dB).to(dt),
        head_sum_plain(dC).to(dt),
        None if h0 is None else dh0,
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    fn = lib.repro_ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_route(dtype: torch.dtype) -> str:
    """The route a call of the kernels takes: ``"wgmma"`` for bf16 (the
    products on the tensor cores), ``"simt"`` for f32 (on the CUDA cores)."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def scratch_floats(b, s, h, p, n, q, route: str = "simt") -> int:
    """f32 elements of one call's scratch.

    ``"simt"``: per (b, chunk, head) two P × N states, the Q × Q matrices W
    and M, per-head dB and dC (Q × N each), the row-and-column sums of T,
    the decay and its gradient by block of the state passing (up to 4).
    ``"wgmma"``: per (b, chunk, head) two P × N states, the entering state
    and its gradient as bf16 hi + lo images (64 × 64 × 2 parts, 16 KB
    each), the decay and its gradient by block (4); per (b, chunk, group of
    heads) the group's dB and dC (Q × N each), room for groups of one head
    (the kernel halves its group of 8 while the blocks would not fill the
    card).
    """
    nc = -(-s // q)
    blocks = b * nc * h
    if route == "wgmma":
        return blocks * (2 * p * n + 2 * 64 * 64 + 2 * q * n + 5)
    return blocks * (2 * p * n + 2 * q * q + 2 * q * n + q + 5)


def ssd_scan_bwd(xh, la, Bm, Cm, h0, dy, dh_final=None, *, block_q: int = 128) -> tuple:
    """The gradient of :func:`~repro_torch.kernels.ssd_scan.ssd_scan`.

    -> ``(dxh, dla, dBm, dCm, dh0)`` for the output gradients ``dy`` (in
    xh's dtype) and ``dh_final`` (f32, or None for zero).  ``Bm``/``Cm`` may
    be strided as the forward takes them.  CPU tensors run
    :func:`ssd_scan_bwd_plain`; CUDA tensors launch the kernels on the
    current stream.
    """
    check_inputs(xh, la, Bm, Cm, h0)
    check_grads(xh, Bm, dy, dh_final)
    if xh.device.type == "cpu":
        return ssd_scan_bwd_plain(xh, la, Bm, Cm, h0, dy, dh_final, block_q=block_q)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on cpu or cuda, not {xh.device}")
    b, s, h, p = xh.shape
    n = Bm.shape[2]
    if p not in HEAD_DIMS or n not in STATES:
        raise ValueError(
            f"the ssd_scan_bwd kernel takes head dims {HEAD_DIMS} and states "
            f"{STATES}, got P={p}, N={n}"
        )
    q = _chunk(block_q, s)
    if q > MAX_CHUNK:
        raise ValueError(f"the ssd_scan_bwd kernel takes chunks up to {MAX_CHUNK}, got {q}")
    route = kernel_route(xh.dtype)
    # the SIMT kernels read every operand element by element through its
    # strides, so only a unit stride along P / N is asked for; the
    # tensor-core route copies rows in 16-byte pieces
    fits = _vector_rows if route == "wgmma" else (lambda t: t.stride(-1) == 1)
    xh, Bm, Cm, dy = (
        t if fits(t) else t.clone(memory_format=torch.contiguous_format)
        for t in (xh, Bm, Cm, dy)
    )
    h0 = None if h0 is None else h0.contiguous()
    dh_final = None if dh_final is None else dh_final.contiguous()
    global _launches, _last_route
    lib = _library()
    dev = xh.device
    dxh = torch.empty((b, s, h, p), dtype=xh.dtype, device=dev)
    dla = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dBm = torch.empty((b, s, n), dtype=xh.dtype, device=dev)
    dCm = torch.empty((b, s, n), dtype=xh.dtype, device=dev)
    dh0 = None if h0 is None else torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_floats(b, s, h, p, n, q, route), dtype=torch.float32,
                          device=dev)
    strides = [*xh.stride()[:3], *la.stride(), *Bm.stride()[:2], *Cm.stride()[:2]]
    strides += dy.stride()[:3]
    strides = (ctypes.c_int64 * 13)(*strides)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_ssd_scan_bwd(
            xh.data_ptr(),
            la.data_ptr(),
            Bm.data_ptr(),
            Cm.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            dy.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            dxh.data_ptr(),
            dla.data_ptr(),
            dBm.data_ptr(),
            dCm.data_ptr(),
            None if dh0 is None else dh0.data_ptr(),
            scratch.data_ptr(),
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
        raise RuntimeError(f"ssd_scan_bwd kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    _last_route = route
    return dxh, dla, dBm, dCm, dh0
