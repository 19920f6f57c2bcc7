"""The xLSTM mLSTM chunked scan, with the final state (every mLSTM prefill).

The port of ``repro/kernels/mlstm_scan.py::mlstm_scan`` to a kernel written
by hand for Hopper: ``csrc/mlstm_scan.cu``, CUDA C++ for ``sm_90a``, built
with ``nvcc`` at first use and loaded with ``ctypes`` (see
:mod:`repro_torch.kernels._build`).  The TPU kernel ran a ``(batch*heads,
chunks)`` grid whose sequential chunk axis carried the stabilised state
``(C̃ D×D, ñ D, m)`` in VMEM.  At xlstm-1.3b's head dim of 1024, C̃ is 4 MiB
of f32 per head, far past one SM's shared memory, so here the state is
tiled across blocks.  One call runs three CUDA kernels:

1. a gate pass, one warp per (b, h): prefix sums of the log forget gates,
   the running max that stabilises the exponents, and the state's ``m``
   entering every chunk (O(S) scalars);
2. a W pass, one block per (b, h, chunk): ``W = (q kᵀ) ⊙ exp(u_j - g_q)``
   over the causal triangle, and its row sums;
3. a state pass over the chunks in order, by one of two routes
   (:func:`kernel_route`, chosen in plain code by dtype and head dim):

   * ``"wgmma"`` (bf16): a thread-block cluster of ``D / 128`` blocks owns
     a 64-column tile of C̃, each block 128 of its rows in f32 ``wgmma``
     accumulators; ``q C̃``, ``W v`` and the update ``kᵀ (wgt ⊙ v)`` run on
     ``wgmma`` with the f32 operand split into bf16 hi + lo (about 16
     bits), q, k and v come by TMA, and the partial products of h are
     summed across the cluster in distributed shared memory.  The W pass
     runs on ``wgmma`` too;
   * ``"mma.sync"`` (f32, and bf16 at head dims the clusters do not tile):
     one block per (b, h, 32 value columns of C̃) keeps its ``D × 32``
     slab in shared memory and runs the products on ``mma.sync`` in split
     TF32 (about f32 accuracy).

The contract is the TPU kernel's plus the final state, which is what the
model's ``_chunked_mlstm`` returns: ``q``, ``k``, ``v`` (B,S,H,D) in bf16 or
f32 with ``k`` already scaled by 1/√D; ``lf``, ``li`` (B,S,H) f32 log gates;
an optional initial ``state = (C (B,H,D,D), n (B,H,D), m (B,H))`` in f32 ->
``h`` (B,S,H,D) f32 and the final ``(C, n, m)`` in f32.  A ragged tail is
padded with identity steps (f = 1, i = 0: ``lf`` = 0, ``li`` = -1e30), so the
final ``m`` is the value after the padded tail, as in the JAX code.

:func:`mlstm_scan` is the wrapper.  For tensors on the CPU it runs
:func:`mlstm_scan_plain`, the plain PyTorch version of the same chunked
math; for CUDA tensors it launches the kernels or raises: there is no
fallback.  Each call adds one to :func:`launch_count` (one call is three
CUDA kernels).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/mlstm_scan.cu"

NEG_INF = -1e30

#: Head dims are multiples of this (the value columns of one state slab).
HEAD_DIM_STEP = 32
MAX_HEAD_DIM = 1024

#: The longest chunk the kernel's shared-memory tiles hold.
MAX_CHUNK = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: The kernels' two routes (:func:`kernel_route`) and their codes in the C
#: interface: the W and state passes on ``mma.sync`` in split TF32, or on
#: ``wgmma`` (bf16 q, k, v at head dims the clusters tile).
_ROUTE_CODE = {"mma.sync": 0, "wgmma": 1}

#: Blocks of a thread-block cluster at most (the portable size): one
#: 64-column tile of C̃ is split over D / 128 (or D / 64) blocks of rows.
MAX_CLUSTER = 8

#: dtypes the kernel takes for q, k and v (lf, li and the state are float32).
DTYPES = tuple(_DTYPE_CODE)

_launches = 0


def launch_count() -> int:
    """Wrapper calls that launched the kernels since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def check_inputs(q, k, v, lf, li, state=None) -> None:
    """Raise unless the arguments fit one mLSTM scan."""
    if q.dim() != 4 or lf.dim() != 3 or li.dim() != 3:
        raise ValueError(
            "mlstm_scan takes q, k, v (B,S,H,D) and lf, li (B,S,H), got "
            f"{tuple(q.shape)}, {tuple(lf.shape)}, {tuple(li.shape)}"
        )
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} differ"
        )
    if tuple(lf.shape) != (b, s, h) or tuple(li.shape) != (b, s, h):
        raise ValueError(
            f"lf {tuple(lf.shape)} and li {tuple(li.shape)} must be (B,S,H) = "
            f"{(b, s, h)}"
        )
    if s < 1:
        raise ValueError("mlstm_scan needs at least one position")
    if d < 1 or d % HEAD_DIM_STEP or d > MAX_HEAD_DIM:
        raise ValueError(
            f"mlstm_scan takes head dims that are multiples of {HEAD_DIM_STEP} "
            f"up to {MAX_HEAD_DIM}, got {d}"
        )
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"q, k, v must share one dtype of {DTYPES}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if lf.dtype != torch.float32 or li.dtype != torch.float32:
        raise TypeError(f"lf, li (log gates) must be float32, got {lf.dtype}, {li.dtype}")
    tensors = [q, k, v, lf, li]
    if state is not None:
        if len(state) != 3:
            raise ValueError("state is a tuple (C, n, m)")
        shapes = ((b, h, d, d), (b, h, d), (b, h))
        for name, t, want in zip("Cnm", state, shapes):
            if tuple(t.shape) != want or t.dtype != torch.float32:
                raise ValueError(
                    f"state {name} must be float32 {want}, got {t.dtype} "
                    f"{tuple(t.shape)}"
                )
        tensors += list(state)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs lie on {[str(t.device) for t in tensors]}")


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route a call of the kernel takes for q, k, v of ``dtype``.

    ``"wgmma"``: bf16 with a head dim that is a multiple of 128 up to
    ``128 * MAX_CLUSTER``, or of 64 up to ``64 * MAX_CLUSTER`` (one cluster
    of blocks then holds a 64-column tile of C̃).  ``"mma.sync"``: f32, and
    bf16 at the other head dims the kernel takes.
    """
    tiled = (head_dim % 128 == 0 and head_dim // 128 <= MAX_CLUSTER) or (
        head_dim % 64 == 0 and head_dim // 64 <= MAX_CLUSTER
    )
    return "wgmma" if dtype == torch.bfloat16 and tiled else "mma.sync"


def _chunk(block_q: int, seq: int) -> int:
    if block_q < 1:
        raise ValueError(f"block_q must be >= 1, got {block_q}")
    return min(block_q, seq)


def mlstm_scan_plain(q, k, v, lf, li, state=None, *, block_q: int = 128) -> tuple:
    """Plain PyTorch version: ``_chunked_mlstm``'s math in f32.

    Chunks of ``Q = min(block_q, S)`` positions, a Python loop over chunks,
    vectorised over (B, H) inside one.  Within a chunk, with ``cumF`` the
    prefix sum of ``lf``, ``u = li - cumF`` and ``g = max(m, cummax(u))``:
    ``h_q = (Σ_{j<=q} W_qj v_j + e^{m - g_q} q_q C̃) / max(|Σ_j W_qj +
    e^{m - g_q} q_q·ñ|, e^{-(cumF_q + g_q)})`` with ``W = (q kᵀ) ⊙ e^{u_j -
    g_q}``; then ``C̃ <- e^{m - g_Q} C̃ + (k ⊙ e^{u - g_Q})ᵀ v`` as one
    batched product, ``ñ`` the same on ``k``, ``m <- cumF_Q + g_Q``.
    """
    check_inputs(q, k, v, lf, li, state)
    b, s, h, d = q.shape
    qn = _chunk(block_q, s)
    pad = (-s) % qn
    dev = q.device
    # (B,H,S,D) and (B,H,S) in f32
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    lff, lif = lf.float().permute(0, 2, 1), li.float().permute(0, 2, 1)
    if pad:
        qf, kf, vf = (F.pad(t, (0, 0, 0, pad)) for t in (qf, kf, vf))
        lff = F.pad(lff, (0, pad))
        lif = F.pad(lif, (0, pad), value=NEG_INF)
    if state is None:
        C = torch.zeros((b, h, d, d), dtype=torch.float32, device=dev)
        n = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
        m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=dev)
    else:
        C, n, m = (t.float().clone() for t in state)
    tri = torch.ones((qn, qn), dtype=torch.bool, device=dev).tril()
    out = []
    for c0 in range(0, s + pad, qn):
        sl = slice(c0, c0 + qn)
        qc, kc, vc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl]  # (B,H,Q,D)
        cum = lff[:, :, sl].cumsum(dim=-1)  # (B,H,Q)
        u = lif[:, :, sl] - cum
        g = torch.maximum(m[..., None], torch.cummax(u, dim=-1).values)
        # exp(u_j - g_q) only for j <= q: above the diagonal it may overflow
        diff = u[..., None, :] - g[..., :, None]  # (B,H,q,j)
        W = (qc @ kc.transpose(-1, -2)) * diff.masked_fill(~tri, float("-inf")).exp()
        carry = torch.exp(m[..., None] - g)  # (B,H,Q)
        num = W @ vc + carry[..., None] * (qc @ C)
        # |q·ñ| of the combined (intra-chunk + carry) normaliser
        den = (W.sum(dim=-1) + carry * (qc @ n[..., None])[..., 0]).abs()
        floor = torch.exp(-(cum + g))
        out.append(num / torch.maximum(den, floor)[..., None])
        gq = g[..., -1]  # (B,H)
        kw = kc * torch.exp(u - gq[..., None])[..., None]  # (B,H,Q,D)
        decay = torch.exp(m - gq)
        C = torch.baddbmm(
            (C * decay[..., None, None]).reshape(b * h, d, d),
            kw.reshape(b * h, qn, d).transpose(1, 2),
            vc.reshape(b * h, qn, d),
        ).reshape(b, h, d, d)
        n = decay[..., None] * n + kw.sum(dim=2)
        m = cum[..., -1] + gq
    hs = torch.cat(out, dim=2)[:, :, :s].permute(0, 2, 1, 3).contiguous()
    return hs, (C, n, m)


def _chunk_gates(lf, li, qn: int) -> tuple:
    """``cumF`` and ``u = li - cumF`` of each chunk of ``qn`` rows, (B, nc,
    H, Q) in f32, the sequence a whole number of chunks."""
    b, s, h = lf.shape
    if s % qn:
        raise ValueError(f"the sequence ({s}) is not a whole number of chunks of {qn}")
    cum = lf.float().reshape(b, s // qn, qn, h).permute(0, 1, 3, 2).cumsum(dim=-1)
    return cum, li.float().reshape(b, s // qn, qn, h).permute(0, 1, 3, 2) - cum


def _by_chunk(t, qn: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, nc, H, Q, D) in f32."""
    b, s, h, d = t.shape
    return t.float().reshape(b, s // qn, qn, h, d).permute(0, 1, 3, 2, 4)


def chunk_states_plain(k, v, lf, li, rows: tuple, *, block_q: int = 128) -> tuple:
    """What rows ``[r0, r0 + nr)`` of each chunk add to the chunk's end
    state, stabilised by the chunk's ``a = max u``: ``dC = (k ⊙ e^{u -
    a})ᵀ v`` (B, nc, H, D, D) and ``dn`` (B, nc, H, D), f32 (the plain
    scan's chunk update on those rows; ``nr`` may be 0)."""
    qn = _chunk(block_q, k.shape[1])
    r0, nr = rows
    cum, u = _chunk_gates(lf, li, qn)
    a = u.amax(dim=-1)
    wgt = torch.exp(u[..., r0:r0 + nr] - a[..., None])
    kw = _by_chunk(k, qn)[..., r0:r0 + nr, :] * wgt[..., None]
    return kw.transpose(-1, -2) @ _by_chunk(v, qn)[..., r0:r0 + nr, :], kw.sum(dim=-2)


def pass_states(dC, dn, lf, li, state=None, *, block_q: int = 128) -> tuple:
    """The state entering each chunk, ``(C (B, nc, H, D, D), n (B, nc, H,
    D), m (B, nc, H))``, and the state after the last, from each chunk's
    whole update ``dC``, ``dn`` (:func:`chunk_states_plain` over all its
    rows) and ``state`` (the one entering the first chunk, or None): ``g =
    max(m, a)``, ``C̃ <- e^{m - g} C̃ + e^{a - g} dC``, ``m <- cumF_Q + g``,
    the plain scan's carry."""
    b, nc, h, d, _ = dC.shape
    cum, u = _chunk_gates(lf, li, _chunk(block_q, lf.shape[1]))
    a, end = u.amax(dim=-1), cum[..., -1]
    if state is None:
        C = dC.new_zeros((b, h, d, d))
        n = dn.new_zeros((b, h, d))
        m = dC.new_full((b, h), NEG_INF)
    else:
        C, n, m = (t.float() for t in state)
    entering = ([], [], [])
    for c in range(nc):
        for kept, t in zip(entering, (C, n, m)):
            kept.append(t)
        g = torch.maximum(m, a[:, c])
        decay, add = torch.exp(m - g), torch.exp(a[:, c] - g)
        C = decay[..., None, None] * C + add[..., None, None] * dC[:, c]
        n = decay[..., None] * n + add[..., None] * dn[:, c]
        m = end[:, c] + g
    return tuple(torch.stack(t, dim=1) for t in entering), (C, n, m)


def mlstm_chunk_rows_plain(q, k, v, lf, li, entering: tuple, rows: tuple, *,
                           block_q: int = 128) -> torch.Tensor:
    """h of rows ``[r0, r0 + nr)`` of every chunk, each chunk entered from
    its own state ``entering`` (:func:`pass_states`) -> (B, nc, nr, H, D)
    f32: the plain scan's outputs of those rows, scored against the
    chunk's keys up to them (those after them are masked out)."""
    qn = _chunk(block_q, q.shape[1])
    r0, nr = rows
    end = r0 + nr
    C, n, m = entering
    cum, u = _chunk_gates(lf, li, qn)
    cum, u = cum[..., :end], u[..., :end]
    qc = _by_chunk(q, qn)[..., r0:end, :]  # (B,nc,H,nr,D)
    kc, vc = _by_chunk(k, qn)[..., :end, :], _by_chunk(v, qn)[..., :end, :]
    g = torch.maximum(m[..., None], torch.cummax(u, dim=-1).values)[..., r0:end]
    tri = torch.ones((end, end), dtype=torch.bool, device=q.device).tril()[r0:end]
    diff = u[..., None, :] - g[..., :, None]  # (B,nc,H,nr,end)
    W = (qc @ kc.transpose(-1, -2)) * diff.masked_fill(~tri, float("-inf")).exp()
    carry = torch.exp(m[..., None] - g)
    num = W @ vc + carry[..., None] * (qc @ C)
    den = (W.sum(dim=-1) + carry * (qc @ n[..., None])[..., 0]).abs()
    floor = torch.exp(-(cum[..., r0:end] + g))
    return (num / torch.maximum(den, floor)[..., None]).permute(0, 1, 3, 2, 4)


def _vector_rows(t: torch.Tensor) -> bool:
    """Whether every (b, s, h) row of ``t`` starts 16-byte aligned with a unit
    stride along D, as the kernel's vector loads need."""
    vec = 16 // t.element_size()
    return (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all(s % vec == 0 for s in t.stride()[:3])
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("mlstm_scan")
    fn = lib.repro_mlstm_scan
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def mlstm_scan(q, k, v, lf, li, state=None, *, block_q: int = 128) -> tuple:
    """The mLSTM scan -> (h (B,S,H,D) f32, (C (B,H,D,D), n (B,H,D), m (B,H))).

    ``q``, ``k``, ``v`` (B,S,H,D) bf16 or f32 (``k`` pre-scaled) may be
    strided along B, S and H; a layout whose rows are not 16-byte aligned
    with a unit stride on D is copied.
    ``lf``, ``li`` (B,S,H) f32 may be strided.  ``state`` is an optional
    initial ``(C, n, m)`` in f32.  Chunks hold ``min(block_q, S)``
    positions.  CPU tensors run :func:`mlstm_scan_plain`; CUDA tensors
    launch the kernels on the current stream.
    """
    check_inputs(q, k, v, lf, li, state)
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, lf, li, state, block_q=block_q)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan runs on cpu or cuda, not {q.device}")
    b, s, h, d = q.shape
    qn = _chunk(block_q, s)
    if qn > MAX_CHUNK:
        raise ValueError(f"the mlstm_scan kernel takes chunks up to {MAX_CHUNK}, got {qn}")
    global _launches
    lib = _library()
    # the kernel reads rows as 16-byte vectors; any other layout is copied
    q, k, v = (t if _vector_rows(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    if state is not None:
        state = tuple(t.contiguous() for t in state)
    nc = -(-s // qn)
    sp = nc * qn
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((b, s, h, d), **f32)
    c_out = torch.empty((b, h, d, d), **f32)
    n_out = torch.empty((b, h, d), **f32)
    m_out = torch.empty((b, h), **f32)
    # scratch: per position cumF, u, g and the rows of W summed; per chunk
    # the m entering it; W itself, (B, H, chunks, Q, Q)
    gates = torch.empty((4, b, h, sp), **f32)
    m_in = torch.empty((b, h, nc), **f32)
    w = torch.empty((b, h, nc, qn, qn), **f32)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    strides += [*lf.stride(), *li.stride()]
    strides = (ctypes.c_int64 * 15)(*strides)
    c0, n0, m0 = (None, None, None) if state is None else (t.data_ptr() for t in state)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_mlstm_scan(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            lf.data_ptr(),
            li.data_ptr(),
            c0,
            n0,
            m0,
            out.data_ptr(),
            c_out.data_ptr(),
            n_out.data_ptr(),
            m_out.data_ptr(),
            gates.data_ptr(),
            m_in.data_ptr(),
            w.data_ptr(),
            ctypes.addressof(strides),
            b,
            s,
            h,
            d,
            qn,
            _DTYPE_CODE[q.dtype],
            _ROUTE_CODE[kernel_route(q.dtype, d)],
            stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"mlstm_scan kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    return out, (c_out, n_out, m_out)
