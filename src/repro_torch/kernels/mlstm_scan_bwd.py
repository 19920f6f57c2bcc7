"""The gradient of the xLSTM mLSTM chunked scan (every xlstm train step).

A kernel of the port with no TPU counterpart: the JAX package's models
never call its Pallas scan, and ``jax.value_and_grad`` differentiates the
plain chunked code (``repro/models/xlstm.py::_chunked_mlstm``) through XLA.
The port's train step runs the forward kernel
(:mod:`repro_torch.kernels.mlstm_scan`), so its gradient is a kernel too:
``csrc/mlstm_scan_bwd.cu``, CUDA C++ for ``sm_90a``, built with ``nvcc`` at
first use and loaded with ``ctypes`` (see :mod:`repro_torch.kernels._build`).

**The stabilisers are held fixed.**  Within a chunk the forward divides by
``max(|s_q|, exp(-M_q))`` with ``M_q = cumF_q + g_q`` the absolute
stabiliser at position q and ``g = max(m, cummax(li - cumF))``.  Every
stabilised factor is then ``exp(x - M)`` for some sum ``x`` of the inputs,
and ``h`` does not depend on ``M``: autograd through the ``max`` and
``cummax`` gives the gradients of the same function as holding every
absolute stabiliser ``M_q`` (and the entering ``m``) constant.  So here
``D[q, j] = exp(li_j + cumF_q - cumF_j - M_q)``, ``a_q = exp(m + cumF_q -
M_q)`` and the chunk-end weights take gradients through ``li`` and
``cumF`` only.  The relative ``g_q`` must not be held fixed: it moves with
``cumF``.  The final state is stabilised by its own ``m``, which does move
with the inputs: the gradients of the final ``(C̃, ñ)`` (and of ``m``, if
asked) also reach the gates along the one path that ``m`` takes, from the
position (or the entering ``m``) that won its maxima.

One call runs nine CUDA kernels (no atomics, so two calls give equal
bits; the plain version below is the same math, chunk by chunk), by one of
two routes (:func:`kernel_route`, reported by :func:`last_route`):
``"wgmma"`` (bf16 at head dims that are multiples of 64) runs the products
of kernels 2, 4, 5, 6 and 8 on the tensor cores, bf16 in and f32
accumulated, each f32 operand (with its row scalar applied) split into
bf16 ``hi + lo`` parts, about 16 significant bits, and the state passes
write the states and their gradients as those parts in the layout the
products read; ``"simt"`` (f32, and bf16 at the other head dims) runs
every product on the CUDA cores in f32:

1. a gate pass, one warp per (b, h): ``cumF``, ``g`` and each chunk's
   entering ``m``, as the forward's gate pass;
2. the chunk updates ``Σ_j wgt_j k_j ⊗ v_j`` and ``Σ_j wgt_j k_j``, one
   block per (b, h, chunk, 128 × 128 tile of C̃);
3. the state pass in chunk order: the state entering each chunk, written
   over its update (the ``D × D`` slab of every chunk, 4 MiB a (b, h,
   chunk): 0.5 GiB at xlstm-1.3b's train shape of B 1, S 4096, transient;
   on the ``"wgmma"`` route as bf16 parts into a slab of its own);
4. ``Z = dh C̃ᵀ`` for each chunk (the carry's share of ``dq``) and ``q · Z``
   by tile, one block per (b, h, chunk, 128 columns);
5. a row pass, one block per (b, h, chunk): ``S = q kᵀ``, ``dh vᵀ``, the
   denominators, ``ds`` (zero where the floor wins, else through
   ``sign(s)``), then ``dq`` whole and the ``Q × Q`` shares of ``dk`` and
   ``dv``;
6. the local state gradients ``Σ_q (a_q / dd_q) q_q ⊗ dh_q`` and
   ``Σ_q a_q ds_q q_q`` (kernel 2's shape);
7. the reverse state pass: the gradient of the state leaving each chunk
   (over kernel 6's output), the entering state's gradient, and each
   chunk's ``<dC̃', C̃> + <dñ', ñ>`` by block;
8. the state's shares of ``dk`` and ``dv`` and of the chunk-end weights,
   one block per (b, h, chunk, 128 columns);
9. a last gate pass, one warp per (b, h): ``dcumF`` and ``dli`` summed in
   order, the final ``m``'s path, ``dlf`` as the reverse prefix sum of
   ``dcumF`` within each chunk.

The contract: the forward's ``q, k, v (B,S,H,D)`` (``k`` pre-scaled),
``lf``, ``li (B,S,H)`` f32, an optional entering ``state = (C, n, m)``,
the gradient ``dh (B,S,H,D)`` f32 of h and optionally ``dC``, ``dn``,
``dm`` of the final state -> ``(dq, dk, dv, dlf, dli, dstate)``: ``dq``,
``dk``, ``dv`` in the input dtype, ``dlf``, ``dli`` f32, ``dstate = (dC,
dn, dm)`` f32 for the entering state (None without one).  Head dims are
multiples of 32 up to 1024; chunks up to 128.  The ``"wgmma"`` route reads
q, k, v and dh in 16-byte pieces: a layout whose rows are not 16-byte
aligned with a unit last stride is copied first.

:func:`mlstm_scan_bwd` is the wrapper.  For tensors on the CPU it runs
:func:`mlstm_scan_bwd_plain`; for CUDA tensors it launches the kernels or
raises: there is no fallback.  Each call adds one to :func:`launch_count`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_scan import (
    MAX_CHUNK,
    NEG_INF,
    _chunk,
    _DTYPE_CODE,
    _vector_rows,
    check_inputs,
)

#: Path of the kernel's source in the repository.
SOURCE = "src/repro_torch/csrc/mlstm_scan_bwd.cu"

#: The kernels' tile of C̃ and of the head dim (columns a block takes).
TILE = 128

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


def check_grads(q, dh, dfinal) -> None:
    """Raise unless ``dh`` and the final state's gradients fit the call."""
    b, s, h, d = q.shape
    if tuple(dh.shape) != (b, s, h, d) or dh.dtype != torch.float32 or dh.device != q.device:
        raise ValueError(
            f"dh must be float32 {(b, s, h, d)} on {q.device}, got {dh.dtype} "
            f"{tuple(dh.shape)} on {dh.device}"
        )
    shapes = ((b, h, d, d), (b, h, d), (b, h))
    for name, t, want in zip(("dC", "dn", "dm"), dfinal, shapes):
        if t is not None and (
            tuple(t.shape) != want or t.dtype != torch.float32 or t.device != q.device
        ):
            raise ValueError(
                f"{name} must be float32 {want} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def _padded(q, k, v, lf, li, qn: int) -> tuple:
    """(B,H,Sp,D) q, k, v and (B,H,Sp) lf, li in f32, the tail padded with
    identity steps (lf 0, li NEG_INF, zero q, k, v)."""
    pad = (-q.shape[1]) % qn
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    lff, lif = lf.float().permute(0, 2, 1), li.float().permute(0, 2, 1)
    if pad:
        qf, kf, vf = (F.pad(t, (0, 0, 0, pad)) for t in (qf, kf, vf))
        lff = F.pad(lff, (0, pad))
        lif = F.pad(lif, (0, pad), value=NEG_INF)
    return qf, kf, vf, lff, lif


def mlstm_scan_bwd_plain(q, k, v, lf, li, state, dh, dC=None, dn=None, dm=None, *,
                         block_q: int = 128) -> tuple:
    """Plain PyTorch version: the explicit chunked backward in f32 (not
    autograd), the absolute stabilisers held fixed (see the module note).

    -> ``(dq, dk, dv, dlf, dli, dstate)`` as :func:`mlstm_scan_bwd`.
    """
    check_inputs(q, k, v, lf, li, state)
    check_grads(q, dh, (dC, dn, dm))
    b, s, h, d = q.shape
    qn = _chunk(block_q, s)
    dev = q.device
    qf, kf, vf, lff, lif = _padded(q, k, v, lf, li, qn)
    dhf = dh.float().permute(0, 2, 1, 3)
    pad = qf.shape[2] - s
    if pad:
        dhf = F.pad(dhf, (0, 0, 0, pad))
    sp = qf.shape[2]
    nc = sp // qn
    f32 = dict(dtype=torch.float32, device=dev)
    if state is None:
        C = torch.zeros((b, h, d, d), **f32)
        n = torch.zeros((b, h, d), **f32)
        m = torch.full((b, h), NEG_INF, **f32)
    else:
        C, n, m = (t.float() for t in state)
    tri = torch.ones((qn, qn), dtype=torch.bool, device=dev).tril()

    # forward: the gates and the state entering each chunk
    enter, gates = [], []
    for c in range(nc):
        sl = slice(c * qn, (c + 1) * qn)
        cum = lff[:, :, sl].cumsum(dim=-1)
        u = lif[:, :, sl] - cum
        g = torch.maximum(m[..., None], torch.cummax(u, dim=-1).values)
        enter.append((C, n, m))
        gates.append((cum, u, g))
        gq = g[..., -1]
        wgt = torch.exp(u - gq[..., None])
        decay = torch.exp(m - gq)
        kw = kf[:, :, sl] * wgt[..., None]
        C = C * decay[..., None, None] + kw.transpose(-1, -2) @ vf[:, :, sl]
        n = n * decay[..., None] + kw.sum(dim=2)
        m = cum[..., -1] + gq
    # the final state's stabiliser moves with the inputs: its total gradient
    # (asked, plus the final (C̃, ñ)'s through exp(-m)) follows m's path back
    dm_path = torch.zeros((b, h), **f32) if dm is None else dm.float().clone()
    if dC is not None:
        dm_path -= (dC.float() * C).sum(dim=(-1, -2))
    if dn is not None:
        dm_path -= (dn.float() * n).sum(dim=-1)

    dCp = torch.zeros((b, h, d, d), **f32) if dC is None else dC.float()
    dnp = torch.zeros((b, h, d), **f32) if dn is None else dn.float()
    dq, dk, dv = (torch.zeros((b, h, sp, d), **f32) for _ in range(3))
    dlf, dli = torch.zeros((b, h, sp), **f32), torch.zeros((b, h, sp), **f32)
    dm0 = torch.zeros((b, h), **f32)
    for c in reversed(range(nc)):
        sl = slice(c * qn, (c + 1) * qn)
        qc, kc, vc, dhc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], dhf[:, :, sl]
        Ci, ni, mi = enter[c]
        cum, u, g = gates[c]
        Dm = (u[..., None, :] - g[..., :, None]).masked_fill(~tri, float("-inf")).exp()
        W = (qc @ kc.transpose(-1, -2)) * Dm
        a = torch.exp(mi[..., None] - g)  # (B,H,Q)
        qC = qc @ Ci
        qnv = (qc * ni[..., None, :]).sum(dim=-1)
        ssum = W.sum(dim=-1) + a * qnv
        floor = torch.exp(-(cum + g))
        den = torch.maximum(ssum.abs(), floor)
        num = W @ vc + a[..., None] * qC
        dnum = dhc / den[..., None]
        dden = -(dhc * num).sum(dim=-1) / den**2
        ds = torch.where(ssum.abs() > floor, dden * torch.sign(ssum), torch.zeros_like(dden))
        dW = (dnum @ vc.transpose(-1, -2) + ds[..., None]).masked_fill(~tri, 0.0)
        dSm = dW * Dm
        P = dW * W  # d(loss)/d(log D[q, j])
        dq[:, :, sl] = dSm @ kc + a[..., None] * (dnum @ Ci.transpose(-1, -2)) \
            + (a * ds)[..., None] * ni[..., None, :]
        dk[:, :, sl] = dSm.transpose(-1, -2) @ qc
        dv[:, :, sl] = W.transpose(-1, -2) @ dnum
        dloga = a * ((dnum * qC).sum(dim=-1) + ds * qnv)
        dli_c = P.sum(dim=-2)
        dcum = P.sum(dim=-1) - P.sum(dim=-2) + dloga
        # the chunk-end update: C̃' = decay C̃ + Σ_j wgt_j k_j ⊗ v_j, ñ alike
        gq = g[..., -1]
        wgt = torch.exp(u - gq[..., None])
        decay = torch.exp(mi - gq)
        kd = vc @ dCp.transpose(-1, -2) + dnp[..., None, :]  # dC̃' v_j + dñ'
        dk[:, :, sl] += wgt[..., None] * kd
        dv[:, :, sl] += wgt[..., None] * (kc @ dCp)
        dlogw = wgt * (kc * kd).sum(dim=-1)
        dlogdecay = decay * ((dCp * Ci).sum(dim=(-1, -2)) + (dnp * ni).sum(dim=-1))
        dli_c = dli_c + dlogw
        dcum = dcum - dlogw
        dcum[..., -1] += dlogw.sum(dim=-1) + dlogdecay + dm_path
        # m leaving the chunk is cumF_end + max(m entering, max_j u_j): the
        # path goes to the winning u_j, or on to the entering m
        umax, jmax = u.max(dim=-1)
        won = (umax > mi).float()
        hit = F.one_hot(jmax, qn).float() * (won * dm_path)[..., None]
        dli_c = dli_c + hit
        dcum = dcum - hit
        dm_path = dm_path * (1 - won)
        dlf[:, :, sl] = dcum.flip(-1).cumsum(dim=-1).flip(-1)
        dli[:, :, sl] = dli_c
        if c == 0:
            dm0 = dloga.sum(dim=-1) + dlogdecay + dm_path
        dCp = decay[..., None, None] * dCp + (a[..., None] * qc).transpose(-1, -2) @ dnum
        dnp = decay[..., None] * dnp + ((a * ds)[..., None] * qc).sum(dim=2)

    def out(t, dtype):
        return t[:, :, :s].permute(0, 2, 1, 3).contiguous().to(dtype)

    dstate = None if state is None else (dCp, dnp, dm0)
    return (out(dq, q.dtype), out(dk, q.dtype), out(dv, q.dtype),
            dlf[:, :, :s].permute(0, 2, 1).contiguous(),
            dli[:, :, :s].permute(0, 2, 1).contiguous(), dstate)


def _library() -> ctypes.CDLL:
    lib = _build.load("mlstm_scan_bwd")
    fn = lib.repro_mlstm_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route a call of the kernels takes for q, k, v of ``dtype``.

    ``"wgmma"``: bf16 at head dims that are multiples of 64 (the products on
    the tensor cores, 64-column panels).  ``"simt"``: f32, and bf16 at the
    other head dims (the products on the CUDA cores in f32).
    """
    return "wgmma" if dtype == torch.bfloat16 and head_dim % 64 == 0 else "simt"


def scratch_floats(b, s, h, d, qn, route: str = "simt") -> int:
    """f32 elements of one call's scratch (see ``csrc/mlstm_scan_bwd.cu``)."""
    nc = -(-s // qn)
    sp = nc * qn
    bh = b * h
    tiles = -(-d // TILE)
    dd = d * d
    if route == "wgmma":
        # the states as bf16 parts: D rows padded to the 128-row panels; the
        # updates' slab then holds the leaving gradients' parts, and a third
        # slab the entering states'
        pslab = tiles * TILE * d
        pass_blocks = -(-pslab // 1024) + 1
        slabs = bh * nc * (2 * pslab + dd)
    else:
        pass_blocks = -(-dd // 1024) + 1
        slabs = 2 * bh * nc * dd  # the entering states; the leaving states' gradients
    return (
        slabs
        + 2 * bh * nc * d  # the same for ñ
        + 3 * bh * sp * d  # Z; the row pass's shares of dk and dv
        + bh * sp * (8 + 2 * tiles)  # per position scalars; q·Z and dwgt by tile
        + bh * nc * (1 + pass_blocks)  # m entering each chunk; <dC̃', C̃> by block
        + bh * (pass_blocks + 1)  # <dC̃, C̃_final> by block; dm0's chunk-0 share
    )


def mlstm_scan_bwd(q, k, v, lf, li, state, dh, dC=None, dn=None, dm=None, *,
                   block_q: int = 128) -> tuple:
    """The gradient of :func:`~repro_torch.kernels.mlstm_scan.mlstm_scan`.

    -> ``(dq, dk, dv, dlf, dli, dstate)`` for the gradient ``dh`` (f32) of
    h and, optionally, ``dC``, ``dn``, ``dm`` of the final state (None for
    zero).  CPU tensors run :func:`mlstm_scan_bwd_plain`; CUDA tensors
    launch the kernels on the current stream.
    """
    check_inputs(q, k, v, lf, li, state)
    check_grads(q, dh, (dC, dn, dm))
    if q.device.type == "cpu":
        return mlstm_scan_bwd_plain(q, k, v, lf, li, state, dh, dC, dn, dm,
                                    block_q=block_q)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan_bwd runs on cpu or cuda, not {q.device}")
    b, s, h, d = q.shape
    qn = _chunk(block_q, s)
    if qn > MAX_CHUNK:
        raise ValueError(f"the mlstm_scan_bwd kernel takes chunks up to {MAX_CHUNK}, got {qn}")
    global _launches, _last_route
    lib = _library()
    route = kernel_route(q.dtype, d)
    # the SIMT kernels read every operand element by element through its
    # (b, s, h) strides, so a unit stride along D is asked for; the
    # tensor-core route copies rows in 16-byte pieces
    fits = _vector_rows if route == "wgmma" else (lambda t: t.stride(-1) == 1)
    q, k, v, dh = (
        t if fits(t) else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v, dh)
    )
    state = None if state is None else tuple(t.contiguous() for t in state)
    dC, dn, dm = (None if t is None else t.contiguous() for t in (dC, dn, dm))
    dev = q.device
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=dev) for _ in range(3))
    dlf = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dli = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dstate = None
    if state is not None:
        dstate = (torch.empty((b, h, d, d), dtype=torch.float32, device=dev),
                  torch.empty((b, h, d), dtype=torch.float32, device=dev),
                  torch.empty((b, h), dtype=torch.float32, device=dev))
    scratch = torch.empty(scratch_floats(b, s, h, d, qn, route), dtype=torch.float32,
                          device=dev)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dh.stride()[:3]]
    strides += [*lf.stride(), *li.stride()]
    strides = (ctypes.c_int64 * 18)(*strides)

    def ptr(t):
        return None if t is None else t.data_ptr()

    c0, n0, m0 = (None, None, None) if state is None else state
    dc0, dn0, dm0 = (None, None, None) if dstate is None else dstate
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_mlstm_scan_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(), li.data_ptr(),
            ptr(c0), ptr(n0), ptr(m0), dh.data_ptr(), ptr(dC), ptr(dn), ptr(dm),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlf.data_ptr(),
            dli.data_ptr(), ptr(dc0), ptr(dn0), ptr(dm0), scratch.data_ptr(),
            ctypes.addressof(strides), b, s, h, d, qn, _DTYPE_CODE[q.dtype], stream,
        )
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"mlstm_scan_bwd kernel failed: CUDA error {err}: {msg}")
    _launches += 1
    _last_route = route
    return dq, dk, dv, dlf, dli, dstate
