"""Public wrappers for the model kernels, as the models call them.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, or the call raises.  Inside :func:`plain`, CUDA
tensors go to the plain versions too: tests and ``chip_smoke.py`` use it to
hold the model with kernels against the same model without them on the
card, and the dry run (``launch/dryrun.py``) to capture the plain math.
Nothing on the serving or training path enters it.

Gradients: each forward kernel on a CUDA input that needs one runs through
a ``torch.autograd.Function`` whose backward is a hand-written backward
kernel: :class:`FlashAttention` (its forward also stores each query row's
log-sum-exp, which :mod:`repro_torch.kernels.flash_attention_bwd` reads),
:class:`SSDScan` (:mod:`repro_torch.kernels.ssd_scan_bwd`) and
:class:`MLSTMScan` (:mod:`repro_torch.kernels.mlstm_scan_bwd`).  CPU tensors
take the plain versions, which autograd differentiates; the Functions also
run on CPU tensors (their backward then takes the plain backward), which is
how the CPU tests hold them to that autograd.

Under a device mesh the kernels take DTensors (:func:`_on_shards`): a
custom op has no DTensor sharding rule, so each call redistributes its
inputs to the placements the kernel can take (batch on the plan's data
axes, attention heads on ``model`` where the plan shards both query and
KV heads there, sequence and head dims whole; DTensor inserts the
all-gathers GSPMD would), then runs the same wrapper on this rank's local
shards through ``local_map``: the kernel on the card (with no plain
fallback), the plain version on the CPU.  Where the plan keeps the query
heads off the mesh, attention is split as ``repro``'s plan splits it:
each rank's query rows of a split sequence against the whole K/V
(:func:`flash_attention_rows`), and in decode each rank's slice of a
cache split along its sequence, the slices merged by their log-sum-exp
(:func:`decode_attention_slice`, :func:`merge_slices`); where it splits
the query heads but not the KV heads, each rank's query heads against
all the KV heads (:func:`flash_attention_heads`).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import mlstm_scan as _mlstm
from repro_torch.kernels import mlstm_scan_bwd as _mlstm_bwd
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssd_bwd

_plain_depth = 0


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _on_shards(fn, args: tuple, logical: tuple, out_logical):
    """``fn(*local shards)`` for DTensor ``args``: each redistributed to
    the placements of its entry of ``logical`` (a tuple of logical axes, or
    None for an argument that is None) under the current plan, the result
    placed by ``out_logical`` (one tuple, or a tuple of them for several
    outputs)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.context import current_plan

    plan = current_plan()
    if plan is None:
        raise ValueError("a DTensor reached a kernel outside parallel_context: "
                         "the plan says where its shards go")
    mesh = next(a for a in args if a is not None).device_mesh

    def placed(axes):  # a list: local_map reads a tuple as one entry an output
        return None if axes is None else list(plan.placements(mesh, *axes))

    out = (placed(out_logical) if isinstance(out_logical[0], (str, type(None)))
           else tuple(placed(o) for o in out_logical))
    return local_map(fn, out_placements=out,
                     in_placements=tuple(placed(a) for a in logical),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _attn_axes() -> tuple:
    """(q's, k/v's) logical axes at the attention kernels: heads sharded only
    where the plan puts query and KV heads on the same mesh axes (so each
    rank's query heads read its own KV heads)."""
    from repro_torch.parallel.context import current_plan

    plan = current_plan()
    same = plan is not None and plan.get("heads") == plan.get("kv_heads")
    heads, kv = ("heads", "kv_heads") if same else (None, None)
    return ("batch", heads, None, None), ("batch", kv, None, None)


@contextlib.contextmanager
def plain() -> Iterator[None]:
    """Route CUDA tensors to the plain versions for the duration."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def _needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these CUDA tensors."""
    return (
        torch.is_grad_enabled()
        and tensors[0].device.type == "cuda"
        and any(t is not None and t.requires_grad for t in tensors)
    )


class FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _flash.flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd.flash_attention_bwd(
            q, k, v, out, dout, causal=ctx.causal, lse=lse
        )
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B,Hq,Sq,D); k/v (B,Hkv,Sk,D) -> (B,Hq,Sq,D); see the kernel module.

    Where the query heads are kept whole and the sequence is split, causal
    self-attention is sequence-parallel (:func:`_flash_rows`); where the KV
    heads alone are whole, each rank attends with its query heads
    (:func:`_flash_heads`)."""
    if _is_dtensor(q):
        from repro_torch.parallel.context import attention_placement, split_dims

        heads = attention_placement(q.shape[1]).heads
        if heads == "rows" and causal and split_dims(q, 2) and q.shape[2] == k.shape[2]:
            return _flash_rows(q, k, v)
        if heads == "kv_rows":
            return _flash_heads(q, k, v, causal)
        qa, kva = _attn_axes()
        return _on_shards(lambda q, k, v: flash_attention(q, k, v, causal=causal),
                          (q, k, v), (qa, kva, kva), qa)
    if _plain_depth:
        return _flash.flash_attention_plain(q, k, v, causal=causal)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _flash.flash_attention(q, k, v, causal=causal)


def flash_attention_rows(q, k, v, offset: int) -> torch.Tensor:
    """Causal attention of query rows q (B,Hq,Sq,D) that sit at positions
    ``[offset, offset + Sq)`` of k/v (B,Hkv,Sk,D): a rank's rows of a split
    sequence against the whole keys.  On the card the flash kernel (and its
    backward) runs over k/v cut to ``[0, offset + Sq)``, where the queries
    sit at the end of the keys; the plain version scores the whole of k,
    masked, as GSPMD does."""
    if q.device.type == "cpu" or _plain_depth:
        return _flash.flash_attention_rows_plain(q, k, v, offset)
    end = offset + q.shape[2]
    return flash_attention(q, k[:, :, :end], v[:, :, :end], causal=True)


def _flash_rows(q, k, v):
    """Sequence-parallel causal self-attention of DTensors: each rank scores
    its own query rows (the sequence split as the plan splits it), all heads,
    against the whole K/V (gathered), from its first row's position, the
    rank's offset along the sequence.  K/V's gradients are partial sums over
    the mesh dims that split the rows."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.context import current_plan, local_offset

    plan = current_plan()
    mesh = q.device_mesh
    rows = list(plan.placements(mesh, "batch", None, "seq", None))
    whole = list(plan.placements(mesh, "batch", None, None, None))
    kv_grad = [Partial() if r.is_shard() and r.dim == 2 else w
               for r, w in zip(rows, whole)]
    offset = local_offset(q, 2, rows)
    return local_map(flash_attention_rows, out_placements=rows,
                     in_placements=(rows, whole, whole, None),
                     in_grad_placements=(rows, kv_grad, kv_grad, None),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v, offset)


def flash_attention_heads(q, k, v, first: int, n_heads: int, *,
                          causal: bool = True) -> torch.Tensor:
    """Attention of a rank's query heads ``[first, first + Hq)`` of
    ``n_heads`` (q (B,Hq,Sq,D)) over all the KV heads k/v (B,Hkv,Sk,D):
    each query head reads the KV head it groups to, a slice of k/v where the
    rank's heads group evenly, else the KV heads picked one a query head."""
    group = n_heads // k.shape[1]
    kv = [(first + j) // group for j in range(q.shape[1])]
    lo, n_kv = kv[0], kv[-1] + 1 - kv[0]
    per = q.shape[1] // n_kv
    if per * n_kv == q.shape[1] and all(h - lo == j // per for j, h in enumerate(kv)):
        k, v = k[:, lo:lo + n_kv], v[:, lo:lo + n_kv]
    else:
        index = torch.tensor(kv, device=k.device)
        k, v = k.index_select(1, index), v.index_select(1, index)
    return flash_attention(q, k, v, causal=causal)


def _flash_heads(q, k, v, causal: bool):
    """Attention of DTensors where the plan splits the query heads but not
    the KV heads (they do not divide the mesh axis): each rank attends with
    its own query heads over all the KV heads (gathered), the sequence
    whole; K/V's gradients are partial sums over the mesh dims that split
    the heads."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.context import current_plan, local_offset

    plan = current_plan()
    mesh = q.device_mesh
    heads = list(plan.placements(mesh, "batch", "heads", None, None))
    whole = list(plan.placements(mesh, "batch", None, None, None))
    kv_grad = [Partial() if h.is_shard() and h.dim == 1 else w
               for h, w in zip(heads, whole)]
    first, n_heads = local_offset(q, 1, heads), q.shape[1]
    return local_map(
        lambda q, k, v: flash_attention_heads(q, k, v, first, n_heads, causal=causal),
        out_placements=heads, in_placements=(heads, whole, whole),
        in_grad_placements=(heads, kv_grad, kv_grad),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def decode_attention(q, k, v, kv_len: int) -> torch.Tensor:
    """q (B,Hq,1,D) over keys [0, kv_len) of k/v (B,Hkv,S,D) -> (B,Hq,1,D).

    A cache split along its sequence is attended slice by slice and the
    slices merged (:func:`_decode_merged`)."""
    if _is_dtensor(q):
        from repro_torch.parallel.context import split_dims

        if split_dims(k, 2):
            return _decode_merged(q, k, v, kv_len)
        qa, kva = _attn_axes()
        return _on_shards(lambda q, k, v: decode_attention(q, k, v, kv_len),
                          (q, k, v), (qa, kva, kva), qa)
    if _plain_depth:
        return _decode.decode_attention_plain(q, k, v, kv_len)
    return _decode.decode_attention(q, k, v, kv_len)


def decode_attention_slice(q, k, v, kv_len: int) -> tuple:
    """(out, lse) of q over keys ``[0, kv_len)`` of one slice of a cache,
    ``kv_len`` clamped to the slice: a slice wholly past the filled keys
    gives out 0 and lse -inf, and launches nothing."""
    kv_len = min(max(int(kv_len), 0), k.shape[2])
    if kv_len == 0:
        return (torch.zeros_like(q),
                torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                           device=q.device))
    if _plain_depth:
        return _decode.decode_attention_plain(q, k, v, kv_len, return_lse=True)
    return _decode.decode_attention(q, k, v, kv_len, return_lse=True)


def merge_slices(out, lse, groups) -> torch.Tensor:
    """The attention over a whole cache from each rank's ``(out, lse)`` over
    its slice (``out`` (B,H,1,D), ``lse`` (B,H,1)): weights
    ``exp(lse - max lse)``, by two all-reduces over ``groups`` (the process
    groups of the mesh dims that split the cache), the max of lse and the
    sum of the weighted outputs beside the weights."""
    import torch.distributed._functional_collectives as funcol

    m = lse
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    w = torch.exp(lse - m)[..., None]
    acc = torch.cat([out.float() * w, w], dim=-1)
    for g in groups:
        acc = funcol.all_reduce(acc, "sum", g)
    return (acc[..., :-1] / acc[..., -1:]).to(out.dtype)


def _decode_merged(q, k, v, kv_len: int):
    """Decode attention over a cache k/v split along its sequence: each rank
    attends over its own slice, keys before ``kv_len`` (its slice's offset
    off), with all query heads, and the slices merge by their log-sum-exp
    (:func:`merge_slices`) in place of gathering the cache."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.context import current_plan, local_offset, split_dims

    plan = current_plan()
    mesh = k.device_mesh
    qp = list(plan.placements(mesh, "batch", None, None, None))
    kvp = list(k.placements)
    groups = [mesh.get_group(d) for d in split_dims(k, 2)]
    start = local_offset(k, 2)

    def local(q, k, v):
        out, lse = decode_attention_slice(q, k, v, kv_len - start)
        return merge_slices(out, lse, groups)

    return local_map(local, out_placements=qp, in_placements=(qp, kvp, kvp),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


class SSDScan(torch.autograd.Function):
    """The SSD forward kernel, with the SSD backward kernel as its gradient.

    Saves the inputs only: the backward recomputes the chunk states.  An
    output nobody differentiates (``h_final`` in training) comes back as
    None and costs nothing.
    """

    @staticmethod
    def forward(ctx, xh, la, Bm, Cm, h0, block_q: int):
        ctx.set_materialize_grads(False)
        y, h_final = _ssd.ssd_scan(xh, la, Bm, Cm, h0, block_q=block_q)
        ctx.save_for_backward(xh, la, Bm, Cm, h0)
        ctx.block_q = block_q
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        xh, la, Bm, Cm, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xh)
        dxh, dla, dBm, dCm, dh0 = _ssd_bwd.ssd_scan_bwd(
            xh, la, Bm, Cm, h0, dy, dh_final, block_q=ctx.block_q
        )
        return dxh, dla, dBm, dCm, dh0, None


class MLSTMScan(torch.autograd.Function):
    """The mLSTM forward kernel, with the mLSTM backward kernel as its
    gradient.  Saves the inputs only: the backward recomputes the states
    entering each chunk.  ``state`` is passed as its three tensors (or three
    Nones)."""

    @staticmethod
    def forward(ctx, q, k, v, lf, li, C0, n0, m0, block_q: int):
        ctx.set_materialize_grads(False)
        state = None if C0 is None else (C0, n0, m0)
        h, (C, n, m) = _mlstm.mlstm_scan(q, k, v, lf, li, state, block_q=block_q)
        ctx.save_for_backward(q, k, v, lf, li, C0, n0, m0)
        ctx.block_q = block_q
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, lf, li, C0, n0, m0 = ctx.saved_tensors
        state = None if C0 is None else (C0, n0, m0)
        if dh is None:
            dh = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dq, dk, dv, dlf, dli, dstate = _mlstm_bwd.mlstm_scan_bwd(
            q, k, v, lf, li, state, dh, dC, dn, dm, block_q=ctx.block_q
        )
        dstate = (None, None, None) if dstate is None else dstate
        return dq, dk, dv, dlf, dli, *dstate, None


def ssd_scan(xh, la, Bm, Cm, h0=None, *, block_q: int = 128) -> tuple:
    """xh (B,S,H,P), la (B,S,H), Bm/Cm (B,S,N) -> (y, h_final (B,H,P,N) f32).

    Under a mesh the scan's inputs are split by batch, and by heads where
    the plan splits them (:func:`_ssd_heads`)."""
    if _is_dtensor(xh):
        from repro_torch.parallel.context import split_over

        if split_over(xh.shape[2], "mlp"):
            return _ssd_heads(xh, la, Bm, Cm, h0, block_q)
        b4, b3 = ("batch", None, None, None), ("batch", None, None)
        return _on_shards(lambda *a: ssd_scan(*a, block_q=block_q),
                          (xh, la, Bm, Cm, h0),
                          (b4, b3, b3, b3, None if h0 is None else b4), (b4, b4))
    if _plain_depth:
        return _ssd.ssd_scan_plain(xh, la, Bm, Cm, h0, block_q=block_q)
    if _needs_grad(xh, la, Bm, Cm, h0):
        return SSDScan.apply(xh, la, Bm, Cm, h0, block_q)
    return _ssd.ssd_scan(xh, la, Bm, Cm, h0, block_q=block_q)


def _grad_partial(split, whole) -> list:
    """``whole``'s placements, Partial on the mesh dims where ``split`` is
    split and ``whole`` is not: the gradient of an input that every rank
    reads whole while another input's dim is split, each rank's part of
    the sum."""
    from torch.distributed.tensor import Partial

    return [Partial() if s.is_shard() and not w.is_shard() else w
            for s, w in zip(split, whole)]


def _ssd_heads(xh, la, Bm, Cm, h0, block_q: int) -> tuple:
    """The SSD scan of DTensors with its heads split over the mesh axes of
    the plan's ``mlp`` rule, as GSPMD splits them: each rank scans its own
    heads (xh's and la's dim 2, h0's and h_final's dim 1) over the whole
    sequence, Bm and Cm whole; their gradients are partial sums over the
    mesh dims that split the heads."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.context import current_plan

    plan = current_plan()
    mesh = xh.device_mesh
    x4 = list(plan.placements(mesh, "batch", None, "mlp", None))
    x3 = list(plan.placements(mesh, "batch", None, "mlp"))
    bc = list(plan.placements(mesh, "batch", None, None))
    st = list(plan.placements(mesh, "batch", "mlp", None, None))
    bc_grad = _grad_partial(x3, bc)
    h0p = None if h0 is None else st
    return local_map(lambda *a: ssd_scan(*a, block_q=block_q),
                     out_placements=(x4, st),
                     in_placements=(x4, x3, bc, bc, h0p),
                     in_grad_placements=(x4, x3, bc_grad, bc_grad, h0p),
                     device_mesh=mesh, redistribute_inputs=True)(xh, la, Bm, Cm, h0)


def mlstm_chunk_rows(q, k, v, lf, li, entering: tuple, rows: tuple, *,
                     block_q: int = 128) -> torch.Tensor:
    """h of rows ``[r0, r0 + nr)`` of every chunk of the sequence, each
    chunk entered from its own state ``entering`` (C (B, nc, H, D, D), n
    (B, nc, H, D), m (B, nc, H)) -> (B, nc, nr, H, D) f32.  The plain
    version scores those rows alone, against the keys up to them; on the
    card the mLSTM kernel scans each chunk's rows up to ``r0 + nr`` as a
    sequence of its own from the chunk's state, and keeps the last ``nr``."""
    if q.device.type == "cpu" or _plain_depth:
        return _mlstm.mlstm_chunk_rows_plain(q, k, v, lf, li, entering, rows, block_q=block_q)
    b, s, h, d = q.shape
    qn = min(block_q, s)
    r0, nr = rows

    def per_chunk(t):
        return t.reshape(b * (s // qn), qn, *t.shape[2:])[:, :r0 + nr]

    state = tuple(t.reshape(b * (s // qn), *t.shape[2:]).contiguous() for t in entering)
    out, _ = mlstm_scan(*(per_chunk(t) for t in (q, k, v, lf, li)), state, block_q=qn)
    return out[:, r0:].reshape(b, s // qn, nr, h, d)


def _mlstm_rows(q, k, v, lf, li, state, block_q: int, rows: int) -> tuple:
    """The mLSTM scan of DTensors where the plan splits the sequence over
    more ranks than it has chunks (``context.scan_rows``), placed as GSPMD
    places ``repro``'s chunked scan: each chunk's rows split over the ranks
    that hold them, ``rows`` a rank, and every chunk run on every rank.

    A rank whose own rows are the ``j``-th ``rows`` of their chunk works on
    the ``j``-th rows of every chunk, over the gathered sequence: (1) what
    they add to each chunk's end state, a partial sum over the ranks that
    split the sequence, taken from the first chunk's ranks alone (the
    others add nothing, over no rows); (2) the state entering each chunk,
    from those sums, on every rank; (3) their outputs, of which the rank
    keeps its own chunk's.  The inputs' gradients are partial sums over the
    mesh dims that split the sequence; the final state's gradient enters
    through the first rank alone."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.context import current_plan, local_offset

    plan = current_plan()
    mesh = q.device_mesh
    qn = min(block_q, q.shape[1])
    seq4 = list(plan.placements(mesh, "batch", "seq", None, None))
    row0 = local_offset(q, 1, seq4)
    own = (row0 % qn, rows)
    w5, w4, w3, w2 = (list(plan.placements(mesh, "batch", *(None,) * n)) for n in (4, 3, 2, 1))
    p5, p4, p3, p2 = (_grad_partial(seq4, w) for w in (w5, w4, w3, w2))

    def added(k, v, lf, li):
        return _mlstm.chunk_states_plain(k, v, lf, li, (own[0], rows if row0 < qn else 0),
                                         block_q=qn)

    dC, dn = local_map(added, out_placements=(p5, p4), in_placements=(w4, w4, w3, w3),
                       in_grad_placements=(p4, p4, p3, p3), device_mesh=mesh,
                       redistribute_inputs=True)(k, v, lf, li)

    def outputs(q, k, v, lf, li, dC, dn, C0, n0, m0):
        s0 = None if C0 is None else (C0, n0, m0)
        entering, final = _mlstm.pass_states(dC, dn, lf, li, s0, block_q=qn)
        h = mlstm_chunk_rows(q, k, v, lf, li, entering, own, block_q=qn)[:, row0 // qn]
        if row0:
            final = tuple(t.detach() for t in final)
        return (h, *final)

    st, st_grad = (None,) * 3, (None,) * 3
    if state is not None:
        st, st_grad = (w4, w3, w2), (p4, p3, p2)
    h, C, n, m = local_map(
        outputs, out_placements=(seq4, w4, w3, w2),
        in_placements=(w4, w4, w4, w3, w3, w5, w4, *st),
        in_grad_placements=(p4, p4, p4, p3, p3, p5, p4, *st_grad),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, lf, li, dC, dn,
                                                     *(state or (None,) * 3))
    return h, (C, n, m)


def mlstm_scan(q, k, v, lf, li, state=None, *, block_q: int = 128) -> tuple:
    """q/k/v (B,S,H,D), lf/li (B,S,H) -> (h (B,S,H,D) f32, (C, n, m) f32).

    Under a mesh the scan's inputs are split by batch only, but where the
    plan splits the sequence over more ranks than it has chunks
    (:func:`_mlstm_rows`)."""
    if _is_dtensor(q):
        from repro_torch.parallel.context import scan_rows

        rows = scan_rows(q.shape[1], block_q)
        if rows:
            return _mlstm_rows(q, k, v, lf, li, state, block_q, rows)
        b4, b3, b2 = ("batch", None, None, None), ("batch", None, None), ("batch", None)
        st = (b4, b3, b2) if state is not None else (None,) * 3

        def local(q, k, v, lf, li, C0, n0, m0):
            s0 = None if C0 is None else (C0, n0, m0)
            h, (C, n, m) = mlstm_scan(q, k, v, lf, li, s0, block_q=block_q)
            return h, C, n, m

        h, C, n, m = _on_shards(local, (q, k, v, lf, li, *(state or (None,) * 3)),
                                (b4, b4, b4, b3, b3, *st), (b4, b4, b3, b2))
        return h, (C, n, m)
    if _plain_depth:
        return _mlstm.mlstm_scan_plain(q, k, v, lf, li, state, block_q=block_q)
    if _needs_grad(q, k, v, lf, li, *(state or ())):
        h, C, n, m = MLSTMScan.apply(q, k, v, lf, li, *(state or (None,) * 3), block_q)
        return h, (C, n, m)
    return _mlstm.mlstm_scan(q, k, v, lf, li, state, block_q=block_q)


_KERNELS = {
    "flash_attention": _flash,
    "flash_attention_bwd": _flash_bwd,
    "decode_attention": _decode,
    "ssd_scan": _ssd,
    "ssd_scan_bwd": _ssd_bwd,
    "mlstm_scan": _mlstm,
    "mlstm_scan_bwd": _mlstm_bwd,
}


def launch_counts() -> dict:
    """Kernel launches of each model kernel since the last reset."""
    return {name: mod.launch_count() for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.reset_launch_count()
