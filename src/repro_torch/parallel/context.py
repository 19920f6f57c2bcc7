"""Ambient (mesh, plan) context for activation sharding constraints.

The port of ``repro/parallel/context.py``.  Model code calls
``shard_act(x, ("batch", "seq", "embed"))`` at layer boundaries; when a
parallel context is installed (the launcher's mesh path) and ``x`` is a
DTensor, this redistributes ``x`` to the plan's placements on its device
mesh (DTensor inserts the collectives, as GSPMD inserts them for
``with_sharding_constraint``); otherwise it returns ``x`` unchanged
(single-device runs never see a mesh).

Tensors the models make from nothing (RoPE's angles, the loss's vocab
iota, a zero aux loss) are plain tensors; :func:`replicate` makes them
replicated DTensors on the context's mesh, so DTensor ops accept them.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Iterator, NamedTuple, Optional

#: process-wide, not thread-local (the reference's is): on the card the
#: autograd engine runs the backward, and so the recompute of a
#: checkpointed layer, on threads of its own, which must see the plan too
_CTX = SimpleNamespace(mesh=None, plan=None)


@contextlib.contextmanager
def parallel_context(mesh, plan) -> Iterator[None]:
    """Install ``mesh`` (a ``torch.distributed`` DeviceMesh) and ``plan`` (a
    :class:`~repro_torch.parallel.sharding.ShardingPlan`) for the block."""
    prev = (_CTX.mesh, _CTX.plan)
    _CTX.mesh, _CTX.plan = mesh, plan
    try:
        yield
    finally:
        _CTX.mesh, _CTX.plan = prev


def current_plan():
    return _CTX.plan


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_act(x, logical_axes: tuple):
    """Constrain an activation's sharding by logical axes (no-op without a
    context, or for a plain tensor)."""
    if _CTX.mesh is None or _CTX.plan is None or not _is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _CTX.plan.placements(x.device_mesh,
                                                              *logical_axes))


def _seq_split(x) -> bool:
    """Whether ``x`` is a DTensor split along dim 1, the sequence of a
    (batch, seq, ...) activation."""
    from torch.distributed.tensor import Shard

    return _is_dtensor(x) and any(isinstance(p, Shard) and p.dim == 1
                                  for p in x.placements)


def rows_product(x, w):
    """``x @ w`` for x (batch, seq, K); where x is a DTensor split along its
    sequence, each rank multiplies its own rows by the whole weight
    (:func:`rows_einsum`), as GSPMD does for rows split along the sequence:
    a DTensor cannot fold a split sequence dim into the batch, as
    ``matmul`` does."""
    if not _seq_split(x):
        return x @ w
    return rows_einsum("bsk,kd->bsd", x, w)[0]


def rows_einsum(eq: str, x, *ws) -> tuple:
    """``torch.einsum(eq, x, w)`` for each ``w``; where ``x`` is a DTensor,
    each rank multiplies its own rows of ``x`` (its shards, on any dim the
    output keeps) by the whole weights (gathered), as GSPMD multiplies rows
    it splits, and each product keeps x's placements on the dims it keeps.
    A weight's gradient is a partial sum over every mesh dim that splits the
    rows, reduced as the gather's backward returns it to the weight's
    placements.  So a product that makes (heads x head_dim) never splits
    that flattened dim, which DTensor could not unflatten into heads that do
    not divide the mesh axis; nor does it fold a split sequence into the
    batch, which a DTensor cannot."""
    import torch

    if not _is_dtensor(x):
        return tuple(torch.einsum(eq, x, w) for w in ws)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lhs, out = eq.replace(" ", "").split("->")
    xs = lhs.split(",")[0]
    mesh = x.device_mesh
    rows = list(x.placements)
    if any(p.is_partial() or (p.is_shard() and xs[p.dim] not in out) for p in rows):
        raise ValueError(f"{eq}: x {x.placements} is split on a contracted dim")
    prod = [Shard(out.index(xs[p.dim])) if p.is_shard() else Replicate() for p in rows]
    whole = [Replicate()] * mesh.ndim
    w_grad = [Partial() if p.is_shard() else Replicate() for p in rows]
    return local_map(lambda x, *ws: tuple(torch.einsum(eq, x, w) for w in ws),
                     out_placements=tuple(prod for _ in ws),
                     in_placements=(rows, *(whole for _ in ws)),
                     in_grad_placements=(rows, *(w_grad for _ in ws)),
                     device_mesh=mesh, redistribute_inputs=True)(x, *ws)


def sliced_einsum(eq: str, x, *ws) -> tuple:
    """``torch.einsum(eq, x, w)`` for each ``w`` whose first dim is
    contracted with x's last, as GSPMD places decode's projections where
    :func:`contraction_slices` holds: each ``model`` rank contracts its
    slice of that dim (x's own columns, whole there, and the weight's
    matching rows, brought from the FSDP split) on x's rows, and the
    partial sums are all-reduced over ``model``.  Each product keeps x's
    placements on the dims it keeps."""
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lhs, out = eq.replace(" ", "").split("->")
    xs = lhs.split(",")[0]
    mesh = x.device_mesh
    m = tuple(mesh.mesh_dim_names).index("model")
    if not x.placements[m].is_replicate():
        raise ValueError(f"{eq}: x {x.placements} is not whole on 'model'")
    rows = list(x.placements)
    cols = rows[:m] + [Shard(x.ndim - 1)] + rows[m + 1:]
    w_in = [Replicate()] * mesh.ndim
    w_in[m] = Shard(0)
    prod = [Shard(out.index(xs[p.dim])) if p.is_shard() else Replicate() for p in rows]
    partial = prod[:m] + [Partial()] + prod[m + 1:]
    w_grad = [Partial() if p.is_shard() else Replicate() for p in rows]
    w_grad[m] = Shard(0)
    parts = local_map(lambda x, *ws: tuple(torch.einsum(eq, x, w) for w in ws),
                      out_placements=tuple(partial for _ in ws),
                      in_placements=(cols, *(w_in for _ in ws)),
                      in_grad_placements=(cols, *(w_grad for _ in ws)),
                      device_mesh=mesh, redistribute_inputs=True)(x, *ws)
    return tuple(t.redistribute(mesh, prod) for t in parts)


def local_offset(x, dim: int, placements=None) -> int:
    """The global index of this rank's first element of DTensor ``x`` along
    ``dim`` (0 where ``dim`` is whole), as ``x`` is placed or, given
    ``placements``, would be: the row offset of a split sequence, from this
    rank's coordinates on the mesh."""
    mesh = x.device_mesh
    coordinate = mesh.get_coordinate()
    size, offset = x.shape[dim], 0
    # mesh dims split a tensor dim in their order, each into torch.chunk's
    # pieces (ceil-sized, the last ones short or empty), as DTensor does
    for i, p in enumerate(x.placements if placements is None else placements):
        if p.is_shard() and p.dim == dim:
            piece = -(-size // mesh.size(i))
            start = min(coordinate[i] * piece, size)
            offset += start
            size = min(piece, size - start)
    return offset


def split_dims(x, dim: int) -> list:
    """The mesh dims that split DTensor ``x`` along ``dim``."""
    return [i for i, p in enumerate(x.placements) if p.is_shard() and p.dim == dim]


def write_row(local, new, i: int, dim: int) -> None:
    """Row ``i`` along ``dim`` of a rank's slice ``local`` set to ``new``
    (of size 1 there), in place, where ``0 <= i < local.shape[dim]``; every
    rank runs the same ops (a select into its slice's nearest row), as
    GSPMD's update of a split dim does, so each rank's program is the
    same."""
    import torch

    n = local.shape[dim]
    if n == 0:
        return
    row = local.narrow(dim, min(max(i, 0), n - 1), 1)
    mine = torch.full((), 0 <= i < n, dtype=torch.bool, device=local.device)
    row.copy_(torch.where(mine, new.to(local.dtype), row))


def write_rows(x, new, pos: int, dim: int) -> None:
    """DTensor ``x`` at index ``pos`` along ``dim`` set to ``new`` (of size
    1 there), in place: a DTensor split along ``dim`` is written by the rank
    whose slice holds ``pos`` (:func:`write_row`), with no collective."""
    from torch.distributed.tensor import Replicate

    new = new.redistribute(x.device_mesh, [
        Replicate() if p.is_shard() and p.dim == dim else p for p in x.placements])
    write_row(x.to_local(), new.to_local(), pos - local_offset(x, dim), dim)


def _ranks(names) -> int:
    """The ranks of the context's mesh over mesh axes ``names`` (an axis
    name, a tuple of them, or None); axes the mesh lacks count 1."""
    names = (names,) if isinstance(names, str) else tuple(names or ())
    dims = tuple(_CTX.mesh.mesh_dim_names or ())
    n = 1
    for a in names:
        n *= _CTX.mesh.size(dims.index(a)) if a in dims else 1
    return n


def splits_evenly(size: int, logical: str) -> bool:
    """Whether a dim of ``size`` splits evenly over the mesh axes the plan
    gives ``logical`` (always, without a context).  GSPMD pads an uneven
    split; a DTensor's cannot be reshaped, so a caller replicates such a
    dim instead (each device then holds what GSPMD's padded shard holds at
    most)."""
    if _CTX.mesh is None or _CTX.plan is None:
        return True
    return size % _ranks(_CTX.plan.get(logical)) == 0


class Placement(NamedTuple):
    """How attention's heads and caches lie on the context's mesh
    (:func:`attention_placement`).

    ``heads``: ``"plan"`` where the plan's placements serve as they are (no
    context; the query and KV heads split alike; or the heads off the mesh
    with the sequence whole and a model axis they divide, as the
    launcher's plan keeps them); ``"rows"`` where the query heads are kept
    off a model axis of more than one rank that they do not divide, or off
    a split sequence: the projections then run on each rank's own rows
    with the heads whole (:func:`rows_einsum`), and attention takes the
    rank's query rows (or, in decode, its cache slice); ``"kv_rows"``
    where the query heads are split and the KV heads, which do not divide
    the axis, are not: the K/V projections run on the rank's rows, and
    each rank attends with its query heads over all the KV heads.

    ``cache_slices``: the plan splits the decode caches' sequence over more
    than one rank (``kv_seq``): each rank writes and attends over its own
    slice, and the slices merge by their log-sum-exp."""

    heads: str
    cache_slices: bool


def attention_placement(n_heads: int) -> Placement:
    """The :class:`Placement` of attention with ``n_heads`` query heads,
    from the context's plan and mesh.  GSPMD pads a split that does not
    divide; DTensor splits the flattened (heads x head_dim) output of a
    projection over the model axis and cannot unflatten it, so such heads
    are kept whole, as ``repro``'s plan keeps them."""
    plan = _CTX.plan
    if _CTX.mesh is None or plan is None:
        return Placement("plan", False)
    slices = _ranks(plan.get("kv_seq")) > 1
    if plan.get("heads") is None:
        uneven = n_heads % _ranks("model") != 0
        return Placement("rows" if uneven or _ranks(plan.get("seq")) > 1 else "plan",
                         slices)
    return Placement("kv_rows" if plan.get("kv_heads") != plan.get("heads") else "plan",
                     slices)


def contraction_slices(decode: bool) -> bool:
    """Whether decode's q/k/v projections whose heads are kept whole
    (:func:`attention_placement`) contract each ``model`` rank's slice of
    ``d_model`` (:func:`sliced_einsum`), as GSPMD places them: where the
    plan splits the weights' ``embed`` (FSDP) over F > 1 ranks that divide
    the ``model`` axis's M > 1, so that each model slice of ``d_model``
    lies within one FSDP slice (GSPMD moves it there by a permute) and the
    activation's ``d_model`` is whole on ``model``.  Otherwise the weights
    are gathered (:func:`rows_einsum`): without a context, in train and
    prefill (the sequence split over ``model``), on a model axis of one
    rank, without FSDP, and where F does not divide M (2 x 16 x 16's F of
    32 against M of 16)."""
    if not decode or _CTX.mesh is None or _CTX.plan is None or seq_rows():
        return False
    f, m = _ranks(_CTX.plan.get("embed")), _ranks("model")
    return f > 1 and m > 1 and m % f == 0


def seq_rows() -> bool:
    """Whether the plan splits the sequence over more than one rank (train
    and prefill under ``repro``'s default plan): the recurrent blocks and
    MLA then run their products on each rank's own rows, as GSPMD places
    them (:func:`rows_einsum`).  False without a context, in decode (the
    plan's ``seq`` is None there) and on a model axis of one rank."""
    if _CTX.mesh is None or _CTX.plan is None:
        return False
    return _ranks(_CTX.plan.get("seq")) > 1


def split_over(size: int, logical: str) -> bool:
    """Whether the plan splits a dim of ``size`` over more than one rank by
    ``logical``'s rule, evenly: the SSD scan's heads (``mlp``) and the
    mLSTM's value dim (``mlp``) are then split over it.  False without a
    context and on mesh axes of one rank."""
    if _CTX.mesh is None or _CTX.plan is None:
        return False
    n = _ranks(_CTX.plan.get(logical))
    return n > 1 and size % n == 0


class GroupTiles(NamedTuple):
    """The part of the MoE's dispatch and combine a rank computes
    (:func:`moe_tiles`), as GSPMD partitions them for ``repro``'s plan.

    ``dispatch``: (first group, groups) of the rank's local groups whose
    dispatch it computes, over their whole tokens; ``lead``: whether its
    product is the one that counts where several ranks compute the same
    groups (the others add zeros).  ``rows``: (first group, groups, first
    token, tokens) of the combine, and of the dispatch's and the combine's
    backward; ``own``: for each group of ``rows``, whether its tokens there
    are this rank's own rows of the residual stream (each token's output
    and gradients come from its owner alone).  ``dims``: the mesh dims that
    split those rows, over which the results are partial sums."""

    dispatch: tuple
    lead: bool
    rows: tuple
    own: tuple
    dims: tuple


def moe_tiles(x, xg) -> Optional[GroupTiles]:
    """Where each rank's share of the MoE layer lies, for the residual
    stream ``x`` (B,S,D) cut into groups ``xg`` (G,T,D) (both DTensors),
    as GSPMD gives it to a device; None where the plain products serve (no
    context, a plain tensor, groups that do not tile the rows).

    Train and prefill (the sequence split over a model axis of M ranks, R
    rows a rank): a group of T tokens spans M_T = T / R ranks.  The
    combine and the backward take each group's R tokens at the rank's
    offset; the dispatch takes whole groups: with one sequence a data rank,
    only the rank's own group (its M_T ranks compute the same one), else
    all of the rank's groups, and the combine all of them too (the groups'
    order puts the batch outside the sequence, so GSPMD cannot split them
    by the sequence; it repeats the work on M / M_T ranks).  Decode (one
    group held whole): the combine takes the rank's own batch rows."""
    if _CTX.mesh is None or _CTX.plan is None or not _is_dtensor(xg):
        return None
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    G, T = xg.shape[0], xg.shape[1]
    B, S = x.shape[0], x.shape[1]
    if G * T != B * S:
        return None
    coord = mesh.get_coordinate()
    if seq_rows():
        axis = _CTX.plan.get("seq")
        if not isinstance(axis, str) or split_dims(xg, 1):
            return None
        dim = names.index(axis)
        M, r = mesh.size(dim), coord[dim]
        if S % M or T % (S // M) or S % T:
            return None
        R = S // M
        MT = T // R
        groups_local = xg.to_local().shape[0]
        j = r // MT  # the rank's group within a sequence
        rows_t = ((r % MT) * R, R)
        if groups_local == S // T:  # one sequence a rank: its own group
            return GroupTiles((j, 1), r % MT == 0, (j, 1, *rows_t), (True,), (dim,))
        own = tuple(g % (S // T) == j for g in range(groups_local))
        return GroupTiles((0, groups_local), True, (0, groups_local, *rows_t), own, (dim,))
    if G != 1 or split_dims(xg, 0) or split_dims(xg, 1):
        return None
    dims = tuple(split_dims(x, 0))
    if not dims:
        return None
    b0, bl = local_offset(x, 0), x.to_local().shape[0]
    return GroupTiles((0, 1), True, (0, 1, b0 * S, bl * S), (True,), dims)


def value_split(n_heads: int, value_dim: int) -> bool:
    """Whether the mLSTM's decode state splits its value dim (``value_dim``
    columns) over the plan's ``mlp`` axes, as GSPMD splits the state's
    work: where the heads are kept whole (:func:`attention_placement`) and
    those axes, of more than one rank, divide the value dim."""
    return (split_over(value_dim, "mlp")
            and attention_placement(n_heads).heads == "rows")


def scan_rows(seq_len: int, chunk: int) -> Optional[int]:
    """The rows of each chunk a rank computes in a chunked scan (the
    mLSTM's) of ``seq_len`` rows in chunks of ``chunk``, where the plan
    splits the sequence over more ranks than it has chunks: GSPMD then
    splits each chunk's rows over the ranks that hold them and runs every
    chunk on every rank (``repro``'s products of 64 of a chunk's 128 rows
    at 1024 rows over 16).  None where each rank holds whole chunks (GSPMD
    gathers them for the scan's loop, which runs whole on every rank), in
    decode, without a context and on a model axis of one rank."""
    if not seq_rows():
        return None
    ranks = _ranks(_CTX.plan.get("seq"))
    q = min(chunk, seq_len)
    if seq_len % ranks or seq_len % q:
        return None
    rows = seq_len // ranks
    return rows if rows < q and q % rows == 0 else None


def replicate(x):
    """``x`` as a DTensor replicated over the context's mesh, when a context
    is installed and ``x`` is a plain tensor; otherwise ``x``.  Every rank
    holds the same value, so this moves no bytes."""
    if _CTX.mesh is None or x is None or _is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _CTX.mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def table_split(table) -> bool:
    """Whether ``table`` is a DTensor split over more than one rank, with a
    context installed: :func:`embedding` then looks tokens up in each
    rank's own shard."""
    return (_CTX.mesh is not None and _CTX.plan is not None and _is_dtensor(table)
            and any(p.is_shard() and table.device_mesh.size(i) > 1
                    for i, p in enumerate(table.placements)))


def embedding(table, tokens, logical_axes: tuple):
    """``table[tokens]`` for a (vocab, d) table split as the plan splits it
    (:func:`table_split`), placed by ``logical_axes``, as GSPMD partitions
    the lookup: the tokens, not the table, are gathered over the mesh dims
    that split the table; each rank takes the rows of its own vocab shard
    (zeros for tokens outside it) at its own columns; the partial sums
    over the vocab's mesh dims are reduced, and columns split over FSDP
    dims are turned into rows by one all-to-all a mesh dim.  Tokens lie in
    one vocab shard each, so every reduction adds one row to zeros and the
    result equals the gathered table's lookup bit for bit.  The table's
    gradient is each rank's scatter-add into its own rows: placed as the
    table is, partial only over mesh dims that split the tokens' rows and
    not the table."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not _is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    n = tokens.ndim
    split = table.placements
    ids_in = [Replicate() if p.is_shard() else q for p, q in zip(split, tokens.placements)]
    found = [(Partial() if p.dim == 0 else Shard(n)) if p.is_shard() else q
             for p, q in zip(split, ids_in)]
    grad = [p if p.is_shard() else Partial() if q.is_shard() else Replicate()
            for p, q in zip(split, ids_in)]
    first = local_offset(table, 0)

    def lookup(t, ids):
        if t.shape[0] == 0:  # a shard past the vocab's end
            return t.new_zeros((*ids.shape, t.shape[1]))
        ids = ids.long() - first
        mine = (ids >= 0) & (ids < t.shape[0])
        rows = F.embedding(ids.clamp(0, t.shape[0] - 1), t)
        return rows.masked_fill(~mine.unsqueeze(-1), 0)

    x = local_map(lookup, out_placements=found, in_placements=(split, ids_in),
                  in_grad_placements=(grad, ids_in), device_mesh=mesh,
                  redistribute_inputs=True)(table, tokens)
    target = _CTX.plan.placements(mesh, *logical_axes)
    cols = [i for i, p in enumerate(found) if p.is_shard() and p.dim == n]
    if cols:
        # the vocab's partial sums first, the columns kept split
        x = x.redistribute(mesh, [p if i in cols else target[i]
                                  for i, p in enumerate(found)])
        if (all(target[i] == Shard(0) for i in cols)
                and not any(p == Shard(0) for p in x.placements)
                and x.shape[0] % math.prod(mesh.size(i) for i in cols) == 0):
            x = _cols_to_rows(x, cols)
    return x.redistribute(mesh, target)


def _cols_to_rows(x, dims: list):
    """DTensor ``x`` with its last dim split over mesh dims ``dims`` (in
    mesh order) and its first whole there, split instead along its first
    dim over them: one all-to-all a mesh dim, the major one first (DTensor's
    own redistribution gathers on a CPU mesh)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    sizes = [mesh.size(i) for i in dims]
    groups = [mesh.get_group(i) for i in dims]

    def swap(t):
        for n, group in zip(sizes, groups):
            # rows block j goes to rank j; what comes back from rank j is
            # this rank's rows at rank j's columns, laid out after the
            # columns already held
            t = funcol.wait_tensor(funcol.all_to_all_single_autograd(
                t.contiguous(), None, None, group))
            t = t.reshape(n, t.shape[0] // n, *t.shape[1:]).movedim(0, -2).flatten(-2)
        if len(sizes) > 1:
            # the last dim's sources lead; the mesh's order has the first lead
            k = len(sizes)
            t = t.reshape(*t.shape[:-1], *reversed(sizes), t.shape[-1] // math.prod(sizes))
            lead = t.ndim - k - 1
            t = t.permute(*range(lead), *reversed(range(lead, lead + k)), t.ndim - 1)
            t = t.flatten(lead)
        return t

    rows = [Shard(0) if i in dims else p for i, p in enumerate(x.placements)]
    return local_map(swap, out_placements=rows, in_placements=(list(x.placements),),
                     device_mesh=mesh)(x)


def zero_pad(x, pad: tuple):
    """``F.pad(x, pad)`` with zeros; a DTensor is padded shard by shard, its
    placements kept, after it is gathered along any padded dim that is
    split (torch 2.11's DTensor rule for ``pad`` fails on a 2-D mesh)."""
    import torch.nn.functional as F

    if not _is_dtensor(x):
        return F.pad(x, pad)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    padded = {x.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
    if any(p.is_shard() and p.dim in padded for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_shard() and p.dim in padded else p
            for p in x.placements])
    placements = list(x.placements)
    return local_map(lambda t: F.pad(t, pad), out_placements=placements,
                     in_placements=(placements,), device_mesh=x.device_mesh)(x)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` runs on the
    local shards (a partial sum made whole first), for an op DTensor has
    no sharding rule for (``F.logsigmoid``'s backward)."""
    if not _is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    placements = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(fn, out_placements=placements, in_placements=(placements,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)
