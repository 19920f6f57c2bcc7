"""int8 error-feedback gradient compression (distributed-optimization trick).

The port of ``repro/optim/compress.py``.  For data-parallel all-reduce
traffic: quantize each gradient leaf to int8 with a scale shared by all
ranks, sum the payload (accumulated in int32, as the reference does),
dequantize, and carry the quantization error into the next step (error
feedback keeps the compression unbiased over time; Seide et al., 1-bit SGD
lineage).

The collectives are the port's instrumented ``pmax`` / ``psum`` inside
``compat.shard_map``, under a ``grad_allreduce`` communication region: a
meta trace records the profile the reference records, and real tensors
run over ``torch.distributed``.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.regions import comm_region


def compressed_psum(grads, err_state, axis_name):
    """Inside shard_map: all-reduce int8-quantized grads with error feedback.

    Returns (mean_grads, new_err_state).  ``err_state`` matches grads'
    structure (f32).  A *shared* scale (pmax of the per-shard absmax, one
    scalar collective) makes the summed int8 payload exactly dequantizable;
    the quantization residual is carried into the next step.
    """
    n = compat.axis_size(axis_name)

    def one(g, err):
        gf = g.to(torch.float32) + err
        with comm_region("grad_allreduce"):
            scale = coll.pmax(gf.abs().amax(), axis_name) / 127.0 + 1e-12
            q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            new_err = gf - q.to(torch.float32) * scale
            # int8 payload; overflow-safe accumulation in int32
            acc = coll.psum(q.to(torch.int32), axis_name)
        mean = acc.to(torch.float32) * scale / n
        return mean.to(g.dtype), new_err

    flat_g, spec = pytree.tree_flatten(grads)
    flat_e = pytree.tree_leaves(err_state)
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (pytree.tree_unflatten([o[0] for o in outs], spec),
            pytree.tree_unflatten([o[1] for o in outs], spec))


def init_error_state(grads_like):
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like)


def make_compressed_allreduce(mesh, dp_axes=("data",)):
    """shard_map wrapper: grads sharded arbitrarily, DP-replicated leaves
    averaged with int8 compression over the dp axes."""
    axis = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]

    def fn(grads, err):
        def inner(g, e):
            return compressed_psum(g, e, axis)

        spec = pytree.tree_map(lambda _: compat.PartitionSpec(), grads)
        espec = pytree.tree_map(lambda _: compat.PartitionSpec(), err)
        return compat.shard_map(
            inner, mesh=mesh, in_specs=(spec, espec), out_specs=(spec, espec)
        )(grads, err)

    return fn
