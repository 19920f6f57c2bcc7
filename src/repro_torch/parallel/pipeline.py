"""GPipe-style pipeline parallelism over a mesh axis (the ``pod`` axis).

The port of ``repro/parallel/pipeline.py``.  Stage s holds the parameters
of layer-group s; microbatches stream through stages, moving between
neighbours with the instrumented ``ppermute`` (so the comm-region profiler
sees the pipeline traffic like any other pattern), and the last stage's
outputs reach every stage with the instrumented ``pbroadcast``.

SPMD formulation (runs inside ``compat.shard_map`` over the stage axis,
on meta tensors for a trace or on the ranks of a process group): at step
t, every stage applies its layer-group to its current microbatch, then
shifts activations one stage to the right.  With S stages and M
microbatches the schedule takes M + S - 1 steps; bubble fraction
(S-1)/(M+S-1).  This is the forward pipeline.
"""

from __future__ import annotations

import torch

from repro_torch.core import collectives as coll
from repro_torch.core import compat
from repro_torch.core.regions import comm_region


def pipeline_forward(stage_fn, n_stages: int, axis: str = "pod"):
    """Returns fn(stage_params, microbatches) for use inside shard_map.

    stage_fn(params, x) -> x      one stage's computation
    stage_params                  this stage's params (sharded over `axis`)
    microbatches (M, mb, ...)     the *stage-0* input stream (other stages
                                  ignore their copy; activations arrive via
                                  the pipeline shifts)
    Returns (M, mb, ...) outputs, valid on the last stage (replicated back
    via a broadcast from the last stage).
    """

    def run(stage_params, microbatches):
        sid = compat.axis_index(axis)
        M = microbatches.shape[0]
        steps = M + n_stages - 1
        cur = torch.zeros_like(microbatches[0])
        outs = torch.zeros_like(microbatches)
        shift = [(i, i + 1) for i in range(n_stages - 1)]

        for t in range(steps):
            # stage 0 ingests microbatch t (if any remain)
            injected = torch.where(sid == 0, microbatches[min(t, M - 1)], cur)
            active = (sid <= t) & (t - sid < M)
            y = stage_fn(stage_params, injected)
            y = torch.where(active, y, torch.zeros_like(y))
            # last stage banks its finished microbatch (index t-S+1)
            done_idx = t - (n_stages - 1)
            if done_idx >= 0:
                banked = outs.clone()
                banked[done_idx] = y
                outs = torch.where(sid == n_stages - 1, banked, outs)
            with comm_region("pipeline_shift"):
                cur = coll.ppermute(y, axis, shift)
        # replicate the last stage's output stream to every stage
        with comm_region("pipeline_collect"):
            outs = coll.pbroadcast(outs, axis, root=n_stages - 1)
        return outs

    return run


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


def run_pipeline(stage_fn, stage_params_stacked, microbatches, mesh,
                 axis: str = "pod"):
    """Drive pipeline_forward under shard_map over ``mesh`` (a
    ``compat.Mesh``): on meta tensors a trace, on real tensors this rank's
    stage of a process group of ``mesh.size`` ranks.

    stage_params_stacked: a tensor, or dict / tuple of them, each with a
    leading stage dim (n_stages, ...).  microbatches (M, mb, ...),
    replicated.  Returns the (M, mb, ...) outputs on every rank.
    """
    n_stages = mesh.shape[axis]

    def inner(params, mbs):
        params = _tree(lambda p: p[0], params)   # this stage's slice
        return pipeline_forward(stage_fn, n_stages, axis)(params, mbs)

    pspec = _tree(lambda _: compat.PartitionSpec(axis), stage_params_stacked)
    return compat.shard_map(
        inner, mesh=mesh, in_specs=(pspec, compat.PartitionSpec()),
        out_specs=compat.PartitionSpec())(stage_params_stacked, microbatches)
