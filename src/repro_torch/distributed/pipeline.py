"""Pipeline parallelism: GPipe-style microbatch schedule over a mesh axis.

The layer stack is split into S stages mapped onto a ``stage`` mesh axis;
microbatches flow stage to stage by ring shifts on that axis's process
group.  The schedule is the classic GPipe fill-drain loop of S + M - 1
ticks (S stages, M microbatches): at every tick each stage processes the
activation it holds and passes it to its successor, in one
``batch_isend_irecv`` (the reference's ``ppermute``).

The stage axis can be any mesh axis (the tests pipeline over a 4-way
axis; in a (pod, data, model) mesh the natural stage axis for very deep
models is ``pod``, giving DP x PP x TP).  This is the *forward* pipeline;
its point-to-point transfers carry no gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.distributed.sharding import full, is_dtensor


def _stage_params(leaf, stage: int):
    """This stage's row of a stacked leaf: a DTensor sharded over the
    stage axis holds it as its one local row; a whole tensor, at
    ``stage``."""
    if is_dtensor(leaf):
        return leaf.to_local()[0]
    return leaf[stage]


def pipeline_forward(mesh, stage_axis: str, stage_fn, params_stacked,
                     x_microbatches):
    """Run x through S pipeline stages with M microbatches.

    stage_fn(stage_params, x) -> x   (same shape in/out)
    params_stacked: pytree with leading [S, ...] dim (each rank uses its
      own stage's row; a DTensor sharded over ``stage_axis`` holds only
      that row).
    x_microbatches: [M, mb, ...] replicated input microbatches.

    Returns [M, mb, ...] outputs, computed on the last stage and
    replicated to every stage by a masked SUM all-reduce (point-to-point
    sends need one source each, so broadcast-by-reduction, as the
    reference does).
    """
    group = mesh.get_group(stage_axis)
    S = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    stage = mesh.get_local_rank(stage_axis)
    params_s = tree_map(lambda a: _stage_params(a, stage), params_stacked)
    xs = full(x_microbatches)
    M = xs.shape[0]
    nxt = dist.get_global_rank(group, (stage + 1) % S)
    prv = dist.get_global_rank(group, (stage - 1) % S)

    held = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(S + M - 1):
        # stage 0 injects microbatch t (when available)
        x_in = xs[t if t < M else 0] if stage == 0 else held
        active = 0 <= t - stage < M
        y = stage_fn(params_s, x_in) if active else held
        # pass to the next stage (ring shift by +1)
        if S > 1:
            passed = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, passed, prv, group)])
            for r in reqs:
                r.wait()
        else:
            passed = y
        # last stage records its finished microbatch
        done = t - (S - 1)
        if stage == S - 1 and 0 <= done < M:
            outs[done] = y
        held = passed
    if stage != S - 1:
        outs.zero_()
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs
