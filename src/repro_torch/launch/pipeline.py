"""GPipe-style pipeline parallelism over ``torch.distributed`` point-to-point
sends (twin of ``repro/launch/pipeline.py``).

Schedule: classic GPipe. ``n_stages`` ranks along the mesh's ``stage``
axis each own one stage; ``n_micro`` microbatches stream through. Each
outer tick every stage applies its block to its current microbatch and
sends the activation to the next stage (``isend`` / ``irecv``, the
reference's ``ppermute`` ring); stage 0 takes the next microbatch, the last
stage commits one output per tick once the pipe is full. The tick count
is the reference's, ``n_micro + n_stages - 1``, so the bubble fraction is
``(S - 1) / (M + S - 1)``. The outputs are broadcast from the last stage.
The stage body is any ``(params, x) -> x`` function.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.util.tree import tree_map


def pipeline_apply(stage_params, x_micro: torch.Tensor, stage_fn: Callable,
                   mesh, axis: str = "stage") -> torch.Tensor:
    """Run microbatches through the pipeline stages.

    stage_params: tree with leading dim = n_stages (this rank takes its
    stage's slice); x_micro: (n_micro, mb, ...) microbatched input, the
    same on every rank; stage_fn: (params_for_stage, x) -> y of x's shape.
    Returns (n_micro, mb, ...) outputs after all stages, on every rank."""
    import torch.distributed as dist

    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    idx = mesh.index(axis)
    group = mesh.groups[axis]
    params = tree_map(lambda a: a[idx], stage_params)
    nxt = dist.get_global_rank(group, (idx + 1) % n_stages)
    prv = dist.get_global_rank(group, (idx - 1) % n_stages)
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):  # GPipe ticks incl. bubble
        if idx == 0 and t < n_micro:  # stage 0 ingests microbatch t
            buf = x_micro[t]
        y = stage_fn(params, buf)
        out_slot = t - (n_stages - 1)
        if idx == n_stages - 1 and out_slot >= 0:
            outs[out_slot] = y
        if n_stages == 1:
            buf = y
            continue
        recv = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        buf = recv
    dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return outs


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
