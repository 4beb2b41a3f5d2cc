"""Streamed microbatch pipeline parallelism over a stage mesh axis
(``repro.dist.pipeline``) on ``torch.distributed``.

Stage ``i``'s weights (row ``i`` of the leading dim of every param leaf)
are used by rank ``i`` of the axis. Microbatches stream through the GPipe
schedule: at step ``t`` stage 0 takes microbatch ``t`` while stage ``i``
runs the activation it received last step, then every activation moves
one stage down by send / recv. After ``n_micro + n_stages - 1`` steps the
last stage has emitted every microbatch; the fill and drain compute on
zeros, as the reference does, and the result equals applying the stages
in turn. The last stage's outputs reach every rank by an ``all_reduce``
(the reference's ``psum``; the other ranks add zeros).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.dist.sharding import axis_names


def _pipe(params, x, *, stage_fn, group, idx: int, n_stages: int):
    local = tu.tree_map(lambda a: a[idx], params)
    n_micro = x.shape[0]
    mb_shape = x.shape[1:]
    zeros = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
    state = zeros                                 # activation in flight
    outputs = torch.zeros_like(x)                 # filled on the last stage
    nxt = dist.get_global_rank(group, idx + 1) if idx < n_stages - 1 else None
    prv = dist.get_global_rank(group, idx - 1) if idx > 0 else None

    for t in range(n_micro + n_stages - 1):
        feed = x[t] if t < n_micro else zeros
        y = stage_fn(local, feed if idx == 0 else state)
        out_idx = t - (n_stages - 1)              # microbatch leaving stage n-1
        if out_idx >= 0 and idx == n_stages - 1:
            outputs[out_idx] = y
        if t != n_micro + n_stages - 2:
            ops = []
            if nxt is not None:
                ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
            if prv is not None:
                state = torch.empty(mb_shape, dtype=x.dtype, device=x.device)
                ops.append(dist.P2POp(dist.irecv, state, prv, group))
            else:
                state = zeros
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
    dist.all_reduce(outputs, group=group)
    return outputs


def make_pipeline(mesh, stage_fn: Callable, *, axis_name: str = "pod",
                  n_stages: Optional[int] = None):
    """A pipeline over ``axis_name`` of a ``DeviceMesh``.
    ``stage_fn(stage_params, x_mb)`` applies one stage to one microbatch.
    The returned ``pipe(params, x)`` takes params whose leaves are stacked
    over a leading stage dim (the axis size; each rank reads its row) and
    ``x`` (n_micro, microbatch, ...), the same on every rank; it returns
    the pipelined result, shaped as ``x``, on every rank."""
    group = mesh.get_group(axis_name)
    n = n_stages or mesh.size(axis_names(mesh).index(axis_name))
    idx = mesh.get_local_rank(axis_name)

    def pipe(params, x):
        return _pipe(params, x, stage_fn=stage_fn, group=group, idx=idx, n_stages=n)
    return pipe
