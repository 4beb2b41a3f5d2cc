"""AdamW written out (``repro.optim.adamw``): decoupled weight decay, bias
correction, global-norm clipping and a schedule, functional over a nested
dict/list tree of tensors. The state mirrors the parameter tree.

``torch.optim.AdamW`` is not used: it has no global-norm clip, no decay mask
by leaf name, and steps its own counter outside the schedule. Leaves are
visited in JAX's order (:mod:`repro_torch.tree`), so the global norm sums
them in the reference's order and the decay mask sees the same names.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import TrainConfig


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, ()
    m: object
    v: object


def init(params) -> AdamWState:
    def zeros(p):
        return tu.tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), p)
    step = torch.zeros((), dtype=torch.int32,
                       device=tu.leaves(params)[0].device)
    return AdamWState(step=step, m=zeros(params), v=zeros(params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tu.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, g=None):
    """``grads`` scaled to global norm at most ``max_norm``, and the norm
    (``g`` where the caller computed it, as the sharded step does over
    every rank's shards)."""
    if g is None:
        g = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tu.tree_map(lambda x: x * factor, grads), g


# the reference's exempt prefixes that the port's trees can hold: norms and
# the attention biases (its other names belong to models the port lacks)
_WD_EXEMPT = ("ln", "bq", "bk", "bv")


def _decay_mask(path: str) -> bool:
    last = path.split("/")[-1]
    return not last.startswith(_WD_EXEMPT)


def update(tc: TrainConfig, lr_fn: Callable, state: AdamWState, params, grads,
           grad_norm=None) -> Tuple[object, AdamWState, dict]:
    """One step: returns (params, state, {'grad_norm', 'lr'}). The bias
    corrections are computed on the f32 step, as in the reference.
    ``grad_norm``, where given, is the global norm to clip by (the sharded
    step passes the norm over every rank's shards)."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, grad_norm)
    step = state.step + 1
    lr = lr_fn(step)
    b1, b2, eps = tc.b1, tc.b2, tc.eps
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(tu.leaves_with_path(params), tu.leaves(grads),
                                  tu.leaves(state.m), tu.leaves(state.v)):
        gf = g.float()
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf.square()
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        if _decay_mask(path) and tc.weight_decay > 0:
            upd = upd + tc.weight_decay * p.float()
        new_p.append((p.float() - lr * upd).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return tu.unflatten(params, new_p), AdamWState(
        step=step, m=tu.unflatten(params, new_m),
        v=tu.unflatten(params, new_v)), {"grad_norm": gnorm, "lr": lr}
