"""Activation specs derived from a ModelConfig (``repro.dist.ctx``), and
the data-parallel context that the sharded training step sets around the
model.

``logits_spec`` / ``activation_spec`` return the reference's specs as the
port's spec tuples (``dist.sharding``): None when ``cfg.mesh_axes`` is
empty, as on a bare run. ``pin(x, spec)`` is the reference's
``with_sharding_constraint``: on a DTensor it redistributes to the spec's
placements, on a plain tensor it does nothing.

The data-parallel context. ``train.loop``'s sharded step runs the
unchanged model code on this rank's rows of the global batch. A few places
couple rows across the batch; they go through the helpers below
(``n_data``, ``global_sum``, ``sum_before``, ``gather_rows``, ``my_rows``),
which are the identity with no context set, so the model code never
branches on distribution. Under :func:`data_parallel` they make those
places compute what one device computes on the global batch:

* ``nn.softmax_cross_entropy`` divides by the global token (or mask)
  count, so each rank's loss is its share of the global mean;
* ``models.moe.moe_ffn`` sizes the capacity by the global row count,
  places each pair at its global slot (the pairs of lower data ranks come
  first, as their rows do), and takes the Switch loss's dispatch fractions
  over all rows;
* rank mode 'random' draws the global (batch, head) ranks and takes its
  rows; the agent's sampled actions are drawn from the gathered
  probabilities of every row.

The shares sum to the global value over the data ranks; the step sums the
losses and the gradients there. The context is a ``ContextVar``: it holds
only for the code that entered it, not for models run on other threads.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def _dp(axes: Tuple[str, ...]):
    dp = tuple(a for a in axes if a != "model")
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else dp


def logits_spec(cfg) -> Optional[tuple]:
    """Spec of (batch, seq, vocab) logits: batch over the data axes, vocab
    over ``model`` under 'tp' / 'fsdp_tp' (the lm head is vocab-sharded),
    sequence replicated. None without ``cfg.mesh_axes``."""
    axes = tuple(getattr(cfg, "mesh_axes", ()) or ())
    if not axes:
        return None
    tp = "model" if ("model" in axes and getattr(cfg, "sharding", "fsdp_tp")
                     in ("tp", "fsdp_tp")) else None
    return (_dp(axes), None, tp)


def activation_spec(cfg, ndim: int = 3) -> Optional[tuple]:
    """Spec of (batch, seq, d_model)-shaped activations: batch over the
    data axes, everything else replicated. None without ``cfg.mesh_axes``."""
    axes = tuple(getattr(cfg, "mesh_axes", ()) or ())
    if not axes or ndim < 1:
        return None
    return (_dp(axes),) + (None,) * (ndim - 1)


def pin(x, spec):
    """``x`` placed by ``spec`` on its own mesh when it is a DTensor; ``x``
    itself otherwise (or with no spec)."""
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.dist.sharding import to_placements
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------------------
# data-parallel context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This rank's place among the data ranks of a mesh: ``groups`` the
    process groups of the data axes in mesh order (pod before data),
    ``sizes`` their sizes, ``index`` the rank's flat data coordinate
    (pod-major)."""
    groups: Tuple[object, ...]
    sizes: Tuple[int, ...]
    index: int

    @property
    def n(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data ranks (no gradient flows)."""
        x = x.detach().clone()
        for g, s in zip(self.groups, self.sizes):
            if s > 1:
                dist.all_reduce(x, group=g)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n, *x.shape): every data rank's ``x`` in flat data order (no
        gradient flows)."""
        x = x.detach().contiguous()[None]
        for g, s in reversed(list(zip(self.groups, self.sizes))):
            if s > 1:
                parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(s)]
                dist.all_gather(parts, x, group=g)
                x = torch.cat(parts, 0)
        return x


_CURRENT: contextvars.ContextVar[Optional[DataParallel]] = contextvars.ContextVar(
    "data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(ctx: DataParallel):
    """Run the model's row-coupled places as one device would on the
    global batch (module docstring)."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def n_data() -> int:
    """The number of data ranks (1 with no context)."""
    dp = _CURRENT.get()
    return 1 if dp is None else dp.n


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks, with no gradient through the sum
    (``x`` itself with no context)."""
    dp = _CURRENT.get()
    return x if dp is None else dp.all_sum(x)


def sum_before(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks before this one in the global row
    order (zeros with no context)."""
    dp = _CURRENT.get()
    return torch.zeros_like(x) if dp is None else dp.all_gather(x)[:dp.index].sum(0)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``x`` along dim 0, in global row order,
    with no gradient (``x`` itself with no context)."""
    dp = _CURRENT.get()
    return x if dp is None else dp.all_gather(x).flatten(0, 1)


def my_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a tensor whose dim 0 runs over every data
    rank's rows (``x`` itself with no context)."""
    dp = _CURRENT.get()
    return x if dp is None else x.reshape((dp.n, -1) + tuple(x.shape[1:]))[dp.index]


def data_parallel_of(mesh) -> DataParallel:
    """The data-parallel context of this rank on a ``DeviceMesh``: its
    data axes (every axis but 'model') and its flat data coordinate."""
    from repro_torch.dist.sharding import axis_names, data_axes, mesh_sizes
    names, sizes = axis_names(mesh), mesh_sizes(mesh)
    coord = mesh.get_coordinate()
    index = 0
    for a in data_axes(mesh):
        index = index * sizes[a] + coord[names.index(a)]
    return DataParallel(groups=tuple(mesh.get_group(a) for a in data_axes(mesh)),
                        sizes=tuple(sizes[a] for a in data_axes(mesh)),
                        index=index)
