"""Path-based partition-spec rules over a ("data", "model") mesh
(``repro.dist.sharding``), and their placement as DTensors.

Every init in the model zoo names its weights consistently (wq/wk/wv are
column-parallel, wo/w_down row-parallel, MoE expert stacks carry an expert
dim, ...), so sharding is decided from the *leaf path*. The rules are the
reference's, Megatron-style:

- column-parallel matrices shard their output dim over ``model`` and (under
  fsdp) their input dim over the data axes;
- row-parallel matrices shard their input dim over ``model`` and their
  output dim over the data axes;
- MoE expert stacks shard the expert dim over ``model`` and the matrix
  input dim over the data axes;
- embeddings shard the vocab dim over ``model``;
- norms, biases without a model-parallel dim and anything unrecognised
  stay replicated.

Any axis that does not evenly divide its dim is **dropped** (never an
error). ``cfg.sharding`` selects the live axes: ``dp`` (replicated
params), ``tp``, ``fsdp``, ``fsdp_tp``.

A spec is a tuple with one entry per tensor dim: None, a mesh axis name or
a tuple of names (JAX's ``PartitionSpec`` entries). The rules read a mesh
only through its axis names and sizes (:func:`mesh_sizes`), so a
``torch.distributed.device_mesh.DeviceMesh`` and a duck-typed mesh with
``.shape`` (a dict) and ``.axis_names`` both work.

:func:`to_placements` turns a spec into DTensor placements (a dim naming
mesh dim ``m`` is ``Shard(dim)`` there; a tuple of names shards the dim
over those mesh dims in mesh order, pod-major as JAX's ``P(("pod",
"data"))``), and :func:`distribute` places a tree of full tensors, held
alike on every rank, by each rank taking its shard (no communication).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tu

# leaf names whose LAST dim is the model-parallel (output) dim
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "wr", "wg", "wa", "w_gate", "w_up",
    "wq_a", "wq_b", "wkv_a", "wkv_b", "in_proj", "lm_head", "router",
    "bq", "bk", "bv", "a",
})
# leaf names whose SECOND-TO-LAST dim is the model-parallel (input) dim
_ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj", "wb", "b"})
# leaves holding a vocab-major embedding table: (V, d)
_EMBED = frozenset({"embed"})
# MoE expert stacks: (..., E, in, out) under an immediate "moe" parent
_EXPERT = frozenset({"w_gate", "w_up", "w_down"})


def path_str(path: Sequence[Any]) -> str:
    """Stable string form of a tree path: 'layers/attn/wq'. Entries are
    JAX key objects (with ``key``, ``idx`` or ``name``) or the port's plain
    str / int; each renders as its bare token, joined by '/'. Checkpoint
    manifests key leaves by this string."""
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        elif hasattr(k, "name"):
            parts.append(str(k.name))
        else:
            parts.append(str(k))
    return "/".join(parts)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} in mesh order, of a ``DeviceMesh``
    (``mesh_dim_names``, ``shape``) or a duck-typed mesh whose ``shape`` is
    that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_sizes(mesh))


def data_axes(mesh) -> Tuple[str, ...]:
    """Every non-'model' mesh axis, in mesh order ('pod' before 'data')."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def is_spec(x) -> bool:
    """A partition spec: None, or a list / plain tuple of entries, each
    None, an axis name or a sequence of axis names."""
    if x is None:
        return True
    if not isinstance(x, (list, tuple)) or tu.is_namedtuple(x):
        return False
    return all(a is None or isinstance(a, str)
               or (isinstance(a, (list, tuple)) and all(isinstance(n, str) for n in a))
               for a in x)


def _fit_axes(dim: int, axes: Tuple[str, ...], sizes: dict) -> Optional[Any]:
    """Largest prefix of ``axes`` (present in the mesh) that divides
    ``dim``, as a spec entry: an axis name, a tuple of names, or None."""
    axes = tuple(a for a in axes if a in sizes)
    while axes:
        if dim % math.prod(sizes[a] for a in axes) == 0:
            break
        axes = axes[:-1]
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _entry(spec_axes, dim, sizes):
    """One per-dim rule entry through the divisibility check."""
    if spec_axes is None:
        return None
    if isinstance(spec_axes, str):
        spec_axes = (spec_axes,)
    return _fit_axes(dim, tuple(spec_axes), sizes)


def _param_rule(path, shape, mesh, *, use_tp: bool, use_fsdp: bool) -> tuple:
    sizes = mesh_sizes(mesh)
    names = [p.lower() for p in (path_str(path).split("/") if path else [])]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    nd = len(shape)
    spec = [None] * nd

    model = "model" if (use_tp and "model" in sizes) else None
    data = data_axes(mesh) if use_fsdp else None

    if nd >= 1 and leaf in _EMBED:
        # (V, d): vocab over model, feature over data under fsdp
        spec[0] = model
        if nd >= 2:
            spec[1] = data
    elif nd >= 3 and leaf in _EXPERT and parent == "moe":
        # expert stack (..., E, in, out): experts over model, input over data
        spec[-3] = model
        spec[-2] = data
    elif nd >= 1 and leaf in _COL_PARALLEL:
        spec[-1] = model
        if nd >= 2:
            spec[-2] = data
    elif nd >= 2 and leaf in _ROW_PARALLEL:
        spec[-2] = model
        spec[-1] = data
    # everything else (norms, scalar gates, conv kernels) stays replicated
    return tuple(_entry(s, d, sizes) for s, d in zip(spec, shape))


def param_pspecs(params, cfg, mesh):
    """Spec tree (same structure as ``params``) for model weights.
    ``params`` may hold anything with a ``.shape``; ``cfg.sharding`` picks
    the parallelism style."""
    mode = getattr(cfg, "sharding", "fsdp_tp")
    use_tp = mode in ("tp", "fsdp_tp")
    use_fsdp = mode in ("fsdp", "fsdp_tp")
    specs = {}
    for path, leaf in tu.flatten_with_keys(params):
        shape = tuple(leaf.shape)
        specs[path] = ((None,) * len(shape) if mode == "dp" else
                       _param_rule(path, shape, mesh, use_tp=use_tp, use_fsdp=use_fsdp))
    return tu.rebuild(params, specs)


def batch_pspecs(batch, mesh):
    """Shard the leading (batch) dim of every leaf over the data axes."""
    sizes = mesh_sizes(mesh)
    dp = data_axes(mesh)
    specs = {}
    for path, leaf in tu.flatten_with_keys(batch):
        shape = tuple(leaf.shape)
        specs[path] = (() if not shape else
                       (_entry(dp, shape[0], sizes),) + (None,) * (len(shape) - 1))
    return tu.rebuild(batch, specs)


def cache_pspecs(cache, cfg, mesh):
    """Decode-cache specs: batch over data; with ``cfg.cache_seq_shard``
    the sequence dim also over ``model`` (split-KV decode). Leaves are
    (layers, batch, seq, heads, head_dim), or (batch, ...) for 2-d states;
    scalars replicate."""
    sizes = mesh_sizes(mesh)
    dp = data_axes(mesh)
    seq_shard = getattr(cfg, "cache_seq_shard", False)
    specs = {}
    for path, leaf in tu.flatten_with_keys(cache):
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        if nd < 2:
            specs[path] = (None,) * nd
            continue
        b_dim = 1 if nd >= 3 else 0
        spec = [None] * nd
        spec[b_dim] = _entry(dp, shape[b_dim], sizes)
        if seq_shard and nd >= 3 and "model" in sizes:
            spec[b_dim + 1] = _entry("model", shape[b_dim + 1], sizes)
        specs[path] = tuple(spec)
    return tu.rebuild(cache, specs)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve_spec(spec, mesh) -> tuple:
    """``spec`` with the axes ``mesh`` lacks dropped (the elastic restore of
    ``CheckpointManager.load``)."""
    names = axis_names(mesh)
    out = []
    for entry in spec or ():
        keep = tuple(a for a in _axes_of(entry) if a in names)
        out.append(keep if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``:
    ``Shard(dim)`` on each mesh dim a tensor dim names, ``Replicate()``
    on the others. A dim over several axes takes them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec or ()):
        axes = _axes_of(entry)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {spec} names an axis the mesh {names} lacks")
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes of one dim must be in mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {names[i]} twice")
            out[i] = Shard(dim)
    return tuple(out)


def local_shard(full: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (DTensor's chunk
    rule: ceil(n / k) per rank, the last ones short or empty)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    x = full
    for m, p in enumerate(placements):
        dim = getattr(p, "dim", None)
        if dim is None:
            continue
        n, k = x.shape[dim], mesh.size(m)
        size = -(-n // k)
        start = min(coord[m] * size, n)
        x = x.narrow(dim, start, min(start + size, n) - start)
    return x


def place(full: torch.Tensor, spec, mesh):
    """A DTensor on ``mesh`` with ``spec``'s placements, its local shard
    copied out of ``full`` (which every rank holds alike)."""
    from torch.distributed.tensor import DTensor
    placements = to_placements(spec, mesh)
    full = full.to(mesh.device_type)
    local = local_shard(full, placements, mesh).clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def distribute(tree, specs, mesh):
    """``tree``'s tensors as DTensors placed by the spec tree ``specs`` (or
    a leading subtree of it, as ``CheckpointManager.save`` takes them:
    leaves past it replicate)."""
    flat = tu.flatten_with_keys(tree)
    spec_flat = [s for _, s in tu.flatten_with_keys(specs, is_leaf=is_spec)]
    if len(spec_flat) > len(flat):
        raise ValueError(f"specs has {len(spec_flat)} leaves but tree has only {len(flat)}")
    spec_flat += [None] * (len(flat) - len(spec_flat))
    return tu.rebuild(tree, {path: place(x, spec, mesh)
                             for (path, x), spec in zip(flat, spec_flat)})


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def full_tensor(x):
    """The whole value of a DTensor (a collective over its mesh); ``x``
    itself otherwise."""
    return x.full_tensor() if is_dtensor(x) else x


def replication(x) -> int:
    """How many ranks of its mesh hold each element of DTensor ``x``."""
    out = 1
    for m, p in enumerate(x.placements):
        if p.is_replicate():
            out *= x.device_mesh.size(m)
    return out


def reduce_grad(grad: torch.Tensor, like):
    """This rank's shard, under DTensor ``like``'s placements, of the sum
    over the data ranks of ``grad`` (each rank's full-size gradient of its
    share of the loss; the ranks of one data coordinate hold the same):
    a reduce-scatter over a data axis the param is sharded on, an
    all-reduce over one it is replicated on, a slice over 'model'."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = like.device_mesh
    dp = data_axes(mesh)
    src = [Partial() if a in dp else Replicate() for a in axis_names(mesh)]
    return DTensor.from_local(grad, mesh, src, run_check=False).redistribute(
        mesh, like.placements).to_local()


def sharded_global_norm(shards, likes) -> torch.Tensor:
    """The global norm of a tree given as this rank's shards of DTensors
    ``likes``: each shard's squares divided by the ranks that hold it alike,
    summed over every mesh axis."""
    mesh = likes[0].device_mesh
    total = sum(g.float().square().sum() / replication(p) for g, p in zip(shards, likes))
    for a in axis_names(mesh):
        if mesh.size(axis_names(mesh).index(a)) > 1:
            torch.distributed.all_reduce(total, group=mesh.get_group(a))
    return torch.sqrt(total)


def like(local: torch.Tensor, dt):
    """``local`` as the shard of a DTensor placed as ``dt``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, dt.device_mesh, dt.placements, run_check=False,
                              shape=dt.shape, stride=dt.stride())
