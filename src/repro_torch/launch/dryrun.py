"""Dry run of the port (``repro.launch.dryrun``): one rank's step of every
(arch x shape cell x production mesh), traced on fake tensors, with the
counts the roofline report reads.

The reference lowers and compiles each cell for 256 or 512 placeholder TPU
devices and reads XLA's cost and memory analyses. The port's step is eager
PyTorch, so the counterpart runs it: this process is rank 0 of a fake
process group of the production mesh's size
(:func:`repro_torch.launch.mesh.make_production_mesh`), the params, the
AdamW state, the batch and the cache are fake tensors placed by the
sharding rules, and the step runs once under ``FakeTensorMode`` (no memory,
no compute, no communication) with ``FlopCounterMode``, ``CommDebugMode``
and :class:`StepCounter` watching every op this rank dispatches.

What is traced is the port's own program on the mesh: the training cell is
``train.loop.make_train_step``'s sharded step (every param gathered whole,
the model on this rank's rows, gradients reduce-scattered to the params'
placements, AdamW on the shards); the prefill and decode cells run
``loss`` and ``decode_step`` the same way, on gathered params and this
rank's rows of the batch or cache. What is counted (:data:`COUNTS`) is not
what XLA counts: ``FlopCounterMode`` counts matmul, convolution and
attention ops only, and the bytes are those of the eager, unfused program.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --cell train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cpu

Artifacts land in benchmarks/artifacts/dryrun_torch/<arch>__<cell>__<mesh>.json
(existing artifacts are skipped unless --force). A cell that cannot be
traced (a data-dependent op such as ``.item()`` or ``nonzero`` on a fake
tensor) is written with ``ok: false`` and its error.
"""
from __future__ import annotations

import argparse
import contextlib
import heapq
import json
import math
import pathlib
import sys
import time
import traceback
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tu
from repro_torch.configs import ARCH_IDS, cells_for, get_config
from repro_torch.configs.base import SHAPE_CELLS, ShapeCell, TrainConfig
from repro_torch.core import prng
from repro_torch.dist import ctx as dctx
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh
from repro_torch.models.api import get_model

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "benchmarks" / \
    "artifacts" / "dryrun_torch"

COUNTS = ("flops: FlopCounterMode over this rank's ops, matmul, convolution and "
          "attention only (XLA's count adds elementwise work); bytes_accessed: each "
          "op's input and output bytes in the eager, unfused program (views, "
          "allocations and collectives move none here); collectives: each "
          "collective's result bytes on this rank, read from its tensors; memory: "
          "this rank's live fake storage (arguments = the local shards passed in)")

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute", "broadcast", "other")
# the collective ops of torch.distributed (functional and c10d) by kind
_COLL_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d")
# ops that move no bytes: allocations without a write, waits, aliases and
# views (``_unsafe_view`` is one, though its schema does not say so)
_NO_TRAFFIC = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
    "aten::new_empty_strided", "aten::detach", "aten::alias", "aten::lift_fresh",
    "aten::_unsafe_view", "_c10d_functional::wait_tensor"})


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tensors) -> int:
    """The bytes of the distinct storages behind ``tensors``."""
    return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in tensors}.values())


def _arg_values(schema, args, kwargs) -> dict:
    vals = {a.name: v for a, v in zip(schema.arguments, args)}
    vals.update(kwargs)
    return vals


def _local(x):
    return x.to_local() if shd.is_dtensor(x) else x


def local_tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` as this rank holds them (a DTensor's local
    shard); host ints and the like left out."""
    return [_local(x) for x in tu.leaves(tree) if isinstance(x, torch.Tensor)]


def _src() -> str:
    """The two innermost ``repro_torch`` lines (outside this module and the
    tree helpers) on the Python stack, innermost first: the code that dispatched
    the current op and its caller; in the backward pass also the autograd
    node that runs it."""
    f, lines = sys._getframe(2), []
    while f is not None and len(lines) < 2:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(("dryrun.py", "tree.py")):
            lines.append(f"{name[name.rindex('repro_torch'):]}:{f.f_lineno} "
                         f"({f.f_code.co_name})")
        f = f.f_back
    node = torch._C._current_autograd_node()
    return " < ".join(lines or ["?"]) + (f" [backward: {node.name()}]" if node else "")


class StepCounter(TorchDispatchMode):
    """Counts what this rank's ops do, from their tensors: bytes read and
    written, collective result bytes by kind and mesh axis, and live
    storage (each new output storage is live until Python frees it; the
    peak is taken after every op). ``args`` are the step's inputs: their
    storages are live from the start, and those an op writes in place are
    the aliased bytes. With ``topk`` > 0 it also keeps the ``topk`` largest
    collectives and ops by result bytes, each with the source line that
    dispatched it."""

    def __init__(self, args, axes: Dict[str, str], topk: int = 0):
        super().__init__()
        self.axes = axes
        self.topk = topk
        self.bytes_accessed = 0
        self.coll = {k: 0 for k in COLL_KINDS}
        self.coll_counts = {k: 0 for k in COLL_KINDS}
        self.by_axis: Dict[str, int] = {}
        self.top_colls: list = []
        self.top_ops: list = []
        self.by_op: Dict[str, int] = {}
        self._seen = 0                   # tie-breaker for the heaps
        self._live = 0
        self._tracked = weakref.WeakKeyDictionary()
        self._args = {}
        for t in _tensors(args):
            st = t.untyped_storage()
            if id(st) not in self._args:
                self._args[id(st)] = st
                self._track(st)
        self.argument_bytes = self._live
        self.peak = self._live
        self._aliased: Dict[int, int] = {}

    def _track(self, st) -> None:
        if st in self._tracked:
            return
        n = st.nbytes()
        self._tracked[st] = n
        self._live += n
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    def _push(self, heap, item) -> None:
        self._seen += 1
        entry = (item[0], self._seen) + tuple(item[1:])
        if len(heap) < self.topk:
            heapq.heappush(heap, entry)
        elif entry > heap[0]:
            heapq.heapreplace(heap, entry)

    def _group(self, func, vals) -> str:
        """The mesh axis (or group name) a collective runs over."""
        for a in func._schema.arguments:
            v = vals.get(a.name)
            if a.name == "group_name" and isinstance(v, str):
                return self.axes.get(v, v)
            if isinstance(v, torch.ScriptObject) and "ProcessGroup" in str(a.type):
                name = torch._C._distributed_c10d.ProcessGroup.unbox(v).group_name
                return self.axes.get(name, name)
        return "?"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        ns, _, name = schema.name.partition("::")
        vals = _arg_values(schema, args, kwargs)
        written = [t for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write
                   for t in _tensors(vals.get(a.name))]
        outs = _tensors(out)
        for t in written:
            st = t.untyped_storage()
            if id(st) in self._args:
                self._aliased[id(st)] = st.nbytes()
        for t in outs:
            self._track(t.untyped_storage())
        self.peak = max(self.peak, self._live)
        if ns in _COLL_NAMESPACES and schema.name not in _NO_TRAFFIC:
            kind = _COLL_OPS.get(name, "other")
            nbytes = sum(_nbytes(t) for t in (written or outs))
            axis = self._group(func, vals)
            self.coll[kind] += nbytes
            self.coll_counts[kind] += 1
            self.by_axis[axis] = self.by_axis.get(axis, 0) + nbytes
            if self.topk:
                self._push(self.top_colls, (nbytes, kind, axis, _src()))
            return out
        if not outs or schema.name in _NO_TRAFFIC or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in schema.returns):
            return out                   # metadata, an allocation, a wait or a view
        out_bytes = sum(_nbytes(t) for t in outs)
        nbytes = out_bytes + sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs))
        self.bytes_accessed += nbytes
        if self.topk:
            self.by_op[str(func)] = self.by_op.get(str(func), 0) + nbytes
            if out_bytes:
                self._push(self.top_ops, (out_bytes, str(func), _src()))
        return out

    def collectives(self) -> dict:
        return {**self.coll, "total": sum(self.coll.values()),
                "counts": dict(self.coll_counts), "by_axis": dict(self.by_axis)}

    def memory(self, outputs) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": storage_bytes(outputs),
                "temp_bytes": self.peak - self.argument_bytes,
                "alias_bytes": sum(self._aliased.values())}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _fake(tree, device):
    """Fresh tensors (fake ones, under ``FakeTensorMode``) shaped as the meta
    tensors of ``tree``; other leaves kept."""
    return tu.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device)
                       if isinstance(x, torch.Tensor) else x, tree)


def _place(tree, specs, mesh):
    """``dist.sharding.distribute`` over the tensor leaves of ``tree``; a
    host int (a dense cache's ``len``) stays as it is."""
    flat = tu.flatten_with_keys(tree)
    spec_flat = [s for _, s in tu.flatten_with_keys(specs, is_leaf=shd.is_spec)]
    return tu.rebuild(tree, {path: shd.place(x, spec, mesh)
                             if isinstance(x, torch.Tensor) else x
                             for (path, x), spec in zip(flat, spec_flat)})


def _rows(x, b_dim, mesh):
    """(this rank's rows of DTensor ``x`` as a plain tensor, whether the
    rows are split): its local shard along ``b_dim`` with every other dim
    gathered whole. Rows not split over every data axis (a batch the data
    ranks do not divide) are gathered whole, and every rank computes them."""
    from torch.distributed.tensor import Replicate, Shard
    names, dp = shd.axis_names(mesh), shd.data_axes(mesh)
    split = all(x.placements[names.index(a)] == Shard(b_dim) for a in dp)
    want = tuple(Shard(b_dim) if split and a in dp else Replicate() for a in names)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return x.to_local(), split


def build_cell(arch: str, cell: ShapeCell, mesh, *, static_rank=None,
               overrides=None, device="cuda"):
    """(fn, args): ``fn(*args)`` runs this rank's step of ``cell`` on
    ``mesh``. The params are made from ``init(gen, device="meta")`` as
    fresh tensors on ``device`` and placed by ``param_pspecs``; the batch
    by ``batch_pspecs``, the cache by ``cache_pspecs``. Under
    ``FakeTensorMode`` every tensor is fake; outside it they are real and
    uninitialised (the caller fills them). The config takes the
    reference's overrides: the mesh's axis names and, with
    ``static_rank``, a fixed static rank."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    if not cfg.mesh_axes:
        cfg = cfg.with_(mesh_axes=shd.axis_names(mesh))
    if static_rank is not None:
        cfg = cfg.with_(rank=cfg.rank.__class__(
            mode="fixed", realisation="static", static_rank=static_rank,
            fixed_rank=static_rank))
    fns = get_model(cfg)
    specs = fns.input_specs(cell)
    params_shape = fns.init(torch.Generator().manual_seed(0), device="meta")
    pspecs = shd.param_pspecs(params_shape, cfg, mesh)
    params = _place(_fake(params_shape, device), pspecs, mesh)

    def gathered(p):
        return tu.tree_map(shd.full_tensor, p)

    if cell.kind == "train":
        from repro_torch.optim import adamw
        from repro_torch.train.loop import make_train_step
        tc = TrainConfig(global_batch=cell.global_batch, seq_len=cell.seq_len)
        step = make_train_step(cfg, tc, lambda p, b, r: fns.loss(p, b))
        opt = adamw.init(params)
        batch = _place(_fake(specs["batch"], device),
                       shd.batch_pspecs(specs["batch"], mesh), mesh)
        rng = prng.key(0).to(device)

        def train_step(params, opt_state, batch, rng):
            # the sharded step takes the global batch, alike on every rank
            return step(params, opt_state, gathered(batch), rng)
        return train_step, (params, opt, batch, rng)

    dp = dctx.data_parallel_of(mesh)
    if cell.kind == "prefill":
        batch = _place(_fake(specs["batch"], device),
                       shd.batch_pspecs(specs["batch"], mesh), mesh)

        def prefill_step(params, batch):
            rows = {k: _rows(v, 0, mesh) for k, v in batch.items()}
            with _maybe_dp(dp, all(s for _, s in rows.values())):
                # the loss's first output, as the reference's prefill step returns
                out, _ = fns.loss(gathered(params), {k: r for k, (r, _) in rows.items()})
            return out
        return prefill_step, (params, batch)

    cache = _place(_fake(specs["cache"], device),
                   shd.cache_pspecs(specs["cache"], cfg, mesh), mesh)
    tokens = _place(_fake(specs["tokens"], device),
                    shd.batch_pspecs({"t": specs["tokens"]}, mesh)["t"], mesh)

    def serve_step(params, cache, tokens):
        tok, split = _rows(tokens, 0, mesh)
        local = tu.tree_map(
            lambda x: _rows(x, 1 if x.dim() >= 3 else 0, mesh)[0]
            if isinstance(x, torch.Tensor) and x.dim() >= 2 else _local(x), cache)
        with _maybe_dp(dp, split):
            return fns.decode_step(gathered(params), local, tok)
    return serve_step, (params, cache, tokens)


def _maybe_dp(dp, split):
    """The data-parallel context where this rank's rows are its share."""
    return dctx.data_parallel(dp) if split else contextlib.nullcontext()


def require_device(device) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dry run on fake 'cuda' tensors needs a PyTorch with CUDA "
                           "and a card; pass --device cpu to trace on fake CPU tensors")


def trace_step(arch: str, cell: ShapeCell, mesh, *, static_rank=None,
               overrides=None, device="cuda", topk: int = 0) -> dict:
    """One traced step of ``cell`` on this rank of ``mesh`` (whose process
    group is a fake one): the counts of :func:`run_cell`'s record (raises
    where the step does); with ``topk`` also the largest collectives and
    ops (``top_collectives``: (bytes, kind, axis, source line); ``top_ops``:
    (bytes, op, source line))."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    import torch.distributed as dist

    axes = {mesh.get_group(a).group_name: a for a in shd.axis_names(mesh)}
    axes[dist.group.WORLD.group_name] = "world"
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = build_cell(arch, cell, mesh, static_rank=static_rank,
                              overrides=overrides, device=device)
        counter = StepCounter(local_tensors(args), axes, topk=topk)
        flops = FlopCounterMode(display=False)
        comm = CommDebugMode()
        t0 = time.monotonic()
        with flops, comm, counter:
            out = fn(*args)
        trace_s = time.monotonic() - t0
        rec = {"flops": float(flops.get_total_flops()),
               "bytes_accessed": float(counter.bytes_accessed),
               "collectives": counter.collectives(),
               "comm_debug_counts": {str(k): v for k, v in
                                     comm.get_comm_counts().items()},
               "memory": counter.memory(local_tensors(out)),
               "trace_s": round(trace_s, 2),
               "devices": dist.get_world_size(),
               "device": torch.device(device).type,
               "counts": COUNTS}
    if topk:
        rec["top_collectives"] = [(b,) + tuple(rest) for b, _, *rest in
                                  sorted(counter.top_colls, reverse=True)]
        rec["top_ops"] = [(b,) + tuple(rest) for b, _, *rest in
                          sorted(counter.top_ops, reverse=True)]
        rec["bytes_by_op"] = dict(sorted(counter.by_op.items(), key=lambda kv: -kv[1])[:topk])
    return rec


def trace_cell(arch: str, cell: ShapeCell, mesh_kind: str, **kw) -> dict:
    """:func:`trace_step` on rank 0 of the production mesh ``mesh_kind``
    ('single' or 'multi'), in a fake process group of its own."""
    import torch.distributed as dist
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device=kw.get("device", "cuda"))
    try:
        return trace_step(arch, cell, mesh, **kw)
    finally:
        dist.destroy_process_group()


def _artifact(name: str, force: bool):
    ART_DIR.mkdir(parents=True, exist_ok=True)
    path = ART_DIR / f"{name}.json"
    if path.exists() and not force:
        print(f"[skip] {name} (artifact exists)")
        return path, json.loads(path.read_text())
    return path, None


def _failed(rec: dict, name: str, e: Exception) -> None:
    rec.update({"ok": False, "error": f"{type(e).__name__}: {e}"[:2000],
                "traceback": traceback.format_exc()[-4000:]})
    print(f"[FAIL] {name}: {type(e).__name__}: {str(e)[:300]}")


def run_cell(arch: str, cell: ShapeCell, mesh_kind: str, *, force=False,
             static_rank=None, tag="", overrides=None, device="cuda") -> dict:
    """Trace one cell and write its artifact (see the module docstring);
    a cell whose trace raises is written with ``ok: false`` and its error."""
    require_device(device)
    name = f"{arch}__{cell.name}__{mesh_kind}{tag}"
    path, done = _artifact(name, force)
    if done is not None:
        return done
    rec = {"arch": arch, "cell": cell.name, "mesh": mesh_kind,
           "devices": math.prod(PRODUCTION_MESHES[mesh_kind][0])}
    try:
        rec.update(trace_cell(arch, cell, mesh_kind, static_rank=static_rank,
                              overrides=overrides, device=device))
        rec["ok"] = True
        print(f"[ok] {name}: flops={rec['flops']:.3e} "
              f"bytes={rec['bytes_accessed']:.3e} "
              f"coll={rec['collectives']['total']:.3e} (trace {rec['trace_s']:.1f}s)")
    except Exception as e:      # a cell that cannot trace is recorded, not fatal
        _failed(rec, name, e)
    path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--static-rank", type=int, default=None,
                    help="trace the DR-RL serving bucket at this rank")
    ap.add_argument("--tag", default="", help="artifact suffix")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (default; the card's "
                         "routes) or cpu")
    args = ap.parse_args(argv)
    require_device(args.device)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    n_fail = 0
    for arch in archs:
        cells = cells_for(arch)
        if args.cell:
            cells = [c for c in SHAPE_CELLS if c.name == args.cell]
        for cell in cells:
            for mk in meshes:
                rec = run_cell(arch, cell, mk, force=args.force,
                               static_rank=args.static_rank, tag=args.tag,
                               device=args.device)
                n_fail += 0 if rec.get("ok") else 1
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
