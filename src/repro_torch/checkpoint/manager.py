"""Checkpoints of the port (``repro.checkpoint.manager``): atomic directory
commits, an optional async save thread, ``keep`` newest steps,
latest-step resume and the elastic re-shard on load, in the reference's
format, so a checkpoint written by either package loads in the other.

Format: ``<dir>/step_<n>/`` holds one ``leaf_<i>.npy`` per leaf, numbered
in JAX's leaf order (dict keys sorted, lists by index), and
``manifest.json`` {"step", "leaves": {path -> {"file", "spec", "dtype"}},
"extra"}, each leaf keyed by ``dist.sharding.path_str`` ("layers/0/wq";
a NamedTuple's fields by name, as JAX keys them: the ``AdamWState`` of a
``(params, opt_state)`` tree gives "1/step", "1/m/embed", ...). ``save``
stores the partition specs it is given as the reference does (``[]``
for a leaf without one). A tree holding DTensors is gathered by every
rank, written by rank 0 alone and followed by a barrier. ``load(...,
mesh=)`` places each leaf by its stored spec resolved against the mesh
(axes the mesh lacks dropped), so a run resumes on another mesh shape.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import path_str


def _spec_to_json(spec) -> list:
    """The manifest's form of a spec (``repro.checkpoint.manager``):
    ``[]`` for None, each multi-axis entry as a list."""
    if spec is None:
        return []
    return [list(a) if isinstance(a, (list, tuple)) else a for a in spec]


class CheckpointManager:
    def __init__(self, directory, async_save: bool = True, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.async_save = async_save
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, specs: Any = None,
             extra: Optional[dict] = None) -> None:
        """Blocks only to copy the leaves to host memory; the file writes
        may run on a thread (``async_save``). ``specs``, a tree of
        partition specs over ``tree`` or a leading subtree of it (the
        params of a ``(params, opt_state)`` tree), is stored per leaf in
        leaf order; the leaves past it store ``[]``."""
        self.wait()
        flat = tu.flatten_with_keys(tree)
        spec_flat = ([s for _, s in tu.flatten_with_keys(specs, is_leaf=shd.is_spec)]
                     if specs is not None else [])
        if len(spec_flat) > len(flat):
            raise ValueError(f"specs has {len(spec_flat)} leaves but tree has "
                             f"only {len(flat)}")
        spec_flat += [None] * (len(flat) - len(spec_flat))
        sharded = any(shd.is_dtensor(x) for _, x in flat)
        host = [(path_str(p), shd.full_tensor(x).detach().to("cpu", copy=True).numpy()
                 if isinstance(x, torch.Tensor) else np.array(x))
                for p, x in flat]
        if sharded and dist.get_rank() != 0:
            dist.barrier()              # rank 0 commits
            return

        def _write():
            tmp = self.dir / f".tmp_step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": {}, "extra": extra or {}}
            for i, ((name, arr), spec) in enumerate(zip(host, spec_flat)):
                fname = f"leaf_{i}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][name] = {"file": fname,
                                            "spec": _spec_to_json(spec),
                                            "dtype": str(arr.dtype)}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)           # atomic commit
            self._gc()

        if sharded:
            _write()
            dist.barrier()
        elif self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ----------------------------------------------------------------- load
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, template: Any, step: Optional[int] = None,
             mesh=None) -> tuple:
        """Restore into the structure of ``template`` (a nested dict, list
        or NamedTuple tree of tensors): each leaf comes back as a tensor of
        its stored dtype on the template leaf's device. With ``mesh`` (a
        ``DeviceMesh``) each leaf is placed on it as a DTensor by its stored
        spec, the axes the mesh lacks dropped (the elastic re-shard); a leaf
        stored without a spec takes a DTensor template leaf's placements,
        or comes back a plain tensor on the mesh's device. Returns (tree,
        step, extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_bytes())
        leaves = {}
        for path, tmpl in tu.flatten_with_keys(template):
            ent = manifest["leaves"][path_str(path)]
            x = torch.from_numpy(np.load(d / ent["file"]))
            if mesh is None:
                dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
                leaves[path] = x.to(dev)
            elif ent["spec"]:
                spec = shd.resolve_spec([tuple(a) if isinstance(a, list) else a
                                         for a in ent["spec"]], mesh)
                leaves[path] = shd.place(x, spec, mesh)
            elif shd.is_dtensor(tmpl):
                leaves[path] = shd.like(shd.local_shard(
                    x.to(mesh.device_type), tmpl.placements, mesh).clone(), tmpl)
            else:
                leaves[path] = x.to(mesh.device_type)
        return tu.rebuild(template, leaves), manifest["step"], manifest.get("extra", {})
