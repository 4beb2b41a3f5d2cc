"""Checkpoints of the port (``repro.checkpoint.manager``): atomic directory
commits, an optional async save thread, ``keep`` newest steps and
latest-step resume, in the reference's format, so a checkpoint written by
either package loads in the other.

Format: ``<dir>/step_<n>/`` holds one ``leaf_<i>.npy`` per leaf, numbered
in JAX's leaf order (dict keys sorted, lists by index), and
``manifest.json`` {"step", "leaves": {path -> {"file", "spec", "dtype"}},
"extra"}, each leaf keyed by the reference's ``path_str`` ("layers/0/wq").
The port stores no partition spec (``[]``, what the reference writes
without specs); a spec in a JAX checkpoint is ignored on load.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import not_ported


def path_str(path: Sequence[Any]) -> str:
    """Stable string form of a tree path, ``repro.dist.sharding.path_str``:
    dict keys, sequence indices, attribute names and flattened indices all
    render as their bare token, joined by '/'. Entries are JAX key objects
    (with ``key``, ``idx`` or ``name``) or the port's plain str / int."""
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


def _flatten(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in JAX's leaf order: dict keys sorted, lists and
    tuples by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure (its own key order kept) over ``leaves`` given
    by path tuple."""
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (i,)) for i, v in enumerate(t))
        return leaves[prefix]
    return build(tree, ())


class CheckpointManager:
    def __init__(self, directory, async_save: bool = True, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.async_save = async_save
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        """Blocks only to copy the leaves to host memory; the file writes
        may run on a thread (``async_save``)."""
        self.wait()
        host = [(path_str(p), x.detach().to("cpu", copy=True).numpy()
                 if isinstance(x, torch.Tensor) else np.array(x))
                for p, x in _flatten(tree)]

        def _write():
            tmp = self.dir / f".tmp_step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": {}, "extra": extra or {}}
            for i, (name, arr) in enumerate(host):
                fname = f"leaf_{i}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][name] = {"file": fname, "spec": [],
                                            "dtype": str(arr.dtype)}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)           # atomic commit
            self._gc()

        if self.async_save:
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
        """Restore into the structure of ``template`` (a nested dict/list
        tree of tensors): each leaf comes back as a tensor of its stored
        dtype on the template leaf's device. Returns (tree, step, extra).
        The reference's re-shard onto a mesh is not ported."""
        if mesh is not None:
            raise not_ported("checkpoint load onto a device mesh", "item 19")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_bytes())
        leaves = {}
        for path, tmpl in _flatten(template):
            ent = manifest["leaves"][path_str(path)]
            arr = np.load(d / ent["file"])
            dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
            leaves[path] = torch.from_numpy(arr).to(dev)
        return _rebuild(template, leaves), manifest["step"], manifest.get("extra", {})
