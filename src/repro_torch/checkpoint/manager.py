"""Checkpoints of the port (``repro.checkpoint.manager``): atomic directory
commits, an optional async save thread, ``keep`` newest steps and
latest-step resume, in the reference's format, so a checkpoint written by
either package loads in the other.

Format: ``<dir>/step_<n>/`` holds one ``leaf_<i>.npy`` per leaf, numbered
in JAX's leaf order (dict keys sorted, lists by index), and
``manifest.json`` {"step", "leaves": {path -> {"file", "spec", "dtype"}},
"extra"}, each leaf keyed by the reference's ``path_str`` ("layers/0/wq";
a NamedTuple's fields by name, as JAX keys them: the ``AdamWState`` of a
``(params, opt_state)`` tree gives "1/step", "1/m/embed", ...). ``save``
stores the partition specs it is given as the reference does (``[]``
for a leaf without one); ``load`` places nothing on a mesh, so a stored
spec is ignored on load.
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


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=(), is_leaf=None) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in JAX's leaf order: dict keys sorted, a NamedTuple's
    fields in field order keyed by name, lists and tuples by index.
    ``is_leaf(x)`` stops the walk at ``x``."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (k,), is_leaf)]
    if _is_namedtuple(tree):
        return [kv for k in tree._fields
                for kv in _flatten(getattr(tree, k), prefix + (k,), is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (i,), is_leaf)]
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure (its own key order kept) over ``leaves`` given
    by path tuple."""
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, k), prefix + (k,))
                             for k in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (i,)) for i, v in enumerate(t))
        return leaves[prefix]
    return build(tree, ())


def _is_spec(x) -> bool:
    """A partition spec: None, or a list / plain tuple of mesh axes (each
    None, an axis name or a sequence of axis names)."""
    if x is None:
        return True
    if not isinstance(x, (list, tuple)) or _is_namedtuple(x):
        return False
    return all(a is None or isinstance(a, str)
               or (isinstance(a, (list, tuple)) and all(isinstance(n, str) for n in a))
               for a in x)


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
        flat = _flatten(tree)
        spec_flat = ([s for _, s in _flatten(specs, is_leaf=_is_spec)]
                     if specs is not None else [])
        if len(spec_flat) > len(flat):
            raise ValueError(f"specs has {len(spec_flat)} leaves but tree has "
                             f"only {len(flat)}")
        spec_flat += [None] * (len(flat) - len(spec_flat))
        host = [(path_str(p), x.detach().to("cpu", copy=True).numpy()
                 if isinstance(x, torch.Tensor) else np.array(x))
                for p, x in flat]

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
        """Restore into the structure of ``template`` (a nested dict, list
        or NamedTuple tree of tensors): each leaf comes back as a tensor of
        its stored dtype on the template leaf's device. Returns (tree,
        step, extra).
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
