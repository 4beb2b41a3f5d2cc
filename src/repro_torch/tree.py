"""Nested dict/list trees of tensors, walked in JAX's leaf order.

``jax.tree_util`` flattens a dict in sorted-key order (``embed/bounds``
before ``embed/h_t``, ``head`` before ``layers``) and a list in index
order; the port's trees keep their insertion order (``FEATURE_ORDER``), so
every walk here sorts dict keys. Leaf paths join keys with "/" and write a
list index as ``[i]``, as JAX's key paths print.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """[(path, leaf)] in JAX's leaf order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_path(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_path(v, f"{prefix}[{i}]/")]
    return [(prefix[:-1], tree)]


def leaves(tree) -> List[torch.Tensor]:
    return [x for _, x in leaves_with_path(tree)]


def unflatten(tree, new_leaves):
    """A tree shaped like ``tree`` (its own key order kept) holding
    ``new_leaves``, given in JAX's leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in a tree of the same shape."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
