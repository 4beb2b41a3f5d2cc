"""Nested dict/list trees of tensors, walked in JAX's leaf order.

``jax.tree_util`` flattens a dict in sorted-key order (``embed/bounds``
before ``embed/h_t``, ``head`` before ``layers``) and a list in index
order; the port's trees keep their insertion order (``FEATURE_ORDER``), so
every walk here sorts dict keys. Leaf paths join keys with "/" and write a
list index as ``[i]``, as JAX's key paths print. ``flatten_with_keys`` and
``rebuild`` walk the same order by key tuples (the checkpoint manifest's
and the sharding rules' paths).
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


# -- key paths (the reference's ``tree_flatten_with_path``) -------------------
# ``repro_torch.dist.sharding.path_str`` renders these as "layers/0/wq": dict
# keys and list indices bare, a NamedTuple's fields by name, as JAX keys them.

def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_keys(tree, prefix=(), is_leaf=None) -> List[Tuple[tuple, object]]:
    """[(key path, leaf)] in JAX's leaf order: dict keys sorted, a
    NamedTuple's fields in field order keyed by name, lists and tuples by
    index. ``is_leaf(x)`` stops the walk at ``x``."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_keys(tree[k], prefix + (k,), is_leaf)]
    if is_namedtuple(tree):
        return [kv for k in tree._fields
                for kv in flatten_with_keys(getattr(tree, k), prefix + (k,), is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_keys(v, prefix + (i,), is_leaf)]
    return [(prefix, tree)]


def rebuild(tree, leaves: dict, is_leaf=None):
    """``tree``'s structure (its own key order kept) over ``leaves``, a
    dict from key path to leaf."""
    def build(t, prefix):
        if is_leaf is not None and is_leaf(t):
            return leaves[prefix]
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if is_namedtuple(t):
            return type(t)(*(build(getattr(t, k), prefix + (k,)) for k in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (i,)) for i, v in enumerate(t))
        return leaves[prefix]
    return build(tree, ())
