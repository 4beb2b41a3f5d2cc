"""Shared model components of the port: RoPE (M-RoPE too), the GQA head
maps, the dense KV-cache append and the per-layer activation
checkpointing of ``cfg.remat`` (the reference's ``jax.checkpoint`` around
a layer stack's scan body)."""
from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as tu


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (b, s, h, d); positions: (b, s) integer. Rotate-half RoPE in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    angles = positions[..., None].float() * freqs           # (b, s, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, ...], theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE. x: (b, s, h, d); positions3: (b, 3, s) for the (t,
    h, w) streams. ``sections`` counts *frequency pairs* per stream and sums
    to d/2: the first sections[0] pairs rotate by t, the next sections[1] by
    h, the last by w. Rotate-half in f32, as :func:`apply_rope`."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to d/2 = {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    sel = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                     for i, n in enumerate(sections)])      # stream of each pair
    pos = positions3.float().index_select(1, sel)           # (b, d/2, s)
    angles = pos.transpose(1, 2) * freqs                    # (b, s, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, kv, d) -> (b, s, kv*n_rep, d) for GQA."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def kv_group_mean(w: torch.Tensor, hkv: int) -> torch.Tensor:
    """(..., hq, K) per-q-head key weights -> (..., hkv, K) mean per kv
    group: the inverse reduction of :func:`repeat_kv`."""
    hq, K = w.shape[-2], w.shape[-1]
    return w.reshape(*w.shape[:-2], hkv, hq // hkv, K).mean(dim=-2)


def cache_update(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Append k/v (b, s_new, kv, d) at ``cache['len']`` (an int) of a dense
    cache {'k', 'v': (b, max_len, kv, d), 'len'}. The cache tensors are
    written IN PLACE (JAX returns updated copies; no caller of the port
    keeps the old values) and returned with the advanced length."""
    idx, s_new = int(cache["len"]), k_new.shape[1]
    if idx + s_new > cache["k"].shape[1]:
        raise ValueError(f"cache holds {cache['k'].shape[1]} positions, "
                         f"appending {s_new} at {idx}")
    cache["k"][:, idx:idx + s_new] = k_new.to(cache["k"].dtype)
    cache["v"][:, idx:idx + s_new] = v_new.to(cache["v"].dtype)
    return {"k": cache["k"], "v": cache["v"], "len": idx + s_new}


# ---------------------------------------------------------------------------
# Activation checkpointing (``cfg.remat``)
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "full", "dots")

# what a ``dot_general`` reaches the dispatcher as in eager PyTorch: the ops
# that ``@``, ``linear``, ``matmul`` and ``einsum`` lower to
_DOT_OPS = frozenset({
    torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
    torch.ops.aten.baddbmm, torch.ops.aten.addbmm, torch.ops.aten.mv,
    torch.ops.aten.addmv, torch.ops.aten.dot, torch.ops.aten.vdot})


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots``: every matrix product's
    output saved, every other op recomputed."""
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXTS = functools.partial(create_selective_checkpoint_contexts, _save_dots)


def remat_layer(cfg, body: Callable,
                generators: Iterable[Optional[torch.Generator]] = ()) -> Callable:
    """``body`` as the reference's ``jax.checkpoint(body, policy=...)`` wraps
    a layer stack's scan body, by ``cfg.remat``: 'none' returns ``body``;
    'full' runs each call under ``torch.utils.checkpoint.checkpoint``
    (non-reentrant), so the backward keeps only the call's inputs and runs
    ``body`` again; 'dots' does the same with selective checkpointing that
    saves every matrix product (``_save_dots``) and recomputes the rest.

    A call that autograd records nothing of (grad mode off, or no tensor
    among its arguments requiring grad) runs ``body`` directly, as JAX's
    checkpoint changes nothing without a gradient: serving, decoding and
    every grad-free forward are untouched.

    ``generators`` are the explicit ``torch.Generator`` s that ``body``
    draws from (rank mode 'drrl''s sampled actions). Checkpointing restores
    only the global CPU and CUDA generators for its recompute, so each call
    records their states as it starts and sets them back for the recompute
    (then returns them to where the backward found them): the recompute
    draws what the forward drew. Kernels called through ctypes are opaque
    to the dispatcher, so 'dots' cannot save their outputs: they run again
    in the recompute (``lowrank_flash``'s forward, once per call)."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"remat {cfg.remat!r}: not one of {REMAT_MODES}")
    if cfg.remat == "none":
        return body
    gens = [g for g in generators if g is not None]
    context = {"context_fn": _DOTS_CONTEXTS} if cfg.remat == "dots" else {}

    def call(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(x, torch.Tensor) and x.requires_grad for x in tu.leaves(args))):
            return body(*args)
        start = [g.get_state() for g in gens]
        first = True

        def region(*a):
            nonlocal first
            if first:
                first = False
                return body(*a)
            now = [g.get_state() for g in gens]
            for g, s in zip(gens, start):
                g.set_state(s)
            try:
                return body(*a)
            finally:
                for g, s in zip(gens, now):
                    g.set_state(s)
        return checkpoint(region, *args, use_reentrant=False, **context)
    return call
