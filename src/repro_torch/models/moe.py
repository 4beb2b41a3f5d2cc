"""Mixture-of-Experts FFN of the port with sort-based grouped dispatch
(``repro.models.moe``).

Static shapes, the reference's dispatch exactly: each token's top-k
(token, expert) pairs are sorted by expert id (a stable sort), placed into
a fixed-capacity (E, C, d) buffer with C = max(int(T K / E x
capacity_factor), 1) (pairs past an expert's capacity go to the trash slot
E C and are dropped), run through batched expert SwiGLUs (one ``bmm`` per
matrix over the expert dim) and combined with gate weighting. Shared
experts (DeepSeek-V3) and the Switch load-balancing auxiliary loss as in
the reference.

Three hazards, pinned by ``tests/test_torch_moe.py``:

* ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk``
  promises no order, so the experts are a stable descending sort, cut at K;
* the router is bf16 operands with f32 accumulation (the f32 router weight
  cast to the activation dtype first): the rounded operands are upcast and
  multiplied in f32;
* the combine: the reference scatter-adds the pairs in sorted order in the
  activation dtype. ``index_add_`` on CUDA adds with atomics in no fixed
  order, so the port sums each token's K contributions itself in a fixed
  order, by ascending expert id (the order in which the reference's scatter
  meets them): the same sum, deterministic on every device.

No step here reads a device value on the host (no boolean-mask indexing,
``nonzero`` or ``.item()``): ``moe_ffn`` runs inside the serving step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import ctx as dctx


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype, *, device,
             batch=()) -> Dict[str, torch.Tensor]:
    """Seeded random MoE parameters with the shapes and scales of the JAX
    ``init_moe``, stacked on ``batch``: the f32 router (*batch, d, E), the
    experts (*batch, E, d, f) / (*batch, E, f, d) and the shared experts'
    SwiGLU."""
    m, d = cfg.moe, cfg.d_model
    kw = dict(device=device, dtype=dtype)
    ex = (*batch, m.num_experts)
    p = {
        "router": nn.dense_init(gen, d, m.num_experts, device=device,
                                dtype=torch.float32, scale=0.02, batch=batch),
        "w_gate": nn.dense_init(gen, d, m.d_expert, batch=ex, **kw),
        "w_up": nn.dense_init(gen, d, m.d_expert, batch=ex, **kw),
        "w_down": nn.dense_init(gen, m.d_expert, d, batch=ex, **kw),
    }
    if m.num_shared_experts:
        f = m.d_shared * m.num_shared_experts
        p["shared"] = {
            "w_gate": nn.dense_init(gen, d, f, batch=batch, **kw),
            "w_up": nn.dense_init(gen, d, f, batch=batch, **kw),
            "w_down": nn.dense_init(gen, f, d, batch=batch, **kw),
        }
    return p


def route(cfg: ModelConfig, p, xf: torch.Tensor):
    """Router probabilities (T, E) in f32 and each token's top-k experts
    and renormalised gates (T, K), ties to the lower expert id."""
    logits = xf.float() @ p["router"].to(xf.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :cfg.moe.top_k]
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, idx, gates


def _expert_counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(…, K) expert ids -> (…, n) how often each expert appears (a device
    comparison, no host read of the ids)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).sum(-2)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, s, d) -> (y, {'aux_loss'}); every one of the b s rows is
    routed and takes capacity, as in the reference. Under
    ``dist.ctx.data_parallel`` the rows are this rank's of the global
    batch: the capacity counts every data rank's rows, the pairs of lower
    data ranks take their slots first, and ``aux_loss`` is this rank's
    share of the global loss."""
    m = cfg.moe
    b, s, d = x.shape
    T = b * s
    E, K = m.num_experts, m.top_k
    C = max(int(T * dctx.n_data() * K / E * m.capacity_factor), 1)
    dev = x.device

    xf = x.reshape(T, d)
    probs, idx, gates = route(cfg, p, xf)

    # load-balancing auxiliary loss (Switch-style)
    # (every data rank holds T rows: the global means are the ranks' means
    # over n; me is this rank's share, ce the global fraction)
    me = probs.mean(0) / dctx.n_data()                            # (E,)
    ce = dctx.global_sum(_expert_counts(idx, E).float().mean(0)) / dctx.n_data()
    aux_loss = m.router_aux_coef * E * (me * ce).sum()

    # sort-based dispatch
    flat_e = idx.reshape(-1)                                      # (T K,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]                                            # sorted experts
    tok = order // K                                              # source token
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(0) - counts                            # exclusive
    pos = torch.arange(T * K, device=dev) - starts[se]            # slot in expert
    # the pairs of lower data ranks come first in the global order
    keep = pos + dctx.sum_before(counts)[se] < C
    slot = torch.where(keep, se * C + pos.clamp(0, C - 1),
                       torch.full_like(se, E * C))                # E C = trash

    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xf[tok]
    h = buf[:E * C].reshape(E, C, d)

    # batched expert SwiGLU
    g = torch.bmm(h, p["w_gate"].to(x.dtype))
    u = torch.bmm(h, p["w_up"].to(x.dtype))
    o = torch.bmm(F.silu(g) * u, p["w_down"].to(x.dtype))

    # combine: pair (t, k)'s slot and keep flag, back in token order
    slot_tk = torch.empty_like(slot)
    slot_tk[order] = slot
    keep_tk = torch.empty_like(keep)
    keep_tk[order] = keep
    gate_tk = (gates.reshape(-1) * keep_tk).to(x.dtype)
    contrib = (o.reshape(E * C, d)[slot_tk.clamp(max=E * C - 1)]
               * gate_tk[:, None]).reshape(T, K, d)
    # each token's K contributions summed by ascending expert id, in the
    # activation dtype
    by_expert = torch.argsort(idx, dim=1)
    contrib = contrib.gather(1, by_expert[..., None].expand(T, K, d))
    y = contrib[:, 0]
    for j in range(1, K):
        y = y + contrib[:, j]

    if "shared" in p:
        sp = p["shared"]
        y = y + nn.swiglu(xf, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.reshape(b, s, d), {"aux_loss": aux_loss}


def moe_ffn_dense_fallback(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The reference's oracle: every expert on every token, then the
    gate-weighted sum (O(T E) compute; tests only)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = xf.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :m.top_k]
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    g = torch.einsum("td,edf->tef", xf, p["w_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xf, p["w_up"].to(x.dtype))
    o = torch.einsum("tef,efd->ted", F.silu(g) * u, p["w_down"].to(x.dtype))
    w = torch.zeros(probs.shape, dtype=x.dtype, device=x.device)
    w.scatter_(1, idx, gates.to(x.dtype))
    y = torch.einsum("te,ted->td", w, o)
    if "shared" in p:
        sp = p["shared"]
        y = y + nn.swiglu(xf, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.reshape(b, s, d)
