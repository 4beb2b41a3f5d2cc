"""Dense decoder-only transformer of the port (``repro.models.
transformer``): stacked-layer init, the cache-free forward and its loss,
the dense-cache decode step, and the fused paged decode step of the
continuous-batching engine. The MoE family without MLA (granite) runs here
too, with ``models.moe.moe_ffn`` in place of the SwiGLU FFN."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.core import baselines, drrl, prng
from repro_torch.dist.ctx import logits_spec
from repro_torch.kernels.ops import decode_attention
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import attend, mhsa
from repro_torch.models.common import apply_rope, kv_group_mean, remat_layer


def init_attn(cfg: ModelConfig, gen: torch.Generator, dtype, *, device,
              batch=()) -> Dict[str, torch.Tensor]:
    """The JAX ``init_attn``'s shapes and scales, stacked on ``batch``."""
    d, dh = cfg.d_model, cfg.resolved_head_dim()
    hq, hkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    kw = dict(device=device, dtype=dtype, batch=batch)
    attn = {
        "wq": nn.dense_init(gen, d, hq * dh, **kw),
        "wk": nn.dense_init(gen, d, hkv * dh, **kw),
        "wv": nn.dense_init(gen, d, hkv * dh, **kw),
        "wo": nn.dense_init(gen, hq * dh, d,
                            scale=(hq * dh) ** -0.5 / (2 * L) ** 0.5, **kw),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            attn[name] = torch.zeros((*batch, width), dtype=dtype, device=device)
    return attn


def init_ffn(cfg: ModelConfig, gen: torch.Generator, dtype, *, device,
             d_ff: Optional[int] = None, batch=()) -> Dict[str, torch.Tensor]:
    """The JAX ``init_ffn``'s shapes and scales, stacked on ``batch``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(device=device, dtype=dtype, batch=batch)
    return {
        "w_gate": nn.dense_init(gen, d, f, **kw),
        "w_up": nn.dense_init(gen, d, f, **kw),
        "w_down": nn.dense_init(gen, f, d,
                                scale=f ** -0.5 / (2 * cfg.num_layers) ** 0.5, **kw),
    }


def ffn(cfg: ModelConfig, lp, xin) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """A block's FFN on the normed input: ``models.moe.moe_ffn`` where the
    layer's parameters hold ``moe`` (returning its aux), the SwiGLU FFN
    else (no aux)."""
    if "moe" in lp:
        return moe_mod.moe_ffn(cfg, lp["moe"], xin)
    return nn.swiglu(xin, lp["ffn"]["w_gate"], lp["ffn"]["w_up"],
                     lp["ffn"]["w_down"]), {}


def init_dense(cfg: ModelConfig, gen: torch.Generator, *,
               device="cuda") -> Dict[str, Any]:
    """Seeded random parameters with the shapes and scales of the JAX
    ``init_dense``: layers stacked on a leading L axis, matrices (in, out),
    truncated-normal fan-in init with the ``wo``/``w_down`` depth scaling;
    the MoE family (granite) has ``moe`` (``models.moe.init_moe``) where
    the dense family has ``ffn``. ``gen`` must live on ``device``."""
    dtype = nn.dt(cfg.param_dtype)
    L, d = cfg.num_layers, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "attn": init_attn(cfg, gen, dtype, device=device, batch=(L,)),
        "ln1": ones(L, d),
        "ln2": ones(L, d),
    }
    if cfg.family == "moe" and cfg.moe is not None:
        layers["moe"] = moe_mod.init_moe(cfg, gen, dtype, device=device, batch=(L,))
    else:
        layers["ffn"] = init_ffn(cfg, gen, dtype, device=device, batch=(L,))
    params = {
        "embed": nn.embed_init(gen, cfg.vocab_size, d, device=device,
                               dtype=dtype),
        "layers": layers,
        "ln_f": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.dense_init(gen, d, cfg.vocab_size,
                                          device=device, dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# Forward (the layer stack runs as a Python loop; per-layer aux is stacked
# on a leading L axis, as JAX's scan stacks it)
# ---------------------------------------------------------------------------

def _block(cfg: ModelConfig, lp, x, positions, rank_ctx, cache, chunked):
    h, new_cache, aux = mhsa(cfg, lp["attn"], nn.rms_norm(x, lp["ln1"], cfg.rms_eps),
                             positions, rank_ctx=rank_ctx, cache=cache,
                             chunked=chunked)
    x = x + h
    f, ffn_aux = ffn(cfg, lp, nn.rms_norm(x, lp["ln2"], cfg.rms_eps))
    return x + f, new_cache, {**aux, **ffn_aux}


def _aux_slim(aux: Dict[str, Any], collect: str) -> Dict[str, Any]:
    """Select which per-layer aux to keep.
    collect: 'none' | 'ranks' | 'rl' (also the agent's actions, logits,
    values, masks and features, the spectra, bounds and the serve prefill's
    qkv and mass); both keep the MoE layers' 'aux_loss'."""
    if collect == "none":
        return {}
    keep = {"rank", "delta_a_rel", "fidelity", "aux_loss"}
    if collect == "rl":
        keep |= {"action_idx", "logp", "value", "action_mask", "features",
                 "logits", "delta_a_grid", "delta_a_norm", "k_s2", "qkv",
                 "mass"}
    return {k: v for k, v in aux.items() if k in keep}


def _stack(per_layer: List[Dict[str, Any]]) -> Dict[str, Any]:
    """[{name: tensor or dict}] over layers -> {name: (L, ...) stacked}."""
    if not per_layer or not per_layer[0]:
        return {}
    return {k: (_stack([a[k] for a in per_layer]) if isinstance(v, dict)
                else torch.stack([a[k] for a in per_layer]))
            for k, v in per_layer[0].items()}


def _pick(tree, li: int):
    """Entry ``li`` of every leaf of a stacked tree (views)."""
    return ({k: _pick(v, li) for k, v in tree.items()} if isinstance(tree, dict)
            else tree[li])


def _layer(params, li: int) -> Dict[str, Any]:
    """Layer ``li``'s parameters out of the stacked tree (views)."""
    return _pick(params["layers"], li)


def _logits(params, x):
    head = params.get("lm_head")
    return x @ head.to(x.dtype) if head is not None else x @ params["embed"].to(x.dtype).T


def make_rank_ctx(cfg: ModelConfig, *, policy_params=None, h_t=None, t=0,
                  greedy=True, generator=None, proj=None, device=None,
                  compute_fidelity=False, collect_qkv=False,
                  collect_mass=False, mass_q_len=None):
    """Build the per-forward rank context (None when mode == 'off', unless
    qkv/mass capture is requested: the serve prefill collects per-layer
    k/v and the per-key attention mass from the full-rank forward). Rank
    mode 'drrl' needs the agent's ``policy_params`` and its h_t features;
    ``t`` (the RL step) anneals the guardrail, ``greedy=False`` samples
    actions from ``generator``. Rank mode 'performer' takes its feature matrices
    ``proj`` (h, m, d) from the caller, or draws them on ``device`` with
    m = max(2 dh, 4 fixed_rank) from a CPU generator seeded 42 (the
    reference draws them with ``jax.random`` at ``PRNGKey(42)``;
    ``convert.proj_from_jax`` carries those across)."""
    rcfg = cfg.rank
    if rcfg.mode == "off" and not (collect_qkv or collect_mass):
        return None
    ctx = {"cfg": rcfg, "t": t, "compute_fidelity": compute_fidelity,
           "collect_qkv": collect_qkv, "collect_mass": collect_mass,
           "mass_q_len": mass_q_len}
    if rcfg.mode == "performer":
        if proj is None:
            dh = cfg.resolved_head_dim()
            proj = baselines.orthogonal_proj(
                torch.Generator().manual_seed(42), cfg.num_heads,
                max(2 * dh, 4 * rcfg.fixed_rank), dh)
        ctx["proj"] = proj.to(device)
    if rcfg.mode == "drrl":
        if policy_params is None:
            raise ValueError("rank mode 'drrl' needs policy params (the "
                             "agent of repro_torch.core.drrl.init_agent)")
        if h_t is None:
            raise ValueError("rank mode 'drrl': pass h_t (conv features)")
        ctx["action_fn"] = drrl.make_action_fn(policy_params, rcfg, h_t=h_t,
                                               greedy=greedy,
                                               generator=generator)
    return ctx


def _rank_layer_ctx(cfg: ModelConfig, rank_ctx, lp, li: int, prev_rank,
                    power_v0, rng=None):
    """Layer ``li``'s rank context: the agent's prev_rank carry, layer
    index, (rank mode 'drrl') the layer's weight statistics w_t and (rank
    mode 'random') its ``core.prng`` key ``rng``."""
    if rank_ctx is None:
        return None
    w_t = (drrl.weight_stats(lp["attn"], cfg.rank.power_iters, v0=power_v0)
           if cfg.rank.mode == "drrl" else None)
    return dict(rank_ctx, prev_rank=prev_rank, layer_id=li, w_t=w_t, rng=rng)


def _drrl_setup(cfg: ModelConfig, params, x, policy_params, power_v0):
    """h_t from the embeddings ``x`` and the power-iteration start vectors,
    both once per call (rank mode 'drrl'; (None, None) otherwise)."""
    if cfg.rank.mode != "drrl" or policy_params is None:
        return None, None
    h_t = drrl.conv_features(x, policy_params["conv"])
    if power_v0 is None:
        power_v0 = drrl.power_starts(_layer(params, 0)["attn"])
    return h_t, power_v0


def _default_positions(cfg: ModelConfig, start: int, b: int, s: int, device):
    """start ... start+s-1 for every row: (b, s), or (b, 3, s) (the same on
    the three streams) for M-RoPE."""
    pos = (start + torch.arange(s, device=device))[None].expand(b, s)
    return pos[:, None].expand(b, 3, s) if cfg.mrope else pos


def forward_dense(cfg: ModelConfig, params, tokens, *, positions=None,
                  policy_params=None, rl_t=0, greedy: bool = True,
                  rank_generator: Optional[torch.Generator] = None,
                  rank_rng: Optional[torch.Tensor] = None,
                  proj: Optional[torch.Tensor] = None,
                  power_v0: Optional[Dict[str, torch.Tensor]] = None,
                  compute_fidelity=False, collect_aux: str = "none",
                  chunked: bool = False, collect_qkv: bool = False,
                  collect_mass: bool = False, mass_q_len=None,
                  return_hidden: bool = False,
                  extra_embeddings: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (b, s) integer, or (b, s_txt) with ``extra_embeddings`` (b,
    n, d) prepended (the VLM stub's patch embeddings), s = n + s_txt.
    Without ``positions``, 0 ... s-1, on all three streams for M-RoPE
    (``positions`` (b, 3, s) there). Returns (logits (b, s, V), aux) with
    aux['layers'] the per-layer aux selected by ``collect_aux``, stacked on
    a leading L axis, and (``return_hidden``) aux['hidden'] the final
    hidden state (b, s, d) after ``ln_f``, before the LM head.
    ``chunked`` sends every attention over more than 1024 keys through the
    ``lowrank_flash`` kernel. Every rank mode: 'off', 'fixed',
    'adaptive', 'random', 'drrl', 'performer' and 'nystrom'. In 'drrl' the
    agent (``policy_params``) picks each layer's ranks from h_t (once,
    from the embeddings), the layer's w_t and the previous layer's ranks
    (r_max before layer 0); ``rl_t`` anneals its guardrail and
    ``greedy=False`` samples from ``rank_generator``. In 'random' the
    ``core.prng`` key ``rank_rng`` is split once per layer, as JAX's scan
    splits it, and each layer draws from its half, on the key's device: a
    CPU key keeps the draws' few hundred tiny integer ops per layer off the
    card, and only each layer's (b, hkv) ranks move to it. ``proj`` is the
    'performer' feature matrices (see :func:`make_rank_ctx`).
    ``power_v0`` {'wq', 'wk', 'wv': start vector} overrides the start
    vectors of w_t's power iterations (default ``drrl.power_starts``).
    Under autograd each layer runs as ``cfg.remat`` says
    (:func:`repro_torch.models.common.remat_layer`): its rank context and
    block are recomputed in the backward ('full'), all but their matrix
    products ('dots'), or kept ('none')."""
    dtype = nn.dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    if extra_embeddings is not None:
        x = torch.cat([extra_embeddings.to(dtype), x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        positions = _default_positions(cfg, 0, b, s, x.device)
    h_t, power_v0 = _drrl_setup(cfg, params, x, policy_params, power_v0)
    rank_ctx = make_rank_ctx(cfg, policy_params=policy_params, h_t=h_t,
                             t=rl_t, greedy=greedy, generator=rank_generator,
                             proj=proj, device=x.device,
                             compute_fidelity=compute_fidelity,
                             collect_qkv=collect_qkv,
                             collect_mass=collect_mass, mass_q_len=mass_q_len)
    prev = torch.full((b, cfg.num_kv_heads), cfg.rank.rank_grid[-1],
                      dtype=torch.int32, device=x.device)
    key = rank_rng

    def layer(x, prev, lp, li, sub):
        # the reference's scan body: the layer's rank context (w_t), the
        # block and its aux, under cfg.remat
        x, _, aux = _block(cfg, lp, x, positions,
                           _rank_layer_ctx(cfg, rank_ctx, lp, li, prev,
                                           power_v0, rng=sub), None, chunked)
        return x, aux
    layer = remat_layer(cfg, layer, generators=(rank_generator,))
    aux_layers = []
    for li in range(cfg.num_layers):
        sub = None
        if rank_ctx is not None and key is not None:
            key, sub = prng.split(key)
        x, aux = layer(x, prev, _layer(params, li), li, sub)
        prev = aux.get("rank", prev)
        aux_layers.append(_aux_slim(aux, collect_aux))
    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    out_aux: Dict[str, Any] = {"layers": _stack(aux_layers)}
    if return_hidden:
        out_aux["hidden"] = x
    return _logits(params, x), out_aux


def loss_dense(cfg: ModelConfig, params, batch, **kw):
    """Mean next-token cross-entropy of ``batch`` {'tokens', 'labels'[,
    'mask']} over the last ``labels.shape[1]`` positions (the VLM passes
    its patch embeddings as ``extra_embeddings``), plus the MoE
    layers' mean auxiliary loss where ``collect_aux`` keeps it (as in the
    reference); returns (loss, aux)."""
    logits, aux = forward_dense(cfg, params, batch["tokens"], **kw)
    n_txt = batch["labels"].shape[1]
    loss = nn.softmax_cross_entropy(logits[:, -n_txt:], batch["labels"],
                                    batch.get("mask"), spec=logits_spec(cfg))
    if "aux_loss" in aux["layers"]:
        loss = loss + aux["layers"]["aux_loss"].mean()
    return loss, aux


# ---------------------------------------------------------------------------
# Dense-cache decode (caches stacked over layers)
# ---------------------------------------------------------------------------

def init_cache_dense(cfg: ModelConfig, batch: int, max_len: int, *,
                     device="cuda") -> dict:
    """{'k', 'v': (L, batch, max_len, hkv, dh) zeros, 'len': 0}."""
    dtype = nn.dt(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


def decode_step_dense(cfg: ModelConfig, params, cache, tokens, *,
                      positions=None, policy_params=None,
                      rank_rng: Optional[torch.Tensor] = None,
                      proj: Optional[torch.Tensor] = None,
                      power_v0: Optional[Dict[str, torch.Tensor]] = None,
                      chunked: bool = False):
    """One decode step: tokens (b, s_new) appended at cache['len'], at
    ``positions`` (default cache['len'] on, on all three M-RoPE streams).
    Returns (logits (b, s_new, V), new_cache); the cache tensors are
    updated in place. Rank mode 'drrl' takes the agent's greedy actions,
    h_t from this step's embeddings (``power_v0`` as in forward_dense).
    In rank mode 'random' every layer draws from ``rank_rng`` itself (the
    reference's decode step does not split it); 'performer' and 'nystrom'
    run their non-causal form over the whole cache buffer, as the
    reference's do."""
    dtype = nn.dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    b, s, _ = x.shape
    start = int(cache["len"])
    if positions is None:
        positions = _default_positions(cfg, start, b, s, x.device)
    h_t, power_v0 = _drrl_setup(cfg, params, x, policy_params, power_v0)
    rank_ctx = make_rank_ctx(cfg, policy_params=policy_params, h_t=h_t,
                             proj=proj, device=x.device)
    prev = torch.full((b, cfg.num_kv_heads), cfg.rank.rank_grid[-1],
                      dtype=torch.int32, device=x.device)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        layer_cache = {"k": cache["k"][li], "v": cache["v"][li], "len": start}
        x, _, aux = _block(cfg, lp, x, positions,
                           _rank_layer_ctx(cfg, rank_ctx, lp, li, prev,
                                           power_v0, rank_rng), layer_cache,
                           chunked)
        prev = aux.get("rank", prev)
    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return _logits(params, x), {"k": cache["k"], "v": cache["v"],
                                "len": start + s}


def decode_step_paged(cfg: ModelConfig, params, pool_k, pool_v, page_table,
                      tokens, *, slot_lens, slot_ranks=None, basis=None,
                      active=None, use_kernel: bool = False,
                      kt_pool=None, mass_pool=None,
                      q_lens=None, prefill_rows=None,
                      return_all_logits: bool = False,
                      mass_defer: bool = False):
    """One fused decode step over every serving slot of a slot-paged cache.

    Same arguments and semantics as the JAX ``decode_step_paged``:
    pool_k/pool_v (L, P, page_size, hkv, dh); page_table (n_slots, pages)
    with page 0 the scratch page; tokens (n_slots, C); slot_lens
    (n_slots,) valid prefix length BEFORE this step; slot_ranks (n_slots,)
    with basis (L, n_slots, hkv, dh, r_keep) (both None for rank mode
    'off'); active (n_slots,) bool. ``q_lens``/``prefill_rows`` select the
    mixed step (chunked prefill rows attend full-rank dense, decode rows
    read the factor-projected rank path); ``kt_pool`` (L, n_slots + 1, M,
    hkv, r_keep) is the factor-form K cache; ``mass_pool`` (L, n_slots, M,
    hkv) accumulates per-key attention mass with the in-graph cell reset.
    ``use_kernel`` routes every attention through
    :func:`repro_torch.kernels.ops.decode_attention` (with ``q_lens`` when
    C > 1: a padding query then gives exact zeros, and no caller reads
    it).

    Speculative verify: ``return_all_logits`` keeps every query's logits,
    (n_slots, C, V). ``mass_defer`` (rank path, no ``mass_pool``) returns
    each query's attention mass under ``pools["mass_q"]`` (L, n_slots, C,
    M, hkv) instead of adding it, so the caller applies only the accepted
    queries (``serve.spec.apply_deferred_mass``).

    The pools are updated IN PLACE and returned in the ``pools`` dict. The
    JAX engine donates these buffers to the step (engine.py:218), so no
    caller holds their old values; in place is the same contract without
    the copy. Dead lanes and padding columns write to scratch page 0 and
    scratch kt row n_slots, in no defined order.

    Returns (logits (n_slots, 1, V), pools): for C > 1 only each row's
    last valid query feeds the LM head, unless ``return_all_logits``."""
    if cfg.mrope:
        raise ValueError("paged decode does not support M-RoPE streams")
    if (slot_ranks is None) != (basis is None):
        raise ValueError("slot_ranks and basis must be given together")
    if (kt_pool is not None or mass_pool is not None) and slot_ranks is None:
        raise ValueError("kt_pool/mass_pool require the rank path")
    if mass_defer and slot_ranks is None:
        raise ValueError("mass_defer requires the rank path")
    if mass_defer and mass_pool is not None:
        raise ValueError("mass_defer and mass_pool are mutually exclusive: "
                         "deferred contributions are applied by the caller")
    dev = tokens.device
    dtype = nn.dt(cfg.dtype)
    tokens = tokens.long()
    page_table = page_table.long()
    slot_lens = slot_lens.long()
    x = params["embed"][tokens].to(dtype)                    # (ns, C, d)
    ns, C = tokens.shape
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim()
    d = cfg.d_model
    n_rep = hq // hkv
    ps = pool_k.shape[2]
    n_pp = page_table.shape[1]
    M = n_pp * ps
    rank_path = cfg.rank.mode != "off" and slot_ranks is not None
    # the pure-decode form keeps the lean factor-only read; the mixed form
    # builds both score reads and selects per row
    mixed = prefill_rows is not None
    if active is None:
        active = torch.ones((ns,), dtype=torch.bool, device=dev)
    q_lens = (torch.ones((ns,), dtype=torch.long, device=dev) if q_lens is None
              else q_lens.long())
    is_pf = (torch.zeros((ns,), dtype=torch.bool, device=dev)
             if prefill_rows is None else prefill_rows & active)
    j_idx = torch.arange(C, device=dev)[None, :]              # (1, C)
    m_idx = torch.arange(M, device=dev)[None, :]              # (1, M)
    positions = slot_lens[:, None] + j_idx                    # (ns, C)
    # physical write coordinates (scratch for dead lanes and padding)
    write_ok = (j_idx < q_lens[:, None]) & active[:, None]
    pg = torch.clamp(positions // ps, max=n_pp - 1)
    zero = torch.zeros_like(positions)
    phys = torch.where(write_ok, page_table.gather(1, pg), zero)
    off = torch.where(write_ok, positions % ps, zero)
    kv_end = slot_lens + q_lens                               # keys after write
    # per-(row, query) visible length; padding queries clamp to the last
    # valid query's window
    kv_len_q = (slot_lens[:, None]
                + torch.minimum(j_idx, q_lens[:, None] - 1) + 1)  # (ns, C)
    valid = m_idx < kv_end[:, None]                           # (ns, M)
    vmask = valid[:, :, None, None]
    # slot-indexed factor rows: padding / dead lanes land on scratch row ns
    slot_rows = torch.where(write_ok, torch.arange(ns, device=dev)[:, None],
                            torch.full_like(positions, ns))
    slot_pos = torch.where(write_ok, torch.clamp(positions, max=M - 1), zero)
    # a position's mass cell is reset exactly once: in the step appending it
    new_cell = valid & (m_idx >= slot_lens[:, None]) & active[:, None]
    score_dtype = nn.dt(cfg.softmax_dtype)
    scale = dh ** -0.5
    if rank_path:
        r_keep = basis.shape[-1]
        col_ok = (torch.arange(r_keep, device=dev)[None, :]
                  < torch.clamp(slot_ranks.long(), max=r_keep)[:, None]
                  ).float()                                   # (ns, r_keep)
    mass_q = (torch.empty((cfg.num_layers, ns, C, M, hkv), device=dev)
              if mass_defer else None)
    lay = params["layers"]
    for li in range(cfg.num_layers):
        p = {name: t[li] for name, t in lay["attn"].items()}
        h = nn.rms_norm(x, lay["ln1"][li], cfg.rms_eps)
        q = (h @ p["wq"].to(x.dtype)).reshape(ns, C, hq, dh)
        k = (h @ p["wk"].to(x.dtype)).reshape(ns, C, hkv, dh)
        v = (h @ p["wv"].to(x.dtype)).reshape(ns, C, hkv, dh)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(hq, dh).to(x.dtype)
            k = k + p["bk"].reshape(hkv, dh).to(x.dtype)
            v = v + p["bv"].reshape(hkv, dh).to(x.dtype)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kp, vp = pool_k[li], pool_v[li]                       # views: in place
        kp[phys, off] = k.to(kp.dtype)
        vp[phys, off] = v.to(vp.dtype)
        vg = vp[page_table].reshape(ns, M, hkv, dh)
        if not rank_path:
            kg = kp[page_table].reshape(ns, M, hkv, dh)
            q_use, k_use = q, kg * vmask.to(kg.dtype)
        else:
            # project q onto the slot's segment eigenbasis; per-row rank =
            # zeroed q columns beyond the slot's bucket
            basis_l = basis[li]                               # (ns, hkv, dh, r)
            b_q = basis_l.repeat_interleave(n_rep, dim=1) if n_rep > 1 else basis_l
            q_proj = (torch.einsum("bshd,bhdr->bshr", q.float(), b_q)
                      * col_ok[:, None, None, :]).to(x.dtype)
            if kt_pool is not None:
                # factor-form cache: append the new tokens' factors, read
                # the slot-indexed factors (r/d of the dense K bytes)
                ktp = kt_pool[li]
                kt_new = torch.einsum("bshd,bhdr->bshr", k.float(), basis_l)
                ktp[slot_rows, slot_pos] = kt_new.to(ktp.dtype)
                ktg = ktp[:ns]                                # (ns, M, hkv, r)
                k_fac = (ktg * vmask.to(ktg.dtype)).to(x.dtype)
            else:
                kg = kp[page_table].reshape(ns, M, hkv, dh)
                k_masked = kg * vmask.to(kg.dtype)
                k_fac = torch.einsum("bmhd,bhdr->bmhr", k_masked.float(),
                                     basis_l).to(x.dtype)
            if not mixed:
                q_use, k_use = q_proj, k_fac
            else:
                # mid-prefill rows attend full-rank dense; decode rows keep
                # the factor read, zero-padded to head-dim width
                kg = kp[page_table].reshape(ns, M, hkv, dh)
                k_dense = kg * vmask.to(kg.dtype)
                pf = is_pf[:, None, None, None]
                q_use = torch.where(pf, q, F.pad(q_proj, (0, dh - r_keep)))
                k_use = torch.where(pf, k_dense, F.pad(k_fac, (0, dh - r_keep)))
        want_probs = mass_pool is not None or mass_defer
        if use_kernel:
            qk = q_use.transpose(1, 2)                        # (ns, hq, C, r)
            chunk = mixed or C > 1
            res = decode_attention(
                (qk if chunk else qk[:, :, 0]).contiguous(),
                k_use.transpose(1, 2).contiguous(),           # (ns, hkv, M, r)
                vg.transpose(1, 2).contiguous(),              # (ns, hkv, M, dh)
                kv_end, scale=scale, q_start=slot_lens,
                q_lens=q_lens if chunk else None, return_probs=want_probs)
            o, probs = res if want_probs else (res, None)
            if o.dim() == 3:
                o = o[:, :, None]
                probs = None if probs is None else probs[:, :, None]
            o = o.transpose(1, 2)                             # (ns, C, hq, dh)
        else:
            res = attend(q_use, k_use, vg, scale=scale, causal=False,
                         kv_len=kv_len_q[:, None, :, None],
                         score_dtype=score_dtype, return_probs=want_probs)
            o, probs = res if want_probs else (res, None)
        if mass_pool is not None:
            # per-key attention mass: group-mean over each kv head's q
            # heads, masked to live lanes and valid queries; cells appended
            # this step are reset before the add
            w = (probs.float() * write_ok[:, None, :, None]).sum(dim=2)
            w_tok = kv_group_mean(w, hkv)                     # (ns, hkv, M)
            mp = mass_pool[li]
            mass_pool[li] = (mp.masked_fill(new_cell[:, :, None], 0.0)
                             + w_tok.transpose(1, 2).to(mp.dtype))
        if mass_defer:
            # per-query mass, not summed over the chunk: the caller adds
            # the accepted queries only
            wq = probs.float() * write_ok[:, None, :, None]   # (ns, hq, C, M)
            wq = kv_group_mean(wq.transpose(1, 2), hkv)       # (ns, C, hkv, M)
            mass_q[li] = wq.transpose(2, 3)                   # (ns, C, M, hkv)
        x = x + o.reshape(ns, C, hq * dh) @ p["wo"].to(x.dtype)
        # an MoE FFN routes every row, idle slots and padding queries too:
        # they take capacity exactly as in the reference's step
        f, _ = ffn(cfg, {k: _pick(lay[k], li) for k in ("ffn", "moe") if k in lay},
                   nn.rms_norm(x, lay["ln2"][li], cfg.rms_eps))
        x = x + f
    if C > 1 and not return_all_logits:
        # only each row's last valid query feeds the LM head
        x = x.gather(1, (q_lens - 1)[:, None, None].expand(ns, 1, d))
    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = _logits(params, x)
    pools = {"k": pool_k, "v": pool_v}
    if kt_pool is not None:
        pools["kt"] = kt_pool
    if mass_pool is not None:
        pools["mass"] = mass_pool
    if mass_q is not None:
        pools["mass_q"] = mass_q
    return logits, pools
