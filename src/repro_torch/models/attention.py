"""Multi-head attention of the port with DR-RL dynamic low-rank score
contraction (``repro.models.attention``).

Three realisations of the paper's technique live here:
  * full-rank reference (rank.mode == 'off')
  * 'masked' — rank expressed by zeroing eigendirections of q and k
  * 'static' — rank-r factors q~, k~ (the serving bucket), whose score
    contraction runs over r

Both reach the port's attention kernels through ``attend`` wherever the
JAX model takes its flash-semantics branch (``chunked`` and more than
``chunk`` keys): ``flash_decode`` for a call of at most 16 queries (the
dense cache's decodes, K/V read in place from the cache), ``lowrank_flash``
for the rest and, with its backward kernel, for every call a training
step differentiates. Rank modes 'performer' and 'nystrom' replace the whole
score/softmax/value core by the static baselines of ``core/baselines.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig, RankConfig
from repro_torch.core import baselines
from repro_torch.core import lowrank as lr
from repro_torch.core import perturbation as pert
from repro_torch.core import prng
from repro_torch.dist import ctx as dctx
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_mrope, apply_rope, cache_update,
                                       kv_group_mean, repeat_kv)


# ---------------------------------------------------------------------------
# Score/softmax/value core
# ---------------------------------------------------------------------------

def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, causal: bool, q_offset: int = 0,
           kv_len=None, chunked: bool = False, chunk: int = 1024,
           score_dtype=torch.float32, return_probs: bool = False):
    """softmax(q k^T * scale) v.

    q: (b, sq, hq, dq)  k: (b, skv, hkv, dq)  v: (b, skv, hkv, dv), hq a
    multiple of hkv (each kv head serves hq // hkv q heads). ``dq`` may be
    a truncated rank r (the caller supplies the scale). ``kv_len``
    (broadcastable to (b, h, sq, 1)) masks out positions >= kv_len.
    ``score_dtype=torch.bfloat16`` keeps the score chain in bf16 with the
    denominator accumulated in f32. ``return_probs`` also returns the
    probabilities (b, hq, sq, skv).

    ``chunked`` with more than ``chunk`` keys takes flash semantics, as in
    JAX, through :func:`repro_torch.kernels.ops.flash_attention`, K/V
    unrepeated: at most 16 queries (a dense-cache decode) go to the
    ``flash_decode`` kernel on CUDA tensors, which reads K/V in place
    through their strides; more go to ``lowrank_flash`` on contiguous
    copies. A call that autograd records (a training step's
    ``loss(chunked=True)``) goes to ``lowrank_flash`` whatever the number
    of queries, with its backward kernel on the card (f32 or bf16), so the
    branch is differentiable as JAX's ``_attend_chunked`` is. With a cache,
    ``kv_len`` must be an int and the kernel reads the valid prefix of
    K/V. That branch never materialises probabilities."""
    if chunked and k.shape[1] > chunk:
        if return_probs:
            raise ValueError("return_probs is unsupported on the chunked "
                             "path (probs are never materialised)")
        if kv_len is not None:
            # masking keys >= kv_len is reading only the first kv_len keys
            k, v = k[:, :int(kv_len)], v[:, :int(kv_len)]
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale=scale, causal=causal,
                                q_offset=q_offset)
        return o.transpose(1, 2)
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(score_dtype) * scale
    sq, skv = q.shape[1], k.shape[1]
    neg = -1e30        # a Python scalar: torch.where takes it without a copy
    k_pos = torch.arange(skv, device=q.device)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        s = torch.where(k_pos[None, :] <= q_pos, s, neg)
    if kv_len is not None:
        s = torch.where(k_pos < kv_len, s, neg)
    if score_dtype == torch.float32:
        p = torch.softmax(s, dim=-1).to(v.dtype)
    else:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        denom = e.float().sum(dim=-1, keepdim=True)
        p = (e / denom.clamp_min(1e-30).to(score_dtype)).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return (out, p) if return_probs else out


# ---------------------------------------------------------------------------
# Rank decision + projection
# ---------------------------------------------------------------------------

def spectral_ctx(q: torch.Tensor, k: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-head Gram spectra of q (b, s, hq, d) and k (b, s, hkv, d):
    sigmas (b, h, d) descending, evecs (b, h, d, d)."""
    q_s2, q_e = lr.gram_spectrum(lr.gram(q.transpose(1, 2)))
    k_s2, k_e = lr.gram_spectrum(lr.gram(k.transpose(1, 2)))
    return {"q_s2": q_s2, "q_e": q_e, "k_s2": k_s2, "k_e": k_e}


def grid_array(rank_cfg: RankConfig, device=None) -> torch.Tensor:
    return torch.tensor(rank_cfg.rank_grid, dtype=torch.int32, device=device)


def heuristic_rank(rank_cfg: RankConfig, ctx: Dict[str, torch.Tensor],
                   rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank per (b, hkv) for the modes 'fixed', 'adaptive' and 'random'
    (a uniform grid draw from the ``core.prng`` key ``rng``: JAX's
    ``randint`` bits, drawn on the key's device; only the ranks move to
    the spectra's)."""
    k_s2 = ctx["k_s2"]
    grid = rank_cfg.rank_grid
    if rank_cfg.mode == "fixed":
        return torch.full(k_s2.shape[:2], rank_cfg.fixed_rank,
                          dtype=torch.int32, device=k_s2.device)
    if rank_cfg.mode == "adaptive":
        return lr.rank_for_energy(k_s2, rank_cfg.energy_threshold,
                                  grid[0], grid[-1])
    if rank_cfg.mode == "random":
        if rng is None:
            raise ValueError("rank mode 'random' needs a PRNG key (rank_rng)")
        # this rank's rows of the global batch's draw
        b, hkv = k_s2.shape[:2]
        idx = dctx.my_rows(prng.randint(rng, (b * dctx.n_data(), hkv), 0, len(grid)))
        return grid_array(rank_cfg, rng.device)[idx.long()].to(k_s2.device)
    raise ValueError(rank_cfg.mode)


def apply_rank_masked(q, k, ctx, rank_q: torch.Tensor, rank_k: torch.Tensor):
    """Project q/k onto their top-rank eigendirections ('masked'
    realisation). rank_q: (b, hq); rank_k: (b, hkv)."""
    d = q.shape[-1]
    mq = lr.rank_mask(d, rank_q)
    mk = lr.rank_mask(d, rank_k)
    q_r = lr.project_masked(q.transpose(1, 2), ctx["q_e"], mq)
    k_r = lr.project_masked(k.transpose(1, 2), ctx["k_e"], mk)
    return q_r.transpose(1, 2), k_r.transpose(1, 2)


def apply_rank_static(q, k, ctx, r: int):
    """Rank-r factors for the serving bucket: q~ (b, s, hq, r), k~ (b, s,
    hkv, r) with q~ k~^T == Q_r K_r^T (both sides truncated)."""
    n_rep = q.shape[2] // k.shape[2]
    eq, ek = ctx["q_e"], ctx["k_e"]
    ek_rep = ek.repeat_interleave(n_rep, dim=1) if n_rep > 1 else ek
    m = lr.mixing_matrix(eq, ek_rep, r)              # (b, hq, r, r)
    q_t = lr.project_static(q.transpose(1, 2), eq, r)  # (b, hq, s, r)
    q_t = torch.einsum("bhsr,bhrt->bhst", q_t.float(), m).to(q.dtype)
    k_t = lr.project_static(k.transpose(1, 2), ek, r)  # (b, hkv, s, r)
    return q_t.transpose(1, 2), k_t.transpose(1, 2)


# ---------------------------------------------------------------------------
# Full MHSA layer (projection + rope + rank logic + attend + output proj)
# ---------------------------------------------------------------------------

def mhsa(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
         positions: torch.Tensor, *,
         rank_ctx: Optional[Dict[str, Any]] = None,
         cache: Optional[dict] = None,
         chunked: bool = False) -> Tuple[torch.Tensor, Optional[dict], Dict[str, Any]]:
    """Standard/GQA MHSA with optional dynamic low-rank scores.

    rank_ctx (None = full rank): {'cfg': RankConfig, 'compute_fidelity',
    'collect_qkv', 'collect_mass', 'mass_q_len', 'rng'} and, in rank mode
    'drrl', 'action_fn' with the per-layer 'prev_rank', 'layer_id', 'w_t'
    and 't' it reads, in 'performer' the feature matrices 'proj' (see
    :func:`repro_torch.models.transformer.make_rank_ctx`); the agent's
    outputs join ``aux``. ``cache`` is a
    dense layer cache {'k', 'v', 'len'} (updated in place). With
    ``cfg.mrope``, ``positions`` are the (b, 3, s) M-RoPE streams.
    Returns (output, new_cache, aux)."""
    rcfg = rank_ctx["cfg"] if rank_ctx else None
    b, s, d = x.shape
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim()
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, hq, dh)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, hkv, dh)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, hkv, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(hq, dh).to(x.dtype)
        k = k + p["bk"].reshape(hkv, dh).to(x.dtype)
        v = v + p["bv"].reshape(hkv, dh).to(x.dtype)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    q_offset, kv_len, new_cache = 0, None, None
    if cache is not None:
        q_offset = int(cache["len"])
        new_cache = cache_update(cache, k, v)
        k_full, v_full = new_cache["k"], new_cache["v"]
        kv_len = new_cache["len"]
    else:
        k_full, v_full = k, v

    aux: Dict[str, Any] = {}
    scale = dh ** -0.5
    if rank_ctx is not None and rank_ctx.get("collect_qkv", False):
        # qkv capture works in every rank mode, 'off' included (the serve
        # prefill seeds its pools from the full-rank forward)
        aux["qkv"] = {"q": q, "k": k_full, "v": v_full}
    score_dtype = nn.dt(cfg.softmax_dtype)

    if rcfg is not None and rcfg.mode in ("performer", "nystrom"):
        # static linear-attention baselines (the paper's comparison set);
        # with a cache (decode) both run their non-causal form, as in JAX
        n_rep = hq // hkv
        kr, vr = repeat_kv(k_full, n_rep), repeat_kv(v_full, n_rep)
        if rcfg.mode == "performer":
            o = baselines.performer_attention(q, kr, vr, proj=rank_ctx["proj"],
                                              causal=cache is None)
        else:
            o = baselines.nystrom_attention(q, kr, vr,
                                            n_landmarks=rcfg.fixed_rank,
                                            causal=cache is None)
        out = o.reshape(b, s, hq * dh) @ p["wo"].to(x.dtype)
        return out, new_cache, aux

    if rcfg is None or rcfg.mode == "off":
        q_use, k_use = q, k_full
    else:
        ctx = spectral_ctx(q, k_full)
        aux["k_s2"] = ctx["k_s2"]
        if rcfg.mode == "drrl":
            rank_k, drrl_aux = rank_ctx["action_fn"](ctx, rank_ctx)
            aux.update(drrl_aux)
        else:
            rank_k = heuristic_rank(rcfg, ctx, rank_ctx.get("rng"))
        n_rep = hq // hkv
        rank_q = rank_k.repeat_interleave(n_rep, dim=1) if n_rep > 1 else rank_k
        aux["rank"] = rank_k
        q_s2_kv = (ctx["q_s2"].reshape(b, hkv, n_rep, dh).mean(2)
                   if hq != hkv else ctx["q_s2"])
        bounds, norm = pert.guardrail_report(q_s2_kv, ctx["k_s2"],
                                             rcfg.rank_grid, dh)
        aux["delta_a_grid"] = bounds
        aux["delta_a_norm"] = norm
        if rcfg.realisation == "static":
            r = rcfg.static_rank or int(rcfg.rank_grid[-1])
            q_use, k_use = apply_rank_static(q, k_full, ctx, r)
        else:
            q_use, k_use = apply_rank_masked(q, k_full, ctx, rank_q, rank_k)
        if rcfg.truncate_values and rcfg.realisation == "masked":
            # value-side truncation (paper Eq. 5/10): V projected onto its
            # own top-rank eigenbasis
            _, v_e = lr.gram_spectrum(lr.gram(v_full.transpose(1, 2)))
            mv = lr.rank_mask(v_full.shape[-1], rank_k)
            v_full = lr.project_masked(v_full.transpose(1, 2), v_e,
                                       mv).transpose(1, 2)
        if rank_ctx.get("compute_fidelity", False):
            # cosine similarity between full-rank and low-rank outputs (Eq. 8)
            aux["_o_full"] = attend(q, k_full, v_full, scale=scale,
                                    causal=True, q_offset=q_offset,
                                    kv_len=kv_len, chunked=chunked)

    if rank_ctx is not None and rank_ctx.get("collect_mass", False):
        # per-key attention mass off the output's own softmax chain: summed
        # over valid queries, group-meaned over each kv head's q heads
        o, pr = attend(q_use, k_use, v_full, scale=scale, causal=True,
                       q_offset=q_offset, kv_len=kv_len, chunked=chunked,
                       score_dtype=score_dtype, return_probs=True)
        prf = pr.float()                           # (b, hq, sq, skv)
        mql = rank_ctx.get("mass_q_len")
        if mql is not None:
            # padded-bucket prefill: padding queries scatter no mass
            q_ok = (torch.arange(prf.shape[2], device=prf.device) < mql).float()
            prf = prf * q_ok[None, None, :, None]
        aux["mass"] = kv_group_mean(prf.sum(dim=2), hkv)
    else:
        o = attend(q_use, k_use, v_full, scale=scale, causal=True,
                   q_offset=q_offset, kv_len=kv_len, chunked=chunked,
                   score_dtype=score_dtype)
    if "_o_full" in aux:
        of, ol = aux.pop("_o_full").float(), o.float()
        num = (of * ol).sum(dim=(1, 3))
        den = (torch.linalg.vector_norm(of, dim=(1, 3))
               * torch.linalg.vector_norm(ol, dim=(1, 3)) + 1e-30)
        aux["fidelity"] = num / den                # (b, hq) cosine sim
    out = o.reshape(b, s, hq * dh) @ p["wo"].to(x.dtype)
    return out, new_cache, aux


def attention_flops(seq: int, kv: int, hq: int, dh: int, dv: int,
                    rank=None) -> float:
    """MAC-counted (x2) attention score+value FLOPs per sequence per head
    set. With rank-r scores the QK^T contraction runs over r instead of dh."""
    c = rank if rank is not None else dh
    return 2.0 * hq * (seq * kv * c + seq * kv * dv)
