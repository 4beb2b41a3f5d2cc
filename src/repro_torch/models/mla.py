"""Multi-head Latent Attention (DeepSeek-V3) of the port with the DR-RL
rank composition (``repro.models.mla``).

MLA is itself a static low-rank compression of the KV path (kv_lora_rank);
DR-RL truncates the score contraction of the assembled per-head q/k (width
qk_nope + qk_rope = 192 at full width) on top. Under 'masked' ranks that
contraction stays 192 wide (the directions beyond r are zeroed, not
dropped), so the chunked forward reaches ``lowrank_flash`` at r = 192.
Decode uses the absorbed formulation: the cache holds only the
(kv_lora + rope) latent per token.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (apply_rank_masked, attend,
                                          heuristic_rank, spectral_ctx)
from repro_torch.models.common import apply_rope


def init_mla(cfg: ModelConfig, gen: torch.Generator, dtype, *, device,
             batch=()) -> Dict[str, torch.Tensor]:
    """The JAX ``init_mla``'s shapes and scales, stacked on ``batch``."""
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(device=device, dtype=dtype, batch=batch)
    return {
        "wq_a": nn.dense_init(gen, d, m.q_lora_rank, **kw),
        "q_norm": torch.ones((*batch, m.q_lora_rank), dtype=dtype, device=device),
        "wq_b": nn.dense_init(gen, m.q_lora_rank, h * qk, **kw),
        "wkv_a": nn.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, **kw),
        "kv_norm": torch.ones((*batch, m.kv_lora_rank), dtype=dtype, device=device),
        "wkv_b": nn.dense_init(gen, m.kv_lora_rank,
                               h * (m.qk_nope_head_dim + m.v_head_dim), **kw),
        "wo": nn.dense_init(gen, h * m.v_head_dim, d,
                            scale=(h * m.v_head_dim) ** -0.5
                            / (2 * cfg.num_layers) ** 0.5, **kw),
    }


def _project_q(cfg: ModelConfig, p, x, positions):
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    q_lat = nn.rms_norm(nn.linear(x, p["wq_a"]), p["q_norm"], cfg.rms_eps)
    q = nn.linear(q_lat, p["wq_b"]).reshape(
        b, s, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latent(cfg: ModelConfig, p, x, positions):
    """The normalised KV latent (b, s, kv_lora) and the roped shared key
    (b, s, 1, rope)."""
    m = cfg.mla
    c_kv, k_rope = nn.linear(x, p["wkv_a"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = nn.rms_norm(c_kv, p["kv_norm"], cfg.rms_eps)
    return c_kv, apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)


def mla_train(cfg: ModelConfig, p, x, positions, *,
              rank_ctx: Optional[Dict[str, Any]] = None,
              chunked: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Training/prefill path (non-absorbed): per-head k/v materialised,
    k_rope broadcast over the heads, scale (nope + rope)^-0.5. With a rank
    mode other than 'off' the per-head q/k Grams' eigenbases (192 x 192 at
    full width) mask both to each head's rank ('masked' realisation)."""
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c_kv, k_rope = _latent(cfg, p, x, positions)
    kvb = nn.linear(c_kv, p["wkv_b"]).reshape(
        b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvb.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    aux: Dict[str, Any] = {}
    rcfg = rank_ctx["cfg"] if rank_ctx else None
    if rcfg is not None and rcfg.mode != "off":
        ctx = spectral_ctx(q, k)
        aux["k_s2"] = ctx["k_s2"]
        if rcfg.mode == "drrl":
            rank_k, drrl_aux = rank_ctx["action_fn"](ctx, rank_ctx)
            aux.update(drrl_aux)
        else:
            rank_k = heuristic_rank(rcfg, ctx, rank_ctx.get("rng"))
        aux["rank"] = rank_k
        q, k = apply_rank_masked(q, k, ctx, rank_k, rank_k)
    o = attend(q, k, v, scale=scale, causal=True, chunked=chunked,
               score_dtype=nn.dt(cfg.softmax_dtype))
    out = o.reshape(b, s, h * m.v_head_dim) @ p["wo"].to(x.dtype)
    return out, aux


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                   dtype, *, device="cuda") -> dict:
    """{'ckv': (L, b, M, kv_lora), 'krope': (L, b, M, rope) zeros, 'len': 0}."""
    m = cfg.mla
    return {
        "ckv": torch.zeros((n_layers, batch, max_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((n_layers, batch, max_len, m.qk_rope_head_dim),
                             dtype=dtype, device=device),
        "len": 0,
    }


def mla_decode(cfg: ModelConfig, p, x, positions, layer_cache: dict
               ) -> Tuple[torch.Tensor, dict]:
    """Absorbed decode: scores and values computed against the latent cache
    ``layer_cache`` {'ckv': (b, M, kv_lora), 'krope': (b, M, rope), 'len'
    (an int)}, written IN PLACE at 'len' (no caller keeps the old values).
    The probabilities are cast to the activation dtype before the value
    product, as in the reference."""
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c_kv_new, k_rope_new = _latent(cfg, p, x, positions)

    idx = int(layer_cache["len"])
    ckv, krope = layer_cache["ckv"], layer_cache["krope"]
    if idx + s > ckv.shape[1]:
        raise ValueError(f"cache holds {ckv.shape[1]} positions, appending {s} at {idx}")
    ckv[:, idx:idx + s] = c_kv_new.to(ckv.dtype)
    krope[:, idx:idx + s] = k_rope_new[:, :, 0].to(krope.dtype)
    kv_len = idx + s

    # absorb W_uk into q: q_abs (b, s, h, kv_lora)
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_head_dim].to(x.dtype)      # (kv_lora, h, nope)
    w_uv = wkv_b[..., m.qk_nope_head_dim:].to(x.dtype)      # (kv_lora, h, v)
    q_abs = torch.einsum("bshn,chn->bshc", q_nope, w_uk)

    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshc,bmc->bhsm", q_abs, ckv.to(x.dtype))
              + torch.einsum("bshr,bmr->bhsm", q_rope, krope.to(x.dtype))
              ).float() * scale
    q_pos = idx + torch.arange(s, device=x.device)[:, None]
    k_pos = torch.arange(ckv.shape[1], device=x.device)[None, :]
    mask = (k_pos <= q_pos) & (k_pos < kv_len)
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_c = torch.einsum("bhsm,bmc->bshc", probs, ckv.to(x.dtype))   # latent output
    o = torch.einsum("bshc,chv->bshv", o_c, w_uv)
    out = o.reshape(b, s, h * m.v_head_dim) @ p["wo"].to(x.dtype)
    return out, {"ckv": ckv, "krope": krope, "len": kv_len}
