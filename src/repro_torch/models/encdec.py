"""Encoder-decoder transformer of the port (``repro.models.encdec``), the
Seamless-M4T backbone.

The audio frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings (b, src_len, d_model) to the encoder. The text
decoder has causal self-attention (``mhsa``: DR-RL applies, and
``chunked=True`` over more than 1024 keys runs the ``lowrank_flash``
kernel, or ``flash_decode`` for at most 16 queries) and cross-attention over the encoder memory. The encoder's
bidirectional attention and the cross-attention are plain einsums, as in
the reference: softmax in f32, cast to the activation dtype before the
value product.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.core import drrl
from repro_torch.dist.ctx import logits_spec
from repro_torch.models.attention import mhsa
from repro_torch.models.common import apply_rope, repeat_kv
from repro_torch.models.transformer import _pick, init_attn, init_ffn, make_rank_ctx


def _init_block(cfg, gen, dtype, cross: bool, *, device, batch):
    ones = lambda: torch.ones((*batch, cfg.d_model), dtype=dtype, device=device)  # noqa: E731
    p = {
        "attn": init_attn(cfg, gen, dtype, device=device, batch=batch),
        "ffn": init_ffn(cfg, gen, dtype, device=device, batch=batch),
        "ln1": ones(),
        "ln2": ones(),
    }
    if cross:
        p["xattn"] = init_attn(cfg, gen, dtype, device=device, batch=batch)
        p["ln_x"] = ones()
    return p


def init_encdec(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """Seeded random parameters with the JAX ``init_encdec``'s tree: the
    encoder and decoder blocks stacked on leading axes (n_enc, ...) and
    (L, ...)."""
    dtype = nn.dt(cfg.param_dtype)
    n_enc = cfg.num_encoder_layers or cfg.num_layers
    kw = dict(device=device, dtype=dtype)
    return {
        "embed": nn.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "enc": _init_block(cfg, gen, dtype, False, device=device, batch=(n_enc,)),
        "dec": _init_block(cfg, gen, dtype, True, device=device,
                           batch=(cfg.num_layers,)),
        "ln_enc": torch.ones((cfg.d_model,), **kw),
        "ln_f": torch.ones((cfg.d_model,), **kw),
        "lm_head": nn.dense_init(gen, cfg.d_model, cfg.vocab_size, **kw),
    }


def _heads(x, w, h, dh):
    """x (b, s, d) @ w (d, h*dh) -> (b, s, h, dh)."""
    return (x @ w.to(x.dtype)).reshape(x.shape[0], x.shape[1], h, dh)


def _attend_full(cfg, q, k, v, dtype):
    """Unmasked attention with the reference's numerics: scores in the
    activation dtype, softmax in f32, probabilities cast back before the
    value product. q (b, sq, hq, dh), k/v (b, skv, hkv, dh)."""
    n_rep = cfg.num_heads // cfg.num_kv_heads
    dh = q.shape[-1]
    s_ = torch.einsum("bqhd,bkhd->bhqk", q, repeat_kv(k, n_rep)) * dh ** -0.5
    a = torch.softmax(s_.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, repeat_kv(v, n_rep))


def _cross_attend(cfg, p, x, memory, mem_kv=None):
    """Cross-attention: q from x, k/v from the encoder memory, or the
    precomputed ``mem_kv`` (k, v)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    q = _heads(x, p["wq"], hq, dh)
    if mem_kv is None:
        k = _heads(memory, p["wk"], hkv, dh)
        v = _heads(memory, p["wv"], hkv, dh)
    else:
        k, v = mem_kv
    o = _attend_full(cfg, q, k, v, x.dtype)
    return o.reshape(b, s, hq * dh) @ p["wo"].to(x.dtype)


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (b, src, d_model) precomputed modality embeddings (stub).
    Bidirectional self-attention with RoPE, SwiGLU, a final RMSNorm."""
    dtype = nn.dt(cfg.dtype)
    x = frames.to(dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    n_enc = params["enc"]["ln1"].shape[0]
    for li in range(n_enc):
        lp = _pick(params["enc"], li)
        h = nn.rms_norm(x, lp["ln1"], cfg.rms_eps)
        q = apply_rope(_heads(h, lp["attn"]["wq"], hq, dh), positions, cfg.rope_theta)
        k = apply_rope(_heads(h, lp["attn"]["wk"], hkv, dh), positions, cfg.rope_theta)
        v = _heads(h, lp["attn"]["wv"], hkv, dh)
        o = _attend_full(cfg, q, k, v, x.dtype)
        x = x + o.reshape(b, s, hq * dh) @ lp["attn"]["wo"].to(x.dtype)
        x = x + nn.swiglu(nn.rms_norm(x, lp["ln2"], cfg.rms_eps),
                          lp["ffn"]["w_gate"], lp["ffn"]["w_up"], lp["ffn"]["w_down"])
    return nn.rms_norm(x, params["ln_enc"], cfg.rms_eps)


def forward_encdec(cfg: ModelConfig, params, frames, tokens, *,
                   policy_params=None, rank_rng=None, rl_t=0,
                   chunked: bool = False):
    """Teacher-forced forward: ``encode(frames)``, then the decoder over
    ``tokens``. Returns (logits, {}). The decoder's self-attention takes the
    rank mode: 'drrl' reads h_t from the token embeddings and each layer's
    w_t, ``prev_rank`` carries across layers from the grid's top; 'random'
    draws every layer from ``rank_rng`` itself, as the reference."""
    memory = encode(cfg, params, frames)
    dtype = nn.dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)

    rcfg = cfg.rank
    h_t = None
    if rcfg.mode == "drrl" and policy_params is not None:
        h_t = drrl.conv_features(x, policy_params["conv"])
    rank_ctx0 = make_rank_ctx(cfg, policy_params=policy_params, h_t=h_t, t=rl_t,
                              device=x.device)
    prev = torch.full((b, cfg.num_kv_heads), rcfg.rank_grid[-1], dtype=torch.int32,
                      device=x.device)
    for li in range(cfg.num_layers):
        lp = _pick(params["dec"], li)
        rank_ctx = None
        if rank_ctx0 is not None:
            w_t = (drrl.weight_stats(lp["attn"], rcfg.power_iters)
                   if rcfg.mode == "drrl" else None)
            rank_ctx = dict(rank_ctx0, prev_rank=prev, layer_id=li, w_t=w_t,
                            rng=rank_rng)
        h, _, aux = mhsa(cfg, lp["attn"], nn.rms_norm(x, lp["ln1"], cfg.rms_eps),
                         positions, rank_ctx=rank_ctx, chunked=chunked)
        x = x + h
        x = x + _cross_attend(cfg, lp["xattn"], nn.rms_norm(x, lp["ln_x"], cfg.rms_eps),
                              memory)
        x = x + nn.swiglu(nn.rms_norm(x, lp["ln2"], cfg.rms_eps),
                          lp["ffn"]["w_gate"], lp["ffn"]["w_up"], lp["ffn"]["w_down"])
        prev = aux.get("rank", prev)
    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return x @ params["lm_head"].to(x.dtype), {}


def loss_encdec(cfg: ModelConfig, params, batch, **kw):
    """Mean cross-entropy of batch {'frames', 'tokens', 'labels'[, 'mask']};
    returns (loss, aux)."""
    logits, aux = forward_encdec(cfg, params, batch["frames"], batch["tokens"], **kw)
    return nn.softmax_cross_entropy(logits, batch["labels"], batch.get("mask"),
                                    spec=logits_spec(cfg)), aux


def init_cache_encdec(cfg: ModelConfig, batch: int, max_len: int, src_len: int, *,
                      device="cuda") -> dict:
    """Decode cache: self-attention K/V per decoder layer {'k', 'v': (L,
    batch, max_len, hkv, dh)}, the cross-attention K/V {'xk', 'xv': (L,
    batch, src_len, hkv, dh)} (``prefill_cross``), zeros, and 'len': 0."""
    dtype = nn.dt(cfg.dtype)
    hkv, dh, L = cfg.num_kv_heads, cfg.resolved_head_dim(), cfg.num_layers

    def zeros(n):
        return torch.zeros((L, batch, n, hkv, dh), dtype=dtype, device=device)
    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(src_len),
            "xv": zeros(src_len), "len": 0}


def prefill_cross(cfg: ModelConfig, params, memory: torch.Tensor, cache: dict) -> dict:
    """The cross-attention K/V of every decoder layer from the encoder
    ``memory`` (b, src_len, d), cast to the cache's dtype."""
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    xk = torch.stack([_heads(memory, _pick(params["dec"], li)["xattn"]["wk"], hkv, dh)
                      for li in range(cfg.num_layers)])
    xv = torch.stack([_heads(memory, _pick(params["dec"], li)["xattn"]["wv"], hkv, dh)
                      for li in range(cfg.num_layers)])
    return dict(cache, xk=xk.to(cache["xk"].dtype), xv=xv.to(cache["xv"].dtype))


def decode_step_encdec(cfg: ModelConfig, params, cache, tokens):
    """tokens (b, s) appended at cache['len'] (full-rank self-attention over
    the dense cache, cross-attention over the prefilled K/V). The
    self-attention cache is updated IN PLACE. Returns (logits, new cache)."""
    dtype = nn.dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    b, s, _ = x.shape
    start = int(cache["len"])
    positions = (start + torch.arange(s, device=x.device))[None].expand(b, s)
    for li in range(cfg.num_layers):
        lp = _pick(params["dec"], li)
        layer_cache = {"k": cache["k"][li], "v": cache["v"][li], "len": start}
        h, _, _ = mhsa(cfg, lp["attn"], nn.rms_norm(x, lp["ln1"], cfg.rms_eps),
                       positions, cache=layer_cache)
        x = x + h
        x = x + _cross_attend(cfg, lp["xattn"], nn.rms_norm(x, lp["ln_x"], cfg.rms_eps),
                              None, mem_kv=(cache["xk"][li], cache["xv"][li]))
        x = x + nn.swiglu(nn.rms_norm(x, lp["ln2"], cfg.rms_eps),
                          lp["ffn"]["w_gate"], lp["ffn"]["w_up"], lp["ffn"]["w_down"])
    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return x @ params["lm_head"].to(x.dtype), dict(cache, len=start + s)
