"""Zamba2 hybrid of the port (``repro.models.zamba2``): a Mamba2 backbone and
one *shared* attention block invoked after every ``hybrid_period`` mamba
blocks, with per-invocation LoRA adapters on its q projection.

DR-RL drives the rank of the shared attention block only (the mamba blocks
are attention-free). The 81 'layers' of zamba2-7b are 54 mamba blocks and
27 shared-attention invocations (period 2). The shared attention reaches
the ``lowrank_flash`` kernel through ``mhsa(chunked=True)``, and its
dense-cache decode steps ``flash_decode`` (the few-query route of
``ops.flash_attention``, K/V read in place from the cache).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.core import drrl
from repro_torch.dist.ctx import logits_spec
from repro_torch.models.attention import mhsa
from repro_torch.models.mamba2 import init_mamba_block, init_mamba_state, mamba_block
from repro_torch.models.transformer import _pick, init_attn, init_ffn, make_rank_ctx

LORA_RANK = 64


def n_blocks(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_mamba, n_shared_invocations) with n_mamba + n_inv == num_layers."""
    n_inv = cfg.num_layers // (cfg.hybrid_period + 1)
    return cfg.num_layers - n_inv, n_inv


def init_zamba(cfg: ModelConfig, gen: torch.Generator, *,
               device="cuda") -> Dict[str, Any]:
    """Seeded random parameters with the JAX ``init_zamba``'s tree, shapes
    and scales: the mamba blocks stacked (n_mamba, ...), one shared
    attention block and FFN, the LoRA adapters stacked (n_inv, ...)."""
    dtype = nn.dt(cfg.param_dtype)
    n_mamba, n_inv = n_blocks(cfg)
    d, dh = cfg.d_model, cfg.resolved_head_dim()
    kw = dict(device=device, dtype=dtype)

    def ones(n):
        return torch.ones((n,), **kw)

    return {
        "embed": nn.embed_init(gen, cfg.vocab_size, d, **kw),
        "mamba": init_mamba_block(cfg, gen, dtype, device=device, batch=(n_mamba,)),
        "shared": {
            "attn": init_attn(cfg, gen, dtype, device=device),
            "ffn": init_ffn(cfg, gen, dtype, device=device),
            "ln1": ones(d),
            "ln2": ones(d),
        },
        "lora": {
            "a": nn.dense_init(gen, d, LORA_RANK, batch=(n_inv,), **kw),
            "b": nn.dense_init(gen, LORA_RANK, cfg.num_heads * dh, scale=0.01,
                               batch=(n_inv,), **kw),
        },
        "ln_f": ones(d),
        "lm_head": nn.dense_init(gen, d, cfg.vocab_size, **kw),
    }


def _shared_attn(cfg, shared, lora, x, positions, rank_ctx, cache, chunked):
    """The shared block with this invocation's LoRA delta on wq."""
    p = dict(shared["attn"])
    p["wq"] = p["wq"] + lora["a"] @ lora["b"]
    h, new_cache, aux = mhsa(cfg, p, nn.rms_norm(x, shared["ln1"], cfg.rms_eps),
                             positions, rank_ctx=rank_ctx, cache=cache,
                             chunked=chunked)
    x = x + h
    x = x + nn.swiglu(nn.rms_norm(x, shared["ln2"], cfg.rms_eps),
                      shared["ffn"]["w_gate"], shared["ffn"]["w_up"],
                      shared["ffn"]["w_down"])
    return x, new_cache, aux


def forward_zamba(cfg: ModelConfig, params, tokens, *, positions=None,
                  policy_params=None, rank_rng=None, rl_t=0,
                  collect_aux: str = "none", chunked: bool = False,
                  cache: Optional[dict] = None,
                  power_v0: Optional[Dict[str, torch.Tensor]] = None,
                  compute_fidelity: bool = False):
    """Groups of ``hybrid_period`` mamba blocks and one shared-attention
    invocation. Returns (logits, {'cache', 'ranks'[, 'fidelity']}).

    With ``cache`` (``init_cache_zamba``'s dict) it runs a decode step: the
    tokens are appended at cache['len'], the cache tensors are updated IN
    PLACE and returned with the advanced length. One token advances each
    mamba block's SSM state (``single_step``); several start the scan from
    zero, as the reference's do, so decode into a non-empty cache one token
    at a time. The rank context: in rank mode 'drrl' the agent's h_t comes
    from this call's embeddings and w_t from the shared attention weights
    WITHOUT the LoRA delta (``power_v0`` overrides its power-iteration start
    vectors), ``prev_rank`` starts at the grid's top and carries across the
    invocations; in 'random' every invocation draws from ``rank_rng``
    itself, unsplit, as in the reference. ``collect_aux != 'none'`` returns
    the ranks per invocation (n_inv, b, hkv); ``compute_fidelity`` (which
    the reference's forward does not take) also returns each invocation's
    Eq. 8 fidelity (n_inv, b, hq), at the cost of a full-rank attention."""
    dtype = nn.dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    b, s, _ = x.shape
    n_mamba, n_inv = n_blocks(cfg)
    period = cfg.hybrid_period
    decode = cache is not None
    start = int(cache["len"]) if decode else 0
    if positions is None:
        positions = (start + torch.arange(s, device=x.device))[None].expand(b, s)

    rcfg = cfg.rank
    h_t = w_t = None
    if rcfg.mode == "drrl" and policy_params is not None:
        h_t = drrl.conv_features(x, policy_params["conv"])
        w_t = drrl.weight_stats(params["shared"]["attn"], rcfg.power_iters, v0=power_v0)
    rank_ctx0 = make_rank_ctx(cfg, policy_params=policy_params, h_t=h_t, t=rl_t,
                              device=x.device, compute_fidelity=compute_fidelity)

    prev = torch.full((b, cfg.num_kv_heads), rcfg.rank_grid[-1], dtype=torch.int32,
                      device=x.device)
    ranks, fids = [], []
    for gi in range(n_inv):
        for j in range(period):
            mi = gi * period + j
            mp = _pick(params["mamba"], mi)
            x, nc, ns = mamba_block(cfg, mp, x,
                                    conv_state=cache["conv"][mi] if decode else None,
                                    ssm_state=cache["ssm"][mi] if decode else None,
                                    single_step=decode and s == 1)
            if decode:
                cache["conv"][mi] = nc
                cache["ssm"][mi] = ns
        rank_ctx = None
        if rank_ctx0 is not None:
            rank_ctx = dict(rank_ctx0, prev_rank=prev, layer_id=gi, w_t=w_t,
                            rng=rank_rng)
        layer_cache = ({"k": cache["k"][gi], "v": cache["v"][gi], "len": start}
                       if decode else None)
        x, _, aux = _shared_attn(cfg, params["shared"], _pick(params["lora"], gi), x,
                                 positions, rank_ctx, layer_cache, chunked)
        prev = aux.get("rank", prev)
        if "rank" in aux:
            ranks.append(aux["rank"])
        if "fidelity" in aux:
            fids.append(aux["fidelity"])

    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    new_cache = dict(cache, len=start + s) if decode else None
    out = {"cache": new_cache,
           "ranks": torch.stack(ranks) if collect_aux != "none" and ranks else None}
    if fids:
        out["fidelity"] = torch.stack(fids)
    return logits, out


def init_cache_zamba(cfg: ModelConfig, batch: int, max_len: int, *,
                     device="cuda") -> dict:
    """{'conv' (n_mamba, batch, d_conv - 1, conv_dim), 'ssm' (n_mamba, batch,
    H, N, head_dim) f32, 'k', 'v' (n_inv, batch, max_len, hkv, dh): zeros,
    'len': 0}."""
    dtype = nn.dt(cfg.dtype)
    n_mamba, n_inv = n_blocks(cfg)
    c0, s0 = init_mamba_state(cfg, batch, dtype, device=device)
    shape = (n_inv, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim())
    return {
        "conv": c0[None].repeat(n_mamba, 1, 1, 1),
        "ssm": s0[None].repeat(n_mamba, 1, 1, 1, 1),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": 0,
    }


def loss_zamba(cfg: ModelConfig, params, batch, **kw):
    """Mean next-token cross-entropy of batch {'tokens', 'labels'[, 'mask']};
    returns (loss, {})."""
    logits, _ = forward_zamba(cfg, params, batch["tokens"], **kw)
    return nn.softmax_cross_entropy(logits, batch["labels"], batch.get("mask"),
                                    spec=logits_spec(cfg)), {}
