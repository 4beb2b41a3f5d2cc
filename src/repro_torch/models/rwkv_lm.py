"""RWKV6 language model of the port (``repro.models.rwkv_lm``): stacked Finch
blocks run as a Python loop over layers. It launches no kernel: there is
no attention to run."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.ctx import logits_spec
from repro_torch.models.rwkv6 import init_rwkv_block, init_rwkv_state, rwkv_block
from repro_torch.models.transformer import _pick


def init_rwkv_lm(cfg: ModelConfig, gen: torch.Generator, *,
                 device="cuda") -> Dict[str, Any]:
    """Seeded random parameters with the JAX ``init_rwkv_lm``'s tree: the
    blocks stacked on a leading L axis."""
    dtype = nn.dt(cfg.param_dtype)
    kw = dict(device=device, dtype=dtype)
    return {
        "embed": nn.embed_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "layers": init_rwkv_block(cfg, gen, dtype, device=device,
                                  batch=(cfg.num_layers,)),
        "ln_f": torch.ones((cfg.d_model,), **kw),
        "lm_head": nn.dense_init(gen, cfg.d_model, cfg.vocab_size, **kw),
    }


def forward_rwkv(cfg: ModelConfig, params, tokens, *, state=None,
                 single_step=False, **_ignored):
    """state: the per-layer (shift1, S, shift2) stacked on a leading L axis,
    or None (zeros). Returns (logits, new stacked state)."""
    dtype = nn.dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    if state is None:
        state = init_cache_rwkv(cfg, tokens.shape[0], device=x.device)
    new = []
    for li in range(cfg.num_layers):
        x, st = rwkv_block(cfg, _pick(params["layers"], li), x,
                           state=tuple(t[li] for t in state), single_step=single_step)
        new.append(st)
    x = nn.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return logits, tuple(torch.stack(ts) for ts in zip(*new))


def loss_rwkv(cfg: ModelConfig, params, batch, **kw):
    """Mean next-token cross-entropy of batch {'tokens', 'labels'[, 'mask']};
    the rank arguments are ignored, as in the reference. Returns (loss, {})."""
    logits, _ = forward_rwkv(cfg, params, batch["tokens"])
    return nn.softmax_cross_entropy(logits, batch["labels"], batch.get("mask"),
                                    spec=logits_spec(cfg)), {}


def init_cache_rwkv(cfg: ModelConfig, batch: int, *, device="cuda") -> Any:
    """The zero state of every layer, stacked: (shift1 (L, batch, 1, d), S
    (L, batch, h, hd, hd) f32, shift2 (L, batch, 1, d))."""
    s0 = init_rwkv_state(cfg, batch, nn.dt(cfg.dtype), device=device)
    return tuple(t[None].repeat(cfg.num_layers, *([1] * t.dim())) for t in s0)


def decode_step_rwkv(cfg: ModelConfig, params, cache, tokens):
    """tokens (b, s) after the state ``cache``: the recurrence for one token,
    the chunked scan from the carried state for several. Returns (logits,
    new state)."""
    return forward_rwkv(cfg, params, tokens, state=cache,
                        single_step=tokens.shape[1] == 1)
