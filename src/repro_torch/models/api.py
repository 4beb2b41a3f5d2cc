"""Model API of the port: family-dispatched init, loss, dense-cache decode
and the paged decode step (``repro.models.api.get_model``) for every
family of the reference: dense and the VLM (M-RoPE; no paged step), the
MoE family with dense attention (granite) or with MLA (DeepSeek-V3, no
paged step), the Zamba2 hybrid, RWKV6 and the encoder-decoder (none of
the last three has a paged step, as in the reference)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

from repro_torch.configs.base import ModelConfig


class ModelFns(NamedTuple):
    init: Callable[..., Any]                    # (generator, device=...) -> params
    loss: Callable[..., Any]                    # (params, batch, **kw) -> (loss, aux)
    init_cache: Callable[..., Any]              # (batch, max_len, device=...) -> cache
    decode_step: Callable[..., Any]             # (params, cache, tokens) -> (logits, cache)
    # continuous-batching fused step over a slot-paged cache
    decode_step_paged: Optional[Callable[..., Any]] = None


def get_model(cfg: ModelConfig) -> ModelFns:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return _dense_fns(cfg)
    if fam == "moe" and cfg.mla is not None:
        return _deepseek_fns(cfg)
    if fam == "moe":                             # granite: dense attn + moe ffn
        return _dense_fns(cfg)
    if fam == "hybrid":
        return _zamba_fns(cfg)
    if fam == "rwkv":
        return _rwkv_fns(cfg)
    if fam == "encdec":
        return _encdec_fns(cfg)
    raise ValueError(f"unknown family {fam}")


def _dense_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import transformer as tr

    def loss(params, batch, **kw):
        return tr.loss_dense(cfg, params, batch,
                             positions=batch.get("positions"),
                             extra_embeddings=batch.get("patch_embeds"), **kw)

    return ModelFns(
        init=lambda gen, device="cuda": tr.init_dense(cfg, gen, device=device),
        loss=loss,
        init_cache=lambda b, m, device="cuda": tr.init_cache_dense(
            cfg, b, m, device=device),
        decode_step=lambda params, cache, tokens, **kw:
            tr.decode_step_dense(cfg, params, cache, tokens, **kw),
        decode_step_paged=(None if cfg.mrope else
                           lambda params, *a, **kw:
                           tr.decode_step_paged(cfg, params, *a, **kw)),
    )


def _deepseek_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import deepseek_v3 as ds

    return ModelFns(
        init=lambda gen, device="cuda": ds.init_deepseek(cfg, gen, device=device),
        loss=lambda params, batch, **kw: ds.loss_deepseek(cfg, params, batch, **kw),
        init_cache=lambda b, m, device="cuda": ds.init_cache_deepseek(
            cfg, b, m, device=device),
        decode_step=lambda params, cache, tokens, **kw:
            ds.decode_step_deepseek(cfg, params, cache, tokens, **kw),
    )


def _zamba_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import zamba2 as zb

    def decode_step(params, cache, tokens, **kw):
        logits, aux = zb.forward_zamba(cfg, params, tokens, cache=cache, **kw)
        return logits, aux["cache"]

    return ModelFns(
        init=lambda gen, device="cuda": zb.init_zamba(cfg, gen, device=device),
        loss=lambda params, batch, **kw: zb.loss_zamba(cfg, params, batch, **kw),
        init_cache=lambda b, m, device="cuda": zb.init_cache_zamba(
            cfg, b, m, device=device),
        decode_step=decode_step,
    )


def _rwkv_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import rwkv_lm as rk

    return ModelFns(
        init=lambda gen, device="cuda": rk.init_rwkv_lm(cfg, gen, device=device),
        loss=lambda params, batch, **kw: rk.loss_rwkv(cfg, params, batch, **kw),
        init_cache=lambda b, m, device="cuda": rk.init_cache_rwkv(
            cfg, b, device=device),
        decode_step=lambda params, cache, tokens, **kw:
            rk.decode_step_rwkv(cfg, params, cache, tokens),
    )


def _encdec_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import encdec as ed

    return ModelFns(
        init=lambda gen, device="cuda": ed.init_encdec(cfg, gen, device=device),
        loss=lambda params, batch, **kw: ed.loss_encdec(cfg, params, batch, **kw),
        init_cache=lambda b, m, device="cuda": ed.init_cache_encdec(
            cfg, b, m, cfg.frontend_positions or 1024, device=device),
        decode_step=lambda params, cache, tokens, **kw:
            ed.decode_step_encdec(cfg, params, cache, tokens),
    )
