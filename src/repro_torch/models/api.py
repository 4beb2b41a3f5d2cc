"""Model API of the port: family-dispatched init, loss, dense-cache decode
and the paged decode step (``repro.models.api.get_model`` for the families
the port runs: dense, and the MoE family with dense attention (granite) or
with MLA (DeepSeek-V3, which has no paged step, as in the reference))."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

from repro_torch import not_ported
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
    if fam == "moe" and cfg.mla is not None:
        return _deepseek_fns(cfg)
    if fam in ("dense", "moe"):                  # granite: dense attn + moe ffn
        return _dense_fns(cfg)
    raise not_ported(f"family {fam!r}", "item 18")


def _dense_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import transformer as tr

    def loss(params, batch, **kw):
        return tr.loss_dense(cfg, params, batch,
                             positions=batch.get("positions"), **kw)

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
