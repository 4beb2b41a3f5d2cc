"""Model API of the port: family-dispatched init, loss, dense-cache decode
and the paged decode step (the dense-family subset of
``repro.models.api.get_model``)."""
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
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            "item 18: remaining families)")
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
