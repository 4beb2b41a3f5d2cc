"""Model API of the port: family-dispatched init and paged decode step
(the subset of ``repro.models.api.get_model`` the serving engine uses)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

from repro_torch.configs.base import ModelConfig


class ModelFns(NamedTuple):
    init: Callable[..., Any]                    # (generator, device=...) -> params
    # continuous-batching fused step over a slot-paged cache
    decode_step_paged: Optional[Callable[..., Any]] = None


def get_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            "item 18: remaining families)")
    from repro_torch.models import transformer as tr
    return ModelFns(
        init=lambda gen, device="cuda": tr.init_dense(cfg, gen, device=device),
        decode_step_paged=(None if cfg.mrope else
                           lambda params, *a, **kw:
                           tr.decode_step_paged(cfg, params, *a, **kw)),
    )
