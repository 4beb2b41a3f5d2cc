"""Model API of the port: family-dispatched init, loss, dense-cache decode,
the dry run's input stand-ins (``input_specs``) and the paged decode step
(``repro.models.api.get_model``) for every family of the reference: dense
and the VLM (M-RoPE; no paged step), the MoE family with dense attention
(granite) or with MLA (DeepSeek-V3, no paged step), the Zamba2 hybrid,
RWKV6 and the encoder-decoder (none of the last three has a paged step,
as in the reference)."""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig, ShapeCell


class ModelFns(NamedTuple):
    init: Callable[..., Any]                    # (generator, device=...) -> params
    loss: Callable[..., Any]                    # (params, batch, **kw) -> (loss, aux)
    init_cache: Callable[..., Any]              # (batch, max_len, device=...) -> cache
    decode_step: Callable[..., Any]             # (params, cache, tokens) -> (logits, cache)
    # (cell) -> {'batch': ...} or {'cache': ..., 'tokens': ...} of meta tensors
    input_specs: Callable[[ShapeCell], Dict[str, Any]]
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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta-tensor stand-ins (the reference's ``jax.ShapeDtypeStruct``s)
    for a train or prefill batch."""
    b, s = cell.global_batch, cell.seq_len
    specs = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    if cfg.family == "vlm":
        # stubbed modality frontend: patch embeddings prepended; positions are
        # the 3-stream M-RoPE ids
        n_patch = cfg.frontend_positions
        specs["patch_embeds"] = _meta((b, n_patch, cfg.d_model), nn.dt(cfg.dtype))
        specs["positions"] = _meta((b, 3, s + n_patch), torch.int32)
        specs["labels"] = _meta((b, s + n_patch), torch.int32)
    if cfg.family == "encdec":
        src = cfg.frontend_positions or s
        specs["frames"] = _meta((b, src, cfg.d_model), nn.dt(cfg.dtype))
    return specs


def _input_specs(cfg: ModelConfig, init_cache) -> Callable[[ShapeCell], Dict[str, Any]]:
    """``ModelFns.input_specs`` of a family: the batch of a train or prefill
    cell; for a decode cell the family's ``init_cache`` on the meta device
    and one token per row."""
    def input_specs(cell: ShapeCell) -> Dict[str, Any]:
        if cell.kind in ("train", "prefill"):
            return {"batch": _batch_specs(cfg, cell)}
        b = cell.global_batch
        return {"cache": init_cache(b, cell.seq_len, device="meta"),
                "tokens": _meta((b, 1), torch.int32)}
    return input_specs


def _dense_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import transformer as tr

    def loss(params, batch, **kw):
        return tr.loss_dense(cfg, params, batch,
                             positions=batch.get("positions"),
                             extra_embeddings=batch.get("patch_embeds"), **kw)

    def init_cache(b, m, device="cuda"):
        return tr.init_cache_dense(cfg, b, m, device=device)

    return ModelFns(
        init=lambda gen, device="cuda": tr.init_dense(cfg, gen, device=device),
        loss=loss,
        init_cache=init_cache,
        decode_step=lambda params, cache, tokens, **kw:
            tr.decode_step_dense(cfg, params, cache, tokens, **kw),
        input_specs=_input_specs(cfg, init_cache),
        decode_step_paged=(None if cfg.mrope else
                           lambda params, *a, **kw:
                           tr.decode_step_paged(cfg, params, *a, **kw)),
    )


def _deepseek_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import deepseek_v3 as ds

    def init_cache(b, m, device="cuda"):
        return ds.init_cache_deepseek(cfg, b, m, device=device)

    return ModelFns(
        init=lambda gen, device="cuda": ds.init_deepseek(cfg, gen, device=device),
        loss=lambda params, batch, **kw: ds.loss_deepseek(cfg, params, batch, **kw),
        init_cache=init_cache,
        decode_step=lambda params, cache, tokens, **kw:
            ds.decode_step_deepseek(cfg, params, cache, tokens, **kw),
        input_specs=_input_specs(cfg, init_cache),
    )


def _zamba_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import zamba2 as zb

    def decode_step(params, cache, tokens, **kw):
        logits, aux = zb.forward_zamba(cfg, params, tokens, cache=cache, **kw)
        return logits, aux["cache"]

    def init_cache(b, m, device="cuda"):
        return zb.init_cache_zamba(cfg, b, m, device=device)

    return ModelFns(
        init=lambda gen, device="cuda": zb.init_zamba(cfg, gen, device=device),
        loss=lambda params, batch, **kw: zb.loss_zamba(cfg, params, batch, **kw),
        init_cache=init_cache,
        decode_step=decode_step,
        input_specs=_input_specs(cfg, init_cache),
    )


def _rwkv_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import rwkv_lm as rk

    def init_cache(b, m, device="cuda"):
        return rk.init_cache_rwkv(cfg, b, device=device)

    return ModelFns(
        init=lambda gen, device="cuda": rk.init_rwkv_lm(cfg, gen, device=device),
        loss=lambda params, batch, **kw: rk.loss_rwkv(cfg, params, batch, **kw),
        init_cache=init_cache,
        decode_step=lambda params, cache, tokens, **kw:
            rk.decode_step_rwkv(cfg, params, cache, tokens),
        input_specs=_input_specs(cfg, init_cache),
    )


def _encdec_fns(cfg: ModelConfig) -> ModelFns:
    from repro_torch.models import encdec as ed

    def init_cache(b, m, device="cuda"):
        return ed.init_cache_encdec(cfg, b, m, cfg.frontend_positions or 1024,
                                    device=device)

    return ModelFns(
        init=lambda gen, device="cuda": ed.init_encdec(cfg, gen, device=device),
        loss=lambda params, batch, **kw: ed.loss_encdec(cfg, params, batch, **kw),
        init_cache=init_cache,
        decode_step=lambda params, cache, tokens, **kw:
            ed.decode_step_encdec(cfg, params, cache, tokens),
        input_specs=_input_specs(cfg, init_cache),
    )
