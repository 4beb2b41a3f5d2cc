"""DeepSeek-V3 family of the port (``repro.models.deepseek_v3``): MLA
attention, shared + routed experts, the first layers dense, and the
multi-token prediction (MTP) head.

Layout as the reference's: ``dense_layers`` a list of unstacked blocks,
``moe_layers`` stacked on a leading axis, ``mtp`` one MoE block with its
projection and norms. The family has a forward, a loss and a dense-cache
(absorbed latent) decode; the serving engine's paged step does not cover
it, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.ctx import logits_spec
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import remat_layer
from repro_torch.models.mla import init_mla, init_mla_cache, mla_decode, mla_train
from repro_torch.models.transformer import _logits, _pick, ffn, init_ffn


def _init_block(cfg: ModelConfig, gen, dtype, dense: bool, *, device, batch=()):
    def ones():
        return torch.ones((*batch, cfg.d_model), dtype=dtype, device=device)

    p = {"attn": init_mla(cfg, gen, dtype, device=device, batch=batch),
         "ln1": ones(), "ln2": ones()}
    if dense:
        p["ffn"] = init_ffn(cfg, gen, dtype, device=device,
                            d_ff=cfg.dense_d_ff or cfg.d_ff, batch=batch)
    else:
        p["moe"] = moe_mod.init_moe(cfg, gen, dtype, device=device, batch=batch)
    return p


def init_deepseek(cfg: ModelConfig, gen: torch.Generator, *,
                  device="cuda") -> Dict[str, Any]:
    """Seeded random parameters with the shapes and scales of the JAX
    ``init_deepseek``. ``gen`` must live on ``device``."""
    dtype = nn.dt(cfg.param_dtype)
    d = cfg.d_model
    n_dense = cfg.first_dense_layers
    n_moe = cfg.num_layers - n_dense
    params: Dict[str, Any] = {
        "embed": nn.embed_init(gen, cfg.vocab_size, d, device=device, dtype=dtype),
        "dense_layers": [_init_block(cfg, gen, dtype, True, device=device)
                         for _ in range(n_dense)],
        "moe_layers": _init_block(cfg, gen, dtype, False, device=device,
                                  batch=(n_moe,)),
        "ln_f": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": nn.dense_init(gen, d, cfg.vocab_size, device=device, dtype=dtype),
    }
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": nn.dense_init(gen, 2 * d, d, device=device, dtype=dtype),
            "block": _init_block(cfg, gen, dtype, False, device=device),
            "ln_h": torch.ones((d,), dtype=dtype, device=device),
            "ln_e": torch.ones((d,), dtype=dtype, device=device),
        }
    return params


def _block(cfg: ModelConfig, lp, x, positions, rank_ctx, chunked):
    h, aux = mla_train(cfg, lp["attn"], nn.rms_norm(x, lp["ln1"], cfg.rms_eps),
                       positions, rank_ctx=rank_ctx, chunked=chunked)
    x = x + h
    f, ffn_aux = ffn(cfg, lp, nn.rms_norm(x, lp["ln2"], cfg.rms_eps))
    return x + f, {**aux, **ffn_aux}


def _n_moe(params) -> int:
    return params["moe_layers"]["ln1"].shape[0]


def forward_deepseek(cfg: ModelConfig, params, tokens, *, positions=None,
                     rank_ctx0=None, collect_aux: str = "none",
                     chunked: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (b, s) -> (logits (b, s, V), aux): the dense layers, then the
    MoE stack, then (``mtp_depth`` > 0) the MTP block predicting token t + 2
    from [h_t ; emb(token t+1)] (aux['mtp_logits'] (b, s - 1, V)).
    aux['aux_loss'] sums the MoE blocks' load-balancing losses, the MTP
    block's included. ``rank_ctx0`` ({'cfg': RankConfig[, 'rng']}) is every
    layer's rank context, as in the reference; ``collect_aux`` is accepted
    and unused, as there. ``chunked`` sends every attention over more than
    1024 keys through ``lowrank_flash`` (r = qk_nope + qk_rope). Under
    autograd the MoE layers run as ``cfg.remat`` says
    (:func:`repro_torch.models.common.remat_layer`); the dense layers and
    the MTP block keep their activations, as in the reference."""
    dtype = nn.dt(cfg.dtype)
    tokens = tokens.long()
    x = params["embed"][tokens].to(dtype)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)

    for lp in params["dense_layers"]:
        x, _ = _block(cfg, lp, x, positions, rank_ctx0, chunked)

    def moe_layer(x, lp):
        # the reference's scan body over the MoE stack, under cfg.remat
        x, aux = _block(cfg, lp, x, positions, rank_ctx0, chunked)
        return x, aux["aux_loss"]
    moe_layer = remat_layer(cfg, moe_layer)
    aux_loss = torch.zeros((), device=x.device)
    for li in range(_n_moe(params)):
        x, layer_loss = moe_layer(x, _pick(params["moe_layers"], li))
        aux_loss = aux_loss + layer_loss
    logits = _logits(params, nn.rms_norm(x, params["ln_f"], cfg.rms_eps))
    aux_out: Dict[str, Any] = {"aux_loss": aux_loss}

    if cfg.mtp_depth > 0 and "mtp" in params:
        mtp = params["mtp"]
        emb_next = params["embed"][tokens[:, 1:]].to(dtype)       # (b, s-1, d)
        h_in = torch.cat([nn.rms_norm(x[:, :-1], mtp["ln_h"], cfg.rms_eps),
                          nn.rms_norm(emb_next, mtp["ln_e"], cfg.rms_eps)], dim=-1)
        h_mtp, mtp_aux = _block(cfg, mtp["block"], nn.linear(h_in, mtp["proj"]),
                                positions[:, :-1], rank_ctx0, chunked)
        aux_out["mtp_logits"] = _logits(
            params, nn.rms_norm(h_mtp, params["ln_f"], cfg.rms_eps))
        aux_out["aux_loss"] = aux_out["aux_loss"] + mtp_aux["aux_loss"]
    return logits, aux_out


def loss_deepseek(cfg: ModelConfig, params, batch, *, mtp_weight: float = 0.3,
                  **kw):
    """Next-token cross-entropy, plus ``mtp_weight`` x the MTP head's
    cross-entropy on the labels shifted once more, plus the auxiliary
    loss; returns (loss, aux)."""
    logits, aux = forward_deepseek(cfg, params, batch["tokens"], **kw)
    spec = logits_spec(cfg)
    loss = nn.softmax_cross_entropy(logits, batch["labels"], batch.get("mask"),
                                    spec=spec)
    if "mtp_logits" in aux:
        loss = loss + mtp_weight * nn.softmax_cross_entropy(
            aux["mtp_logits"], batch["labels"][:, 1:], spec=spec)
    return loss + aux["aux_loss"], aux


def init_cache_deepseek(cfg: ModelConfig, batch: int, max_len: int, *,
                        device="cuda") -> dict:
    return init_mla_cache(cfg, batch, max_len, cfg.num_layers, nn.dt(cfg.dtype),
                          device=device)


def decode_step_deepseek(cfg: ModelConfig, params, cache, tokens, *,
                         positions=None):
    """One decode step with the absorbed-MLA latent cache: tokens (b,
    s_new) appended at cache['len']. The cache's ckv/krope are stacked (L,
    b, M, ...), the dense layers first; they are updated in place.
    Returns (logits (b, s_new, V), new_cache)."""
    dtype = nn.dt(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    b, s, _ = x.shape
    start = int(cache["len"])
    if positions is None:
        positions = (start + torch.arange(s, device=x.device))[None].expand(b, s)
    blocks = list(params["dense_layers"]) + [
        _pick(params["moe_layers"], i) for i in range(_n_moe(params))]
    for li, lp in enumerate(blocks):
        lc = {"ckv": cache["ckv"][li], "krope": cache["krope"][li], "len": start}
        h, _ = mla_decode(cfg, lp["attn"], nn.rms_norm(x, lp["ln1"], cfg.rms_eps),
                          positions, lc)
        x = x + h
        f, _ = ffn(cfg, lp, nn.rms_norm(x, lp["ln2"], cfg.rms_eps))
        x = x + f
    logits = _logits(params, nn.rms_norm(x, params["ln_f"], cfg.rms_eps))
    return logits, {"ckv": cache["ckv"], "krope": cache["krope"], "len": start + s}
