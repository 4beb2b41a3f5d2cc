"""Transformer-based rank-selection policy network of the DR-RL agent
(paper section 4.1.3 / 4.5.1; ``repro.core.policy``).

The Eq. 6 state is a short sequence of feature-group tokens
  [ h_t | w_t | NER grid | dA-bound grid | prev-rank | layer-id ]
each linearly embedded into d_pol, run through a pre-LN Transformer
encoder, mean-pooled, and decoded by an MLP into action logits over the
rank grid and a value estimate (the value head serves PPO).

Parameters are a nested dict of tensors in JAX's (in, out) layout, the
tree of ``repro.core.policy.init_policy``; ``layers`` is a list.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import nn

FEATURE_ORDER = ("h_t", "w_t", "ner", "bounds", "prev_rank", "layer_id")
POLICY_HEADS = 4


def init_policy(gen: torch.Generator, feat_dims: Dict[str, int],
                n_actions: int, d_pol: int = 64, n_layers: int = 2,
                d_ff: int = 128, *, device="cuda",
                dtype=torch.float32) -> dict:
    """Seeded parameters with the shapes and scales of the JAX
    ``init_policy`` (logits and value heads at scale 0.01, so the actions'
    logits start close together). ``gen`` must live on ``device``."""
    def dense(i, o, scale=None):
        return nn.dense_init(gen, i, o, device=device, dtype=dtype,
                             scale=scale)

    def ones():
        return torch.ones((d_pol,), dtype=dtype, device=device)

    p: dict = {"embed": {}, "layers": []}
    for name in FEATURE_ORDER:
        p["embed"][name] = {"w": dense(feat_dims[name], d_pol),
                            "b": torch.zeros((d_pol,), dtype=dtype,
                                             device=device)}
    for _ in range(n_layers):
        p["layers"].append({
            "ln1": ones(), "wq": dense(d_pol, d_pol), "wk": dense(d_pol, d_pol),
            "wv": dense(d_pol, d_pol), "wo": dense(d_pol, d_pol),
            "ln2": ones(), "w1": dense(d_pol, d_ff), "w2": dense(d_ff, d_pol),
        })
    p["ln_f"] = ones()
    p["head"] = {"w1": dense(d_pol, d_pol),
                 "w_logits": dense(d_pol, n_actions, scale=0.01),
                 "w_value": dense(d_pol, 1, scale=0.01)}
    return p


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _encoder_layer(lp: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x: (B, T, d_pol): bidirectional self-attention + MLP (pre-LN)."""
    B, T, D = x.shape
    dh = D // n_heads
    h = nn.rms_norm(x, lp["ln1"])
    q = nn.linear(h, lp["wq"]).reshape(B, T, n_heads, dh)
    k = nn.linear(h, lp["wk"]).reshape(B, T, n_heads, dh)
    v = nn.linear(h, lp["wv"]).reshape(B, T, n_heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    a = torch.softmax(s.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, D)
    x = x + nn.linear(o, lp["wo"])
    h = nn.rms_norm(x, lp["ln2"])
    return x + nn.linear(_gelu(nn.linear(h, lp["w1"])), lp["w2"])


def policy_apply(p: dict, feats: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats[name]: (B, feat_dims[name]). Returns (logits (B, A), value
    (B,)), both f32."""
    toks = []
    for name in FEATURE_ORDER:
        e = p["embed"][name]
        toks.append(nn.linear(feats[name].to(e["w"].dtype), e["w"], e["b"]))
    x = torch.stack(toks, dim=1)                    # (B, T=6, d_pol)
    for lp in p["layers"]:
        x = _encoder_layer(lp, x, POLICY_HEADS)
    x = nn.rms_norm(x.mean(dim=1), p["ln_f"])
    h = _gelu(nn.linear(x, p["head"]["w1"]))
    logits = nn.linear(h, p["head"]["w_logits"])
    value = nn.linear(h, p["head"]["w_value"])[..., 0]
    return logits.float(), value.float()
