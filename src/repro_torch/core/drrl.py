"""DR-RL controller (``repro.core.drrl``): spectra -> Eq. 6 features ->
policy -> Eq. 9-11 guardrail -> rank.

The controller runs inside each attention layer, per (batch, kv-head). Every
feature it reads is a small per-head summary (NER grid, Eq. 9 bounds,
weight statistics), and nothing in it reads a value back to the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RankConfig
from repro_torch.core import lowrank as lr
from repro_torch.core import perturbation as pert
from repro_torch.core.policy import init_policy, policy_apply

# weight_stats' power-iteration start vectors are drawn from a CPU generator
# seeded with this (the reference draws them from jax.random.PRNGKey(2))
POWER_SEED = 2
W_NAMES = ("wq", "wk", "wv")


def feat_dims(rank_cfg: RankConfig, h_dim: int = 8) -> Dict[str, int]:
    g = len(rank_cfg.rank_grid)
    return {"h_t": h_dim, "w_t": 9, "ner": g, "bounds": g,
            "prev_rank": g, "layer_id": 1}


def init_agent(gen: torch.Generator, rank_cfg: RankConfig, d_model: int, *,
               h_dim: int = 8, conv_width: int = 5, d_pol: int = 64,
               n_layers: int = 2, device="cuda") -> dict:
    """Seeded agent parameters with the JAX ``init_agent``'s tree, shapes
    and scales: the policy network plus ``conv``, the (k, d, f) kernel of
    the h_t featurizer. ``gen`` must live on ``device``."""
    pol = init_policy(gen, feat_dims(rank_cfg, h_dim),
                      n_actions=len(rank_cfg.rank_grid), d_pol=d_pol,
                      n_layers=n_layers, device=device)
    conv = torch.randn((conv_width, d_model, h_dim), generator=gen,
                       device=device)
    pol["conv"] = conv * (conv_width * d_model) ** -0.5
    return pol


def conv_features(embeddings: torch.Tensor,
                  kernel: torch.Tensor) -> torch.Tensor:
    """Sequence-dynamics feature h_t (paper 4.1.1): a 1-D convolution of the
    input embeddings (b, s, d) with ``kernel`` (k, d, f), over all d input
    channels (a full convolution, as the reference's conv_general_dilated
    with NWC/WIO), "SAME" zero padding ((k-1)//2 before, k//2 after),
    mean-pooled over s, then tanh. Returns (b, f).

    Written as k shifted matrix products, which stay in f32 on the card
    (cuDNN's convolutions default to TF32)."""
    x = embeddings.float()
    k = kernel.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, (k - 1) // 2, k // 2))
    w = kernel.float()
    y = sum(xp[:, j:j + s] @ w[j] for j in range(k))
    return torch.tanh(y.mean(dim=1))


def power_starts(p_attn: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Start vectors of :func:`weight_stats`' power iterations, one per
    matrix of the layer's ``p_attn``: draws from a CPU generator seeded with
    ``POWER_SEED``, so the same on every device and every call, moved to
    the weights' device."""
    gen = torch.Generator().manual_seed(POWER_SEED)
    return {name: torch.randn((p_attn[name].shape[-1],), generator=gen
                              ).to(p_attn[name].device) for name in W_NAMES}


def weight_stats(p_attn: Dict[str, torch.Tensor], power_iters: int = 3,
                 v0: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Layer-parameter feature w_t (paper 4.1.1): mean, variance (ddof 0)
    and spectral norm of W_Q, W_K, W_V (9 scalars), the spectral norms by
    ``power_iters`` power iterations (Eq. 16) from ``v0[name]`` (default
    :func:`power_starts`). Three iterations do not converge, so w_t depends
    on the start vectors."""
    if v0 is None:
        v0 = power_starts(p_attn)
    feats = []
    for name in W_NAMES:
        w = p_attn[name].float()
        w2 = w.reshape(w.shape[0], -1)
        feats += [w2.mean(), w2.var(correction=0),
                  lr.power_iteration_specnorm(w2, power_iters, v0=v0[name])]
    return torch.stack(feats)


def rank_grid_index(rank_cfg: RankConfig, rank: torch.Tensor) -> torch.Tensor:
    """Index of the grid entry nearest each rank (ties to the first)."""
    return torch.stack([(rank - g).abs() for g in rank_cfg.rank_grid],
                       dim=-1).argmin(dim=-1)


def build_features(rank_cfg: RankConfig, ctx: Dict[str, torch.Tensor],
                   h_t: torch.Tensor, w_t: torch.Tensor, layer_id: int,
                   prev_rank: torch.Tensor
                   ) -> Tuple[Dict[str, torch.Tensor], Tuple]:
    """The Eq. 6 state of every (batch, kv-head) pair from ctx's spectra
    'k_s2' (b, h, d) and 'q_s2' (b, hq, d), h_t (b, f), w_t (9,), the
    layer index and prev_rank (b, h).

    Returns (feats {name: (b * h, dim)}, (b, h, bounds_rel (b, h, G),
    norm (b, h)))."""
    k_s2 = ctx["k_s2"]
    b, h, d = k_s2.shape
    grid = rank_cfg.rank_grid
    G = len(grid)
    dev = k_s2.device
    ner = lr.ner_curve(k_s2)
    ner_g = torch.stack([ner[..., min(max(r - 1, 0), d - 1)] for r in grid],
                        dim=-1)                              # (b, h, G)
    hq = ctx["q_s2"].shape[1]
    # q-head spectra averaged per kv group (q heads are contiguous per group)
    q_s2 = (ctx["q_s2"].reshape(b, h, hq // h, d).mean(2)
            if hq != h else ctx["q_s2"])
    bounds, norm = pert.guardrail_report(q_s2, k_s2, grid, d)
    bounds_rel = bounds / norm[..., None].clamp_min(1e-30)
    prev_1h = F.one_hot(rank_grid_index(rank_cfg, prev_rank), G).float()
    B = b * h
    feats = {
        "h_t": h_t[:, None, :].expand(b, h, h_t.shape[-1]).reshape(B, -1),
        "w_t": w_t[None, None, :].expand(b, h, 9).reshape(B, 9),
        "ner": ner_g.reshape(B, G),
        "bounds": bounds_rel.reshape(B, G),
        "prev_rank": prev_1h.reshape(B, G),
        "layer_id": torch.full((B, 1), float(layer_id), device=dev),
    }
    return feats, (b, h, bounds_rel, norm)


def make_action_fn(policy_params: dict, rank_cfg: RankConfig, *,
                   h_t: torch.Tensor, greedy: bool = True,
                   generator: Optional[torch.Generator] = None) -> Callable:
    """Returns ``action_fn(ctx, rank_ctx) -> (rank_k (b, hkv), aux)`` for
    :func:`repro_torch.models.attention.mhsa`, with the Eq. 11 annealed
    safety mask on the logits (masked logits are exactly -1e30). Greedy
    picks the first maximum; ``greedy=False`` samples each (batch, head)
    from softmax(logits) with ``torch.multinomial`` on ``generator``.

    Reads from rank_ctx: 'prev_rank' (b, hkv), 'layer_id' (int), 'w_t'
    (9,) of the current layer, 't' (the RL step, a host number)."""
    if not greedy and generator is None:
        raise ValueError("sampled actions need a torch.Generator")
    grid = torch.tensor(rank_cfg.rank_grid, dtype=torch.int32).to(h_t.device)

    def action_fn(ctx, rank_ctx):
        k_s2 = ctx["k_s2"]
        b, h = k_s2.shape[0], k_s2.shape[1]
        prev = rank_ctx.get("prev_rank")
        if prev is None:
            prev = grid[-1].expand(b, h)
        w_t = rank_ctx.get("w_t")
        if w_t is None:
            w_t = torch.zeros((9,), device=k_s2.device)
        feats, (b, h, bounds_rel, _) = build_features(
            rank_cfg, ctx, h_t, w_t, rank_ctx.get("layer_id", 0), prev)
        logits, value = policy_apply(policy_params, feats)       # (B, G)
        G = logits.shape[-1]
        mask_ok = torch.ones(logits.shape, dtype=torch.bool,
                             device=logits.device)
        if rank_cfg.guardrail:
            # eps_t as a CPU scalar: no host-device copy in the layer
            eps_t = pert.annealed_threshold(rank_cfg.epsilon0,
                                            rank_cfg.anneal_lambda,
                                            rank_ctx.get("t", 0))
            mask_ok = pert.safety_mask(bounds_rel.reshape(-1, G), eps_t)
            logits = torch.where(mask_ok, logits, -1e30)
        if greedy:
            a_idx = torch.argmax(logits, dim=-1)
        else:
            a_idx = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                      generator=generator)[:, 0]
        logp = torch.log_softmax(logits, dim=-1)
        logp_a = logp.gather(-1, a_idx[:, None])[:, 0]
        rank_k = grid[a_idx].reshape(b, h)
        chosen = bounds_rel.reshape(-1, G).gather(-1, a_idx[:, None])[:, 0]
        aux = {
            "action_idx": a_idx.reshape(b, h),
            "logits": logits.reshape(b, h, G),
            "logp": logp_a.reshape(b, h),
            "value": value.reshape(b, h),
            "delta_a_rel": chosen.reshape(b, h),
            "action_mask": mask_ok.reshape(b, h, G),
            "features": feats,
        }
        return rank_k, aux

    return action_fn
