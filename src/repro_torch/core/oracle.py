"""Greedy oracle for the behaviour-cloning warm start (paper 4.5.3;
``repro.core.oracle``).

The oracle scores the Eq. 13 reward of *every* rank of the grid (an
exhaustive sweep) and returns the argmax. Fidelity is exact: the cosine
similarity between the full-rank and the rank-r attention outputs, per
(batch, kv-head). It does not apply the Eq. 11 mask, so it may pick a rank
that the agent's mask forbids.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import RankConfig
from repro_torch.core import perturbation as pert
from repro_torch.core.rewards import reward
from repro_torch.models.attention import apply_rank_masked, attend, spectral_ctx
from repro_torch.models.common import repeat_kv


def oracle_actions(rank_cfg: RankConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, causal: bool = True,
                   chunked: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """q: (b, s, hq, d), k/v: (b, s, hkv, d). Returns (action_idx (b, hkv),
    {'rewards' (b, hkv, G), 'bounds_rel' (b, hkv, G)}). ``chunked`` as in
    :func:`repro_torch.models.attention.attend`: with more than 1024 keys
    its 1 + G attentions go through ``ops.flash_attention`` (the
    ``lowrank_flash`` kernel on CUDA tensors); the function is the same."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    scale = d ** -0.5
    ctx = spectral_ctx(q, k)
    kr, vr = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    o_full = attend(q, kr, vr, scale=scale, causal=causal,
                    chunked=chunked).float()
    of_norm = torch.linalg.vector_norm(o_full, dim=(1, 3))

    q_s2 = (ctx["q_s2"].reshape(b, hkv, n_rep, d).mean(2)
            if hq != hkv else ctx["q_s2"])
    bounds, norm = pert.guardrail_report(q_s2, ctx["k_s2"], rank_cfg.rank_grid, d)
    bounds_rel = bounds / norm[..., None].clamp_min(1e-30)

    rewards = []
    for gi, r in enumerate(rank_cfg.rank_grid):
        rank_k = torch.full((b, hkv), r, dtype=torch.int32, device=q.device)
        rank_q = rank_k.repeat_interleave(n_rep, dim=1) if n_rep > 1 else rank_k
        q_r, k_r = apply_rank_masked(q, k, ctx, rank_q, rank_k)
        o_r = attend(q_r, repeat_kv(k_r, n_rep), vr, scale=scale,
                     causal=causal, chunked=chunked).float()
        num = (o_full * o_r).sum(dim=(1, 3))
        den = of_norm * torch.linalg.vector_norm(o_r, dim=(1, 3)) + 1e-30
        fid = num / den                                    # (b, hq)
        fid_kv = fid.reshape(b, hkv, n_rep).mean(-1) if n_rep > 1 else fid
        rewards.append(reward(rank_cfg, fid_kv, rank_k, bounds_rel[..., gi], d, d))
    rewards = torch.stack(rewards, dim=-1)                 # (b, hkv, G)
    return rewards.argmax(dim=-1), {"rewards": rewards, "bounds_rel": bounds_rel}
