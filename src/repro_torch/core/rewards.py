"""DR-RL reward (paper Eq. 8 / Eq. 13; ``repro.core.rewards``).

R_t = alpha * sim(A_full, A_r)  -  beta * FLOPs(r_t)  -  gamma * ||dA||_F

* sim       — cosine similarity between the full-rank and rank-r attention
              outputs (the forward's fidelity, or the oracle's own);
* FLOPs(r)  — score + value FLOPs at rank r relative to full rank;
* ||dA||_F  — the Eq. 9 bound at the chosen rank, relative to the full
              score scale, so the penalty is dimensionless.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import RankConfig


def flops_fraction(rank: torch.Tensor, d_head: int, d_v: int) -> torch.Tensor:
    """Attention FLOPs at rank r relative to full rank (the score
    contraction runs over r instead of d_head; the value term is
    unchanged)."""
    return (rank.float() + d_v) / float(d_head + d_v)


def reward(rank_cfg: RankConfig, fidelity: torch.Tensor, rank: torch.Tensor,
           delta_a_rel: torch.Tensor, d_head: int, d_v: int) -> torch.Tensor:
    """Element-wise Eq. 13 over whatever batch/head shape the inputs carry."""
    return (rank_cfg.alpha * fidelity
            - rank_cfg.beta * flops_fraction(rank, d_head, d_v)
            - rank_cfg.gamma * delta_a_rel)


def reward_components(rank_cfg: RankConfig, fidelity, rank, delta_a_rel,
                      d_head: int, d_v: int) -> Tuple[torch.Tensor, dict]:
    r = reward(rank_cfg, fidelity, rank, delta_a_rel, d_head, d_v)
    return r, {
        "fidelity": fidelity,
        "flops_frac": flops_fraction(rank, d_head, d_v),
        "delta_a_rel": delta_a_rel,
    }
