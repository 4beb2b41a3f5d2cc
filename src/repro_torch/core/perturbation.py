"""Online matrix perturbation bounds (paper section 3.3 / 4.2): the Eq. 9
guardrail and the Eq. 11 annealed threshold, on singular-value spectra."""
from __future__ import annotations

from typing import Tuple

import torch


def delta_a_bound(q_sigmas_sq: torch.Tensor, k_sigmas_sq: torch.Tensor, r,
                  d_head: int) -> torch.Tensor:
    """Paper Eq. 9:
       ||dA||_F <= (||dQ||_2 ||K||_2 + ||Q||_2 ||dK||_2) / sqrt(d)
    with ||dQ||_2 = sigma_{r+1}(Q) (best rank-r residual spectral norm).
    ``r`` is a Python int (a grid entry)."""
    idx = min(max(int(r), 0), q_sigmas_sq.shape[-1] - 1)
    dq = torch.sqrt(q_sigmas_sq[..., idx])               # sigma_{r+1}(Q)
    dk = torch.sqrt(k_sigmas_sq[..., idx])
    q_top = torch.sqrt(q_sigmas_sq[..., 0])              # ||Q||_2
    k_top = torch.sqrt(k_sigmas_sq[..., 0])
    return (dq * k_top + q_top * dk) / float(d_head) ** 0.5


def annealed_threshold(eps0: float, lam: float, t,
                       device=None) -> torch.Tensor:
    """eps_t = eps0 * exp(-lam t)   (paper Eq. 11), in f32."""
    return eps0 * torch.exp(-lam * torch.as_tensor(t, dtype=torch.float32,
                                                   device=device))


def guardrail_report(q_sigmas_sq: torch.Tensor, k_sigmas_sq: torch.Tensor,
                     rank_grid: Tuple[int, ...], d_head: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorised Eq. 9 bound over a rank grid.

    Returns (bounds (..., n_actions), normaliser (...,)) where normaliser is
    the ||Q||_2 ||K||_2 / sqrt(d) scale of the full score matrix."""
    bounds = torch.stack(
        [delta_a_bound(q_sigmas_sq, k_sigmas_sq, r, d_head) for r in rank_grid],
        dim=-1)
    norm = (torch.sqrt(q_sigmas_sq[..., 0]) * torch.sqrt(k_sigmas_sq[..., 0])
            / float(d_head) ** 0.5)
    return bounds, norm
