"""Online matrix perturbation bounds (paper section 3.3 / 4.2): the
Eq. 3-5 truncation bounds, the Eq. 9 guardrail and the Eq. 11 annealed
threshold and safety mask, all on singular-value spectra."""
from __future__ import annotations

from typing import Tuple

import torch


def eckart_young_tail(sigmas_sq: torch.Tensor, r) -> torch.Tensor:
    """||A - A_r||_F = sqrt(sum_{i>r} sigma_i^2)   (paper Eq. 3).

    sigmas_sq: (..., d) descending; ``r`` an int or a 0-d integer tensor."""
    d = sigmas_sq.shape[-1]
    tail = (torch.arange(d, device=sigmas_sq.device) >= r).to(sigmas_sq.dtype)
    return torch.sqrt((sigmas_sq * tail).sum(dim=-1))


def rank_transition_norm(sigmas_sq: torch.Tensor, r, r_new) -> torch.Tensor:
    """||A_{r'} - A_r||_F = sqrt(sum_{k in (r, r']} sigma_k^2)  (paper Eq. 4)."""
    d = sigmas_sq.shape[-1]
    idx = torch.arange(d, device=sigmas_sq.device)
    lo = torch.minimum(torch.as_tensor(r), torch.as_tensor(r_new))
    hi = torch.maximum(torch.as_tensor(r), torch.as_tensor(r_new))
    band = ((idx >= lo) & (idx < hi)).to(sigmas_sq.dtype)
    return torch.sqrt((sigmas_sq * band).sum(dim=-1))


def output_sensitivity(sigmas_sq: torch.Tensor, r,
                       v_fro: torch.Tensor) -> torch.Tensor:
    """||Y_{r'} - Y_r||_F <= sigma_{r+1} ||V||_F   (paper Eq. 5 / 10).

    ``r`` an int or an integer tensor broadcastable to sigmas_sq's batch
    shape (...)."""
    d = sigmas_sq.shape[-1]
    idx = torch.as_tensor(r, device=sigmas_sq.device).long().clamp(0, d - 1)
    idx = idx.expand(sigmas_sq.shape[:-1])[..., None]
    return torch.sqrt(sigmas_sq.gather(-1, idx))[..., 0] * v_fro


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


def safety_mask(bounds_per_action: torch.Tensor, eps_t,
                normaliser: torch.Tensor = None) -> torch.Tensor:
    """Boolean mask over the rank grid, True = action allowed (paper
    4.3.1, Eq. 11): the bound per candidate rank (..., n_actions), divided
    by ``normaliser`` (...) when given, must not exceed ``eps_t``. The last
    (largest-rank, lowest-bound) action is always allowed, so the guardrail
    never leaves the agent without a legal action."""
    b = bounds_per_action
    if normaliser is not None:
        b = b / normaliser[..., None].clamp_min(1e-30)
    ok = b <= eps_t
    ok[..., -1] = True
    return ok
