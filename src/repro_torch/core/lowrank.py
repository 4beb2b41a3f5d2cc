"""Spectral machinery for DR-RL low-rank attention: the Gram route.

Eigenvalues of the tiny d_h x d_h Gram matrix are the squared singular
values of the factor, and its top-r eigenvectors give the optimal rank-r
column-space projector. Eigenvector signs (and the order inside a
degenerate cluster) differ between solvers, so compare spectra and
projectors ``B_r B_r^T``, never raw bases.
"""
from __future__ import annotations

from typing import Tuple

import torch


def gram_spectrum(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a PSD Gram matrix (..., d, d).

    Returns (sigmas_sq, eigvecs) with sigmas_sq sorted DESCENDING and
    clamped at 0; eigvecs[..., :, i] is the i-th eigenvector."""
    evals, evecs = torch.linalg.eigh(g.float())               # ascending
    evals = torch.flip(evals, dims=(-1,))
    evecs = torch.flip(evecs, dims=(-1,))
    return evals.clamp_min(0.0), evecs


def ner_curve(sigmas_sq: torch.Tensor) -> torch.Tensor:
    """Normalized Energy Ratio (paper Eq. 14) for every rank r=1..d."""
    total = sigmas_sq.sum(dim=-1, keepdim=True)
    return torch.cumsum(sigmas_sq, dim=-1) / total.clamp_min(1e-30)


def rank_for_energy(sigmas_sq: torch.Tensor, threshold: float,
                    r_min: int, r_max: int) -> torch.Tensor:
    """Adaptive-SVD baseline: smallest r whose NER >= threshold (clipped)."""
    hit = ner_curve(sigmas_sq) >= threshold
    # argmax over bools returns the first True (int cast: argmax of bool
    # is not implemented on every backend)
    r = 1 + torch.argmax(hit.to(torch.int32), dim=-1)
    r = torch.where(hit.any(dim=-1), r, torch.full_like(r, r_max))
    return r.clamp(r_min, r_max).to(torch.int32)
