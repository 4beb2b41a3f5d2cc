"""Spectral machinery for DR-RL low-rank attention: the Gram route.

Eigenvalues of the tiny d_h x d_h Gram matrix are the squared singular
values of the factor, and its top-r eigenvectors give the optimal rank-r
column-space projector. Eigenvector signs (and the order inside a
degenerate cluster) differ between solvers, so compare spectra and
projectors ``B_r B_r^T``, never raw bases.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def gram(x: torch.Tensor) -> torch.Tensor:
    """x: (..., n, d) -> Gram (..., d, d) in f32."""
    xf = x.float()
    return torch.einsum("...nd,...ne->...de", xf, xf)


def gram_spectrum(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a PSD Gram matrix (..., d, d).

    Returns (sigmas_sq, eigvecs) with sigmas_sq sorted DESCENDING and
    clamped at 0; eigvecs[..., :, i] is the i-th eigenvector."""
    evals, evecs = torch.linalg.eigh(g.float())               # ascending
    evals = torch.flip(evals, dims=(-1,))
    evecs = torch.flip(evecs, dims=(-1,))
    return evals.clamp_min(0.0), evecs


def singular_values(x: torch.Tensor) -> torch.Tensor:
    """Descending singular values of (..., n, d) via the Gram route."""
    s2, _ = gram_spectrum(gram(x))
    return torch.sqrt(s2)


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


def rank_mask(d: int, r) -> torch.Tensor:
    """(d,) float mask keeping the first r eigendirections; ``r`` may be an
    int or an integer tensor (then the mask is (*r.shape, d))."""
    r = torch.as_tensor(r)
    return (torch.arange(d, device=r.device) < r[..., None]).float()


def project_masked(x: torch.Tensor, evecs: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Rank-truncate x (..., n, d) with eigvecs (..., d, d) and mask (..., d):
    x_r = x . E diag(mask) E^T, in x's shape and dtype (the 'masked'
    realisation: dynamic rank as a mask over static shapes)."""
    xe = torch.einsum("...nd,...de->...ne", x.float(), evecs)
    xe = xe * mask[..., None, :]
    return torch.einsum("...ne,...de->...nd", xe, evecs).to(x.dtype)


def project_static(x: torch.Tensor, evecs: torch.Tensor, r: int) -> torch.Tensor:
    """Rank-r factor x~ = x . E[:, :r] of shape (..., n, r): the score
    contraction then runs over r instead of d."""
    return torch.einsum("...nd,...dr->...nr", x.float(),
                        evecs[..., :, :r]).to(x.dtype)


def mixing_matrix(eq: torch.Tensor, ek: torch.Tensor, r: int) -> torch.Tensor:
    """M = Eq[:, :r]^T Ek[:, :r] (..., r, r), so that
    Q_r K_r^T == (Q Eq_r) M (K Ek_r)^T with rank-r factors on both sides."""
    return torch.einsum("...dr,...ds->...rs", eq[..., :, :r], ek[..., :, :r])


# ---------------------------------------------------------------------------
# Matmul-only spectral routines (subspace / power iteration). Each starts
# from a random draw: pass it (``q0`` / ``v0``, before any orthonormalisation)
# or a ``generator`` to draw it from. The reference draws from fixed
# jax.random keys, whose bits torch cannot reproduce.
# ---------------------------------------------------------------------------

def _start(shape, start: Optional[torch.Tensor], generator, device):
    if start is not None:
        return start.float().to(device)
    if generator is None:
        raise ValueError("pass the start draw or a torch.Generator")
    return torch.randn(shape, generator=generator, device=generator.device
                       ).to(device)


def subspace_iteration(g: torch.Tensor, r: int, iters: int = 3,
                       q0: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       oversample: int = 4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-r eigenpairs of PSD g (..., d, d) by subspace (block power)
    iteration on an oversampled block of r + p columns, p = min(oversample,
    d - r), then Rayleigh-Ritz. ``q0`` (..., d, r + p) is the start block.
    Returns (evals_desc (..., r) clamped at 0, basis (..., d, r))."""
    d = g.shape[-1]
    p = min(oversample, d - r)
    g = g.float()
    q, _ = torch.linalg.qr(_start(g.shape[:-2] + (d, r + p), q0, generator,
                                  g.device))
    for _ in range(iters):
        q, _ = torch.linalg.qr(g @ q)
    h = q.transpose(-1, -2) @ g @ q
    evals, u = torch.linalg.eigh(h)
    evals = torch.flip(evals, dims=(-1,))[..., :r]
    u = torch.flip(u, dims=(-1,))[..., :r]
    return evals.clamp_min(0.0), q @ u


def incremental_extend(g: torch.Tensor, basis_r: torch.Tensor, extra: int,
                       iters: int = 3, q0: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Incremental rank update (paper Eq. 12): given the cached top-r
    eigenbasis ``basis_r`` (..., d, r) of g, ``extra`` further eigenpairs by
    subspace iteration on the deflated operator (I - B B^T) g (I - B B^T).
    ``q0`` (..., d, extra) is the start block. Returns (new_evals
    (..., extra) clamped at 0, extended basis (..., d, r + extra))."""
    d = g.shape[-1]
    g = g.float()
    b = basis_r.float()

    def deflate(v):
        return v - b @ (b.transpose(-1, -2) @ v)

    q, _ = torch.linalg.qr(deflate(_start(g.shape[:-2] + (d, extra), q0,
                                          generator, g.device)))
    for _ in range(iters):
        q, _ = torch.linalg.qr(deflate(g @ q))
    h = q.transpose(-1, -2) @ g @ q
    evals, u = torch.linalg.eigh(h)
    evals = torch.flip(evals, dims=(-1,))
    u = torch.flip(u, dims=(-1,))
    return evals.clamp_min(0.0), torch.cat([b, q @ u], dim=-1)


def power_iteration_specnorm(m: torch.Tensor, iters: int = 3,
                             v0: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """Spectral norm of (..., a, b) by power iteration on M^T M (paper
    Eq. 16). ``v0`` (..., b) is the start vector. A few iterations do not
    converge, so the estimate depends on the start."""
    mf = m.float()
    v = _start(m.shape[:-2] + (m.shape[-1],), v0, generator, m.device)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)
    for _ in range(iters):
        mv = torch.einsum("...ab,...b->...a", mf, v)
        mtmv = torch.einsum("...ab,...a->...b", mf, mv)
        v = mtmv / (torch.linalg.vector_norm(mtmv, dim=-1, keepdim=True)
                    + 1e-30)
    mv = torch.einsum("...ab,...b->...a", mf, v)
    return torch.linalg.vector_norm(mv, dim=-1)
