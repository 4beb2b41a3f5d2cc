"""Static low-rank attention baselines of the paper's comparison set
(``repro.core.baselines``): Performer (FAVOR+ positive random features)
and Nystromformer (landmark attention), drop-in sequence mixers of the
dense transformer in rank modes 'performer' and 'nystrom'.

Both are plain tensor algebra (XLA einsums in the JAX package, no Pallas
kernel), so here they are ``torch.einsum`` / ``torch.matmul``.
"""
from __future__ import annotations

import math

import torch


def favor_features(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Positive softmax-kernel random features (Choromanski et al. 2020).
    x: (b, s, h, d); proj: (h, m, d) orthogonal rows. Returns (b, s, h, m)."""
    d = x.shape[-1]
    x = x / d ** 0.25
    xw = torch.einsum("bshd,hmd->bshm", x, proj.to(x.dtype))
    sq = 0.5 * (x * x).sum(dim=-1, keepdim=True)
    m = proj.shape[1]
    return torch.exp(xw - sq - xw.amax(dim=-1, keepdim=True)) / math.sqrt(m)


def orthogonal_proj(generator: torch.Generator, h: int, m: int,
                    d: int) -> torch.Tensor:
    """Per-head orthogonal random feature matrices (h, m, d): rows of QR
    factors of Gaussian (d, d) blocks, each row scaled by a chi(d) norm.
    The same distribution as the reference's draw, from ``generator``
    (a CPU generator gives the same matrices for every device)."""
    dev = generator.device
    heads = []
    for _ in range(h):
        blocks = []
        for _ in range((m + d - 1) // d):
            q, _ = torch.linalg.qr(torch.randn((d, d), generator=generator,
                                               device=dev))
            blocks.append(q.T)
        w = torch.cat(blocks, dim=0)[:m]
        chi2 = torch.randn((m, d), generator=generator,
                           device=dev).square().sum(dim=-1, keepdim=True)
        heads.append(w * chi2.sqrt())
    return torch.stack(heads)


def performer_attention(q, k, v, *, proj: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q, k: (b, s, h, d); v: (b, s, h, dv). Linear-complexity FAVOR+;
    the causal form runs prefix sums over s."""
    qf = favor_features(q, proj)                    # (b, s, h, m)
    kf = favor_features(k, proj)
    if not causal:
        kv = torch.einsum("bshm,bshd->bhmd", kf, v)
        z = torch.einsum("bshm,bhm->bsh", qf, kf.sum(dim=1))
        num = torch.einsum("bshm,bhmd->bshd", qf, kv)
        return num / z[..., None].clamp_min(1e-6)
    kv_cum = torch.cumsum(torch.einsum("bshm,bshd->bshmd", kf, v), dim=1)
    k_cum = torch.cumsum(kf, dim=1)
    num = torch.einsum("bshm,bshmd->bshd", qf, kv_cum)
    den = torch.einsum("bshm,bshm->bsh", qf, k_cum)
    return num / den[..., None].clamp_min(1e-6)


def nystrom_attention(q, k, v, *, n_landmarks: int = 32, causal: bool = True,
                      pinv_iters: int = 6) -> torch.Tensor:
    """Nystromformer (Xiong et al. 2021): segment-mean landmarks, the
    landmark kernel's pseudo-inverse by ``pinv_iters`` Newton-Schulz
    iterations, and (``causal``) the output scaled by the causal mass
    fraction (position + 1) / s. q, k: (b, s, h, d); v: (b, s, h, dv)."""
    b, s, h, d = q.shape
    m = min(n_landmarks, s)
    scale = d ** -0.5
    seg = s // m
    q_l = q[:, :seg * m].reshape(b, m, seg, h, d).mean(dim=2)   # landmarks
    k_l = k[:, :seg * m].reshape(b, m, seg, h, d).mean(dim=2)

    def soft(a):
        return torch.softmax((a * scale).float(), dim=-1).to(q.dtype)

    f1 = soft(torch.einsum("bqhd,bmhd->bhqm", q, k_l))          # (b, h, s, m)
    a_mid = soft(torch.einsum("bqhd,bmhd->bhqm", q_l, k_l))     # (b, h, m, m)
    f3 = soft(torch.einsum("bmhd,bkhd->bhmk", q_l, k))          # (b, h, m, s)

    z = a_mid.float()
    az = z / (z.abs().sum(dim=-1).amax(dim=-1, keepdim=True)[..., None]
              * z.abs().sum(dim=-2).amax(dim=-1, keepdim=True)[..., None])
    zi = az.transpose(-1, -2)
    eye = torch.eye(m, device=q.device)
    for _ in range(pinv_iters):
        zz = z @ zi
        zi = zi @ (13 * eye - zz @ (15 * eye - 7 * zz + zz @ zz)) / 4.0
    # f1 . zi . (f3 . v): the (s, s) product is never formed
    vh = v.float().transpose(1, 2)                              # (b, h, s, dv)
    out = ((f1.float() @ zi) @ (f3.float() @ vh)).transpose(1, 2)
    if causal:
        frac = (torch.arange(s, dtype=torch.float32, device=q.device) + 1.0) / s
        out = out * frac[None, :, None, None]
    return out.to(v.dtype)
