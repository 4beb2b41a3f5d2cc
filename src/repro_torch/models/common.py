"""Shared model components of the port: RoPE and the GQA head maps."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (b, s, h, d); positions: (b, s) integer. Rotate-half RoPE in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    angles = positions[..., None].float() * freqs           # (b, s, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, kv, d) -> (b, s, kv*n_rep, d) for GQA."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def kv_group_mean(w: torch.Tensor, hkv: int) -> torch.Tensor:
    """(..., hq, K) per-q-head key weights -> (..., hkv, K) mean per kv
    group: the inverse reduction of :func:`repeat_kv`."""
    hq, K = w.shape[-2], w.shape[-1]
    return w.reshape(*w.shape[:-2], hkv, hq // hkv, K).mean(dim=-2)
