"""Shared model components of the port: RoPE, the GQA head maps and the
dense KV-cache append."""
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


def cache_update(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Append k/v (b, s_new, kv, d) at ``cache['len']`` (an int) of a dense
    cache {'k', 'v': (b, max_len, kv, d), 'len'}. The cache tensors are
    written IN PLACE (JAX returns updated copies; no caller of the port
    keeps the old values) and returned with the advanced length."""
    idx, s_new = int(cache["len"]), k_new.shape[1]
    if idx + s_new > cache["k"].shape[1]:
        raise ValueError(f"cache holds {cache['k'].shape[1]} positions, "
                         f"appending {s_new} at {idx}")
    cache["k"][:, idx:idx + s_new] = k_new.to(cache["k"].dtype)
    cache["v"][:, idx:idx + s_new] = v_new.to(cache["v"].dtype)
    return {"k": cache["k"], "v": cache["v"], "len": idx + s_new}
