"""Score/softmax/value core of the port's attention (``attend`` of
``repro.models.attention``); ``mhsa`` is not ported yet."""
from __future__ import annotations

from typing import Optional

import torch


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, causal: bool, q_offset: int = 0,
           kv_len: Optional[torch.Tensor] = None,
           score_dtype=torch.float32, return_probs: bool = False):
    """softmax(q k^T * scale) v.

    q: (b, sq, h, dq)  k: (b, skv, h, dq)  v: (b, skv, h, dv). ``dq`` may be
    a truncated rank r (the caller supplies the scale). ``kv_len``
    (broadcastable to (b, h, sq, 1)) masks out positions >= kv_len.
    ``score_dtype=torch.bfloat16`` keeps the score chain in bf16 with the
    denominator accumulated in f32. ``return_probs`` also returns the
    probabilities (b, h, sq, skv)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(score_dtype) * scale
    sq, skv = q.shape[1], k.shape[1]
    neg = torch.tensor(-1e30, dtype=score_dtype, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        s = torch.where(k_pos[None, :] <= q_pos, s, neg)
    if kv_len is not None:
        s = torch.where(k_pos < kv_len, s, neg)
    if score_dtype == torch.float32:
        p = torch.softmax(s, dim=-1).to(v.dtype)
    else:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        denom = e.float().sum(dim=-1, keepdim=True)
        p = (e / denom.clamp_min(1e-30).to(score_dtype)).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return (out, p) if return_probs else out
