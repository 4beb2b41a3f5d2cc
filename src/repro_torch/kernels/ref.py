"""Plain PyTorch oracles for the attention kernels: straight ports of
``repro.kernels.ref`` (masked scores at -1e30, then a softmax)."""
from __future__ import annotations

import torch


def _rows(x, b: int, device) -> torch.Tensor:
    """() or (b,) lengths / offsets as a (b,) int64 tensor."""
    t = torch.as_tensor(x, device=device).reshape(-1).to(torch.int64)
    return t.expand(b)


def decode_ref(q, k, v, kv_len, *, scale: float):
    """Single-step decode. q: (b, hq, dq); k: (b, hkv, M, dq);
    v: (b, hkv, M, dv); kv_len: () or (b,) valid prefix length.
    Returns (b, hq, dv)."""
    b, hq, _ = q.shape
    hkv, M = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(hq // hkv, dim=1)
    vr = v.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q, kr).float() * scale
    valid = (torch.arange(M, device=q.device)[None, None, :]
             < _rows(kv_len, b, q.device)[:, None, None])
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p.to(vr.dtype), vr)


def decode_chunk_ref(q, k, v, kv_len, q_start, *, scale: float):
    """Chunked-prefill decode oracle. q: (b, hq, C, dq); k: (b, hkv, M, dq);
    v: (b, hkv, M, dv); kv_len/q_start: () or (b,). Query j of row b sees
    keys k_pos <= q_start[b] + j (and k_pos < kv_len[b]).
    Returns ((b, hq, C, dv), probs (b, hq, C, M))."""
    b, hq, C, _ = q.shape
    hkv, M = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(hq // hkv, dim=1)
    vr = v.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhcd,bhkd->bhck", q, kr).float() * scale
    k_pos = torch.arange(M, device=q.device)[None, None, None, :]
    q_pos = (_rows(q_start, b, q.device)[:, None, None, None]
             + torch.arange(C, device=q.device)[None, None, :, None])
    ok = (k_pos <= q_pos) & (k_pos < _rows(kv_len, b, q.device)[:, None, None, None])
    s = s.masked_fill(~ok, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhck,bhkd->bhcd", p.to(vr.dtype), vr), p
