"""Public wrappers around the port's kernels.

A wrapper runs its kernel's plain PyTorch version only because the tensors
it was given lie on the CPU; on CUDA tensors it launches the kernel or
raises, never falling back.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attn import (LAUNCHES, flash_decode,
                                             flash_decode_plain)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def decode_attention(q, k, v, kv_len, *, scale: float,
                     return_probs: bool = False, q_start=None, q_lens=None):
    """Flash decode; see :mod:`repro_torch.kernels.decode_attn` for the
    semantics. ``q`` (b, hq, r) or (b, hq, C, r); ``kv_len`` () or (b,)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len, scale=scale,
                                  return_probs=return_probs,
                                  q_start=q_start, q_lens=q_lens)
    return flash_decode(q, k, v, kv_len, scale=scale,
                        return_probs=return_probs, q_start=q_start,
                        q_lens=q_lens)
