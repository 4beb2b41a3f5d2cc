"""Public wrappers around the port's kernels.

A wrapper runs its kernel's plain PyTorch version only because the tensors
it was given lie on the CPU; on CUDA tensors it launches the kernel or
raises, never falling back.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attn, lowrank_flash
from repro_torch.kernels.decode_attn import flash_decode, flash_decode_plain


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for counts in (decode_attn.LAUNCHES, lowrank_flash.LAUNCHES):
        for name in counts:
            counts[name] = 0


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    q_offset: int = 0):
    """Flash attention over (b, h, s, d) layouts, d possibly a truncated
    rank; see :mod:`repro_torch.kernels.lowrank_flash` for the semantics.
    ``q`` (b, hq, sq, r), ``k`` (b, hkv, skv, r), ``v`` (b, hkv, skv, dv)."""
    if q.device.type == "cpu":
        return lowrank_flash.lowrank_flash_plain(q, k, v, scale=scale,
                                                 causal=causal,
                                                 q_offset=q_offset)
    return lowrank_flash.lowrank_flash(q, k, v, scale=scale, causal=causal,
                                       q_offset=q_offset)


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
