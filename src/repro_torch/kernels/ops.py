"""Public wrappers around the port's kernels.

A wrapper runs its kernel's plain PyTorch version only because the tensors
it was given lie on the CPU; on CUDA tensors it launches the kernel or
raises, never falling back.

Gradients: where autograd records a call (grad enabled and an input that
requires grad), :func:`flash_attention` goes to
``lowrank_flash.LowrankFlash`` whatever the number of queries: on CUDA the
forward kernel for the inputs' type and its backward kernel
(``csrc/lowrank_flash_bwd.cu`` for f32, ``csrc/lowrank_flash_bwd_bf16.cu``
for bf16), on the CPU the same Function over the plain versions.
``flash_decode`` has no backward, so :func:`decode_attention` raises on
CUDA where autograd would record it; its plain version on the CPU stays
differentiable. Calls that need no gradient take the routes below
unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attn, lowrank_flash
from repro_torch.kernels.decode_attn import flash_decode, flash_decode_plain


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for counts in (decode_attn.LAUNCHES, lowrank_flash.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _records(*tensors) -> bool:
    """Whether autograd records a call on these inputs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(name: str, *tensors) -> None:
    if _records(*tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it "
                           "under torch.no_grad() or on inputs that do not "
                           "require grad")


def few_query(sq: int, r: int, dv: int) -> bool:
    """Whether a flash-attention call of ``sq`` queries at widths r, dv
    goes to flash_decode's split-key kernels (its decode path: the keys
    split across blocks, one K/V read per GQA group) instead of
    lowrank_flash's query tiles, which a few queries leave nearly empty.
    A rule of shapes alone, the same on every device."""
    return (sq <= decode_attn.DECODE_MAX_C and r <= decode_attn.MAX_DIM
            and dv <= decode_attn.MAX_DIM)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    q_offset: int = 0):
    """Flash attention over (b, h, s, d) layouts, d possibly a truncated
    rank; see :mod:`repro_torch.kernels.lowrank_flash` for the semantics.
    ``q`` (b, hq, sq, r), ``k`` (b, hkv, skv, r), ``v`` (b, hkv, skv, dv),
    any strides. A call that autograd records goes to
    ``lowrank_flash.LowrankFlash`` on contiguous copies (on CUDA, f32 or
    bf16: both passes kernels). Otherwise a call with few queries
    (:func:`few_query`) is flash_decode's function with kv_len = skv and
    q_start = q_offset (causal) or skv - 1 (every key visible): it goes
    there with K and V read in place; every other call to lowrank_flash,
    on contiguous copies."""
    if _records(q, k, v):
        return lowrank_flash.LowrankFlash.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), scale, causal,
            lowrank_flash.check_offset(q_offset))
    if few_query(q.shape[2], q.shape[3], v.shape[3]):
        q_offset = lowrank_flash.check_offset(q_offset)
        b, skv = q.shape[0], k.shape[2]
        lens = torch.full((b,), skv, dtype=torch.int32, device=q.device)
        start = torch.full((b,), q_offset if causal else skv - 1,
                           dtype=torch.int32, device=q.device)
        return decode_attention(q.contiguous(), k, v, lens, scale=scale,
                                q_start=start)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
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
    _refuse_grad("decode_attention", q, k, v)
    return flash_decode(q, k, v, kv_len, scale=scale,
                        return_probs=return_probs, q_start=q_start,
                        q_lens=q_lens)
