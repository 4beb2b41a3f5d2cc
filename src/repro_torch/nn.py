"""Functional NN pieces of the port on plain tensors (parameters are nested
dicts of tensors, as in ``repro.nn``; matrices keep JAX's (in, out)
layout, so ``x @ w`` is JAX's ``einsum('...d,df->...f')``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *, device,
               dtype=torch.float32, scale: Optional[float] = None,
               batch=()) -> torch.Tensor:
    """Truncated-normal (+-3 std) fan-in init, (*batch, in, out): the shapes
    and scales of ``repro.nn.dense_init`` (not its random bits)."""
    std = scale if scale is not None else in_dim ** -0.5
    w = torch.empty((*batch, in_dim, out_dim), dtype=torch.float32,
                    device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, *, device,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w.to(dtype)


def linear(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def rms_norm(x, gamma, eps: float = 1e-5):
    """RMSNorm computed in f32, returned in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(dtype)


def swiglu(x, w_gate, w_up, w_down):
    return linear(F.silu(linear(x, w_gate)) * linear(x, w_up), w_down)


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy of (..., V) logits in f32 against integer
    ``labels`` (...); with ``mask`` (...), the mask-weighted mean."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
