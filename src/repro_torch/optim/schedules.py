"""LR schedules (``repro.optim.schedules``): linear warm-up, then linear,
cosine or constant decay, computed in f32 from the integer step."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def make_lr_fn(tc: TrainConfig):
    """``lr_fn(step)``: the learning rate at ``step`` (an integer tensor),
    an f32 tensor on the step's device."""
    peak, warm, total = tc.lr, tc.warmup_steps, tc.total_steps

    def lr_fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warmup = peak * s / max(warm, 1)
        frac = ((s - warm) / max(total - warm, 1)).clamp(0.0, 1.0)
        if tc.schedule == "cosine":
            decay = peak * 0.5 * (1.0 + torch.cos(math.pi * frac))
        elif tc.schedule == "linear":
            decay = peak * (1.0 - frac)
        else:
            decay = torch.full_like(s, peak)
        return torch.where(s < warm, warmup, decay)

    return lr_fn
