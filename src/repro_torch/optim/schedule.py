"""LR schedules. The paper uses cosine annealing 1e-3 -> 1e-5 over 3000
steps. Evaluated in float32, as the reference's are."""
from __future__ import annotations

import math

import torch


def cosine_annealing(lr_max: float, lr_min: float, total_steps: int,
                     warmup_steps: int = 0):
    """Cosine decay from lr_max to lr_min with optional linear warmup."""

    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        if warmup_steps > 0:
            warm = lr_max * step / warmup_steps
        else:
            warm = torch.tensor(lr_max, dtype=torch.float32)
        denom = max(total_steps - warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / denom, 0.0, 1.0)
        cos = lr_min + 0.5 * (lr_max - lr_min) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def constant(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32)

    return fn
