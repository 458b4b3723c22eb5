"""Learning-rate schedules (mirror of ``repro.optim.schedule``). A schedule
maps a step (an int or a tensor) to a float32 scalar tensor on the CPU."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        frac = torch.clamp(s / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_frac: float = 0.1,
):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return fn
