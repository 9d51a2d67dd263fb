"""Learning-rate schedules (pure functions of the step counter; port of
``repro.optim.schedule``). ``step`` is an int or a tensor; the result is a
float32 tensor."""

from __future__ import annotations

import math

import torch


def linear_warmup(step, *, peak: float, warmup_steps: int):
    step = torch.as_tensor(step, dtype=torch.float32)
    return peak * torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, *, peak: float, warmup_steps: int, total_steps: int,
                    floor_ratio: float = 0.1):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = linear_warmup(step, peak=peak, warmup_steps=warmup_steps)
    t = torch.clamp((step - warmup_steps) /
                    max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = peak * (floor_ratio + (1 - floor_ratio) * 0.5 *
                  (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
