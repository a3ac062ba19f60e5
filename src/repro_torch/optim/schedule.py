"""Learning-rate schedules (twin of ``repro/optim/schedule.py``): pure
functions of the step, computed in float32 on the CPU, so that every
device's step reads the same learning rate."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor_frac * peak_lr`` at ``total``; a float32 0-dim CPU
    tensor, each operation in the reference's order."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
