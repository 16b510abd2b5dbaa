"""LR schedules.  The twin of ``src/repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor; the result is an f32
    tensor on its device).  Divisors are tensors: on a CUDA tensor a division
    by a Python number is a multiply by its rounded reciprocal."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / s.new_tensor(float(max(warmup_steps, 1)))
    t = torch.clamp((s - warmup_steps)
                    / s.new_tensor(float(max(total_steps - warmup_steps, 1))),
                    0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)
