"""LR schedules (linear warmup + cosine decay), pure functions of step
(port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return f
