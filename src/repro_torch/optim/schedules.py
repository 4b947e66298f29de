"""LR schedules as step -> lr callables.  ``step`` is a Python int or a
0-d tensor; the result is a 0-d float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_step(step), lr)


def linear_warmup(lr: float, warmup: int):
    def f(step):
        s = _step(step)
        return lr * torch.clamp(s / max(warmup, 1), max=1.0)
    return f


def cosine_warmup(lr: float, warmup: int, total: int, floor: float = 0.1):
    def f(step):
        s = _step(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return f
