"""LR schedules (pure step -> lr functions).

A step is an int or a 0-d tensor; the value is a float32 0-d tensor (on
the step's device when the step is a tensor), computed as the reference
computes it in float32.
"""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = _step_f32(step)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)

    return fn


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        s = _step_f32(step)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, peak * cos)

    return fn
