"""Learning-rate schedules: functions of the step counter, a tensor.

The reference's ``repro.optim.schedules``, in float32. Every quotient
divides by a tensor (``true_divide``): on a CUDA tensor, division by a
Python number multiplies by its reciprocal."""

from __future__ import annotations

import math

import torch

from repro_torch.core.quantization import true_divide


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1):
    """``fn(step)``: cosine decay from ``peak_lr`` to ``final_frac *
    peak_lr`` over ``total_steps``, then flat."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp_max(true_divide(step.float(), float(total_steps)), 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    """``fn(step)``: linear warmup to ``peak_lr`` over ``warmup_steps``,
    then :func:`cosine_schedule`'s decay over the remaining steps."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = true_divide(peak_lr * s, float(max(1, warmup_steps)))
        t = torch.clamp(true_divide(s - warmup_steps, float(max(1, total_steps - warmup_steps))),
                        0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return fn
