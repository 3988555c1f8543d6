"""Learning-rate schedules and the paper's ε-greedy annealing schedule
(Mnih et al. 2015: linear 1.0 -> 0.1): the port of
``repro.optim.schedule``."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a cosine
    decay to ``floor * peak`` at ``total_steps``; float32 on the step's
    device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def linear_epsilon(start: float, end: float, anneal_steps: int):
    def eps(step: torch.Tensor) -> torch.Tensor:
        horizon = torch.full((), float(anneal_steps), dtype=torch.float32,
                             device=step.device)
        frac = torch.clamp(step.to(torch.float32) / horizon, 0.0, 1.0)
        return start + (end - start) * frac
    return eps
