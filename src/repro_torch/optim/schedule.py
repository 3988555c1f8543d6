"""The paper's ε-greedy annealing schedule (Mnih et al. 2015: linear
1.0 -> 0.1), the port of ``repro.optim.schedule.linear_epsilon``."""

from __future__ import annotations

import torch


def linear_epsilon(start: float, end: float, anneal_steps: int):
    def eps(step: torch.Tensor) -> torch.Tensor:
        horizon = torch.full((), float(anneal_steps), dtype=torch.float32,
                             device=step.device)
        frac = torch.clamp(step.to(torch.float32) / horizon, 0.0, 1.0)
        return start + (end - start) * frac
    return eps
