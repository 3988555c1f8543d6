"""Centered RMSProp as used by DQN (Mnih et al. 2015): decay 0.95 on
both moments, eps 0.01 inside the square root. The port of
``repro.optim.rmsprop``, in the same operation order.

    g_t  = rho * g_{t-1}  + (1-rho) * grad
    s_t  = rho * s_{t-1}  + (1-rho) * grad^2
    p   -= lr * grad / sqrt(s_t - g_t^2 + eps)
"""

from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer
from repro_torch.rng import sqrt_f32


def centered_rmsprop(learning_rate: float, decay: float = 0.95,
                     eps: float = 0.01, centered: bool = True) -> Optimizer:
    def init(params):
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for k, p in params.items()}
        return {"s": zeros(), "g": zeros()} if centered else {"s": zeros()}

    def update(grads, state, params):
        del params
        s, m, updates = {}, {}, {}
        for k, g in grads.items():
            g = g.to(torch.float32)
            s[k] = decay * state["s"][k] + (1 - decay) * g * g
            if centered:
                m[k] = decay * state["g"][k] + (1 - decay) * g
                denom = sqrt_f32(s[k] - m[k] * m[k] + eps)
            else:
                denom = sqrt_f32(s[k] + eps)
            updates[k] = -learning_rate * g / denom
        return updates, ({"s": s, "g": m} if centered else {"s": s})

    return Optimizer(init, update)
