"""AdamW with decoupled weight decay, an optional learning-rate schedule
and global-norm clipping: the port of ``repro.optim.adamw``, in the same
operation order. The DQN path builds it as ``adamw(lr or 1e-3,
weight_decay=0.0)``, which keeps the default ``grad_clip=1.0``.

    g    = clip_by_global_norm(grad, grad_clip)
    m_t  = b1 * m + (1 - b1) * g
    v_t  = b2 * v + (1 - b2) * g^2
    p   -= lr * ((m_t / (1 - b1^t)) / (sqrt(v_t / (1 - b2^t)) + eps)
                 + weight_decay * p)

The step counter is int32, as in the reference; ``b^t`` is taken in
float32 on the float32 step, and every square root is correctly rounded
(``rng.sqrt_f32``). A population's state has a (R,) step, and then the
bias corrections, the schedule and the clipping norm are per replica.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.optim.base import Optimizer, clip_by_global_norm, per_leaf
from repro_torch.rng import sqrt_f32


def adamw(learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]],
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          grad_clip: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
        dev = next(iter(params.values())).device
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        g32 = {k: g.to(torch.float32) for k, g in grads.items()}
        if grad_clip is not None:
            g32, _ = clip_by_global_norm(g32, grad_clip, step.dim())
        m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in g32.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * g * g
             for k, g in g32.items()}
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1 - torch.pow(torch.full_like(t, b2), t)

        def at(x, k):   # a per-replica scalar against leaf k
            return per_leaf(x, m[k]) if isinstance(x, torch.Tensor) else x
        updates = {
            k: -at(lr, k) * ((m[k] / at(bc1, k))
                             / (sqrt_f32(v[k] / at(bc2, k)) + eps)
                             + weight_decay * params[k].to(torch.float32))
            for k in g32}
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)
