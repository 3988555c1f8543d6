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

from repro_torch.optim.base import (Optimizer, clip_by_global_norm, flatten,
                                    per_leaf, unflatten)
from repro_torch.rng import sqrt_f32


def adamw(learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]],
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          grad_clip: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        flat = flatten(params)

        def zeros():
            return unflatten({k: torch.zeros_like(p, dtype=torch.float32)
                              for k, p in flat.items()})
        dev = next(iter(flat.values())).device
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        g32 = {k: g.to(torch.float32) for k, g in flatten(grads).items()}
        if grad_clip is not None:
            # a dict keyed by paths is a flat tree: it clips as one
            g32, _ = clip_by_global_norm(g32, grad_clip, step.dim())
        m0, v0, p0 = flatten(state["m"]), flatten(state["v"]), flatten(params)
        m = {k: b1 * m0[k] + (1 - b1) * g for k, g in g32.items()}
        v = {k: b2 * v0[k] + (1 - b2) * g * g for k, g in g32.items()}
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1 - torch.pow(torch.full_like(t, b2), t)

        def at(x, k):   # a per-replica scalar against leaf k
            return per_leaf(x, m[k]) if isinstance(x, torch.Tensor) else x
        updates = {
            k: -at(lr, k) * ((m[k] / at(bc1, k))
                             / (sqrt_f32(v[k] / at(bc2, k)) + eps)
                             + weight_decay * p0[k].to(torch.float32))
            for k in g32}
        return unflatten(updates), {"m": unflatten(m), "v": unflatten(v),
                                    "step": step}

    return Optimizer(init, update)
