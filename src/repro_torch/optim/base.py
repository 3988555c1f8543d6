"""Functional optimizer interface, the port of ``repro.optim.base``:

    init(params)                        -> opt_state
    update(grads, opt_state, params)    -> (updates, new_opt_state)

with updates applied as ``params + updates``. Parameters, gradients and
updates are flat dicts of tensors; nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.rng import sqrt_f32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, float32. The leaves
    are summed in sorted-key order, the order ``jax.tree_util.tree_leaves``
    gives a dict, starting from 0 as Python's ``sum`` does."""
    total = 0
    for k in sorted(tree):
        total = total + torch.sum(torch.square(tree[k].to(torch.float32)))
    return sqrt_f32(total)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm); returns the scaled
    tree and the norm before scaling."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm
