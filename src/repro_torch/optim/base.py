"""Functional optimizer interface, the port of ``repro.optim.base``:

    init(params)                        -> opt_state
    update(grads, opt_state, params)    -> (updates, new_opt_state)

with updates applied as ``params + updates``. Parameters, gradients and
updates are flat dicts of tensors; nothing is updated in place. A
population's leaves carry a leading replica axis; the update is
elementwise apart from the global norm, which is then taken per replica
(``replicas=1``).
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


def per_leaf(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-replica value (the leading axes of ``leaf``) shaped to
    broadcast against the leaf."""
    return x.reshape(x.shape + (1,) * (leaf.dim() - x.dim()))


def global_norm(tree: Dict[str, torch.Tensor],
                replicas: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, float32. The leaves
    are summed in sorted-key order, the order ``jax.tree_util.tree_leaves``
    gives a dict, starting from 0 as Python's ``sum`` does. With
    ``replicas`` leading axes the sums stop there: one norm per
    replica."""
    total = 0
    for k in sorted(tree):
        sq = torch.square(tree[k].to(torch.float32))
        total = total + (sq.flatten(replicas).sum(dim=-1) if replicas
                         else torch.sum(sq))
    return sqrt_f32(total)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        replicas: int = 0
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm); returns the scaled
    tree and the norm before scaling. With ``replicas`` leading axes,
    each replica is clipped by its own norm."""
    norm = global_norm(grads, replicas)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * per_leaf(scale, g) for k, g in grads.items()}, norm
