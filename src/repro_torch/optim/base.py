"""Functional optimizer interface, the port of ``repro.optim.base``:

    init(params)                        -> opt_state
    update(grads, opt_state, params)    -> (updates, new_opt_state)

with updates applied as ``params + updates``. Parameters, gradients and
updates are flat dicts of tensors; nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
