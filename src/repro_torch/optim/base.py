"""Functional optimizer interface, the port of ``repro.optim.base``:

    init(params)                        -> opt_state
    update(grads, opt_state, params)    -> (updates, new_opt_state)

with updates applied as ``params + updates``. Parameters, gradients and
updates are dicts of tensors, flat (the Q-network's) or nested (the
transformer's ``layers/b0_attn/*``); the optimizers work on the leaves
by their key paths (``flatten``) and hand back trees of the same
nesting, as ``jax.tree.map`` does. Nothing is updated in place. A
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


Path = Tuple[str, ...]


def flatten(tree: Dict[str, Any], prefix: Path = ()
            ) -> Dict[Path, torch.Tensor]:
    """The leaves of a nested dict by key path, in sorted-path order (the
    order ``jax.tree_util.tree_leaves`` gives a dict)."""
    out: Dict[Path, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: Dict[Path, Any]) -> Dict[str, Any]:
    """The nested dict of ``flatten``'s paths."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def apply_updates(params: Dict[str, Any],
                  updates: Dict[str, Any]) -> Dict[str, Any]:
    u = flatten(updates)
    return unflatten({k: (p + u[k]).to(p.dtype)
                      for k, p in flatten(params).items()})


def per_leaf(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-replica value (the leading axes of ``leaf``) shaped to
    broadcast against the leaf."""
    return x.reshape(x.shape + (1,) * (leaf.dim() - x.dim()))


def global_norm(tree: Dict[str, torch.Tensor],
                replicas: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, float32. The leaves
    are summed in sorted-path order, the order
    ``jax.tree_util.tree_leaves`` gives a dict, starting from 0 as
    Python's ``sum`` does. With ``replicas`` leading axes the sums stop
    there: one norm per replica."""
    total = 0
    for leaf in flatten(tree).values():
        sq = torch.square(leaf.to(torch.float32))
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
    return unflatten({k: g * per_leaf(scale, g)
                      for k, g in flatten(grads).items()}), norm


def value_and_grad(loss_fn: Callable[..., Any], params: Dict[str, Any],
                   *args, has_aux: bool = False):
    """``jax.value_and_grad(loss_fn, has_aux=has_aux)(params, *args)``:
    the loss (and a tensor aux) detached, and the gradient tree of
    ``params``, each leaf in its parameter's dtype, zeros for a leaf the
    loss does not reach. The parameters are read through leaves that
    share their storage; nothing is written in place."""
    flat = flatten(params)
    leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
    with torch.enable_grad():
        out = loss_fn(unflatten(leaves), *args)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    tree = unflatten({k: torch.zeros_like(p) if g is None else g
                      for (k, p), g in zip(leaves.items(), grads)})
    if has_aux:
        return (loss.detach(), out[1].detach()), tree
    return loss.detach(), tree
