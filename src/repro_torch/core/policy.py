"""Stateless policy evaluation, the action-selection primitive: the port
of ``repro.core.policy``. One batched ``q_forward`` call per step, then
ε-greedy per stream, each stream drawing only from its own key."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch import rng

__all__ = ["egreedy_stream", "stream_keys", "policy_step"]


def stream_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """One round key -> (n, 2) per-stream keys."""
    return rng.split(key, n)


def egreedy_stream(q: torch.Tensor, eps: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """ε-greedy over a batch of streams: q (B, A), eps (B,), keys (B, 2)
    -> (B,) int32 actions (any leading stream axes: (R, W, A), (R, W) and
    (R, W, 2) for a population). Row i's draw depends only on keys[i]."""
    k = rng.split(keys)
    greedy = torch.argmax(q, dim=-1)
    rand = rng.randint(k[..., 1, :], (), 0, q.shape[-1])
    explore = rng.uniform(k[..., 0, :], ()) < eps
    return torch.where(explore, rand.to(torch.int64), greedy).to(torch.int32)


def policy_step(q_forward: Callable, params, obs: torch.Tensor,
                eps: Union[float, torch.Tensor], keys: torch.Tensor,
                noise_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Actions for a batch of observation stacks: ONE ``q_forward`` call,
    then per-stream ε-greedy. ``eps`` is a scalar or (B,) rates; for a
    population's (R, W) streams, a scalar, (R,) rates broadcast to each
    replica's streams, or (R, W)."""
    q = (q_forward(params, obs) if noise_key is None
         else q_forward(params, obs, noise_key))
    if not isinstance(eps, torch.Tensor):
        eps = torch.full((), eps, dtype=torch.float32, device=q.device)
    eps = eps.reshape(eps.shape + (1,) * (q.dim() - 1 - eps.dim()))
    return egreedy_stream(q, eps.expand(q.shape[:-1]), keys)
