"""Replay memory 𝒟, a device-resident ring buffer: the port of
``repro.core.replay``.

During a Concurrent-Training cycle the trainer samples only from the
snapshot of 𝒟 taken at the cycle boundary; staged experiences and staged
priority updates enter only at the θ⁻ ← θ sync point. Every function
here returns new tensors and leaves its input state untouched, so the
snapshot stays frozen by construction; the price is one copy of the
frames per flush.

Prioritized replay (Schaul et al. 2016) adds the leaf masses of a
sum-tree (``priority``, padded to a power of two) and the running
``max_priority``; sampling goes through the ``segment_tree`` kernel.
Observations are stored as uint8.

A population's replay has a leading replica axis R on every leaf
(``cursor``, ``size`` and ``max_priority`` become (R,)), and every
function here takes it: keys are (R, 2), draws, indices and minibatches
(R, n, ...), and each replica writes, samples and normalizes only within
its own memory. The R sum-trees are built and descended in one launch
each.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.kernels import ops as kops
from repro_torch.kernels.segment_tree import next_pow2, tree_build

__all__ = [
    "ReplayState", "FIELDS", "replay_init", "replay_capacity",
    "replay_size", "replay_is_prioritized", "replay_add_batch",
    "replay_sample", "per_tree", "stratified_indices", "per_sample",
    "per_stage_priorities", "per_flush_priorities",
]

ReplayState = Dict[str, torch.Tensor]

FIELDS = ("obs", "action", "reward", "next_obs", "done")


def replay_init(capacity: int, obs_shape: Tuple[int, ...],
                obs_dtype=torch.uint8, prioritized: bool = False,
                device=None) -> ReplayState:
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = {
        "obs": zeros((capacity,) + obs_shape, obs_dtype),
        "action": zeros((capacity,), torch.int32),
        "reward": zeros((capacity,), torch.float32),
        "next_obs": zeros((capacity,) + obs_shape, obs_dtype),
        "done": zeros((capacity,), torch.bool),
        "cursor": zeros((), torch.int32),
        "size": zeros((), torch.int32),
    }
    if prioritized:
        # leaf masses, padded to a power of two; unfilled slots and the
        # padding carry 0 mass and are never sampled
        state["priority"] = zeros((next_pow2(capacity),), torch.float32)
        state["max_priority"] = torch.ones((), dtype=torch.float32,
                                           device=device)
    return state


def replay_capacity(state: ReplayState) -> int:
    return state["action"].shape[-1]


def replay_size(state: ReplayState) -> torch.Tensor:
    return state["size"]


def replay_is_prioritized(state: ReplayState) -> bool:
    return "priority" in state


def _index(idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The advanced index of slots ``idx`` (n,), or of (R, n) slots, row
    r in replica r's memory."""
    if idx.dim() == 1:
        return (idx,)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return (rows, idx)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[_index(idx)]


def replay_add_batch(state: ReplayState,
                     batch: Dict[str, torch.Tensor]) -> ReplayState:
    """Append n transitions (the staging-buffer flush; (R, n, ...) for a
    population, n to each replica), wrapping modulo capacity. When n
    exceeds the capacity only the last ``capacity`` transitions survive,
    so the prefix is dropped up front (this also keeps the scatter
    indices unique). On a prioritized state the written slots take the
    current ``max_priority``."""
    cap = replay_capacity(state)
    axis = state["cursor"].dim()          # the transitions' axis
    n = batch["action"].shape[axis]
    offset = torch.arange(min(n, cap), dtype=torch.int32,
                          device=state["cursor"].device)
    if n > cap:
        batch = {k: v.narrow(axis, n - cap, cap) for k, v in batch.items()}
        offset = offset + (n - cap)
    idx = ((state["cursor"][..., None] + offset) % cap).long()
    at = _index(idx)
    new = dict(state)
    for k in FIELDS:
        new[k] = state[k].index_put(at, batch[k].to(state[k].dtype))
    if replay_is_prioritized(state):
        new["priority"] = state["priority"].index_put(
            at, state["max_priority"][..., None].expand(idx.shape))
    new["cursor"] = (state["cursor"] + n) % cap
    new["size"] = torch.clamp(state["size"] + n, max=cap)
    return new


def replay_sample(state: ReplayState, key: torch.Tensor,
                  n: int) -> Dict[str, torch.Tensor]:
    """Uniform minibatch with replacement over the filled slots
    [0, max(size, 1)), per replica under (R, 2) keys."""
    size = torch.clamp(state["size"], min=1)[..., None]
    idx = rng.randint(key, (n,), 0, size).long()
    return {k: _take(state[k], idx) for k in FIELDS}


def per_tree(state: ReplayState) -> torch.Tensor:
    """The (2P,) sum-tree over the current leaf masses; (R, 2P) for a
    population, built in the launches of one tree."""
    return tree_build(state["priority"])


def stratified_indices(tree: torch.Tensor, key: torch.Tensor, n: int,
                       size: torch.Tensor) -> torch.Tensor:
    """n stratified inverse-CDF draws from a (2P,) sum-tree: [0, total)
    splits into n equal strata, one uniform draw each, mapped to leaves
    by the segment-tree kernel and clamped to the filled prefix. (R, 2P)
    trees, (R, 2) keys and (R,) sizes give (R, n) draws, each replica's
    strata over its own total, in one launch."""
    total = tree[..., 1:2]
    u = rng.uniform(key, (n,))
    count = torch.full((), float(n), dtype=torch.float32, device=tree.device)
    strata = torch.arange(n, dtype=torch.float32, device=tree.device)
    targets = (strata + u) / count * total
    idx = kops.segment_tree_sample(tree, targets)
    return torch.minimum(idx, torch.clamp(size, min=1)[..., None] - 1)


def per_sample(state: ReplayState, key: torch.Tensor, n: int,
               beta: torch.Tensor,
               tree: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Stratified proportional minibatch (Schaul et al. 2016 §3.3), plus
    ``index`` (for the priority update) and ``weight``, the importance
    correction (N·P(i))^-β normalized by its max. For a population,
    β is (R,) and each replica's weights are normalized by their own
    max."""
    if tree is None:
        tree = per_tree(state)
    total = tree[..., 1:2]
    size = torch.clamp(state["size"], min=1)[..., None]
    idx = stratified_indices(tree, key, n, state["size"])
    il = idx.long()
    probs = torch.clamp(_take(state["priority"], il)
                        / torch.clamp(total, min=1e-30), min=1e-30)
    w = (size.to(torch.float32) * probs) ** (-beta[..., None])
    w = w / torch.clamp(w.amax(dim=-1, keepdim=True), min=1e-30)
    out = {k: _take(state[k], il) for k in FIELDS}
    out["index"] = idx
    out["weight"] = w
    return out


def per_stage_priorities(pending: torch.Tensor, idx: torch.Tensor,
                         td_abs: torch.Tensor, alpha: float,
                         eps: float) -> torch.Tensor:
    """Stage new masses (|td| + ε)^α into ``pending`` (P,) (or (R, P),
    row r from replica r's minibatch), 0 meaning untouched. Duplicate
    indices combine by max, an order-independent reduction, so the flush
    is deterministic."""
    mass = (torch.abs(td_abs) + eps) ** alpha
    return pending.scatter_reduce(-1, idx.long(), mass, reduce="amax",
                                  include_self=True)


def per_flush_priorities(state: ReplayState,
                         pending: torch.Tensor) -> ReplayState:
    """Apply the staged priority updates at the sync point; each
    replica's ``max_priority`` takes the max of its own staged masses."""
    new = dict(state)
    new["priority"] = torch.where(pending > 0, pending, state["priority"])
    new["max_priority"] = torch.maximum(state["max_priority"],
                                        pending.amax(dim=-1))
    return new
