"""Concurrent Training (§3): the C-cycle, the port of
``repro.core.concurrent``.

One cycle covers C env steps:

  1. θ⁻ ← θ and a snapshot of 𝒟 (the synchronization point);
  2. sampler: C/W synchronized rounds acting from θ⁻, staged;
  3. trainer: C/F minibatch updates on θ, sampled only from the
     snapshot;
  4. flush: staged priorities first, then the (n-step aggregated)
     staged transitions, enter 𝒟.

The cycle runs over a replica axis: every leaf of its carry has a
leading R (the population's layout; a single replica is R = 1, which
``api.trainers.ConcurrentTrainer`` adds and removes at its boundary).
There is no loop over replicas: a round makes one Q call and one env
step for all R W streams, an update one forward and one backward for
all R minibatches, and the PER descent, the tree build and the C51
projection launch for all R replicas at once. ε, β, the keys and the
metrics are per replica, each from its own seed and step.

Steps 2 and 3 share no data: both read only what was fixed at the
boundary. Here they run one after the other on the card's stream; the
result is the same as any interleaving, and two runs from one carry are
bitwise equal. Every key is folded out of the carry's replica seed and
step counter (``replica_key``), so the cycle is a pure function of its
carry. Under PER the trainer samples through the ``segment_tree``
kernel; under C51 its loss projects the target through the
``categorical_projection`` kernel. The sampler, trainer and flush run
under ``torch.profiler`` labels (``cycle.sampler``, ``cycle.trainer``,
``cycle.flush``), so a profile of a cycle splits by phase.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch import rng
from repro_torch.config import DQNConfig
from repro_torch.core.dqn import make_update_fn
from repro_torch.core.replay import (ReplayState, per_flush_priorities,
                                     per_sample, per_stage_priorities,
                                     per_tree, replay_add_batch,
                                     replay_sample)
from repro_torch.core.synchronized import (Obs, SamplerState, nstep_aggregate,
                                           stack_rounds, sync_round)
from repro_torch.envs.games import EnvSpec
from repro_torch.envs.preprocess import as_obs
from repro_torch.optim.schedule import linear_epsilon


class TrainerCarry(NamedTuple):
    """One replica's state; a population's has a leading R on every
    leaf (``step`` and ``seed`` (R,))."""
    params: Dict[str, torch.Tensor]
    opt_state: Dict
    replay: ReplayState
    sampler: SamplerState
    step: torch.Tensor       # int32 scalar: the global env-step counter t
    seed: torch.Tensor       # int32 scalar: the replica seed


def replica_key(tag: int, seed: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """The key of stream ``tag`` at (seed, step):
    fold_in(fold_in(PRNGKey(tag), seed), step); (R,) seeds and steps
    give (R, 2) keys."""
    return rng.fold_in(rng.fold_in(rng.PRNGKey(tag, device=seed.device), seed),
                       step)


EVAL_STREAM_TAG = 29


def _flatten_rounds(agg: Dict[str, torch.Tensor],
                    replicas: bool) -> Dict[str, torch.Tensor]:
    """(rounds, W, ...) staged transitions -> (rounds W, ...) in round
    order; (rounds, R, W, ...) -> (R, rounds W, ...), each replica's in
    its own round order."""
    if replicas:
        return {k: v.movedim(0, 1).flatten(1, 2) for k, v in agg.items()}
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in agg.items()}


def make_concurrent_cycle(spec: EnvSpec, q_forward: Callable, opt,
                          cfg: DQNConfig, obs: Obs = 84,
                          cycle_steps: int = 0,
                          q_logits: Optional[Callable] = None) -> Callable:
    """Build cycle(carry) -> (carry', metrics) over a population carry
    (a leading R on every leaf); every metric is (R,). ``cycle_steps``
    overrides C; ``q_logits`` is the (R, B, A, K) head of distributional
    variants. NoisyNet variants pass a trailing noise key, (R, 2), to
    both callables."""
    C = cycle_steps or cfg.target_update_period
    W = cfg.n_envs
    assert C % W == 0, (C, W)
    rounds = C // W
    updates = max(C // cfg.train_period, 1)
    variant = cfg.variant
    variant.validate()
    assert rounds >= variant.n_step, (rounds, variant.n_step)
    update_fn = make_update_fn(q_forward, opt, cfg, variant, q_logits=q_logits)
    eps_fn = linear_epsilon(cfg.eps_start, cfg.eps_end, cfg.eps_anneal_steps)

    def split_update_key(k):
        """Sampling keys, and (noisy only) the update's noise keys."""
        if variant.noisy:
            ks = rng.split(k)
            return ks[:, 0], ks[:, 1]
        return k, None

    def cycle(carry: TrainerCarry) -> Tuple[TrainerCarry, Dict[str, torch.Tensor]]:
        # --- synchronization point: θ⁻ ← θ; snapshot 𝒟 ---
        target_params = carry.params
        replay_snapshot = carry.replay
        dev = carry.step.device
        zero = torch.zeros(carry.step.shape, dtype=torch.float32, device=dev)

        # --- sampler: C/W synchronized rounds from θ⁻ ---
        if variant.noisy:
            k_act = replica_key(23, carry.seed, carry.step)
            qf_act = lambda p, o: q_forward(p, o, k_act)  # noqa: E731
        else:
            qf_act = q_forward
        sampler, staged = carry.sampler, []
        with torch.no_grad(), record_function("cycle.sampler"):
            for i in range(rounds):
                eps = zero if variant.noisy else eps_fn(carry.step + i * W)
                sampler, tr = sync_round(spec, qf_act, target_params, sampler,
                                         eps, obs)
                staged.append(tr)
        staged = stack_rounds(staged)

        # --- trainer: C/F updates on θ from the frozen snapshot ---
        with record_function("cycle.trainer"):
            keys = rng.split(replica_key(17, carry.seed, carry.step),
                             updates)                      # (R, U, 2)
            params, opt_state, losses = carry.params, carry.opt_state, []
            if variant.prioritized:
                tree = per_tree(replay_snapshot)
                beta = torch.clamp(
                    variant.per_beta0 + (1.0 - variant.per_beta0)
                    * carry.step.to(torch.float32)
                    / torch.full((), float(variant.per_beta_anneal_steps),
                                 dtype=torch.float32, device=dev), max=1.0)
                pending = torch.zeros_like(replay_snapshot["priority"])
                for u in range(updates):
                    ks, kn = split_update_key(keys[:, u])
                    batch = per_sample(replay_snapshot, ks, cfg.minibatch_size,
                                       beta, tree=tree)
                    params, opt_state, loss, td_abs = update_fn(
                        params, target_params, opt_state, batch, kn)
                    pending = per_stage_priorities(
                        pending, batch["index"], td_abs, variant.per_alpha,
                        variant.per_eps)
                    losses.append(loss)
            else:
                for u in range(updates):
                    ks, kn = split_update_key(keys[:, u])
                    batch = replay_sample(replay_snapshot, ks,
                                          cfg.minibatch_size)
                    params, opt_state, loss, _ = update_fn(
                        params, target_params, opt_state, batch, kn)
                    losses.append(loss)

        # --- flush at the sync point: staged priorities, then staged
        # experiences (new slots enter at the updated max priority) ---
        with record_function("cycle.flush"):
            replay = carry.replay
            if variant.prioritized:
                replay = per_flush_priorities(replay, pending)
            agg = nstep_aggregate(staged, variant.n_step, cfg.discount)
            replay = replay_add_batch(replay, _flatten_rounds(agg, True))

        # per replica: staged transitions are (rounds, R, W)
        metrics = {
            "loss": torch.stack(losses).mean(dim=0),
            "reward": staged["reward"].sum(dim=(0, 2)),
            "episodes": staged["done"].sum(dim=(0, 2)),
            "eps": zero if variant.noisy else eps_fn(carry.step),
        }
        new = TrainerCarry(params, opt_state, replay, sampler,
                           carry.step + C, carry.seed)
        return new, metrics

    return cycle


def prepopulate(spec: EnvSpec, q_forward: Callable, cfg: DQNConfig,
                replay: ReplayState, sampler: SamplerState,
                n: int, obs: Obs = 84):
    """Fill 𝒟 with at least n uniform-random transitions. Rounds are
    rounded up and n-step aggregation's n-1 dropped rounds added back, so
    (rounds - n_step + 1)·W = ceil(n/W)·W >= n transitions land. A
    population's replay and sampler (leading R) fill in the same rounds,
    all R W streams at once."""
    W = cfg.n_envs
    rounds = max(-(-n // W), 1) + (cfg.variant.n_step - 1)
    frame_dims = len(as_obs(obs).shape) + 1                 # obs and stack

    def zero_q(params, o):
        return torch.zeros(o.shape[:-frame_dims] + (spec.n_actions,),
                           device=o.device)

    one = torch.ones((), dtype=torch.float32, device=sampler.key.device)
    staged = []
    with torch.no_grad():
        for _ in range(rounds):
            sampler, tr = sync_round(spec, zero_q, None, sampler, one, obs)
            staged.append(tr)
    agg = nstep_aggregate(stack_rounds(staged), cfg.variant.n_step,
                          cfg.discount)
    replicas = sampler.key.dim() == 2
    return (replay_add_batch(replay, _flatten_rounds(agg, replicas)),
            sampler)
