"""The paper's baseline, standard sequential DQN control flow: the port
of ``repro.core.baseline``.

Per Figure 1a: act with the current parameters θ; every F env steps run
exactly one minibatch update, which the next action waits for; θ⁻ ← θ
every C env steps; every experience enters 𝒟 at once. The chunk is a
loop over F-step groups: F // W synchronized W-env rounds from θ, each
written to 𝒟 as it happens, then one update whose replay key is
``fold_in(PRNGKey(23), group)``, then θ⁻ ← θ on every (C // F)-th group.
It shares q_forward, replay, ε-greedy and the update with the concurrent
cycle, and its metrics carry the same keys (loss, reward, episodes,
eps). Every function returns new tensors, so the chunk is a pure
function of its carry.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import rng
from repro_torch.config import DQNConfig
from repro_torch.core.dqn import make_update_fn
from repro_torch.core.replay import (ReplayState, replay_add_batch,
                                     replay_sample)
from repro_torch.core.synchronized import Obs, SamplerState, sync_round
from repro_torch.envs.games import EnvSpec
from repro_torch.optim.schedule import linear_epsilon


class BaselineCarry(NamedTuple):
    params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: Dict
    replay: ReplayState
    sampler: SamplerState
    step: torch.Tensor       # int32 scalar: the global env-step counter t
    group: torch.Tensor      # int32 scalar: F-step groups run so far


def make_baseline_chunk(spec: EnvSpec, q_forward: Callable, opt,
                        cfg: DQNConfig, obs: Obs = 84,
                        chunk_steps: int = 0) -> Callable:
    """Build chunk(carry) -> (carry', metrics) for ``chunk_steps`` env
    steps (default C) of standard DQN."""
    W = cfg.n_envs
    F = cfg.train_period
    C = cfg.target_update_period
    steps = chunk_steps or C
    # each group runs F // W batched rounds, so F must be a multiple of W
    if F % W != 0:
        raise ValueError(f"train_period {F} is no multiple of n_envs {W}")
    if steps % F != 0:
        raise ValueError(f"chunk_steps {steps} is no multiple of "
                         f"train_period {F}")
    groups = max(steps // F, 1)
    groups_per_target = max(C // F, 1)
    rounds_per_group = max(F // W, 1)
    update_fn = make_update_fn(q_forward, opt, cfg)
    eps_fn = linear_epsilon(cfg.eps_start, cfg.eps_end, cfg.eps_anneal_steps)

    def group_body(carry: BaselineCarry):
        # --- F env steps acting from the current θ (the sequential lock) --
        sampler, replay = carry.sampler, carry.replay
        rewards, dones = [], []
        with torch.no_grad():
            for i in range(rounds_per_group):
                eps = eps_fn(carry.step + i * W)
                sampler, tr = sync_round(spec, q_forward, carry.params,
                                         sampler, eps, obs)
                # standard DQN: experiences enter 𝒟 at once
                replay = replay_add_batch(replay, tr)
                rewards.append(tr["reward"])
                dones.append(tr["done"])

        # --- one update; the next group's actions depend on its result ---
        kup = rng.fold_in(rng.PRNGKey(23, device=carry.group.device),
                          carry.group)
        batch = replay_sample(replay, kup, cfg.minibatch_size)
        params, opt_state, loss, _ = update_fn(
            carry.params, carry.target_params, carry.opt_state, batch)

        # --- θ⁻ ← θ every C steps ---
        group = carry.group + 1
        sync = (group % groups_per_target) == 0
        target = {k: torch.where(sync, params[k], t)
                  for k, t in carry.target_params.items()}

        new = BaselineCarry(params, target, opt_state, replay, sampler,
                            carry.step + rounds_per_group * W, group)
        return new, (loss, torch.stack(rewards).sum(),
                     torch.stack(dones).sum())

    def chunk(carry: BaselineCarry
              ) -> Tuple[BaselineCarry, Dict[str, torch.Tensor]]:
        # ε at the chunk boundary, as the concurrent cycle's metric
        eps0 = eps_fn(carry.step)
        losses, rewards, episodes = [], [], []
        for _ in range(groups):
            carry, (loss, r, d) = group_body(carry)
            losses.append(loss)
            rewards.append(r)
            episodes.append(d)
        return carry, {"loss": torch.stack(losses).mean(),
                       "reward": torch.stack(rewards).sum(),
                       "episodes": torch.stack(episodes).sum(),
                       "eps": eps0}

    return chunk
