"""Synchronized Execution (§4 of the paper): the port of
``repro.core.synchronized``.

W sampler streams step in lock-step and share ONE batched Q call per
round. ``sync_round`` is one such step: Q call -> ε-greedy -> batched
env step with auto-reset -> frame push. The concurrent cycle loops it
and stacks its outputs into the staging buffer.

A population's sampler has a leading replica axis: env states and the
stack (R, W, ...), the key (R, 2). A round then makes one Q call for
all R replicas, and the env step takes the R W streams as one flat batch
(each stream draws only from its own key, so it is the standalone
stream's step bit for bit).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch import rng
from repro_torch.config import DQNConfig
from repro_torch.core.policy import policy_step, stream_keys
from repro_torch.envs.games import EnvSpec, step_autoreset
from repro_torch.envs.preprocess import (ObsPipeline, as_obs, init_obs_stack,
                                         obs_batch, push_frame,
                                         reset_stack_where)

Obs = Union[int, ObsPipeline]


class SamplerState(NamedTuple):
    env_states: Dict[str, torch.Tensor]   # per-stream env states (leading W)
    stack: torch.Tensor                   # (W, *obs, K) current obs stack
    key: torch.Tensor                     # (2,); a population's: (R, 2)


def _flat(x: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
    """(*lead, W, ...) stream tensors as one (prod(lead) W, ...) batch."""
    return x.flatten(0, len(lead)) if lead else x


def _unflat(x: torch.Tensor, lead: Tuple[int, ...], W: int) -> torch.Tensor:
    return x.unflatten(0, lead + (W,)) if lead else x


def _streams(spec: EnvSpec, keys: torch.Tensor, pipe: ObsPipeline,
             frame_stack: int):
    """Fresh streams under (*lead, W, 2) keys: their env states and
    stacks holding the first frame."""
    lead, W = keys.shape[:-2], keys.shape[-2]
    env_states = {k: _unflat(v, lead, W)
                  for k, v in spec.reset(_flat(keys, lead)).items()}
    stack = init_obs_stack(lead + (W,), pipe, frame_stack, keys.device)
    frame = obs_batch(pipe, spec, {k: _flat(v, lead)
                                   for k, v in env_states.items()})
    return env_states, push_frame(stack, _unflat(frame, lead, W))


def sampler_init(spec: EnvSpec, cfg: DQNConfig, key: torch.Tensor,
                 obs: Obs = 84) -> SamplerState:
    pipe = as_obs(obs)
    k = rng.split(key)
    env_states, stack = _streams(spec, rng.split(k[0], cfg.n_envs), pipe,
                                 cfg.frame_stack)
    return SamplerState(env_states, stack, k[1])


def sync_round(spec: EnvSpec, q_forward: Callable, params, s: SamplerState,
               eps: torch.Tensor, obs: Obs = 84
               ) -> Tuple[SamplerState, Dict[str, torch.Tensor]]:
    """One synchronized W-env step. Returns (state', transitions), the
    transitions with leading dim W ((R, W) for a population, whose ε may
    be (R,))."""
    pipe = as_obs(obs)
    lead = s.key.shape[:-1]
    k = rng.split(s.key, 3)
    cur = s.stack
    W = cur.shape[len(lead)]
    actions = policy_step(q_forward, params, cur, eps,
                          stream_keys(k[..., 1, :], W))
    env_states, rewards, dones = step_autoreset(
        spec, {n: _flat(v, lead) for n, v in s.env_states.items()},
        _flat(actions, lead), _flat(rng.split(k[..., 2, :], W), lead))
    frame = _unflat(obs_batch(pipe, spec, env_states), lead, W)
    env_states = {n: _unflat(v, lead, W) for n, v in env_states.items()}
    rewards, dones = _unflat(rewards, lead, W), _unflat(dones, lead, W)
    next_obs = push_frame(s.stack, frame)                  # pre-reset view
    new_stack = push_frame(reset_stack_where(s.stack, dones), frame)
    transitions = {"obs": cur, "action": actions, "reward": rewards,
                   "next_obs": next_obs, "done": dones}
    return SamplerState(env_states, new_stack, k[..., 0, :]), transitions


def nstep_aggregate(staged: Dict[str, torch.Tensor], n: int,
                    discount: float) -> Dict[str, torch.Tensor]:
    """Collapse staged (rounds, W, ...) 1-step transitions into n-step
    ones along the rounds axis. For start round t <= rounds-n:
    reward = Σ_{k<n} γᵏ r[t+k] Π_{j<k}(1 - done[t+j]); next_obs =
    next_obs[t+n-1]; done = any terminal in the window. The last n-1
    rounds lack their future and are dropped."""
    if n <= 1:
        return staged
    rounds = staged["reward"].shape[0]
    assert rounds >= n, (rounds, n)
    R = rounds - n + 1
    live = torch.ones_like(staged["reward"][:R])
    reward = torch.zeros_like(staged["reward"][:R])
    done = torch.zeros_like(staged["done"][:R])
    for k in range(n):
        reward = reward + (discount ** k) * live * staged["reward"][k:k + R]
        done = done | staged["done"][k:k + R]
        live = live * (1.0 - staged["done"][k:k + R].to(live.dtype))
    return {
        "obs": staged["obs"][:R],
        "action": staged["action"][:R],
        "reward": reward,
        "next_obs": staged["next_obs"][n - 1:],
        "done": done,
    }


def stack_rounds(rounds: list) -> Dict[str, torch.Tensor]:
    """A list of per-round transition dicts -> (rounds, W, ...) tensors."""
    return {k: torch.stack([r[k] for r in rounds]) for k in rounds[0]}


def evaluate(spec: EnvSpec, q_forward: Callable, params, key: torch.Tensor,
             cfg: DQNConfig, n_episodes: int = 30, obs: Obs = 84,
             max_steps: int = 1000) -> torch.Tensor:
    """ε = eval_eps greedy evaluation (paper §5.2): the mean return over
    the n_episodes parallel streams whose episode finished within
    max_steps (all streams' partial mean when none finished). A
    population's (R, ...) parameters and (R, 2) keys give (R,) returns,
    each replica's mean over its own streams."""
    pipe = as_obs(obs)
    k = rng.split(key)
    env_states, stack = _streams(spec, rng.split(k[..., 0, :], n_episodes),
                                 pipe, cfg.frame_stack)
    s = SamplerState(env_states, stack, k[..., 1, :])
    eps = torch.full((), cfg.eval_eps, dtype=torch.float32, device=key.device)
    returns = torch.zeros(key.shape[:-1] + (n_episodes,), dtype=torch.float32,
                          device=key.device)
    live = returns + 1.0
    for _ in range(max_steps):
        s, tr = sync_round(spec, q_forward, params, s, eps, pipe)
        returns = returns + tr["reward"] * live
        live = live * (1.0 - tr["done"].to(torch.float32))
    finished = 1.0 - live
    n_finished = finished.sum(dim=-1)
    finished_mean = ((returns * finished).sum(dim=-1)
                     / torch.clamp(n_finished, min=1.0))
    return torch.where(n_finished > 0, finished_mean, returns.mean(dim=-1))
