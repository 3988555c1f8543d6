"""The single-replica initializer of ``repro.core.population``. The
replica axis itself (a population of carries) is later work
(ROADMAP.md, queue 1 item 9)."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import rng
from repro_torch.config import DQNConfig
from repro_torch.core.concurrent import TrainerCarry, prepopulate
from repro_torch.core.replay import replay_init
from repro_torch.core.synchronized import Obs, sampler_init
from repro_torch.envs.games import EnvSpec
from repro_torch.envs.preprocess import as_obs


def make_replica_init(spec: EnvSpec, q_init_fn: Callable,
                      q_forward: Callable, opt, cfg: DQNConfig,
                      obs: Obs = 84, device="cpu") -> Callable:
    """Build ``init_one(seed) -> TrainerCarry`` on ``device``: params,
    optimizer state, a replay prepopulated with ``cfg.prepopulate``
    uniform-random transitions, and the sampler streams, all derived
    from ``PRNGKey(seed)``, split once between the network init and the
    sampler. ``init_one(seed, device="meta", fill=False)`` builds only
    the carry's structure, shapes and dtypes (no data, no prepopulate:
    it changes no shape), the port's ``jax.eval_shape`` of the init."""
    pipe = as_obs(obs)

    def init_one(seed: int, device=device, fill: bool = True) -> TrainerCarry:
        seed_t = torch.full((), int(seed), dtype=torch.int32, device=device)
        keys = rng.split(rng.PRNGKey(seed_t))
        params = q_init_fn(keys[0])
        replay = replay_init(cfg.replay_capacity,
                             pipe.shape + (cfg.frame_stack,),
                             obs_dtype=pipe.dtype,
                             prioritized=cfg.variant.prioritized,
                             device=device)
        sampler = sampler_init(spec, cfg, keys[1], pipe)
        if fill:
            replay, sampler = prepopulate(spec, q_forward, cfg, replay,
                                          sampler, cfg.prepopulate, pipe)
        step = torch.zeros((), dtype=torch.int32, device=device)
        return TrainerCarry(params, opt.init(params), replay, sampler, step,
                            seed_t)

    return init_one
