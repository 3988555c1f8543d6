"""The concurrent trainer: the port of ``repro.api.trainers``'
``ConcurrentTrainer`` (Algorithm 1 for a single replica).

    trainer = ConcurrentTrainer(spec, device="cuda")
    carry   = trainer.init_carry()
    carry, metrics = trainer.cycle(carry)
    returns = trainer.eval(carry, trainer.eval_key(i))

As in the reference, metrics, eval returns and ``steps`` carry a leading
replica axis of size 1. The other execution modes (baseline,
synchronized, population) are later work (ROADMAP.md, queue 1 items 9
and 10).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.concurrent import (EVAL_STREAM_TAG, TrainerCarry,
                                         make_concurrent_cycle, replica_key)
from repro_torch.core.population import make_replica_init
from repro_torch.core.synchronized import evaluate
from repro_torch.envs.games import make_env
from repro_torch.envs.preprocess import pixel_obs
from repro_torch.models.nature_cnn import q_forward, q_init, q_logits
from repro_torch.optim.rmsprop import centered_rmsprop
from repro_torch.runtime import configure

__all__ = ["ConcurrentTrainer"]


class _Components:
    """env spec + obs pipeline + network/DQN configs + forward fns +
    optimizer, derived from the spec once."""

    def __init__(self, spec: ExperimentSpec):
        self.env = make_env(spec.env, **spec.env_params)
        if spec.obs_mode != "pixels":
            raise NotImplementedError(
                "vector observations are not ported to repro_torch yet "
                "(ROADMAP.md, queue 1 item 2)")
        if spec.exec.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {spec.exec.compute_dtype!r}: the port's DQN "
                "path runs in float32 only")
        self.obs = pixel_obs(spec.frame_size)
        self.ncfg = spec.cnn_config(self.env.n_actions)
        self.dcfg = spec.dqn_config()
        ncfg = self.ncfg
        self.qf = lambda p, o, k=None: q_forward(p, o, ncfg, noise_key=k)
        self.qlog = ((lambda p, o, k=None: q_logits(p, o, ncfg, noise_key=k))
                     if spec.variant.distributional else None)
        if spec.algo.optimizer != "rmsprop":
            raise NotImplementedError(
                f"optimizer {spec.algo.optimizer!r} is not ported to "
                "repro_torch yet (ROADMAP.md, queue 1 item 6); use "
                "'rmsprop'")
        self.opt = centered_rmsprop(spec.algo.learning_rate or 2.5e-4)
        self.q_init = lambda key: q_init(ncfg, self.env.n_actions, key)


class ConcurrentTrainer:
    """The C-cycle on one ``TrainerCarry`` held on ``device``. The
    constructor pins float32 and deterministic kernels
    (``runtime.configure``)."""

    replicas = 1

    def __init__(self, spec: ExperimentSpec, device: str = "cuda"):
        spec.validate()
        if spec.mode != "concurrent":
            raise ValueError(
                f"ConcurrentTrainer runs mode 'concurrent', got {spec.mode!r}")
        self.spec = spec
        self.device = configure(device)
        c = _Components(spec)
        self._c = c
        self._init_one = make_replica_init(c.env, c.q_init, c.qf, c.opt,
                                           c.dcfg, c.obs, device=self.device)
        self._cycle = make_concurrent_cycle(c.env, c.qf, c.opt, c.dcfg,
                                            obs=c.obs, q_logits=c.qlog)

    def init_carry(self) -> TrainerCarry:
        return self._init_one(self.spec.seed)

    def cycle(self, carry: TrainerCarry
              ) -> Tuple[TrainerCarry, Dict[str, torch.Tensor]]:
        carry, m = self._cycle(carry)
        return carry, {k: v[None] for k, v in m.items()}

    def eval(self, carry: TrainerCarry, key: torch.Tensor) -> torch.Tensor:
        """ε=0.05 greedy returns of the μ-only network, shape (1,)."""
        c, sched = self._c, self.spec.schedule
        with torch.no_grad():
            r = evaluate(c.env, c.qf, carry.params, key, c.dcfg,
                         n_episodes=sched.eval_episodes, obs=c.obs,
                         max_steps=c.env.max_steps + 2)
        return r[None]

    def eval_key(self, cycle_index: int) -> torch.Tensor:
        def i32(v):
            return torch.full((), v, dtype=torch.int32, device=self.device)
        return replica_key(EVAL_STREAM_TAG, i32(self.spec.seed),
                           i32(cycle_index))

    def steps(self, carry: TrainerCarry) -> torch.Tensor:
        return carry.step[None]
