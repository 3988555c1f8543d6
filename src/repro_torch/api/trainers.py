"""The execution-mode registry and its trainers: the port of
``repro.api.trainers``.

    trainer = build_trainer(spec, device="cuda")
    carry   = trainer.init_carry()
    carry, metrics = trainer.cycle(carry)
    returns = trainer.eval(carry, trainer.eval_key(i))

Modes register in ``TRAINERS`` through ``register_trainer``, and
``build_trainer`` dispatches on ``spec.mode``. As in the reference,
metrics, eval returns and ``steps`` carry a leading replica axis of
size ``trainer.replicas``: ``spec.seeds`` in population mode, 1 in the
single-carry modes. The modes:

==============  ============================================================
baseline        Standard DQN (Figure 1a): act from the current θ, one
                blocking update every F steps, experiences enter 𝒟 at
                once (``core.baseline``). The W streams are batched; the
                per-stream transaction cost is the host runner's
                (``core.host_runner``, ``launch/table1.py``).
synchronized    The same sequential structure over W >= 2 streams
                aggregated into one batched Q call per round; equal to
                ``baseline`` at equal W.
concurrent      Algorithm 1: the C-cycle (θ⁻ acting, a training burst on
                the snapshot of 𝒟, the flush at the boundary).
population      The concurrent C-cycle over ``spec.seeds`` replicas seeded
                [seed, seed + P) on a leading replica axis, one program
                on one card (``core.population``; the default mode).
==============  ============================================================

``baseline``/``synchronized`` support only loss-level variants (double,
dueling): PER, n-step, C51 and NoisyNet need the concurrent cycle's
stage-then-flush machinery and are refused at build time.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Protocol, Sequence, Tuple,
                    runtime_checkable)

import torch

from repro_torch import rng
from repro_torch.api.spec import MODES, ExperimentSpec
from repro_torch.core.baseline import BaselineCarry, make_baseline_chunk
from repro_torch.core.concurrent import (EVAL_STREAM_TAG,
                                         make_concurrent_cycle, prepopulate,
                                         replica_key)
from repro_torch.core.population import (eval_keys, gather_replicas,
                                         make_replica_init, own_replicas,
                                         packed_seeds, population_init,
                                         replica, replica_mesh, seed_array,
                                         tree_map)
from repro_torch.core.replay import replay_init
from repro_torch.core.synchronized import evaluate, sampler_init
from repro_torch.envs.games import make_env
from repro_torch.envs.preprocess import pixel_obs, vector_obs
from repro_torch.models.nature_cnn import q_forward, q_init, q_logits
from repro_torch.optim.adamw import adamw
from repro_torch.optim.rmsprop import centered_rmsprop
from repro_torch.runtime import configure

__all__ = ["Trainer", "TRAINERS", "register_trainer", "build_trainer",
           "build_packed_fleet", "PopulationTrainer", "ConcurrentTrainer",
           "BaselineTrainer", "SynchronizedTrainer", "EVAL_STREAM_TAG"]


@runtime_checkable
class Trainer(Protocol):
    """The contract every execution mode keeps (see the module doc):
    ``cycle``'s metrics, ``eval``'s returns and ``steps`` lead with a
    replica axis of size ``replicas``. The carry is opaque to callers:
    checkpoint it with ``repro_torch.checkpoint`` against
    ``init_template()``."""

    spec: ExperimentSpec
    replicas: int
    device: torch.device

    def init_carry(self) -> Any: ...

    def init_template(self) -> Any: ...

    def cycle(self, carry) -> Tuple[Any, Dict[str, torch.Tensor]]: ...

    def eval(self, carry, key: torch.Tensor) -> torch.Tensor: ...

    def eval_key(self, cycle_index: int) -> torch.Tensor: ...

    def steps(self, carry) -> torch.Tensor: ...

    def whole(self, carry) -> Any: ...

    def own(self, carry) -> Any: ...


TRAINERS: Dict[str, Callable[..., Trainer]] = {}


def register_trainer(mode: str):
    """Decorator registering a trainer class for an execution mode."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")

    def deco(factory):
        TRAINERS[mode] = factory
        return factory

    return deco


def build_trainer(spec: ExperimentSpec, device: str = "cuda"):
    """The construction path from a spec to a runnable trainer on
    ``device``: the spec is validated and the mode resolved through the
    registry."""
    spec.validate()
    try:
        factory = TRAINERS[spec.mode]
    except KeyError:
        raise KeyError(f"unknown execution mode {spec.mode!r}; "
                       f"registered: {sorted(TRAINERS)}") from None
    return factory(spec, device=device)


def build_packed_fleet(spec: ExperimentSpec, seeds: Sequence[int],
                       device: str = "cuda") -> "PopulationTrainer":
    """A population fleet over an explicit (possibly non-contiguous)
    seed list: the construction path the sweep packer
    (``repro_torch.api.sweep``) uses for runs that differ only in seed.
    ``spec`` is the shared fleet spec with ``spec.seeds == len(seeds)``;
    replica r follows the standalone run with seed ``seeds[r]``."""
    spec.validate()
    if spec.mode != "population":
        raise ValueError(
            f"packed fleets run in population mode (got {spec.mode!r}); "
            "non-population sweep runs execute as singleton fleets "
            "through build_trainer")
    return PopulationTrainer(spec, device=device, seeds=seeds)


class _Components:
    """env spec + obs pipeline + network/DQN configs + forward fns +
    optimizer, derived from the spec once."""

    def __init__(self, spec: ExperimentSpec):
        self.env = make_env(spec.env, **spec.env_params)
        # the observation pipeline every sampler and eval path consumes
        self.obs = (vector_obs(self.env) if spec.obs_mode == "vector"
                    else pixel_obs(spec.frame_size))
        self.ncfg = spec.cnn_config(self.env.n_actions)
        self.dcfg = spec.dqn_config()
        ec = spec.exec
        ncfg = self.ncfg
        # trailing noise key (NoisyNet; None = μ-only, e.g. greedy eval)
        self.qf = lambda p, o, k=None: q_forward(p, o, ncfg, ec, noise_key=k)
        self.qlog = ((lambda p, o, k=None: q_logits(p, o, ncfg, ec,
                                                    noise_key=k))
                     if spec.variant.distributional else None)
        lr = spec.algo.learning_rate
        if spec.algo.optimizer == "rmsprop":
            self.opt = centered_rmsprop(lr or 2.5e-4)
        else:
            self.opt = adamw(lr or 1e-3, weight_decay=0.0)
        self.q_init = lambda key: q_init(ncfg, self.env.n_actions, key)


@register_trainer("population")
class PopulationTrainer:
    """``spec.seeds`` replicas of the concurrent C-cycle as one program on
    ``device``: the carry has a leading replica axis P on every leaf,
    and ``cycle``, ``eval`` and ``steps`` give (P,) values. Replica r
    follows the standalone run with seed ``seeds[r]`` (its integers
    exactly, its floats to rounding; ``core.population``).

    Under a process group whose ranks divide P (``replica_mesh``) each
    rank's carry holds its P/D replicas, and ``cycle``'s metrics,
    ``eval`` and ``steps`` are gathered to all P; ``whole`` gathers a
    carry (for a checkpoint) and ``own`` takes this rank's share of a
    whole one (a restored checkpoint). On one rank both return the carry
    as it is."""

    def __init__(self, spec: ExperimentSpec, device: str = "cuda",
                 seeds=None):
        spec.validate()
        if spec.mode != "population":
            raise ValueError(
                f"PopulationTrainer runs mode 'population', got {spec.mode!r}")
        self.spec = spec
        self.replicas = spec.seeds
        self.device = configure(device)
        self._c = c = _Components(spec)
        # ``seeds`` is the sweep packer's hook: an explicit (possibly
        # non-contiguous) replica-seed list replaces [seed, seed + P)
        self.seeds = (seed_array(spec.seed, spec.seeds) if seeds is None
                      else packed_seeds(seeds))
        if self.seeds.shape[0] != spec.seeds:
            raise ValueError(
                f"packed seed list has {self.seeds.shape[0]} entries but "
                f"spec.seeds={spec.seeds} — the fleet spec must declare "
                "exactly the packed replica count")
        self._init = make_replica_init(c.env, c.q_init, c.qf, c.opt, c.dcfg,
                                       c.obs, device=self.device)
        self._cycle = make_concurrent_cycle(c.env, c.qf, c.opt, c.dcfg,
                                            obs=c.obs, q_logits=c.qlog)
        self.mesh = replica_mesh(spec.seeds)
        self.local_seeds = self.seeds
        if self.mesh is not None:
            if self.mesh.get_coordinate() is None:
                raise ValueError(
                    f"{spec.seeds} replicas split over the first "
                    f"{self.mesh.size()} ranks; run as many processes as "
                    "divide the replica count")
            self.local_seeds = own_replicas(self.seeds, self.mesh,
                                            spec.seeds)

    def init_carry(self, key=None):
        # the replica seeds determine every RNG stream; ``key`` is taken
        # for the protocol's sake and must be None
        assert key is None, "population init derives all RNG from seeds"
        return population_init(self._init, self.local_seeds.tolist())

    def cycle(self, carry):
        carry, m = self._cycle(carry)
        return carry, self.whole(m)

    def whole(self, tree):
        """The whole population of ``tree`` (this rank's replicas)."""
        return tree if self.mesh is None else gather_replicas(tree,
                                                              self.mesh)

    def own(self, tree):
        """This rank's replicas of a whole population's ``tree``."""
        return tree if self.mesh is None else own_replicas(
            tree, self.mesh, self.replicas)

    def init_template(self):
        """The population carry's structure, shapes and dtypes as meta
        tensors: what ``checkpoint.restore_latest`` restores into."""
        return population_init(self._init, self.seeds.tolist(),
                               device="meta", fill=False)

    def eval(self, carry, key: torch.Tensor) -> torch.Tensor:
        """ε=0.05 greedy returns of each replica's μ-only network, (P,)."""
        c, sched = self._c, self.spec.schedule
        with torch.no_grad():
            return self.whole(evaluate(
                c.env, c.qf, carry.params, key, c.dcfg,
                n_episodes=sched.eval_episodes, obs=c.obs,
                max_steps=c.env.max_steps + 2))

    def eval_key(self, cycle_index: int) -> torch.Tensor:
        """This rank's replicas' keys (all P on one rank)."""
        return eval_keys(self.local_seeds.to(self.device), cycle_index)

    def steps(self, carry) -> torch.Tensor:
        return self.whole(carry.step)


class _SingleReplicaTrainer:
    """What every single-replica mode shares: the ε=0.05 evaluator, the
    eval key, the leading replica axis on metrics, eval and steps, and
    the restore template. The constructor pins float32 and deterministic
    kernels (``runtime.configure``); subclasses set ``self._init``
    (``(seed, device=..., fill=True)`` -> carry) and ``self._cycle``
    (carry -> (carry', metrics)) in ``_build``."""

    replicas = 1

    def __init__(self, spec: ExperimentSpec, device: str = "cuda"):
        spec.validate()
        self.spec = spec
        self.device = configure(device)
        self._c = _Components(spec)
        self._build(spec, self._c)

    def _build(self, spec: ExperimentSpec, c: _Components) -> None:
        raise NotImplementedError

    def init_carry(self):
        return self._init(self.spec.seed)

    def init_template(self):
        """The carry's structure, shapes and dtypes as meta tensors, built
        without data and without prepopulating 𝒟: what
        ``checkpoint.restore_latest`` restores into."""
        return self._init(self.spec.seed, device="meta", fill=False)

    def cycle(self, carry) -> Tuple[object, Dict[str, torch.Tensor]]:
        carry, m = self._cycle(carry)
        return carry, {k: v[None] for k, v in m.items()}

    def eval(self, carry, key: torch.Tensor) -> torch.Tensor:
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

    def steps(self, carry) -> torch.Tensor:
        return carry.step[None]

    def whole(self, carry):
        return carry

    def own(self, carry):
        return carry


@register_trainer("concurrent")
class ConcurrentTrainer(_SingleReplicaTrainer):
    """The C-cycle on one ``TrainerCarry`` held on ``device``."""

    def __init__(self, spec: ExperimentSpec, device: str = "cuda"):
        if spec.mode != "concurrent":
            raise ValueError(
                f"ConcurrentTrainer runs mode 'concurrent', got {spec.mode!r}")
        super().__init__(spec, device)

    def _build(self, spec: ExperimentSpec, c: _Components) -> None:
        self._init = make_replica_init(c.env, c.q_init, c.qf, c.opt,
                                       c.dcfg, c.obs, device=self.device)
        cycle = make_concurrent_cycle(c.env, c.qf, c.opt, c.dcfg,
                                      obs=c.obs, q_logits=c.qlog)

        def one(carry):
            # a population of one: the replica axis added and taken off
            # here, so the carry keeps the single replica's layout
            pop, m = cycle(tree_map(lambda t: t[None], carry))
            return replica(pop, 0), {k: v[0] for k, v in m.items()}

        self._cycle = one


# Variant toggles that need the concurrent cycle's staging machinery
# (PER priority staging, n-step aggregation on the staging buffer, C51
# projection in the burst loss, per-cycle NoisyNet draws).
_STAGING_TOGGLES = ("prioritized", "distributional", "noisy")


class _SequentialTrainer(_SingleReplicaTrainer):
    """One cycle = ``schedule.cycle_steps`` env steps of standard
    sequential DQN (``core.baseline.make_baseline_chunk``)."""

    def __init__(self, spec: ExperimentSpec, device: str = "cuda"):
        bad = [t for t in _STAGING_TOGGLES if getattr(spec.variant, t)]
        if spec.variant.n_step > 1:
            bad.append(f"n_step={spec.variant.n_step}")
        if bad:
            raise ValueError(
                f"mode {spec.mode!r} runs standard sequential DQN and "
                f"supports only loss-level variants (double/dueling); "
                f"variant {spec.variant.name!r} needs {', '.join(bad)} — "
                "use mode='concurrent' or 'population'")
        F, W = spec.algo.train_period, spec.envs
        if F % W != 0:
            raise ValueError(
                f"mode {spec.mode!r} updates every train_period env "
                f"steps over W-batched rounds, so train_period must be "
                f"a positive multiple of envs (got train_period={F}, "
                f"envs={W}) — raise train_period, lower envs, or use "
                "mode='concurrent'/'population' (any F)")
        if spec.schedule.cycle_steps % F != 0:
            raise ValueError(
                f"mode {spec.mode!r} needs cycle_steps divisible by "
                f"train_period (got {spec.schedule.cycle_steps} % {F})")
        super().__init__(spec, device)

    def _build(self, spec: ExperimentSpec, c: _Components) -> None:
        pipe, dev = c.obs, self.device
        self._cycle = make_baseline_chunk(
            c.env, c.qf, c.opt, c.dcfg, obs=pipe,
            chunk_steps=spec.schedule.cycle_steps)

        def init(seed: int, device=dev, fill: bool = True) -> BaselineCarry:
            # split once: the network init and the sampler's episode
            # streams must not draw the same bits
            keys = rng.split(rng.PRNGKey(
                torch.full((), int(seed), dtype=torch.int32, device=device)))
            params = c.q_init(keys[0])
            replay = replay_init(c.dcfg.replay_capacity,
                                 pipe.shape + (c.dcfg.frame_stack,),
                                 obs_dtype=pipe.dtype, device=device)
            sampler = sampler_init(c.env, c.dcfg, keys[1], pipe)
            if fill:
                replay, sampler = prepopulate(c.env, c.qf, c.dcfg, replay,
                                              sampler, c.dcfg.prepopulate,
                                              pipe)
            zero = torch.zeros((), dtype=torch.int32, device=device)
            return BaselineCarry(params, params, c.opt.init(params), replay,
                                 sampler, zero, zero.clone())

        self._init = init


@register_trainer("baseline")
class BaselineTrainer(_SequentialTrainer):
    """Standard DQN (Figure 1a): θ acts, updates block, 𝒟 writes are
    immediate. The W streams are batched (the dataflow model); the
    per-stream transaction cost is the host runner's."""


@register_trainer("synchronized")
class SynchronizedTrainer(_SequentialTrainer):
    """Synchronized Execution without Concurrent Training: the
    sequential update structure over W >= 2 explicitly batched streams
    (one Q transaction per round, Figure 3b)."""

    def __init__(self, spec: ExperimentSpec, device: str = "cuda"):
        if spec.envs < 2:
            raise ValueError(
                "synchronized execution aggregates W >= 2 sampler "
                f"streams (the paper marks W=1 as '—'); got envs={spec.envs}")
        super().__init__(spec, device)
