"""Population training, the port of ``repro.core.population``: P
replicas of the concurrent cycle, one per seed, as one program on one
card.

A population is P ``TrainerCarry`` replicas stacked on a new leading
axis: every leaf of the carry has a leading P. That is the layout the
JAX package's population carry and its checkpoints have, so a
checkpoint of either package resumes in the other. The reference vmaps
the single-replica cycle over that axis; the port carries the axis
through the cycle itself (``core.concurrent.make_concurrent_cycle``): a
round is one Q call and one env step for all P W streams, an update one
forward and one backward for all P minibatches, and the PER descent,
the tree build and the C51 projection launch once for all P replicas.
The cycle's launches, which bound its time on the card, do not grow
with P.

Replica r follows the standalone run with seed ``seeds[r]``: its keys,
env streams, replay draws and kernel results are that run's bit for
bit; its float state agrees to rounding, because a batched product or a
grouped convolution sums in another order than the standalone one (the
reference's own vmapped population misses its standalone runs the same
way, by ~7e-7 relative after two cycles). Two population runs are
bitwise equal.

``replica_mesh`` is the reference's rule for sharding the replica axis:
a 1-D ``replica`` mesh over the largest number of the running process
group's ranks (one card each) that divides P, or None where only one
rank would take part, as on one card. On such a mesh each rank runs its
P/D consecutive replicas through the same batched cycle, with no
collective (replicas are independent); ``gather_replicas`` puts the
ranks' replicas back together along the replica axis (the metrics, the
evaluations, a checkpoint) and ``own_replicas`` takes a rank's share of
a whole population (a restored checkpoint).
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from repro_torch import rng
from repro_torch.config import DQNConfig
from repro_torch.core.concurrent import (EVAL_STREAM_TAG, TrainerCarry,
                                         make_concurrent_cycle, prepopulate,
                                         replica_key)
from repro_torch.core.replay import replay_init
from repro_torch.core.synchronized import Obs, evaluate, sampler_init
from repro_torch.envs.games import EnvSpec
from repro_torch.envs.preprocess import as_obs

__all__ = [
    "seed_array", "packed_seeds", "make_replica_init", "population_init",
    "make_population_cycle", "population_evaluate", "eval_keys",
    "tree_map", "stack_replicas", "with_replicas", "replica",
    "replica_mesh", "replica_mesh_size", "own_replicas", "gather_replicas",
]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` on every tensor of a carry (dicts, named tuples, tuples),
    keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v) for v in tree]
        return (type(tree)(*vals) if hasattr(tree, "_fields")
                else tuple(vals))
    return fn(tree)


def stack_replicas(carries: Sequence[Any]) -> Any:
    """P carries of one structure -> one carry with a leading P on every
    leaf."""
    first = carries[0]
    if isinstance(first, dict):
        return {k: stack_replicas([c[k] for c in carries]) for k in first}
    if isinstance(first, tuple):
        vals = [stack_replicas([c[i] for c in carries])
                for i in range(len(first))]
        return (type(first)(*vals) if hasattr(first, "_fields")
                else tuple(vals))
    return torch.stack(carries)


def with_replicas(template: Any, P: int) -> Any:
    """A single replica's template (its leaves give shapes and dtypes)
    with a leading replica axis of P on every leaf: the population
    carry's layout, allocated without data."""
    return tree_map(lambda t: t.new_empty((P,) + tuple(t.shape)), template)


def replica(carry: Any, r: int) -> Any:
    """Replica r of a population carry (views)."""
    return tree_map(lambda t: t[r], carry)


def seed_array(base_seed: int, n: int) -> torch.Tensor:
    """The n consecutive replica seeds [base, base + n), int32."""
    return torch.arange(n, dtype=torch.int32) + int(base_seed)


def packed_seeds(seeds: Sequence[int]) -> torch.Tensor:
    """Explicit (possibly non-contiguous) replica seeds, int32: the sweep
    packer's entry onto the replica axis. Every population guarantee
    holds for any seed list, since the init and the cycle only consume
    each replica's seed value. Duplicates are refused: two replicas
    sharing a seed would train identical twins, which a sweep manifest
    must surface as a bug, not compute twice."""
    vals = [int(s) for s in seeds]
    if not vals:
        raise ValueError("packed_seeds needs at least one replica seed")
    dupes = sorted({s for s in vals if vals.count(s) > 1})
    if dupes:
        raise ValueError(
            f"duplicate replica seeds {dupes} in packed fleet — each "
            "packed run must carry a distinct seed")
    return torch.tensor(vals, dtype=torch.int32)


class ReplicaInit:
    """``init_one(seed) -> TrainerCarry`` on ``device``: params,
    optimizer state, a replay prepopulated with ``cfg.prepopulate``
    uniform-random transitions, and the sampler streams, all derived
    from ``PRNGKey(seed)``, split once between the network init and the
    sampler. ``init_one(seed, device="meta", fill=False)`` builds only
    the carry's structure, shapes and dtypes (no data, no prepopulate:
    it changes no shape), the port's ``jax.eval_shape`` of the init.
    ``fill(carry)`` prepopulates a carry built with ``fill=False``, one
    replica's or a population's (all P W streams in the same rounds)."""

    def __init__(self, spec: EnvSpec, q_init_fn: Callable,
                 q_forward: Callable, opt, cfg: DQNConfig, obs: Obs,
                 device):
        self.spec, self.q_init_fn, self.q_forward = spec, q_init_fn, q_forward
        self.opt, self.cfg, self.pipe = opt, cfg, as_obs(obs)
        self.device = device

    def __call__(self, seed: int, device=None,
                 fill: bool = True) -> TrainerCarry:
        device = self.device if device is None else device
        cfg, pipe = self.cfg, self.pipe
        seed_t = torch.full((), int(seed), dtype=torch.int32, device=device)
        keys = rng.split(rng.PRNGKey(seed_t))
        params = self.q_init_fn(keys[0])
        replay = replay_init(cfg.replay_capacity,
                             pipe.shape + (cfg.frame_stack,),
                             obs_dtype=pipe.dtype,
                             prioritized=cfg.variant.prioritized,
                             device=device)
        sampler = sampler_init(self.spec, cfg, keys[1], pipe)
        step = torch.zeros((), dtype=torch.int32, device=device)
        carry = TrainerCarry(params, self.opt.init(params), replay, sampler,
                             step, seed_t)
        return self.fill(carry) if fill else carry

    def fill(self, carry: TrainerCarry) -> TrainerCarry:
        replay, sampler = prepopulate(self.spec, self.q_forward, self.cfg,
                                      carry.replay, carry.sampler,
                                      self.cfg.prepopulate, self.pipe)
        return carry._replace(replay=replay, sampler=sampler)


def make_replica_init(spec: EnvSpec, q_init_fn: Callable,
                      q_forward: Callable, opt, cfg: DQNConfig,
                      obs: Obs = 84, device="cpu") -> ReplicaInit:
    """The single-replica initializer (see :class:`ReplicaInit`). The
    same object builds the standalone init and, through
    ``population_init``, each replica of a population, so the two cannot
    drift."""
    return ReplicaInit(spec, q_init_fn, q_forward, opt, cfg, obs, device)


def population_init(init_one: ReplicaInit, seeds, device=None,
                    fill: bool = True) -> TrainerCarry:
    """Stack P replicas, one per seed: each replica's network, optimizer,
    replay and sampler are built as the standalone init builds them,
    then the stacked replays are prepopulated over all P W streams at
    once (the rounds do not grow with P). Every leaf of the returned
    carry has leading dim P, and replica r equals ``init_one(seeds[r])``
    bit for bit. ``device="meta", fill=False`` is the restore
    template."""
    carries: List[TrainerCarry] = [init_one(int(s), device=device, fill=False)
                                   for s in seeds]
    pop = stack_replicas(carries)
    return init_one.fill(pop) if fill else pop


# the reference's names: the concurrent cycle runs over the leading
# replica axis itself, and ``evaluate`` gives (P,) returns for (P, ...)
# parameters and (P, 2) keys
make_population_cycle = make_concurrent_cycle
population_evaluate = evaluate


def eval_keys(seeds: torch.Tensor, step) -> torch.Tensor:
    """Per-replica evaluation keys (P, 2): a dedicated stream tag folded
    with each replica's seed and the eval step counter, so eval RNG never
    collides with the training streams and resumes reproducibly."""
    seeds = torch.as_tensor(seeds, dtype=torch.int32)
    if not isinstance(step, torch.Tensor):
        step = torch.full((), int(step), dtype=torch.int32,
                          device=seeds.device)
    return replica_key(EVAL_STREAM_TAG, seeds, step)


def replica_mesh_size(n_replicas: int, n_ranks: int) -> int:
    """The reference's divisor rule: the largest count of at most
    ``n_ranks`` ranks that divides P (1: no mesh)."""
    d = min(n_ranks, n_replicas)
    while d > 1 and n_replicas % d != 0:
        d -= 1
    return max(d, 1)


def replica_mesh(n_replicas: int):
    """A 1-D ``replica`` DeviceMesh over the first ``replica_mesh_size``
    ranks of the running process group, or None when only one rank would
    take part (no group, or one card: the batched cycle alone)."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    d = replica_mesh_size(n_replicas, n)
    if d <= 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(d),
                      mesh_dim_names=("replica",))


def own_replicas(tree: Any, mesh, n_replicas: int) -> Any:
    """This rank's P/D consecutive replicas of a whole population (a
    copy of each leaf's rows)."""
    n = n_replicas // mesh.size()
    r = mesh.get_local_rank()
    return tree_map(lambda t: t[r * n:(r + 1) * n].clone(), tree)


def gather_replicas(tree: Any, mesh) -> Any:
    """The whole population on every rank: each leaf's rows all-gathered
    along the replica axis in rank order, which is replica order."""
    import torch.distributed as dist
    group = mesh.get_group()

    def gather(t: torch.Tensor) -> torch.Tensor:
        # bool goes as bytes: not every backend reduces or gathers bool
        src = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.size())]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def walk(node):
        # dict keys in sorted order: every rank gathers the same leaf in
        # the same collective, whatever order its dict was built in
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, tuple):
            vals = [walk(v) for v in node]
            return (type(node)(*vals) if hasattr(node, "_fields")
                    else tuple(vals))
        return gather(node)
    return walk(tree)
