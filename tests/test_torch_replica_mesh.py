"""The replica mesh against the JAX package: the size ``replica_mesh``
picks for P replicas over n ranks is the reference's divisor rule, held
against the reference's ``replica_mesh(P, devices[:n])`` on 8 host
devices in a subprocess (the device-count flag must not leak into this
process); without a process group, and on one rank, there is no mesh.
"""

import json
import os
import subprocess
import sys

from repro_torch.core.population import replica_mesh, replica_mesh_size

JAX_SIZES = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.core.population import replica_mesh
devs = jax.devices()
out = {}
for P in range(1, 17):
    for n in range(1, 9):
        m = replica_mesh(P, devs[:n])
        out[f"{P},{n}"] = 1 if m is None else int(m.shape["replica"])
print(json.dumps(out))
"""


def test_replica_mesh_size_is_the_reference_rule():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_SIZES],
                         capture_output=True, text=True, env=env,
                         cwd=os.getcwd(), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {f"{P},{n}": replica_mesh_size(P, n)
           for P in range(1, 17) for n in range(1, 9)}
    assert got == want


def test_no_mesh_on_one_rank():
    import torch.distributed as dist
    assert not dist.is_initialized()
    for P in (1, 2, 4, 16):
        assert replica_mesh(P) is None


SCHED = dict(cycles=1, cycle_steps=32, prepopulate=32, eval_every=1,
             eval_episodes=4)
ALGO = dict(minibatch_size=8, replay_capacity=128, optimizer="adamw")


def _spec(mode, seed=0, seeds=2):
    from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
    from repro_torch.configs.dqn_nature import get_variant
    return ExperimentSpec(env="catch", mode=mode, envs=4, seed=seed,
                          seeds=seeds, obs_mode="pixels", frame_size=10,
                          net="tiny", variant=get_variant("dqn"),
                          schedule=ScheduleSpec(**SCHED),
                          algo=AlgoSpec(**ALGO))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _population_rank(rank, world, path, out):
    import torch
    import torch.distributed as dist
    from repro_torch.api.trainers import build_trainer
    from repro_torch.core.population import replica
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world)
    try:
        trainer = build_trainer(_spec("population"), device="cpu")
        assert trainer.mesh is not None and trainer.mesh.size() == world
        carry = trainer.init_carry()
        for _ in range(SCHED["cycles"]):
            carry, m = trainer.cycle(carry)
            assert m["loss"].shape == (2,)
        alone = build_trainer(_spec("concurrent", seed=rank, seeds=1),
                              device="cpu")
        solo = alone.init_carry()
        for _ in range(SCHED["cycles"]):
            solo, _ = alone.cycle(solo)
        mine = dict(_leaves(replica(carry, 0)))
        for path, t in _leaves(solo):
            assert torch.equal(mine[path], t), (rank, path)
        whole = trainer.whole(carry)
        if rank == 0:
            torch.save(whole, out)
    finally:
        dist.destroy_process_group()


def test_two_rank_population_matches_one_process(tmp_path):
    """2 replicas of dqn on catch (C = 32) over a 2-rank gloo world: each
    rank's replica is bitwise its standalone run with its seed; the
    gathered carry holds the one-process population's integers exactly
    and its floats to 1e-4 of each leaf's largest magnitude."""
    import torch
    import torch.multiprocessing as mp
    from repro_torch.api.trainers import build_trainer
    out = str(tmp_path / "whole.pt")
    mp.spawn(_population_rank, args=(2, str(tmp_path / "store"), out),
             nprocs=2, join=True)
    got = dict(_leaves(torch.load(out, weights_only=False)))
    trainer = build_trainer(_spec("population"), device="cpu")
    assert trainer.mesh is None
    carry = trainer.init_carry()
    for _ in range(SCHED["cycles"]):
        carry, _ = trainer.cycle(carry)
    for path, want in _leaves(carry):
        g = got[path]
        assert g.shape == want.shape and g.dtype == want.dtype, path
        if want.dtype.is_floating_point:
            scale = float(want.abs().max()) or 1.0
            assert float((g - want).abs().max()) <= 1e-4 * scale, path
        else:
            assert torch.equal(g, want), path
