"""Population mode (``core.population``, ``PopulationTrainer``) against
the standalone runs, on the CPU.

Catch at 10x10 with the ``tiny`` net (one conv of 8) and in vector mode
with ``mlp_tiny``; P=3 replicas, W=4, C=16, a 128-slot replay,
minibatch 8, prepopulate 32, AdamW: the sizes ``tests/test_population.py``
gives its fleets. The dqn preset (the scalar path) and rainbow (PER,
n-step, C51, NoisyNet and dueling at once) in both obs modes:

* the initial population carry is the P standalone inits stacked, bit
  for bit;
* after 2 cycles, replica r agrees with the port's standalone
  ``concurrent`` run with seed r (integer and bool leaves exactly, float
  leaves within 1e-4 of each leaf's largest magnitude) and with the JAX
  package's standalone run with seed r (integers exactly, floats to
  atol = rtol = 1e-4, the tolerance the concurrent presets hold against
  JAX: the port's standalone run itself differs from JAX's by up to
  ~5e-4 of a NoisyNet sigma leaf's largest magnitude, at elements whose
  gradient cancels to ~1e-9, where AdamW's step m / (sqrt(v) + eps) turns
  rounding into a visible move). Not bitwise: a batched product or a
  grouped convolution sums in another order than the standalone one, and
  the reference's own vmapped population misses its standalone runs the
  same way (~7e-7 relative after two cycles);
* two population runs are bitwise equal;
* ``eval_key`` is (P, 2) and equal to ``repro.core.population.eval_keys``
  bit for bit; ``eval`` and ``steps`` are (P,), the returns those of the
  reference's ``population_evaluate`` on the same parameters;
* ``packed_seeds`` refuses a duplicate seed, and a packed list must match
  ``spec.seeds``;
* AdamW clips per replica: one replica's gradient norm above
  ``grad_clip`` and another's below it, each update equal to its own
  standalone one and to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_trainer as jbuild
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.configs.dqn_nature import get_variant as jvariant
from repro.core import population as jpop
from repro.optim import adamw as jadamw
from repro_torch import rng
from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
from repro_torch.api.trainers import PopulationTrainer, build_trainer
from repro_torch.configs.dqn_nature import get_variant
from repro_torch.convert import carry_from_jax
from repro_torch.core.population import (packed_seeds, replica,
                                         seed_array, stack_replicas)
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import global_norm

P = 3
SCHED = dict(cycles=2, cycle_steps=16, prepopulate=32, eval_every=1,
             eval_episodes=4)
ALGO = dict(minibatch_size=8, replay_capacity=128, optimizer="adamw")
OBS = {"pixels": dict(obs_mode="pixels", frame_size=10, net="tiny"),
       "vector": dict(obs_mode="vector", net="mlp_tiny")}
CASES = [(v, o) for v in ("dqn", "rainbow") for o in OBS]
IDS = ["-".join(c) for c in CASES]
REL = 1e-4


def _specs(variant, obs, mode="population", seed=0, seeds=P):
    top = dict(env="catch", mode=mode, envs=4, seed=seed, seeds=seeds,
               **OBS[obs])
    return (JSpec(variant=jvariant(variant), schedule=JSched(**SCHED),
                  algo=JAlgo(**ALGO), **top),
            ExperimentSpec(variant=get_variant(variant),
                           schedule=ScheduleSpec(**SCHED),
                           algo=AlgoSpec(**ALGO), **top))


def _leaves(carry, prefix=""):
    if isinstance(carry, dict):
        for k, v in carry.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(carry, tuple) and hasattr(carry, "_fields"):
        for k, v in zip(carry._fields, carry):
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, carry


def _assert_bitwise(a, b, label=""):
    got, want = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and torch.equal(g, w), f"{label}{path}"


def _assert_close(a, b, label="", elementwise=False):
    """Integers and bools exactly; floats within REL of each leaf's
    largest magnitude, or (``elementwise``) to atol = rtol = REL."""
    got, want = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, f"{label}{path}"
        if w.dtype.is_floating_point and elementwise:
            torch.testing.assert_close(g, w, atol=REL, rtol=REL,
                                       msg=f"{label}{path}")
        elif w.dtype.is_floating_point:
            scale = float(w.abs().max()) if w.numel() else 0.0
            err = float((g - w).abs().max()) if w.numel() else 0.0
            assert err <= REL * scale, f"{label}{path}: {err} of {scale}"
        else:
            assert torch.equal(g, w), f"{label}{path}"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("variant,obs", CASES, ids=IDS)
def test_replicas_match_standalone_runs(variant, obs):
    _, tspec = _specs(variant, obs)
    pt = build_trainer(tspec, device="cpu")
    assert isinstance(pt, PopulationTrainer) and pt.replicas == P
    pop0 = pt.init_carry()
    pop, metrics = pt.cycle(pop0)
    pop, metrics = pt.cycle(pop)
    assert {k: tuple(v.shape) for k, v in metrics.items()} == {
        k: (P,) for k in ("loss", "reward", "episodes", "eps")}
    assert torch.equal(pt.steps(pop), torch.full((P,), 32, dtype=torch.int32))
    # the JAX standalone runs: one compiled init and cycle for all seeds
    jspec, _ = _specs(variant, obs, mode="concurrent", seeds=1)
    jt = jbuild(jspec)
    c = jt._c
    jinit = jax.jit(jpop.make_replica_init(c.env, c.q_init, c.qf, c.opt,
                                           c.dcfg, c.obs))
    for r in range(P):
        _, sspec = _specs(variant, obs, mode="concurrent", seed=r, seeds=1)
        st = build_trainer(sspec, device="cpu")
        single = st.init_carry()
        _assert_bitwise(replica(pop0, r), single, f"init replica {r}: ")
        for _ in range(2):
            single, sm = st.cycle(single)
        _assert_close(replica(pop, r), single, f"replica {r} vs port: ")
        j = jinit(jnp.int32(r))
        for _ in range(2):
            j, jm = jt.cycle(j)
        _assert_close(replica(pop, r), carry_from_jax(jax.device_get(j)),
                      f"replica {r} vs JAX: ", elementwise=True)
        np.testing.assert_allclose(float(metrics["loss"][r]),
                                   float(sm["loss"][0]), rtol=REL)
        np.testing.assert_allclose(float(metrics["loss"][r]),
                                   float(jm["loss"][0]), rtol=REL)
        for k in ("reward", "episodes", "eps"):
            assert float(metrics[k][r]) == float(sm[k][0]), k
            assert float(metrics[k][r]) == float(np.asarray(jm[k])[0]), k


def test_two_population_runs_are_bitwise_equal():
    _, tspec = _specs("rainbow", "pixels")
    runs = []
    for _ in range(2):
        pt = build_trainer(tspec, device="cpu")
        carry = pt.init_carry()
        for _ in range(2):
            carry, m = pt.cycle(carry)
        runs.append((carry, m))
    _assert_bitwise(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.parametrize("obs", list(OBS))
def test_eval_keys_and_eval_match_reference(obs):
    jspec, tspec = _specs("dueling", obs, seed=5)
    jt = jbuild(jspec)
    pt = build_trainer(tspec, device="cpu")
    for i in (0, 3, 1000):
        key = pt.eval_key(i)
        assert key.shape == (P, 2) and key.dtype == torch.int64
        want = np.asarray(jpop.eval_keys(jpop.seed_array(5, P), i))
        np.testing.assert_array_equal(key.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(
            key.numpy(), np.asarray(jt.eval_key(i)).astype(np.int64))
    carry, _ = pt.cycle(pt.init_carry())
    got = pt.eval(carry, pt.eval_key(2))
    assert got.shape == (P,) and got.dtype == torch.float32
    c = jt._c
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), carry.params)
    want = jax.jit(lambda p, k: jpop.population_evaluate(
        c.env, c.qf, p, k, c.dcfg, n_episodes=SCHED["eval_episodes"],
        obs=c.obs))(params, jnp.asarray(pt.eval_key(2).numpy()
                                        .astype(np.uint32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_seed_lists():
    assert seed_array(7, 3).tolist() == [7, 8, 9]
    assert seed_array(7, 3).dtype == torch.int32
    assert packed_seeds([4, 1, 9]).tolist() == [4, 1, 9]
    with pytest.raises(ValueError, match=r"duplicate replica seeds \[1\]"):
        packed_seeds([1, 2, 1])
    with pytest.raises(ValueError, match="at least one"):
        packed_seeds([])
    _, tspec = _specs("dqn", "vector")
    with pytest.raises(ValueError, match="spec.seeds=3"):
        PopulationTrainer(tspec, device="cpu", seeds=[0, 1])
    pt = PopulationTrainer(tspec, device="cpu", seeds=[11, 3, 5])
    assert pt.seeds.tolist() == [11, 3, 5]
    assert pt.init_template().seed.shape == (P,)
    with pytest.raises(ValueError, match="mode 'population'"):
        PopulationTrainer(dataclasses.replace(tspec, mode="concurrent"),
                          device="cpu")


def test_packed_replicas_follow_their_seeds():
    """A packed, non-contiguous seed list: replica r's initial carry is
    the standalone init of seeds[r]."""
    _, tspec = _specs("dqn", "vector")
    pt = PopulationTrainer(tspec, device="cpu", seeds=[11, 3, 5])
    pop = pt.init_carry()
    for r, seed in enumerate((11, 3, 5)):
        _, sspec = _specs("dqn", "vector", mode="concurrent", seed=seed,
                          seeds=1)
        _assert_bitwise(replica(pop, r),
                        build_trainer(sspec, device="cpu").init_carry(),
                        f"replica {r}: ")


def test_adamw_clips_each_replica_by_its_own_norm():
    """Two AdamW steps on a pair of replicas. Replica 0's first gradient
    has a norm above grad_clip = 1, every other gradient one below it.
    Each batched update equals its own standalone update and the
    reference's; replica 1 clipped by the pair's joint norm in the first
    step would take another second step (Adam's step depends on the
    ratio of its gradients)."""
    from repro_torch.configs.dqn_nature import cnn_geometry
    from repro_torch.models.nature_cnn import q_init
    from repro_torch.optim.base import clip_by_global_norm
    ncfg = cnn_geometry("tiny", 10, 3)
    params = [q_init(ncfg, 3, rng.PRNGKey(s)) for s in (0, 1)]
    gen = torch.Generator().manual_seed(0)

    def grad(p, norm):
        g = {k: torch.randn(v.shape, generator=gen) for k, v in p.items()}
        s = norm / float(global_norm(g))
        return {k: v * s for k, v in g.items()}

    steps = [[grad(params[0], 3.0), grad(params[1], 0.3)],
             [grad(params[0], 0.5), grad(params[1], 0.2)]]
    opt = adamw(1e-3, weight_decay=0.0)
    jopt = jadamw(1e-3, weight_decay=0.0)
    plain = adamw(1e-3, weight_decay=0.0, grad_clip=None)
    states = [opt.init(p) for p in params]
    state = stack_replicas(states)
    joint = stack_replicas(states)
    assert state["step"].shape == (2,)
    pp = stack_replicas(params)
    for grads in steps:
        batched = stack_replicas(grads)
        np.testing.assert_allclose(
            global_norm(batched, replicas=1).numpy(),
            [float(global_norm(g)) for g in grads], rtol=1e-6)
        upd, state = opt.update(batched, state, pp)
        fleet, _ = clip_by_global_norm(batched, 1.0)      # the joint norm
        jupd, joint = plain.update(fleet, joint, pp)
        for r in range(2):
            u, states_r = opt.update(grads[r], states[r], params[r])
            ju, _ = jopt.update(
                {k: jnp.asarray(v.numpy()) for k, v in grads[r].items()},
                jax.tree.map(lambda t: jnp.asarray(t.numpy()), states[r]),
                {k: jnp.asarray(v.numpy()) for k, v in params[r].items()})
            states[r] = states_r
            for k in u:
                scale = float(u[k].abs().max())
                assert float((upd[k][r] - u[k]).abs().max()) <= 1e-6 * scale
                np.testing.assert_allclose(upd[k][r].numpy(),
                                           np.asarray(ju[k]),
                                           atol=1e-6 * scale, rtol=0)
    # the second step: replica 1 under the joint norm moves differently
    worst = max(float((jupd[k][1] - upd[k][1]).abs().max()
                      / upd[k][1].abs().max()) for k in upd)
    assert worst > 1e-2, worst
