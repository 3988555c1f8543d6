"""The sequential modes against the JAX package's.

``baseline`` (the double variant, as examples/specs/baseline_catch.json)
and ``synchronized`` (dueling, as synchronized_catch.json) on catch, in
pixels at frame_size 10 with the ``tiny`` net and in vector mode with
``mlp_tiny``, each with AdamW and with RMSProp; W=4, F=4, C=32, a
256-slot replay, minibatch 8, prepopulate 64, on the CPU:

* the port's own ``init_carry`` is the reference's (parameters to the
  ulps of the normal draws, everything else exactly);
* two cycles from a carry carried over from JAX match the JAX carries:
  integers exactly, floats to 1e-4; metrics and one evaluation too;
* two port runs from one carry are bitwise equal;
* every refusal of the reference's sequential trainers is raised, with
  its message.
"""


import jax
import numpy as np
import pytest
import torch

from repro.api import build_trainer as jbuild
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.configs.dqn_nature import get_variant as jvariant
from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
from repro_torch.api.trainers import (BaselineTrainer, SynchronizedTrainer,
                                      build_trainer)
from repro_torch.configs.dqn_nature import get_variant
from repro_torch.convert import baseline_carry_from_jax, tensor_from_jax

FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
SCHED = dict(cycles=2, cycle_steps=32, prepopulate=64, eval_every=1,
             eval_episodes=4)
MODES = {"baseline": "double", "synchronized": "dueling"}
OBS = {"pixels": dict(obs_mode="pixels", frame_size=10, net="tiny"),
       "vector": dict(obs_mode="vector", net="mlp_tiny")}
CASES = [(m, o, opt) for m in MODES for o in OBS for opt in ("adamw",
                                                            "rmsprop")]
IDS = ["-".join(c) for c in CASES]


def _specs(mode, obs, opt, **over):
    algo = dict(minibatch_size=8, replay_capacity=256, train_period=4,
                optimizer=opt)
    top = dict(env="catch", mode=mode, envs=4, **OBS[obs])
    top.update(over.pop("top", {}))
    algo.update(over.pop("algo", {}))
    sched = dict(SCHED, **over.pop("sched", {}))
    variant = over.pop("variant", MODES.get(mode, "dqn"))
    return (JSpec(variant=jvariant(variant), schedule=JSched(**sched),
                  algo=JAlgo(**algo), **top),
            ExperimentSpec(variant=get_variant(variant),
                           schedule=ScheduleSpec(**sched),
                           algo=AlgoSpec(**algo), **top))


_RUNS = {}


def _run(case):
    """The JAX trainer's carries after init, 1 and 2 cycles, its metrics
    and an eval of the last carry; the port's trainer for the spec."""
    if case not in _RUNS:
        torch.set_num_threads(1)
        jspec, tspec = _specs(*case)
        jt = jbuild(jspec)
        c0 = jt.init_carry()
        c1, m1 = jt.cycle(c0)
        c2, m2 = jt.cycle(c1)
        ev = jt.eval(c2, jt.eval_key(1))
        _RUNS[case] = (jax.device_get([c0, c1, c2]),
                       jax.device_get([m1, m2]), np.asarray(ev),
                       build_trainer(tspec, device="cpu"))
    return _RUNS[case]


def _leaves(carry, prefix=""):
    if isinstance(carry, dict):
        for k, v in carry.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(carry, tuple) and hasattr(carry, "_fields"):
        for k, v in zip(carry._fields, carry):
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, carry


def _assert_carry_matches(tcarry, jcarry):
    want = dict(_leaves(jcarry))
    got = dict(_leaves(tcarry))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].numpy()
        assert g.shape == w.shape, path
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=path, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_init_carry_exact(case):
    jcarries, _, _, tt = _run(case)
    assert isinstance(tt, BaselineTrainer if case[0] == "baseline"
                      else SynchronizedTrainer)
    tc = tt.init_carry()
    got = dict(_leaves(tc))
    want = dict(_leaves(jcarries[0]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = got[path].numpy(), np.asarray(w)
        if path.startswith((".params", ".target_params", ".opt_state")):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)
    assert int(tc.replay["size"]) == 64
    if case[1] == "vector":
        assert tc.replay["obs"].dtype == torch.float32
        assert tuple(tc.replay["obs"].shape) == (256, 3, 2)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_two_cycles_match_reference(case):
    jcarries, jmetrics, jeval, tt = _run(case)
    carry = baseline_carry_from_jax(jcarries[0])
    for i in range(2):
        carry, m = tt.cycle(carry)
        for k in ("loss", "eps"):
            np.testing.assert_allclose(float(m[k][0]),
                                       float(jmetrics[i][k][0]),
                                       err_msg=k, **FLOAT_TOL)
        np.testing.assert_allclose(float(m["reward"][0]),
                                   float(jmetrics[i]["reward"][0]),
                                   err_msg="reward", **FLOAT_TOL)
        assert float(m["episodes"][0]) == float(jmetrics[i]["episodes"][0])
        _assert_carry_matches(carry, jcarries[i + 1])
    assert int(tt.steps(carry)[0]) == 64 and int(carry.group) == 16
    got = tt.eval(baseline_carry_from_jax(jcarries[2]), tt.eval_key(1))
    np.testing.assert_allclose(got.numpy(), jeval, **FLOAT_TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[-1]],
                         ids=[IDS[0], IDS[-1]])
def test_two_runs_from_one_carry_are_bitwise_equal(case):
    jcarries, _, _, tt = _run(case)
    runs = []
    for _ in range(2):
        carry, m = tt.cycle(baseline_carry_from_jax(jcarries[1]))
        runs.append((dict(_leaves(carry)), m))
    (a, ma), (b, mb) = runs
    for path in a:
        assert torch.equal(a[path], b[path]), path
    assert torch.equal(ma["loss"], mb["loss"])


def test_target_network_follows_the_period():
    """θ⁻ ← θ every C // F groups and only then: with C = 32 and F = 4,
    after 8 groups θ⁻ is θ; a carry started mid-period keeps its θ⁻."""
    jcarries, _, _, tt = _run(CASES[0])
    carry, _ = tt.cycle(baseline_carry_from_jax(jcarries[0]))
    for k, p in carry.params.items():
        assert torch.equal(carry.target_params[k], p), k
    mid = baseline_carry_from_jax(jcarries[0])._replace(
        group=torch.full((), 3, dtype=torch.int32))
    carry, _ = tt.cycle(mid)
    assert any(not torch.equal(carry.target_params[k], p)
               for k, p in carry.params.items())


REFUSALS = [
    ("baseline", dict(variant="per")),
    ("baseline", dict(variant="c51")),
    ("synchronized", dict(variant="noisy")),
    ("baseline", dict(variant="rainbow_lite")),
    ("baseline", dict(algo=dict(train_period=6))),
    ("synchronized", dict(sched=dict(cycle_steps=36), algo=dict(
        train_period=8))),
    ("synchronized", dict(top=dict(envs=1))),
]


@pytest.mark.parametrize("mode,over", REFUSALS,
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(REFUSALS)])
def test_refusals_match_reference(mode, over):
    jspec, tspec = _specs(mode, "pixels", "adamw", **over)
    with pytest.raises(ValueError) as want:
        jbuild(jspec)
    with pytest.raises(ValueError) as got:
        build_trainer(tspec, device="cpu")
    assert str(got.value) == str(want.value)


def test_population_builds_through_the_registry():
    """``mode='population'`` resolves to the population trainer, with the
    reference's replica count and (P,) shape contract."""
    jspec, tspec = _specs("baseline", "pixels", "adamw", variant="dqn",
                          top=dict(mode="population", seeds=2),
                          sched=dict(cycle_steps=16, prepopulate=32))
    jt = jbuild(jspec)
    tt = build_trainer(tspec, device="cpu")
    assert type(tt).__name__ == "PopulationTrainer"
    assert tt.replicas == jt.replicas == 2
    carry, m = tt.cycle(tt.init_carry())
    assert {k: tuple(v.shape) for k, v in m.items()} == {
        "loss": (2,), "reward": (2,), "episodes": (2,), "eps": (2,)}
    np.testing.assert_array_equal(tt.steps(carry).numpy(), [16, 16])
    np.testing.assert_array_equal(tt.seeds.numpy(),
                                  np.asarray(jt.seeds))


def test_eval_key_matches_reference():
    _, tspec = _specs("synchronized", "vector", "adamw")
    jspec, _ = _specs("synchronized", "vector", "adamw")
    jt = jbuild(jspec)
    tt = build_trainer(tspec, device="cpu")
    np.testing.assert_array_equal(tt.eval_key(5).numpy(),
                                  tensor_from_jax(jt.eval_key(5)).numpy())
