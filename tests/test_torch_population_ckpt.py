"""Population checkpoints: the port's against the JAX package's, resume,
serving a replica, and the launcher with ``--seeds``, on the CPU.

Catch at 10x10 with the ``tiny`` net and in vector mode with
``mlp_tiny``; P=3 replicas, W=4, C=16, a 128-slot replay, minibatch 8,
prepopulate 32, AdamW (the sizes of ``tests/test_torch_population.py``).
A population carry is the concurrent carry with a leading replica axis
on every leaf in both packages, so:

* ``carry_from_jax`` and ``tree_from_jax`` take a JAX population carry
  with its leading replica axis;
* a JAX population checkpoint restored by the port runs the next cycle
  as the JAX population does, and a port population checkpoint restored
  by ``repro.checkpoint`` runs the next JAX cycle as the port does:
  integers exactly, floats to atol = rtol = 1e-4 (the tolerance of
  ``tests/test_torch_checkpoint.py``'s resume across packages);
* resume in the port is bitwise: two cycles straight equal one cycle, a
  save, a restore into ``init_template()`` and one cycle;
* ``load_policy`` serves replica r of a port-written population
  checkpoint: replica r's parameters, and the actions ``policy_step``
  gives on them;
* ``rl_train --mode population --seeds 3`` writes one metrics row per
  (cycle, replica) with the reference's fields, checkpoints, and
  ``--resume`` continues bitwise-consistent rows.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
from repro.api import build_trainer as jbuild
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.configs.dqn_nature import get_variant as jvariant
from repro_torch import rng
from repro_torch.api.serve import ServeSpec, load_policy, make_server
from repro_torch.api.spec import (AlgoSpec, ExperimentSpec, ScheduleSpec,
                                  save_run_spec)
from repro_torch.api.trainers import build_trainer
from repro_torch.checkpoint import (restore_checkpoint, restore_latest,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs.dqn_nature import get_variant
from repro_torch.convert import carry_from_jax, tree_from_jax
from repro_torch.core.policy import policy_step
from repro_torch.envs.preprocess import init_obs_stack, push_frame

P = 3
FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
SCHED = dict(cycles=2, cycle_steps=16, prepopulate=32, eval_every=1,
             eval_episodes=4)
ALGO = dict(minibatch_size=8, replay_capacity=128, optimizer="adamw")
OBS = {"pixels": dict(obs_mode="pixels", frame_size=10, net="tiny"),
       "vector": dict(obs_mode="vector", net="mlp_tiny")}
CASES = [("rainbow", "pixels"), ("dqn", "vector")]
IDS = ["-".join(c) for c in CASES]
FIELDS = {"cycle", "env", "mode", "variant", "seed", "step", "loss",
          "reward", "episodes", "eval"}


def _specs(variant, obs, **algo):
    top = dict(env="catch", mode="population", envs=4, seeds=P, **OBS[obs])
    return (JSpec(variant=jvariant(variant), schedule=JSched(**SCHED),
                  algo=JAlgo(**ALGO, **algo), **top),
            ExperimentSpec(variant=get_variant(variant),
                           schedule=ScheduleSpec(**SCHED),
                           algo=AlgoSpec(**ALGO, **algo), **top))


def _paths(tree):
    return dict(_flatten(tree))


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].numpy() if isinstance(got[path], torch.Tensor) \
            else np.asarray(got[path])
        assert g.shape == w.shape, path
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=path, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)


def _assert_bitwise(a, b):
    want = _paths(b)
    got = _paths(a)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_RUNS = {}


def _jax_population(case):
    """The JAX population trainer and its carries after 1 and 2 cycles,
    with the port's population trainer for the same spec."""
    if case not in _RUNS:
        jspec, tspec = _specs(*case)
        jt = jbuild(jspec)
        j1, _ = jt.cycle(jt.init_carry())
        j2, _ = jt.cycle(j1)
        _RUNS[case] = (jt, j1, jax.device_get(j2),
                       build_trainer(tspec, device="cpu"))
    return _RUNS[case]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_resumes_a_jax_population_checkpoint(tmp_path, case):
    jt, j1, j2, tt = _jax_population(case)
    d = str(tmp_path / "ck")
    jckpt.save_checkpoint(d, 1, j1)
    template = tt.init_template()
    assert template.params["fc_w"].device.type == "meta"
    step, carry, skipped = restore_latest(d, template)
    assert (step, skipped) == (1, [])
    assert carry.step.shape == (P,) and carry.sampler.key.shape == (P, 2)
    carry, m = tt.cycle(carry)
    assert m["loss"].shape == (P,)
    _assert_close(_paths(carry), dict(jckpt.ckpt._flatten(j2)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_resumes_a_port_population_checkpoint(tmp_path, case):
    jt, j1, _, tt = _jax_population(case)
    t1 = carry_from_jax(jax.device_get(j1))
    assert t1.seed.tolist() == [0, 1, 2]
    # tree_from_jax keeps the replica axis too (a NamedTuple as a tuple)
    tree = tree_from_jax(jax.device_get(j1))
    for path, t in _paths(tree).items():
        assert torch.equal(t, _paths(t1)[path]), path
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, t1)
    restored = jckpt.restore_checkpoint(d, 1, jt.init_template())
    jnext, _ = jt.cycle(jax.tree.map(jnp.asarray, restored))
    tnext, _ = tt.cycle(t1)
    _assert_close(_paths(tnext), dict(jckpt.ckpt._flatten(
        jax.device_get(jnext))))


@pytest.mark.parametrize("obs", list(OBS))
def test_population_resume_in_the_port_is_bitwise(tmp_path, obs):
    tt = build_trainer(_specs("rainbow", obs)[1], device="cpu")
    c1, _ = tt.cycle(tt.init_carry())
    straight, ms = tt.cycle(c1)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, c1)
    resumed, mr = tt.cycle(restore_checkpoint(d, 1, tt.init_template()))
    _assert_bitwise(resumed, straight)
    for k in ms:
        assert torch.equal(ms[k], mr[k]), k


@pytest.mark.parametrize("r", range(P))
def test_load_policy_serves_a_replica_of_a_port_checkpoint(tmp_path, r):
    _, tspec = _specs("noisy", "pixels")
    tt = build_trainer(tspec, device="cpu")
    carry, _ = tt.cycle(tt.init_carry())
    d = str(tmp_path / "ck")
    save_run_spec(d, tspec)
    save_checkpoint(d, 1, carry)
    loaded = load_policy(d, replica=r, device="cpu")
    assert loaded.step == 1
    assert sorted(loaded.params) == sorted(carry.params)
    for k, v in loaded.params.items():
        assert torch.equal(v, carry.params[k][r]), k
    others = [i for i in range(P) if i != r]
    assert any(not torch.equal(loaded.params["fc_w"],
                               carry.params["fc_w"][i]) for i in others)
    # served actions are policy_step's on replica r's parameters
    n = 16
    frames = np.random.default_rng(r).integers(
        0, 256, (n,) + loaded.pipe.shape, dtype=np.uint8)
    serve = ServeSpec(policy="egreedy", seed=3)
    server = make_server(loaded, serve)
    server.submit_many(range(n), frames, [True] * n)
    got = server.flush()
    stacks = push_frame(init_obs_stack(n, loaded.pipe, loaded.frame_stack),
                        torch.from_numpy(frames))
    base = rng.PRNGKey(serve.seed)
    ids = torch.arange(n)
    keys = rng.fold_in(rng.fold_in(base, ids), torch.zeros_like(ids))
    own = {k: v[r] for k, v in carry.params.items()}
    with torch.no_grad():
        want = policy_step(loaded.q_forward, own, stacks, serve.eps,
                           keys).tolist()
    assert [got[i] for i in range(n)] == want
    with pytest.raises(ValueError, match="replica 3 out of range"):
        load_policy(d, replica=P, device="cpu")


def test_launcher_population_metrics_and_resume(tmp_path, capsys):
    """--mode population --seeds 3: one metrics row per (cycle, replica)
    with the reference's fields, each replica's seed and step; a
    checkpoint each cycle; --cycles 3 --resume continues from cycle 2
    with the rows of cycle 3 only, and a resumed run's rows equal those
    of an uninterrupted one."""
    from repro_torch.launch import rl_train
    _, tspec = _specs("dqn", "vector", eps_anneal_steps=64)
    path = tmp_path / "spec.json"
    path.write_text(dataclasses.replace(tspec, seed=4).to_json())

    def run(name, *extra):
        d = tmp_path / name
        args = ["--spec", str(path), "--device", "cpu", "--ckpt-dir",
                str(d), "--ckpt-every", "1", "--metrics-jsonl",
                str(d / "m.jsonl"), *extra]
        assert rl_train.main(args) == 0
        with open(d / "m.jsonl") as f:
            return [json.loads(ln) for ln in f], capsys.readouterr().out

    rows, out = run("a", "--cycles", "2")
    assert "x3 " in out
    assert [(x["cycle"], x["seed"]) for x in rows] == [
        (c, s) for c in (1, 2) for s in (4, 5, 6)]
    for x in rows:
        assert set(x) == FIELDS
        assert (x["env"], x["mode"], x["variant"]) == (
            "catch", "population", "dqn")
        assert x["step"] == 16 * x["cycle"]
    rows, out = run("a", "--cycles", "3", "--resume")
    assert "resumed" in out and "at cycle 2" in out
    assert [(x["cycle"], x["seed"]) for x in rows] == [
        (c, s) for c in (1, 2, 3) for s in (4, 5, 6)]
    straight, _ = run("b", "--cycles", "3")
    assert rows == straight
