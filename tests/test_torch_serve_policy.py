"""The port's policy server against the JAX package's.

Catch at frame_size 10 with the ``tiny`` net and in vector mode with
``mlp_tiny`` (W=4, a 128-slot replay), on the CPU:

* for one checkpoint written by the JAX package, the same observations
  and the same per-stream keys, the port's ``PolicyServer`` serves
  exactly the JAX server's actions under ``greedy``, ``egreedy`` and
  ``noisy`` (rainbow), in pixels and in vector mode; the simulated
  clients see the JAX clients' observations;
* a JAX population checkpoint (P = 2) serves replica 1 as the JAX
  server does;
* the cases of ``tests/test_serve_policy.py``: served actions equal
  ``evaluate``'s round-by-round choices, padding and chunking never
  change an action, padding never touches real stream state, a
  reconnect replays identically, ``ServeSpec`` validation, ``noisy``
  refused off a non-noisy checkpoint, checkpoint-dir loading past a
  torn file, the missing-spec error and the CLI's ``--smoke``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import build_trainer as jbuild
from repro.api import save_run_spec as jsave_run_spec
from repro.api.policy_client import SimulatedClients as JClients
from repro.api.serve import ServeSpec as JServe
from repro.api.serve import load_policy as jload_policy
from repro.api.serve import make_server as jmake_server
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs.dqn_nature import get_variant as jvariant
from repro_torch import rng
from repro_torch.api import build_trainer, save_run_spec
from repro_torch.api.policy_client import SimulatedClients, drive
from repro_torch.api.serve import (PolicyServer, ServeSpec, load_policy,
                                   make_server)
from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
from repro_torch.api.trainers import _Components
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.dqn_nature import get_variant
from repro_torch.core.policy import stream_keys
from repro_torch.core.synchronized import SamplerState, sync_round
from repro_torch.envs.preprocess import init_obs_stack, obs_batch, push_frame
from repro_torch.runtime import configure

TINY = dict(env="catch", mode="concurrent", envs=4, frame_size=10)
SCHED = dict(cycles=2, cycle_steps=16, prepopulate=32, eval_every=1,
             eval_episodes=4)
ALGO = dict(minibatch_size=8, replay_capacity=128, train_period=4,
            eps_anneal_steps=1000)


def _specs(variant="dqn", obs_mode="pixels", **over):
    net = "mlp_tiny" if obs_mode == "vector" else "tiny"
    top = dict(TINY, obs_mode=obs_mode, net=net, **over)
    return (JSpec(variant=jvariant(variant), schedule=JSched(**SCHED),
                  algo=JAlgo(**ALGO), **top),
            ExperimentSpec(variant=get_variant(variant),
                           schedule=ScheduleSpec(**SCHED),
                           algo=AlgoSpec(**ALGO), **top))


def _spec(variant="dqn", obs_mode="pixels", **over):
    return _specs(variant, obs_mode, **over)[1]


_JAX_DIRS = {}


def _jax_checkpoint(tmp_path_factory, variant, obs_mode, **over):
    """A checkpoint dir written by the JAX package: its spec.json and its
    trainer's init_carry at step 1."""
    key = (variant, obs_mode, tuple(sorted(over.items())))
    if key not in _JAX_DIRS:
        jspec, _ = _specs(variant, obs_mode, **over)
        d = str(tmp_path_factory.mktemp("jax_run"))
        jsave_run_spec(d, jspec)
        jsave_checkpoint(d, 1, jbuild(jspec).init_carry())
        _JAX_DIRS[key] = d
    return _JAX_DIRS[key]


def _served_against_jax(d, policy, replica=0, rounds=4, n=5):
    """Closed loop over the JAX clients: both servers get the same raw
    observations and first flags each round; returns both action
    arrays (rounds, n)."""
    torch.set_num_threads(1)
    jloaded = jload_policy(d, replica=replica)
    jsrv = jmake_server(jloaded, JServe(policy=policy, max_batch=8))
    tsrv = make_server(load_policy(d, replica=replica, device="cpu"),
                       ServeSpec(policy=policy, max_batch=8))
    clients = JClients(jloaded.spec, n, seed=1)
    got, want = [], []
    for _ in range(rounds):
        obs = clients.observations()
        for srv in (jsrv, tsrv):
            srv.submit_many(clients.ids, obs, clients.first)
        ja, ta = jsrv.flush(), tsrv.flush()
        want.append([ja[i] for i in clients.ids])
        got.append([ta[i] for i in clients.ids])
        clients.step(np.asarray(want[-1], np.int32))
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("obs_mode", ["pixels", "vector"])
@pytest.mark.parametrize("policy", ["greedy", "egreedy", "noisy"])
def test_served_actions_equal_jax_server(tmp_path_factory, policy, obs_mode):
    variant = "rainbow" if policy == "noisy" else "dqn"
    d = _jax_checkpoint(tmp_path_factory, variant, obs_mode)
    got, want = _served_against_jax(d, policy)
    np.testing.assert_array_equal(got, want)


def test_population_checkpoint_serves_one_replica(tmp_path_factory):
    d = _jax_checkpoint(tmp_path_factory, "dqn", "pixels",
                        mode="population", seeds=2)
    l0 = load_policy(d, replica=0, device="cpu")
    l1 = load_policy(d, replica=1, device="cpu")
    assert l1.spec.mode == "population" and l1.step == 1
    assert all(l0.params[k].shape == l1.params[k].shape for k in l0.params)
    assert any(not torch.equal(l0.params[k], l1.params[k])
               for k in l0.params)
    got, want = _served_against_jax(d, "egreedy", replica=1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="replica"):
        load_policy(d, replica=5, device="cpu")


@pytest.mark.parametrize("obs_mode", ["pixels", "vector"])
def test_clients_see_the_jax_clients_observations(obs_mode):
    jspec, tspec = _specs("dqn", obs_mode)
    jc = JClients(jspec, 6, seed=3)
    tc = SimulatedClients(tspec, 6, seed=3, device="cpu")
    actions = np.arange(6, dtype=np.int32) % 3
    for _ in range(12):
        np.testing.assert_array_equal(tc.observations(), jc.observations())
        np.testing.assert_array_equal(tc.first, jc.first)
        jc.step(actions)
        tc.step(actions)
    assert tc.episodes == jc.episodes and tc.episodes > 0
    assert tc.mean_return() == jc.mean_return()


def test_api_exports_the_reference_surface():
    import repro.api
    import repro_torch.api
    # the reference's Trainer protocol, population fleets and sweeps are
    # not ported (ROADMAP.md queue 1 item 9)
    left = {"Trainer", "build_packed_fleet", "SweepSpec", "SweepRun",
            "Fleet", "MANIFEST_FILENAME", "expand", "pack", "run_sweep",
            "sweep_compat_diff"}
    assert set(repro_torch.api.__all__) == set(repro.api.__all__) - left
    for name in repro_torch.api.__all__:
        assert getattr(repro_torch.api, name) is not None, name


def test_warm_start_noise_key_wraps_minus_one_as_jax():
    # warm_start's noise key folds in -1; jax wraps an int32 -1 to the
    # uint32 word 0xFFFFFFFF (its Python-int form raises OverflowError
    # under jax 0.9), and so does rng.fold_in
    base = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    want = np.asarray(jax.random.fold_in(base, np.int32(-1)))
    np.testing.assert_array_equal(
        want, np.asarray(jax.random.fold_in(base, 0xFFFFFFFF)))
    got = rng.fold_in(rng.fold_in(rng.PRNGKey(0), 7), -1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# the cases of tests/test_serve_policy.py
# ---------------------------------------------------------------------------

def _fresh(spec, serve, seed=0):
    """(components, params, server) over untrained params on the CPU."""
    torch.set_num_threads(1)
    configure("cpu")
    c = _Components(spec)
    params = c.q_init(rng.PRNGKey(seed))
    srv = PolicyServer(params, c.qf, c.obs, c.dcfg.frame_stack,
                       c.env.n_actions, serve)
    return c, params, srv


@pytest.mark.parametrize("variant", ["dqn", "noisy", "rainbow"])
@pytest.mark.parametrize("obs_mode", ["pixels", "vector"])
def test_served_actions_match_evaluate_bitwise(variant, obs_mode):
    _assert_mirror(_spec(variant, obs_mode), policy="egreedy")


def test_served_actions_match_greedy_eval():
    _assert_mirror(_spec("dqn"), policy="greedy")


def _assert_mirror(spec, policy, rounds=5, n=4, seed=0):
    """Replay evaluate's loop against the server: the same initial
    stacks, the same per-round action keys (through flush(keys=...)),
    clients sending the raw frames evaluate renders. Every round's
    served actions equal sync_round's bitwise."""
    c, params, srv = _fresh(
        spec, ServeSpec(policy=policy, eps=0.05, max_batch=8), seed)
    pipe, env, cfg = c.obs, c.env, c.dcfg
    eps = torch.full((), 0.0 if policy == "greedy" else cfg.eval_eps)
    k = rng.split(rng.PRNGKey(seed + 1))
    states = env.reset(rng.split(k[0], n))
    stack = push_frame(init_obs_stack(n, pipe, cfg.frame_stack),
                       obs_batch(pipe, env, states))
    s = SamplerState(states, stack, k[1])
    ids = list(range(n))
    first = np.ones((n,), bool)
    for _ in range(rounds):
        frame = obs_batch(pipe, env, s.env_states).numpy()
        kact = rng.split(s.key, 3)[1]              # sync_round's action key
        srv.submit_many(ids, frame, first)
        acts = srv.flush(keys=stream_keys(kact, n).numpy())
        with torch.no_grad():
            s, tr = sync_round(env, c.qf, params, s, eps, pipe)
        served = np.array([acts[i] for i in ids], np.int32)
        np.testing.assert_array_equal(served, tr["action"].numpy())
        first = tr["done"].numpy()                 # autoreset: zero stack


def _served_rounds(spec, serve, rounds=4, n=5, seed=0):
    """Closed-loop action sequence (rounds, n) under one server config."""
    _, _, srv = _fresh(spec, serve, seed)
    clients = SimulatedClients(spec, n, seed=seed + 1, device="cpu")
    out = []
    for _ in range(rounds):
        srv.submit_many(clients.ids, clients.observations(), clients.first)
        acts = srv.flush()
        actions = np.array([acts[i] for i in clients.ids], np.int32)
        clients.step(actions)
        out.append(actions)
    return np.stack(out)


@pytest.mark.parametrize("policy", ["egreedy", "noisy"])
def test_bucket_padding_and_chunking_invariance(policy):
    spec = _spec("noisy" if policy == "noisy" else "dqn")
    exact = _served_rounds(spec, ServeSpec(policy=policy, buckets=(5,),
                                           max_batch=5))
    padded = _served_rounds(spec, ServeSpec(policy=policy, max_batch=64))
    chunked = _served_rounds(spec, ServeSpec(policy=policy, max_batch=2))
    np.testing.assert_array_equal(exact, padded)
    np.testing.assert_array_equal(exact, chunked)


def test_padding_never_touches_real_stream_state():
    # one request through an 8-wide bucket: the 7 pad rows gather the
    # clamped last slot, a real stream's, and write nothing back
    _, _, srv = _fresh(_spec("dqn"), ServeSpec(max_batch=8, buckets=(8,)))
    obs = np.full((4,) + srv.pipe.shape, 200, np.uint8)
    srv.submit_many([0, 1, 2, 3], obs, np.ones((4,), bool))
    srv.flush()
    before = srv._stacks.clone()
    assert srv._cap == 4 and bool(before[3].any())
    srv.submit(0, obs[0] // 2)
    srv.flush()
    after = srv._stacks
    assert torch.equal(before[1:], after[1:])
    assert not torch.equal(before[0], after[0])


def test_reconnect_replays_identically():
    spec = _spec("dqn")
    a = _served_rounds(spec, ServeSpec(max_batch=8), seed=3)
    b = _served_rounds(spec, ServeSpec(max_batch=8), seed=3)
    np.testing.assert_array_equal(a, b)


def test_serve_spec_validates():
    with pytest.raises(ValueError, match="policy"):
        ServeSpec(policy="boltzmann").validate()
    with pytest.raises(ValueError, match="eps"):
        ServeSpec(eps=1.5).validate()
    with pytest.raises(ValueError, match="max_batch"):
        ServeSpec(max_batch=0).validate()
    with pytest.raises(ValueError, match="replica"):
        ServeSpec(replica=-1).validate()
    assert ServeSpec(max_batch=8).resolved_buckets() == (1, 2, 4, 8)
    assert ServeSpec(max_batch=8, buckets=(3, 16)).resolved_buckets() \
        == (3, 8)
    assert ServeSpec().resolved_buckets() == JServe().resolved_buckets()


def _checkpointed_run(tmp_path, spec, step=1):
    d = tmp_path / "run"
    trainer = build_trainer(spec, device="cpu")
    save_run_spec(str(d), spec)
    save_checkpoint(str(d), step, trainer.init_carry())
    return d


def test_noisy_policy_requires_noisy_checkpoint(tmp_path):
    loaded = load_policy(str(_checkpointed_run(tmp_path, _spec("dqn"))),
                         device="cpu")
    with pytest.raises(ValueError, match="NoisyNet"):
        make_server(loaded, ServeSpec(policy="noisy"))
    with pytest.raises(NotImplementedError, match="item 12"):
        make_server(loaded, ServeSpec(), tracer=object())


@pytest.mark.parametrize("obs_mode", ["pixels", "vector"])
def test_load_policy_serves_checkpoint(tmp_path, obs_mode):
    torch.set_num_threads(1)
    spec = _spec("dqn", obs_mode)
    d = _checkpointed_run(tmp_path, spec)
    loaded = load_policy(str(d), device="cpu")
    assert loaded.step == 1 and loaded.skipped == []
    assert loaded.spec == spec
    srv = make_server(loaded, ServeSpec(max_batch=8))
    assert srv.warm_start(3) == 4 and srv._cap == 4
    clients = SimulatedClients(spec, 3, seed=1, device="cpu")
    stats = drive(srv, clients, 3)
    assert stats["actions"] == 9 and stats["microbatches_per_tick"] == 1.0
    assert stats["p99_ms"] > 0


def test_load_policy_skips_torn_checkpoint(tmp_path):
    d = _checkpointed_run(tmp_path, _spec("dqn"), step=1)
    torn = d / "step_00000002.npz"
    torn.write_bytes((d / "step_00000001.npz").read_bytes()[:100])
    loaded = load_policy(str(d), device="cpu")
    assert loaded.step == 1
    assert len(loaded.skipped) == 1 and "step_00000002" in loaded.skipped[0]


def test_load_policy_without_spec_is_actionable(tmp_path):
    with pytest.raises(ValueError, match="spec"):
        load_policy(str(tmp_path), device="cpu")


def test_serve_policy_cli_smoke(tmp_path, capsys):
    from repro_torch.launch.serve_policy import main
    d = _checkpointed_run(tmp_path, _spec("dqn"))
    rc = main(["--ckpt-dir", str(d), "--clients", "4", "--ticks", "3",
               "--max-batch", "8", "--warm-start", "--smoke",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "SERVE OK" in out and "warm start" in out
    assert main(["--ckpt-dir", str(d), "--trace", "t.jsonl"]) == 2
    assert "item 12" in capsys.readouterr().err
    assert main(["--ckpt-dir", str(tmp_path / "none"), "--device",
                 "cpu"]) == 2
    assert "cannot serve" in capsys.readouterr().out


def test_serving_a_spec_for_another_dir_is_refused(tmp_path):
    # the spec decides the template: a checkpoint of another shape is
    # skipped by name, and then nothing restores
    d = _checkpointed_run(tmp_path, _spec("dqn"))
    other = dataclasses.replace(_spec("dqn"), envs=2)
    with pytest.raises(ValueError, match="no restorable checkpoint"):
        load_policy(str(d), spec=other, device="cpu")
