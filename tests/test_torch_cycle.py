"""The whole slice: the port's concurrent trainer against the JAX one.

Rainbow (double, dueling, PER, 3-step, C51, NoisyNet) on pong at
frame_size 10 with the ``tiny`` net, W=4, C=32, a 256-slot replay,
minibatch 8, prepopulate 64, on the CPU:

* the port's own ``init_carry`` gives the reference's replay and sampler
  state exactly (rng, env, preprocess, replay and n-step at once);
* two cycles from a carry carried over from JAX match the JAX carry:
  uint8, int and bool fields exactly, floats to 1e-4 (conv, matmul and
  RMSProp sum in another order);
* two port runs from one carry are bitwise equal;
* a ``dqn`` cycle (uniform ``replay_sample``) matches too.

Also: no module of the port, nor ``chip_smoke.py``, imports jax or
repro; and the launcher runs on the CPU only when asked.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_trainer
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.configs.dqn_nature import get_variant as jax_variant
from repro.core.synchronized import evaluate as jax_evaluate
from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
from repro_torch.api.trainers import ConcurrentTrainer
from repro_torch.configs.dqn_nature import get_variant
from repro_torch.convert import carry_from_jax, tensor_from_jax
from repro_torch.core.synchronized import evaluate

ROOT = Path(__file__).resolve().parents[1]
FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
SCHED = dict(cycles=2, cycle_steps=32, prepopulate=64, eval_every=1,
             eval_episodes=4)
ALGO = dict(minibatch_size=8, replay_capacity=256, optimizer="rmsprop")
TOP = dict(env="pong", mode="concurrent", envs=4, frame_size=10, net="tiny")


def _specs(variant):
    return (JSpec(variant=jax_variant(variant), schedule=JSched(**SCHED),
                  algo=JAlgo(**ALGO), **TOP),
            ExperimentSpec(variant=get_variant(variant),
                           schedule=ScheduleSpec(**SCHED),
                           algo=AlgoSpec(**ALGO), **TOP))


class _Run:
    """A JAX trainer's init carry and the carries after 1 and 2 cycles
    (on the host), with the port's trainer for the same spec."""

    def __init__(self, variant):
        jspec, tspec = _specs(variant)
        self.jt = build_trainer(jspec)
        c0 = self.jt.init_carry()
        c1, m1 = self.jt.cycle(c0)
        c2, m2 = self.jt.cycle(c1)
        self.jcarries = jax.device_get([c0, c1, c2])
        self.jmetrics = jax.device_get([m1, m2])
        self.tt = ConcurrentTrainer(tspec, device="cpu")


@pytest.fixture(scope="module")
def rainbow():
    torch.set_num_threads(1)
    return _Run("rainbow")


@pytest.fixture(scope="module")
def dqn():
    torch.set_num_threads(1)
    return _Run("dqn")


def _leaves(carry, prefix=""):
    """(path, array) over a carry, reference or port."""
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


def test_init_carry_exact(rainbow):
    """The port's init (params aside: its own normal draws agree to ulps)
    is the reference's, bit for bit."""
    tc = rainbow.tt.init_carry()
    got = dict(_leaves(tc))
    for path, w in _leaves(rainbow.jcarries[0]):
        g, w = got[path].numpy(), np.asarray(w)
        if path.startswith((".params", ".opt_state")):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)
    assert int(tc.replay["size"]) == 64


@pytest.mark.parametrize("n_cycles", [1, 2])
def test_rainbow_cycles_match_reference(rainbow, n_cycles):
    carry = carry_from_jax(rainbow.jcarries[0])
    for i in range(n_cycles):
        carry, m = rainbow.tt.cycle(carry)
        np.testing.assert_allclose(float(m["loss"][0]),
                                   float(rainbow.jmetrics[i]["loss"][0]),
                                   **FLOAT_TOL)
        for k in ("reward", "episodes"):
            assert float(m[k][0]) == float(rainbow.jmetrics[i][k][0]), k
    _assert_carry_matches(carry, rainbow.jcarries[n_cycles])


def test_two_runs_from_one_carry_are_bitwise_equal(rainbow):
    """The snapshot-𝒟 guarantee: the cycle is a pure function of its
    carry."""
    runs = []
    for _ in range(2):
        carry = carry_from_jax(rainbow.jcarries[1])
        carry, m = rainbow.tt.cycle(carry)
        runs.append((dict(_leaves(carry)), m))
    (a, ma), (b, mb) = runs
    for path in a:
        assert torch.equal(a[path], b[path]), path
    assert torch.equal(ma["loss"], mb["loss"])


def test_dqn_cycle_uniform_replay_matches_reference(dqn):
    carry = carry_from_jax(dqn.jcarries[0])
    carry, m = dqn.tt.cycle(carry)
    np.testing.assert_allclose(float(m["loss"][0]),
                               float(dqn.jmetrics[0]["loss"][0]), **FLOAT_TOL)
    np.testing.assert_allclose(float(m["eps"][0]),
                               float(dqn.jmetrics[0]["eps"][0]), **FLOAT_TOL)
    _assert_carry_matches(carry, dqn.jcarries[1])


def test_evaluate_matches_reference(rainbow):
    """ε=0.05 evaluation of the μ-only network, over a short horizon."""
    jc = rainbow.jcarries[2]
    key = rainbow.jt.eval_key(3)
    c = rainbow.jt._c
    want = jax_evaluate(c.env, c.qf, jc.params, key, c.dcfg, n_episodes=8,
                        obs=c.obs, max_steps=40)
    tc = rainbow.tt._c
    got = evaluate(tc.env, tc.qf, carry_from_jax(jc).params,
                   tensor_from_jax(key), tc.dcfg, n_episodes=8, obs=tc.obs,
                   max_steps=40)
    np.testing.assert_allclose(float(got), float(want), **FLOAT_TOL)
    np.testing.assert_array_equal(
        rainbow.tt.eval_key(3).numpy(), np.asarray(key).astype(np.int64))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, name)


def _launch(tmp_path, *extra):
    spec = ExperimentSpec(
        variant=get_variant("rainbow"), env_params={"max_steps": 20},
        schedule=ScheduleSpec(cycles=1, cycle_steps=64, prepopulate=128,
                              eval_every=1, eval_episodes=4),
        algo=AlgoSpec(**ALGO), **TOP)
    path = tmp_path / "spec.json"
    path.write_text(spec.to_json())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.rl_train", "--spec",
         str(path), "--cycle-steps", "32", "--prepopulate", "64", *extra],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def test_launcher_runs_on_cpu_only_when_asked(tmp_path):
    ok = _launch(tmp_path, "--device", "cpu")
    assert ok.returncode == 0, ok.stderr
    line = [ln for ln in ok.stdout.splitlines() if "cycle    1" in ln]
    assert line and "steps      32" in line[0], ok.stdout
    no_card = _launch(tmp_path)
    assert no_card.returncode != 0
    assert "torch.cuda.is_available() is False" in no_card.stderr


@pytest.mark.parametrize("extra,replicas", [
    (("--mode", "population", "--seeds", "2"), 2), (("--seeds", "2"), 1)])
def test_launcher_runs_population_and_seeds(tmp_path, capsys, extra,
                                            replicas):
    """``population`` runs ``--seeds`` replicas; a single-carry mode
    runs one whatever ``--seeds`` says, as the reference's launcher."""
    from repro_torch.launch import rl_train
    path = tmp_path / "spec.json"
    path.write_text(_specs("dqn")[1].to_json())
    assert rl_train.main(["--spec", str(path), "--device", "cpu",
                          "--cycles", "1", "--cycle-steps", "16",
                          "--prepopulate", "32", *extra]) == 0
    out = capsys.readouterr().out
    assert f"steps      16 x{replicas} " in out, out


@pytest.mark.parametrize("extra,item", [
    (("--sweep", "x.json"), "item 9"), (("--trace", "t.jsonl"), "item 12"),
    (("--compute-dtype", "bfloat16"), "item 7")])
def test_launcher_refuses_unported_modes(tmp_path, capsys, extra, item):
    from repro_torch.launch import rl_train
    path = tmp_path / "spec.json"
    path.write_text(_specs("dqn")[1].to_json())
    assert rl_train.main(["--spec", str(path), "--device", "cpu",
                          *extra]) == 2
    assert item in capsys.readouterr().err


def test_launcher_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    """--ckpt-dir checkpoints every cycle beside the stored spec;
    --resume continues from the newest checkpoint with one metrics row
    per cycle, and a changed spec is refused with the field diff."""
    from repro_torch.checkpoint import list_steps
    from repro_torch.launch import rl_train
    torch.set_num_threads(1)
    tspec = _specs("dqn")[1]
    # a pinned ε horizon: a derived one would change with --cycles
    tspec = ExperimentSpec.from_dict({**tspec.to_dict(), "algo": {
        **tspec.to_dict()["algo"], "eps_anneal_steps": 64}})
    path = tmp_path / "spec.json"
    path.write_text(tspec.to_json())
    d = str(tmp_path / "run")
    args = ["--spec", str(path), "--device", "cpu", "--ckpt-dir", d,
            "--ckpt-every", "1", "--metrics-jsonl", f"{d}/m.jsonl",
            "--cycle-steps", "32", "--prepopulate", "64", "--env-param",
            "max_steps=20"]
    assert rl_train.main(args + ["--cycles", "1"]) == 0
    assert list_steps(d) == [1]
    stored = (tmp_path / "run" / "spec.json").read_text()
    assert ExperimentSpec.from_json(stored).to_json() == stored
    assert json.loads(stored)["checkpoint"] == {"dir": d, "every": 1}
    capsys.readouterr()
    assert rl_train.main(args + ["--cycles", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed {d} at cycle 1" in out, out
    assert "init_carry" not in out and "[throughput] cycle    2" in out
    assert list_steps(d) == [1, 2]
    rows = [json.loads(ln) for ln in open(f"{d}/m.jsonl")]
    assert [(r["cycle"], r["step"]) for r in rows] == [(1, 32), (2, 64)]
    assert rl_train.main(args + ["--cycles", "3", "--resume", "--envs",
                                 "2"]) == 2
    err = capsys.readouterr().err
    assert f"cannot resume {d}" in err and "envs: checkpoint=4, " \
        "requested=2" in err, err
    assert list_steps(d) == [1, 2]
    # a torn newest checkpoint is skipped by name; the run resumes below it
    torn = tmp_path / "run" / "step_00000002.npz"
    torn.write_bytes(torn.read_bytes()[:100])
    assert rl_train.main(args + ["--cycles", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "WARNING: skipped unrestorable checkpoint" in out, out
    assert "step_00000002.npz" in out and f"resumed {d} at cycle 1" in out
    rows = [json.loads(ln) for ln in open(f"{d}/m.jsonl")]
    assert [(r["cycle"], r["step"]) for r in rows] == [(1, 32), (2, 64)]


def test_launcher_prints_the_canonical_spec(tmp_path, capsys):
    from repro_torch.launch import rl_train
    spec = ROOT / "examples" / "specs" / "rainbow_fleet.json"
    assert rl_train.main(["--spec", str(spec), "--print-spec"]) == 0
    out = capsys.readouterr().out
    assert out == spec.read_text()
    assert rl_train.main(["--spec", str(spec), "--print-spec", "--cycles",
                          "3", "--ckpt-dir", "runs/x"]) == 0
    printed = ExperimentSpec.from_json(capsys.readouterr().out)
    assert printed.schedule.cycles == 3 and printed.checkpoint.dir == "runs/x"


@pytest.mark.parametrize("name,mode,variant", [
    ("baseline_catch", "baseline", "double"),
    ("synchronized_catch", "synchronized", "dueling")])
def test_launcher_runs_sequential_modes_on_cpu(capsys, name, mode, variant):
    """The committed sequential specs through the launcher on the CPU
    (one cycle cut to 64 steps), and the same mode named by --mode."""
    from repro_torch.launch import rl_train
    torch.set_num_threads(1)
    spec = ROOT / "examples" / "specs" / f"{name}.json"
    for extra in ((), ("--mode", mode, "--obs-mode", "vector")):
        assert rl_train.main(["--spec", str(spec), "--device", "cpu",
                              "--cycles", "1", "--cycle-steps", "64",
                              "--prepopulate", "64", *extra]) == 0
        out = capsys.readouterr().out
        obs = "vector" if extra else "pixels"
        assert f"[{mode}/{variant}] catch ({obs}) init_carry" in out, out
        assert f"[{mode}/{variant}] cycle    1 steps      64" in out, out


def test_committed_specs_parse(tmp_path):
    """Every committed spec file parses; the slice's round-trips."""
    for f in sorted((ROOT / "examples" / "specs").glob("*.json")):
        data = json.loads(f.read_text())
        if "base" in data:                          # a sweep manifest
            continue
        spec = ExperimentSpec.from_json(f.read_text())
        assert ExperimentSpec.from_json(spec.to_json()) == spec
    spec = ExperimentSpec.from_json(
        (ROOT / "examples" / "specs" / "dqn_nature84.json").read_text())
    assert spec.frame_size == 84 and spec.algo.replay_capacity == 16384
    spec.validate()


def test_sampler_rounds_at_84x84_match_reference():
    """The Nature geometry's frames (8x upscale, 2-pixel border) through
    sampler_init and a few uniform-random rounds, exactly."""
    from repro.config import DQNConfig as JDQN
    from repro.core.synchronized import sampler_init as jinit
    from repro.core.synchronized import sync_round as jround
    from repro.envs import make_env as jmake_env
    from repro_torch import rng
    from repro_torch.config import DQNConfig
    from repro_torch.core.synchronized import sampler_init, sync_round
    from repro_torch.envs.games import make_env
    jenv, tenv = jmake_env("pong"), make_env("pong")
    jcfg, tcfg = JDQN(n_envs=4), DQNConfig(n_envs=4)
    js = jinit(jenv, jcfg, jax.random.PRNGKey(4), 84)
    ts = sampler_init(tenv, tcfg, rng.PRNGKey(4), 84)
    jq = lambda p, o: jnp.zeros((o.shape[0], 3))  # noqa: E731
    tq = lambda p, o: torch.zeros((o.shape[0], 3))  # noqa: E731
    for _ in range(3):
        js, jtr = jround(jenv, jq, None, js, jnp.float32(1.0), 84)
        ts, ttr = sync_round(tenv, tq, None, ts, torch.ones(()), 84)
        for k in jtr:
            np.testing.assert_array_equal(ttr[k].numpy(), np.asarray(jtr[k]),
                                          err_msg=k)
    assert ts.stack.shape == (4, 84, 84, 4) and ts.stack.dtype == torch.uint8
    np.testing.assert_array_equal(ts.stack.numpy(), np.asarray(js.stack))
