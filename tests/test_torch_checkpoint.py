"""The port's checkpoints against the JAX package's.

Catch at frame_size 10 with the ``tiny`` net and in vector mode with
``mlp_tiny``; W=4, C=32, a 256-slot replay, minibatch 8, prepopulate 64,
on the CPU:

* layout parity: each package writes its own ``init_carry()`` (the
  concurrent trainer with rainbow, the baseline trainer with double, in
  both obs modes, with RMSProp and with AdamW); the two .npz files hold
  the same paths, shapes and dtypes (keys uint32 in both), integers and
  keys equal, floats within 1e-6;
* ``init_template()`` (meta tensors, no prepopulate) has the real
  carry's paths, shapes and dtypes;
* resume across packages, both ways: a JAX checkpoint restored by the
  port runs the next cycle as JAX does, and a port checkpoint restored
  by ``repro.checkpoint`` runs the next JAX cycle as the port does
  (integers exact, floats to 1e-4); the launchers of both packages
  resume each other's checkpoint directory;
* resume in the port is bitwise: two cycles straight equal one cycle, a
  save, a restore and one cycle;
* the cases of ``tests/test_checkpoint.py`` on the port's module, and
  the stored ``spec.json`` byte for byte as the reference writes it.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
from repro.api import build_trainer as jbuild
from repro.api import save_run_spec as jsave_run_spec
from repro.api import spec_compat_diff as jspec_compat_diff
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.configs.dqn_nature import get_variant as jvariant
from repro_torch.api.spec import (AlgoSpec, ExperimentSpec, ScheduleSpec,
                                  SpecCompatError, check_resume_compat,
                                  load_run_spec, save_run_spec,
                                  spec_compat_diff)
from repro_torch.api.trainers import build_trainer
from repro_torch.checkpoint import (latest_step, list_steps, prune_steps,
                                    restore_checkpoint, restore_latest,
                                    save_checkpoint, trim_metrics_jsonl)
from repro_torch.configs.dqn_nature import get_variant
from repro_torch.convert import baseline_carry_from_jax, carry_from_jax
from repro_torch.core.concurrent import TrainerCarry
from repro_torch.core.synchronized import SamplerState

ROOT = Path(__file__).resolve().parents[1]
FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
SCHED = dict(cycles=2, cycle_steps=32, prepopulate=64, eval_every=1,
             eval_episodes=4)
OBS = {"pixels": dict(obs_mode="pixels", frame_size=10, net="tiny"),
       "vector": dict(obs_mode="vector", net="mlp_tiny")}
VARIANT = {"concurrent": "rainbow", "baseline": "double"}
LAYOUTS = [(m, o, opt) for m in VARIANT for o in OBS
           for opt in ("rmsprop", "adamw")]
LAYOUT_IDS = ["-".join(c) for c in LAYOUTS]


def _specs(mode, obs, opt="adamw"):
    algo = dict(minibatch_size=8, replay_capacity=256, train_period=4,
                optimizer=opt)
    top = dict(env="catch", mode=mode, envs=4, **OBS[obs])
    variant = VARIANT[mode]
    return (JSpec(variant=jvariant(variant), schedule=JSched(**SCHED),
                  algo=JAlgo(**algo), **top),
            ExperimentSpec(variant=get_variant(variant),
                           schedule=ScheduleSpec(**SCHED),
                           algo=AlgoSpec(**algo), **top))


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _paths(tree):
    from repro_torch.checkpoint.ckpt import _flatten
    return dict(_flatten(tree))


def _assert_close(got, want, tol=FLOAT_TOL):
    """Two flat {path: array-like} dicts: same paths and shapes, integers
    (keys included) equal, floats to ``tol``."""
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].numpy() if isinstance(got[path], torch.Tensor) \
            else np.asarray(got[path])
        assert g.shape == w.shape, path
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=path, **tol)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)


# ---------------------------------------------------------------------------
# layout parity and the restore template
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", LAYOUTS, ids=LAYOUT_IDS)
def test_layout_matches_reference(tmp_path, case):
    torch.set_num_threads(1)
    jspec, tspec = _specs(*case)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 0,
                          jbuild(jspec).init_carry())
    save_checkpoint(str(tmp_path / "torch"), 0,
                    build_trainer(tspec, device="cpu").init_carry())
    want = _npz(tmp_path / "jax" / "step_00000000.npz")
    got = _npz(tmp_path / "torch" / "step_00000000.npz")
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)
    keys = [p for p, a in want.items() if a.dtype == np.uint32]
    assert keys and all(p.endswith("__2") for p in keys), keys


@pytest.mark.parametrize("case", LAYOUTS, ids=LAYOUT_IDS)
def test_init_template_matches_carry(case):
    torch.set_num_threads(1)
    tt = build_trainer(_specs(*case)[1], device="cpu")
    template = _paths(tt.init_template())
    carry = _paths(tt.init_carry())
    assert sorted(template) == sorted(carry)
    for path, t in template.items():
        assert t.device.type == "meta", path
        assert (t.dtype, t.shape) == (carry[path].dtype,
                                      carry[path].shape), path
    assert type(tt.init_template()) is type(tt.init_carry())


# ---------------------------------------------------------------------------
# resume across the two packages, and bitwise in the port
# ---------------------------------------------------------------------------

_CYCLES = {}


def _jax_cycles(mode):
    """The JAX trainer's carries after init, 1 and 2 cycles (pixels,
    AdamW), and the port's trainer for the same spec."""
    if mode not in _CYCLES:
        torch.set_num_threads(1)
        jspec, tspec = _specs(mode, "pixels")
        jt = jbuild(jspec)
        c0 = jt.init_carry()
        c1, _ = jt.cycle(c0)
        c2, _ = jt.cycle(c1)
        _CYCLES[mode] = (jt, c1, jax.device_get(c2),
                         build_trainer(tspec, device="cpu"))
    return _CYCLES[mode]


@pytest.mark.parametrize("mode", list(VARIANT))
def test_port_resumes_a_jax_checkpoint(tmp_path, mode):
    jt, j1, j2, tt = _jax_cycles(mode)
    d = str(tmp_path / "ck")
    jckpt.save_checkpoint(d, 1, j1)
    step, carry, skipped = restore_latest(d, tt.init_template())
    assert (step, skipped) == (1, [])
    assert carry.sampler.key.dtype == torch.int64
    carry, _ = tt.cycle(carry)
    _assert_close(_paths(carry), dict(jckpt.ckpt._flatten(j2)))


@pytest.mark.parametrize("mode", list(VARIANT))
def test_jax_resumes_a_port_checkpoint(tmp_path, mode):
    jt, j1, _, tt = _jax_cycles(mode)
    convert = carry_from_jax if mode == "concurrent" \
        else baseline_carry_from_jax
    t1 = convert(jax.device_get(j1))
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, t1)
    restored = jckpt.restore_checkpoint(d, 1, jt.init_template())
    jnext, _ = jt.cycle(jax.tree.map(jnp.asarray, restored))
    tnext, _ = tt.cycle(t1)
    _assert_close(_paths(tnext), dict(jckpt.ckpt._flatten(
        jax.device_get(jnext))))


@pytest.mark.parametrize("mode", list(VARIANT))
def test_resume_in_the_port_is_bitwise(tmp_path, mode):
    torch.set_num_threads(1)
    tt = build_trainer(_specs(mode, "vector")[1], device="cpu")
    c1, _ = tt.cycle(tt.init_carry())
    straight, _ = tt.cycle(c1)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, c1)
    resumed, _ = tt.cycle(restore_checkpoint(d, 1, tt.init_template()))
    want = _paths(straight)
    for path, t in _paths(resumed).items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path


def _write_spec(tmp_path, name="spec.json", **over):
    _, tspec = _specs("baseline", "pixels")
    tspec = dataclasses.replace(tspec, algo=dataclasses.replace(
        tspec.algo, eps_anneal_steps=256), **over)
    path = tmp_path / name
    path.write_text(tspec.to_json())
    return str(path)


def test_launchers_resume_each_others_checkpoints(tmp_path, capsys):
    """repro.launch.rl_train writes cycle 1; the port's launcher resumes
    it and writes cycle 2; the reference's launcher resumes that."""
    from repro.launch import rl_train as jlaunch
    from repro_torch.launch import rl_train as tlaunch
    torch.set_num_threads(1)
    spec = _write_spec(tmp_path)
    d = str(tmp_path / "run")
    common = ["--spec", spec, "--ckpt-dir", d, "--ckpt-every", "1",
              "--metrics-jsonl", os.path.join(d, "m.jsonl")]
    assert jlaunch.main(common + ["--cycles", "1"]) == 0
    assert tlaunch.main(common + ["--cycles", "2", "--resume",
                                  "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"resumed {d} at cycle 1" in out, out
    assert jlaunch.main(common + ["--cycles", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed {d} at cycle 2" in out, out
    assert list_steps(d) == [1, 2, 3]
    with open(os.path.join(d, "m.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["cycle"] for r in rows] == [1, 2, 3]
    assert [r["step"] for r in rows] == [32, 64, 96]
    for r in rows:
        assert set(r) == {"cycle", "env", "mode", "variant", "seed", "step",
                          "loss", "reward", "episodes", "eval"}, r


# ---------------------------------------------------------------------------
# the cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def _tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "stats": (torch.ones((2,)),
                                 torch.zeros((), dtype=torch.int32))},
            "step": torch.full((), 7, dtype=torch.int32)}


def _carry():
    sampler = SamplerState(
        env_states={"ball": torch.arange(4, dtype=torch.int32)},
        stack=torch.ones((4, 10, 10, 2), dtype=torch.uint8),
        key=torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64))
    return TrainerCarry(
        params={"w": torch.arange(6.0).reshape(2, 3)},
        opt_state={"m": torch.zeros((2, 3)),
                   "step": torch.full((), 5, dtype=torch.int32)},
        replay={"obs": torch.zeros((8, 10, 10, 2), dtype=torch.uint8),
                "done": torch.zeros((8,), dtype=torch.bool),
                "cursor": torch.full((), 3, dtype=torch.int32)},
        sampler=sampler, step=torch.full((), 64, dtype=torch.int32),
        seed=torch.full((), 2, dtype=torch.int32))


@pytest.mark.parametrize("make", [_tree, _carry], ids=["dict", "namedtuple"])
def test_roundtrip(tmp_path, make):
    tree = make()
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, tree)
    save_checkpoint(d, 12, tree)
    assert latest_step(d) == 12
    got = restore_checkpoint(d, 7, tree)
    assert type(got) is type(tree)
    if isinstance(tree, TrainerCarry):
        assert isinstance(got.sampler, SamplerState)
    want = _paths(tree)
    for path, t in _paths(got).items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path


def test_key_words_are_written_as_uint32_and_read_back(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _carry())
    data = _npz(os.path.join(d, "step_00000001.npz"))
    assert data["__3/__2"].dtype == np.uint32
    np.testing.assert_array_equal(data["__3/__2"], [0, 0xFFFFFFFF])
    template = _carry()
    template = template._replace(sampler=template.sampler._replace(
        key=torch.empty((2,), dtype=torch.int64, device="meta")))
    got = restore_checkpoint(d, 1, template)
    assert got.sampler.key.tolist() == [0, 0xFFFFFFFF]
    with pytest.raises(ValueError, match="outside uint32"):
        save_checkpoint(d, 2, {"k": torch.tensor([-1], dtype=torch.int64)})
    assert list_steps(d) == [1]


def test_restore_template_mismatch_names_paths(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"params": {"w": torch.ones((2,))}})
    template = {"params": {"w": torch.ones((2,)),
                           "w_sigma": torch.ones((2,))}}  # e.g. noisy head
    with pytest.raises(ValueError) as ei:
        restore_checkpoint(d, 1, template)
    assert "params/w_sigma" in str(ei.value)
    assert "different spec" in str(ei.value)
    with pytest.raises(ValueError, match="params/w: float32\\[2\\]"):
        restore_checkpoint(d, 1, {"params": {"w": torch.ones((3,))}})


def test_resume_spec_compat_guard(tmp_path):
    d = str(tmp_path / "run")
    spec = ExperimentSpec(variant=get_variant("rainbow"), seeds=2,
                          algo=AlgoSpec(eps_anneal_steps=7680))
    save_run_spec(d, spec)
    stored = load_run_spec(d)
    assert stored == spec

    # run extensions and moved output paths are not incompatibilities
    extended = dataclasses.replace(
        spec,
        schedule=dataclasses.replace(spec.schedule, cycles=999,
                                     eval_every=5),
        checkpoint=dataclasses.replace(spec.checkpoint, dir="elsewhere"))
    assert spec_compat_diff(stored, extended) == []
    check_resume_compat(stored, extended)

    # a derived anneal horizon changes with cycles: flagged
    derived = dataclasses.replace(spec, algo=AlgoSpec())
    derived_ext = dataclasses.replace(
        derived, schedule=dataclasses.replace(derived.schedule, cycles=999))
    diff = spec_compat_diff(derived, derived_ext)
    assert len(diff) == 1 and diff[0].startswith("algo.eps_anneal_steps")

    changed = dataclasses.replace(
        spec, frame_size=84,
        variant=dataclasses.replace(spec.variant, num_atoms=21))
    with pytest.raises(SpecCompatError) as ei:
        check_resume_compat(stored, changed)
    msg = str(ei.value)
    assert "frame_size: checkpoint=10, requested=84" in msg
    assert "variant.num_atoms: checkpoint=51, requested=21" in msg

    save_run_spec(d, extended)             # compatible: file untouched
    assert load_run_spec(d) == spec
    save_run_spec(d, changed)              # no checkpoints yet: replaced
    save_run_spec(d, spec)
    save_checkpoint(d, 20, {"w": torch.ones((2,))})
    with pytest.raises(SpecCompatError, match="fresh directory"):
        save_run_spec(d, changed)
    assert load_run_spec(d) == spec

    with open(os.path.join(d, "spec.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(SpecCompatError, match="unreadable"):
        load_run_spec(d)


def test_restore_latest_walks_past_torn_checkpoint(tmp_path):
    tree = {"w": torch.arange(4.0)}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, tree)
    save_checkpoint(d, 2, tree)
    p2 = os.path.join(d, "step_00000002.npz")
    with open(p2, "rb") as f:
        head = f.read(57)
    with open(p2, "wb") as f:
        f.write(head)                              # torn: crash mid-write
    assert latest_step(d) == 2 and list_steps(d) == [1, 2]
    step, got, skipped = restore_latest(d, tree)
    assert step == 1
    assert torch.equal(got["w"], torch.arange(4.0))
    assert len(skipped) == 1 and "step_00000002.npz" in skipped[0]


def test_restore_latest_nothing_restorable(tmp_path):
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    for name in ("step_00000001.npz", "step_00000002.npz"):
        with open(os.path.join(d, name), "wb") as f:
            f.write(b"PK\x03\x04 not actually a zip")
    step, got, skipped = restore_latest(d, {"w": torch.ones((2,))})
    assert step is None and got is None
    assert len(skipped) == 2
    assert restore_latest(str(tmp_path / "nope"), {}) == (None, None, [])


def test_save_failure_leaves_no_debris(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"w": torch.ones((2,))})

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(d, 2, {"w": torch.ones((2,))})
    assert sorted(os.listdir(d)) == ["step_00000001.npz"]
    assert list_steps(d) == [1]


def test_metrics_trim_is_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "metrics.jsonl")
    rows = [json.dumps({"cycle": c, "loss": 0.1 * c}) + "\n"
            for c in range(1, 6)]
    with open(path, "w") as f:
        f.writelines(rows)
        f.write('{"cycle": 6, "loss"')              # torn trailing line
    trim_metrics_jsonl(path, 3)
    with open(path) as f:
        kept = [json.loads(ln) for ln in f]
    assert [r["cycle"] for r in kept] == [1, 2, 3]

    original = open(path).read()

    def boom(*a, **kw):
        raise OSError("crash mid-trim")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="crash mid-trim"):
        trim_metrics_jsonl(path, 1)
    assert open(path).read() == original
    assert os.listdir(tmp_path) == ["metrics.jsonl"]


def test_prune_steps_keeps_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 5, 9):
        save_checkpoint(d, step, {"w": torch.full((2,), float(step))})
    removed = prune_steps(d, keep_last=2)
    assert [os.path.basename(p) for p in removed] == [
        "step_00000001.npz", "step_00000002.npz"]
    assert list_steps(d) == [5, 9]
    got = restore_checkpoint(d, 9, {"w": torch.zeros((2,))})
    assert torch.equal(got["w"], torch.full((2,), 9.0))
    assert prune_steps(d, keep_last=2) == []
    assert prune_steps(str(tmp_path / "missing")) == []
    with pytest.raises(ValueError, match="keep_last"):
        prune_steps(d, keep_last=0)


# ---------------------------------------------------------------------------
# spec.json byte for byte, and the reference's diff
# ---------------------------------------------------------------------------

SPEC_FILES = sorted(f.stem for f in (ROOT / "examples" / "specs").glob(
    "*.json") if "base" not in json.loads(f.read_text()))


def test_four_committed_experiment_specs():
    assert len(SPEC_FILES) == 4, SPEC_FILES


@pytest.mark.parametrize("name", SPEC_FILES)
def test_run_spec_file_is_the_reference_bytes(tmp_path, name):
    text = (ROOT / "examples" / "specs" / f"{name}.json").read_text()
    jsave_run_spec(str(tmp_path / "jax"), JSpec.from_json(text))
    save_run_spec(str(tmp_path / "torch"), ExperimentSpec.from_json(text))
    want = (tmp_path / "jax" / "spec.json").read_bytes()
    assert (tmp_path / "torch" / "spec.json").read_bytes() == want
    assert load_run_spec(str(tmp_path / "jax")) == \
        ExperimentSpec.from_json(text)


def test_spec_compat_diff_is_the_reference_diff():
    text = (ROOT / "examples" / "specs" / "rainbow_fleet.json").read_text()
    jstored, tstored = JSpec.from_json(text), ExperimentSpec.from_json(text)
    over = dict(envs=4, frame_size=84, seed=3)
    jreq = dataclasses.replace(
        jstored, **over, variant=jvariant("c51"),
        schedule=dataclasses.replace(jstored.schedule, cycles=9))
    treq = dataclasses.replace(
        tstored, **over, variant=get_variant("c51"),
        schedule=dataclasses.replace(tstored.schedule, cycles=9))
    want = jspec_compat_diff(jstored, jreq)
    assert len(want) > 5
    assert spec_compat_diff(tstored, treq) == want
