"""The port's sweeps (``repro_torch.api.sweep``) against the JAX package's.

* ``expand``, ``pack``, ``SweepSpec.to_json`` and ``sweep_compat_diff``
  are pure Python: on the committed ``catch_lr_seeds_sweep.json`` and on
  hypothesis grids they give the reference's run ids, fleet ids, seeds
  and spec bytes exactly, and the axis grammar refuses what the
  reference refuses, with its message;
* ``run_sweep`` on the reference's tiny base (catch 10x10, the ``tiny``
  net, W=4, C=16, a 128-slot replay; seeds [3, 7] packed in one fleet)
  writes the reference's tree: the same manifest bytes, run and fleet
  ids, files in each directory and ``result.json`` steps, and final
  carries within atol = rtol = 1e-4 of the JAX package's (the presets'
  tolerance: batched products sum in another order);
* replica r of a packed fleet follows the port's standalone run with
  seed ``seeds[r]``: integers exactly, floats within 1e-4 of each leaf's
  largest magnitude (the standard of tests/test_torch_population.py);
* a sweep of 2 fleets (lr x seeds) interrupted mid-fleet, its newest
  checkpoint torn, then resumed is bitwise equal to the sweep run
  straight through, and a second resume trains nothing; a changed
  manifest is refused naming its field;
* the launcher's ``--sweep`` (on the committed manifest with only its
  schedule cut and its ``dir`` moved), ``--resume``, ``--trace 1`` and
  its refusals.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api.sweep as jsweep
from repro_torch.api import sweep as tsweep
from repro_torch.api.spec import ExperimentSpec, SpecCompatError
from repro_torch.api.trainers import (Trainer, build_packed_fleet,
                                      build_trainer)
from repro_torch.checkpoint import restore_checkpoint

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = ROOT / "examples" / "specs" / "catch_lr_seeds_sweep.json"
TOL = dict(atol=1e-4, rtol=1e-4)
# the reference's TINY_BASE (tests/test_sweep.py), as JSON both packages
# parse
TINY = {"mode": "population", "env": "catch", "envs": 4, "frame_size": 10,
        "net": "auto", "seeds": 1,
        "schedule": {"cycles": 2, "cycle_steps": 16, "prepopulate": 32,
                     "eval_every": 1, "eval_episodes": 4},
        "algo": {"minibatch_size": 8, "replay_capacity": 128,
                 "train_period": 4, "eps_anneal_steps": 1000},
        "checkpoint": {"every": 1}}


def _sweeps(axes, base=None, dir=""):
    """The same manifest in both packages: (JAX SweepSpec, port's)."""
    data = {"dir": dir, "base": base or TINY, "axes": axes}
    text = json.dumps(data)
    return (jsweep.SweepSpec.from_json(text),
            tsweep.SweepSpec.from_json(text))


def _runs(runs):
    return [(r.index, r.id, r.axis_values, r.spec.to_json()) for r in runs]


def _fleets(fleets):
    return [(f.id, f.seeds, f.packed, f.spec.to_json(),
             [m.id for m in f.members]) for f in fleets]


def _outcome(fn, *args):
    """fn(*args)'s value, or the name and message of what it raised."""
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, tuple):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def _assert_close_to_scale(a, b, label):
    """Integers and bools exactly; floats within 1e-4 of each leaf's
    largest magnitude (tests/test_torch_population.py's standard)."""
    got, want = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, f"{label}{path}"
        if w.dtype.is_floating_point:
            scale = float(w.abs().max()) if w.numel() else 0.0
            err = float((g - w).abs().max()) if w.numel() else 0.0
            assert err <= 1e-4 * scale, f"{label}{path}: {err} of {scale}"
        else:
            assert torch.equal(g, w), f"{label}{path}"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# expansion and packing: pure Python, equal to the reference's
# ---------------------------------------------------------------------------

def test_committed_manifest_expands_and_packs_as_reference(tmp_path):
    text = MANIFEST.read_text()
    jsw, tsw = jsweep.SweepSpec.from_json(text), tsweep.SweepSpec.from_json(
        text)
    assert tsw.to_json() == jsw.to_json() == text
    truns, jruns = tsweep.expand(tsw), jsweep.expand(jsw)
    assert _runs(truns) == _runs(jruns)
    assert [r.id for r in truns][:2] == ["run000-lr=0.001-seed=0",
                                         "run001-lr=0.001-seed=1"]
    fleets = tsweep.pack(truns)
    assert _fleets(fleets) == _fleets(jsweep.pack(jruns))
    assert [(f.id, f.seeds) for f in fleets] == [("fleet000-p3", (0, 1, 2)),
                                                ("fleet001-p3", (0, 1, 2))]
    # save_manifest writes the reference's bytes
    tsweep.save_manifest(str(tmp_path / "t"), tsw)
    jsweep.save_manifest(str(tmp_path / "j"), jsw)
    assert ((tmp_path / "t" / "sweep.json").read_bytes()
            == (tmp_path / "j" / "sweep.json").read_bytes())
    assert tsweep.load_manifest(str(tmp_path / "j")) == tsw


# one axis per grammar family; ints where the field is a float (the
# coercion keeps round trips exact), floats whose slugs must match
AXES = {
    "seed": [[0, 7, 13], [3]],
    "lr": [[1e-3, 1], [0.0005, 2.5e-4]],
    "algo.discount": [[0.9, 1]],
    "schedule.cycles": [[2, 4]],
    "variant": [["dqn", "double"], ["rainbow"]],
    "env": [["catch", "pong"]],
    "obs_mode": [["pixels", "vector"]],
    "env_params": [[{}, {"size": 10}]],
    "mode": [["population", "concurrent"]],
    "seeds": [[1, 2]],
}


@settings(max_examples=30, deadline=None)
@given(names=st.lists(st.sampled_from(sorted(AXES)), min_size=0,
                      max_size=3, unique=True),
       pick=st.integers(0, 1), seed_lo=st.integers(0, 50))
def test_expand_pack_compat_equal_reference(names, pick, seed_lo):
    axes = {n: AXES[n][pick % len(AXES[n])] for n in names}
    axes.setdefault("seed", [seed_lo, seed_lo + 1])
    jsw, tsw = _sweeps(axes)
    assert tsw.to_json() == jsw.to_json()
    tout, jout = _outcome(tsweep.expand, tsw), _outcome(jsweep.expand, jsw)
    if jout[0] != "ok":                          # refused by both alike
        assert tout == jout
        return
    truns, jruns = tout[1], jout[1]
    assert _runs(truns) == _runs(jruns)
    for r in truns:
        assert ExperimentSpec.from_json(r.spec.to_json()) == r.spec
    assert _fleets(tsweep.pack(truns)) == _fleets(jsweep.pack(jruns))
    # the manifest guard names the same fields
    moved = {**axes, "seed": [seed_lo + 2]}
    jmoved, tmoved = _sweeps(moved, dir="elsewhere")
    assert (tsweep.sweep_compat_diff(tsw, tmoved)
            == jsweep.sweep_compat_diff(jsw, jmoved))
    base = {**TINY, "frame_size": 84}
    jb, tb = _sweeps(axes, base=base)
    assert (tsweep.sweep_compat_diff(tsw, tb)
            == jsweep.sweep_compat_diff(jsw, jb))


@pytest.mark.parametrize("axes", [
    {"learning_rate": [1e-3]}, {"checkpoint.every": [1, 2]},
    {"metrics": [None]}, {"lr": [1e-3], "algo.learning_rate": [5e-4]},
    {"seed": []}, {"seed": [0, 0]}, {"variant": [7]},
    {"schedule.cyclez": [2]}, {"variant.double": [True]},
    {"nosection.x": [1]}],
    ids=["no-field", "ckpt", "metrics", "both-target", "empty", "dupe",
         "preset-names", "nested-field", "variant-section", "section"])
def test_axis_grammar_rejections_match_reference(axes):
    jsw, tsw = _sweeps(axes)
    want = _outcome(jsweep.expand, jsw)
    assert want[0] == "ValueError"
    assert _outcome(tsweep.expand, tsw) == want


def test_manifest_parse_errors_and_io(tmp_path):
    for bad in ('[]', '{"base": {}, "axes": [1]}', '{"bogus": 1}'):
        want = _outcome(jsweep.SweepSpec.from_json, bad)
        assert want[0] == "ValueError"
        assert _outcome(tsweep.SweepSpec.from_json, bad) == want
    _, sw = _sweeps({"seed": [0, 1]}, dir="runs/sw")
    assert tsweep.sweep_compat_diff(
        sw, dataclasses.replace(sw, dir="elsewhere")) == []
    root = str(tmp_path / "sw")
    assert tsweep.load_manifest(root) is None
    tsweep.save_manifest(root, sw)
    assert tsweep.load_manifest(root) == sw
    (tmp_path / "sw" / "sweep.json").write_text("{not json")
    with pytest.raises(SpecCompatError, match="unreadable"):
        tsweep.load_manifest(root)
    with pytest.raises(ValueError, match="root directory"):
        tsweep.run_sweep(_sweeps({"seed": [0]})[1], device="cpu")


def test_build_packed_fleet_checks_as_reference():
    spec = ExperimentSpec.from_dict({**TINY, "seeds": 2})
    fleet = build_packed_fleet(spec, [7, 3], device="cpu")
    assert fleet.seeds.tolist() == [7, 3] and fleet.replicas == 2
    single = build_trainer(dataclasses.replace(spec, mode="concurrent",
                                               seeds=1), device="cpu")
    assert isinstance(fleet, Trainer) and isinstance(single, Trainer)
    with pytest.raises(ValueError, match="population mode"):
        build_packed_fleet(dataclasses.replace(spec, mode="concurrent",
                                               seeds=1), [0], device="cpu")
    with pytest.raises(ValueError, match="packed replica count"):
        build_packed_fleet(spec, [3, 7, 9], device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        build_packed_fleet(spec, [3, 3], device="cpu")


# ---------------------------------------------------------------------------
# run_sweep against the reference's, and resume
# ---------------------------------------------------------------------------

AXES_RUN = {"seed": [3, 7], "lr": [1e-3, 5e-4]}
BASE_RUN = {**TINY, "net": "tiny",
            "schedule": {**TINY["schedule"], "cycles": 3}}


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The port's sweep run straight through, and its results."""
    root = str(tmp_path_factory.mktemp("straight"))
    _, tsw = _sweeps(AXES_RUN, base=BASE_RUN)
    torch.set_num_threads(1)
    return root, tsweep.run_sweep(tsw, root=root, device="cpu")


def test_run_sweep_writes_the_reference_tree(tmp_path):
    """One packed fleet of the non-contiguous seeds [3, 7], 2 cycles,
    through both packages' run_sweep."""
    jsw, tsw = _sweeps({"seed": [3, 7]}, base={**TINY, "net": "tiny"})
    root, jroot = str(tmp_path / "torch"), str(tmp_path / "jax")
    results = tsweep.run_sweep(tsw, root=root, device="cpu")
    jresults = jsweep.run_sweep(jsw, root=jroot)
    assert _tree(root) == _tree(jroot)
    assert "fleets/fleet000-p2/step_00000002.npz" in _tree(root)
    assert (Path(root, "sweep.json").read_bytes()
            == Path(jroot, "sweep.json").read_bytes())
    assert ([(r["run"], r["fleet"], r["seed"], r["cycles"], r["step"],
              r["skipped"]) for r in results]
            == [(r["run"], r["fleet"], r["seed"], r["cycles"], r["step"],
                 r["skipped"]) for r in jresults])
    for run in tsweep.expand(tsw):
        rdir, jdir = Path(root, "runs", run.id), Path(jroot, "runs", run.id)
        got = json.loads((rdir / "result.json").read_text())
        want = json.loads((jdir / "result.json").read_text())
        assert {k: got[k] for k in got if k != "eval"} == \
            {k: want[k] for k in want if k != "eval"}
        assert (rdir / "spec.json").read_bytes() == \
            (jdir / "spec.json").read_bytes()
        rows = [json.loads(x) for x in (rdir / "metrics.jsonl").open()]
        jrows = [json.loads(x) for x in (jdir / "metrics.jsonl").open()]
        assert [sorted(x) for x in rows] == [sorted(x) for x in jrows]
        assert ([(x["cycle"], x["run"], x["seed"], x["step"]) for x in rows]
                == [(x["cycle"], x["run"], x["seed"], x["step"])
                    for x in jrows])
        fn = "step_00000002.npz"
        a, b = _npz(rdir / fn), _npz(jdir / fn)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if np.issubdtype(b[k].dtype, np.floating):
                np.testing.assert_allclose(a[k], b[k], err_msg=k, **TOL)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_packed_replicas_follow_standalone_runs(straight):
    """Each run's final carry (its replica as a population of one)
    against the port's standalone run with its seed."""
    root, _ = straight
    _, tsw = _sweeps(AXES_RUN, base=BASE_RUN)
    for run in tsweep.expand(tsw)[:2]:
        trainer = build_trainer(run.spec, device="cpu")
        carry = trainer.init_carry()
        for _ in range(run.spec.schedule.cycles):
            carry, _ = trainer.cycle(carry)
        got = restore_checkpoint(str(Path(root, "runs", run.id)), 3,
                                 trainer.init_template())
        _assert_close_to_scale(got, carry, f"{run.id} ")


def test_interrupt_torn_checkpoint_resume_bitwise(straight, tmp_path):
    a_root, res_a = straight
    _, sw = _sweeps(AXES_RUN, base=BASE_RUN)
    runs = tsweep.expand(sw)
    b_root = str(tmp_path / "resumed")

    class Stop(Exception):
        pass

    def bomb(fleet_id, cycle):
        if fleet_id.startswith("fleet001") and cycle == 2:
            raise Stop()

    with pytest.raises(Stop):
        tsweep.run_sweep(sw, root=b_root, on_cycle=bomb, device="cpu")
    fdir = Path(b_root, "fleets", "fleet001-p2")
    steps = sorted(p.name for p in fdir.glob("step_*.npz"))
    assert steps == ["step_00000001.npz", "step_00000002.npz"]
    with open(fdir / steps[-1], "r+b") as f:
        f.truncate(57)                           # torn: a crash mid-write
    with pytest.raises(SpecCompatError, match="--resume"):
        tsweep.run_sweep(sw, root=b_root, device="cpu")

    res_b = tsweep.run_sweep(sw, root=b_root, resume=True, device="cpu")
    assert [r["skipped"] for r in res_b] == [True, True, False, False]
    assert [{k: v for k, v in r.items() if k != "skipped"} for r in res_b] \
        == [{k: v for k, v in r.items() if k != "skipped"} for r in res_a]
    assert _tree(a_root) == _tree(b_root)
    for run in runs:
        a, b = Path(a_root, "runs", run.id), Path(b_root, "runs", run.id)
        for name in ("result.json", "metrics.jsonl", "spec.json"):
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
        xa, xb = _npz(a / "step_00000003.npz"), _npz(b / "step_00000003.npz")
        assert sorted(xa) == sorted(xb)
        for k in xa:
            np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)
    # a second resume trains nothing
    assert all(r["skipped"] for r in tsweep.run_sweep(
        sw, root=b_root, resume=True, device="cpu"))
    # a changed manifest is refused with its field named
    _, mutated = _sweeps({"seed": [3, 7], "lr": [1e-3, 1e-4]},
                         base=BASE_RUN)
    with pytest.raises(SpecCompatError, match="axes.lr"):
        tsweep.run_sweep(mutated, root=b_root, resume=True, device="cpu")
    _, mutated = _sweeps(AXES_RUN, base={**BASE_RUN, "frame_size": 84})
    with pytest.raises(SpecCompatError, match="base.frame_size"):
        tsweep.run_sweep(mutated, root=b_root, resume=True, device="cpu")


def test_load_policy_serves_a_run(straight):
    """A run directory serves through load_policy: its replica, which
    is the slice of the fleet's final carry."""
    from repro_torch.api.serve import load_policy
    root, _ = straight
    run = tsweep.expand(_sweeps(AXES_RUN, base=BASE_RUN)[1])[3]
    loaded = load_policy(str(Path(root, "runs", run.id)), device="cpu")
    assert loaded.step == 3 and loaded.spec == run.spec
    fleet = Path(root, "fleets", "fleet001-p2")
    fspec = ExperimentSpec.from_json((fleet / "spec.json").read_text())
    tmpl = build_packed_fleet(fspec, [3, 7], device="cpu").init_template()
    carry = restore_checkpoint(str(fleet), 3, tmpl)
    for k, v in loaded.params.items():
        assert torch.equal(v, carry.params[k][1]), k


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_sweep_resume_trace_and_refusals(tmp_path, capsys):
    """The committed manifest with only its schedule cut and its dir
    moved: 2 fleets of 3, the reference's run ids, per-run traces;
    --resume skips all 6; refusals exit 2."""
    from repro_torch.launch import rl_train
    from repro_torch.telemetry import report
    data = json.loads(MANIFEST.read_text())
    data["base"]["schedule"].update(cycles=1, cycle_steps=16,
                                    prepopulate=32, eval_episodes=2)
    data["dir"] = str(tmp_path / "out")
    manifest = tmp_path / "sweep.json"
    manifest.write_text(json.dumps(data))
    argv = ["--sweep", str(manifest), "--device", "cpu"]
    assert rl_train.main([*argv, "--trace", "1"]) == 0
    assert "SWEEP OK runs=6 trained=6 skipped=0" in capsys.readouterr().out
    want = [r.id for r in jsweep.expand(jsweep.SweepSpec.from_json(
        manifest.read_text()))]
    assert sorted(os.listdir(tmp_path / "out" / "runs")) == sorted(want)
    assert sorted(os.listdir(tmp_path / "out" / "fleets")) == \
        ["fleet000-p3", "fleet001-p3"]
    for run_id in want:
        trace = report.load_trace(str(tmp_path / "out" / "runs" / run_id
                                      / "trace.jsonl"))
        names = {s["name"] for s in trace["spans"]}
        assert {"init", "train", "cycle", "eval", "metrics",
                "checkpoint"} <= names
        attrs = trace["meta"]["attrs"]
        assert attrs["run"] == run_id and attrs["kind"] == "sweep_fleet"
        assert attrs["device"] == "cpu" and attrs["torch"]
        assert trace["counters"] == {"cycles": 1.0, "env_steps": 3 * 16.0}
    assert rl_train.main([*argv, "--resume"]) == 0
    assert "trained=0 skipped=6" in capsys.readouterr().out
    # without --resume an existing sweep is refused, and so is --spec
    assert rl_train.main(argv) == 2
    assert "--resume" in capsys.readouterr().err
    assert rl_train.main([*argv, "--spec", str(manifest)]) == 2
    assert "mutually exclusive" in capsys.readouterr().err
    data["axes"]["lr"] = [0.001, 0.0001]
    manifest.write_text(json.dumps(data))
    assert rl_train.main([*argv, "--resume"]) == 2
    assert "axes.lr" in capsys.readouterr().err
    # --ckpt-dir overrides the manifest's root
    data["axes"] = {"seed": [5]}
    manifest.write_text(json.dumps(data))
    assert rl_train.main([*argv, "--ckpt-dir", str(tmp_path / "o2")]) == 0
    assert (tmp_path / "o2" / "runs" / "run000-seed=5" /
            "result.json").exists()
    assert (tmp_path / "o2" / "fleets" / "fleet000-p1" /
            "step_00000001.npz").exists()
    assert "trained=1 skipped=0" in capsys.readouterr().out
