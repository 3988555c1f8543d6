"""Sweep orchestration — *a sweep is a list of specs*: the port of
``repro.api.sweep``, with the same manifest, run ids, fleets and
on-disk layout.

A :class:`SweepSpec` is a base :class:`ExperimentSpec` plus an **axis
grid** — each axis names a spec field and lists the values to try — and
expands into a deterministic, canonically-ordered list of
fully-resolved specs. A packer then groups the expanded specs that
differ *only in seed* into shared population fleets
(``build_packed_fleet``: the replica axis of ``core.population`` over an
explicit seed list), and the runner runs the fleets one after another in
canonical order, each as one program over its replicas on one device.
The fleet's cycle makes as many launches for P replicas as for one, so
a packed fleet of P runs costs far less than P standalone runs on a
host-bound card.

The whole sweep is resumable from its on-disk state alone::

    <root>/sweep.json                  # the manifest (canonical JSON)
    <root>/fleets/<fleet_id>/          # packed-fleet spec.json + step_*.npz
    <root>/runs/<run_id>/              # per-run spec.json, final carry,
                                       #   metrics.jsonl, trace.jsonl,
                                       #   result.json

``rl_train --sweep manifest.json --resume`` skips runs whose
``result.json`` exists, restores partial fleets from their newest
*restorable* checkpoint (``checkpoint.restore_latest`` walks down past
torn files, naming each skip) and replays the remaining cycles —
bitwise equal to the uninterrupted sweep, because every cycle is a
pure function of the carry. A mutated manifest fails up front with a
field-level diff (:func:`sweep_compat_diff`), the same guard as the
per-run ``check_resume_compat``. A run's final carry is its replica as
a population of one, so ``load_policy(run_dir)`` serves it in either
package, and either package's sweep directory reads in the other.

Axis grammar (manifest ``"axes"`` object; expansion iterates axes in
sorted-name order, values in their listed order, last axis fastest):

=====================  ====================================================
``"env"``              game registry names (``envs/games.py``)
``"env_params"``       ``EnvParams`` override dicts (``{}`` = defaults)
``"variant"``          variant preset names (``configs/dqn_nature.VARIANTS``)
``"obs_mode"``         ``"pixels"`` / ``"vector"`` (use ``net: "auto"``)
``"seed"``             base replica seeds — the packable axis
``"lr"``               alias for ``"algo.learning_rate"``
``"<field>"``          any other top-level ``ExperimentSpec`` field
``"<section>.<field>"``  nested fields, e.g. ``"schedule.cycles"``
=====================  ====================================================

``checkpoint`` and ``metrics`` cannot be axes — the sweep runner owns
every output path.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import os
import re
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.api.spec import (_NESTED, CheckpointSpec, ExperimentSpec,
                                  MetricsSpec, SpecCompatError,
                                  check_resume_compat, load_run_spec,
                                  save_run_spec, spec_compat_diff)
from repro_torch.api.trainers import build_packed_fleet, build_trainer
from repro_torch.checkpoint import (prune_steps, restore_latest,
                                    save_checkpoint, trim_metrics_jsonl)
from repro_torch.core.population import tree_map
from repro_torch.telemetry import JsonlSink, NullTracer, Tracer, device_meta

__all__ = [
    "SweepSpec", "SweepRun", "Fleet", "MANIFEST_FILENAME",
    "expand", "pack", "run_sweep", "sweep_compat_diff",
    "load_manifest", "save_manifest",
]

# File written at the sweep root so --resume can validate that the
# requested manifest still describes the sweep that produced the state.
MANIFEST_FILENAME = "sweep.json"

# Axis shorthand -> the field path it targets.
_AXIS_ALIASES = {"lr": "algo.learning_rate"}

# Sections/fields the runner owns (it assigns every output path), so a
# manifest may not sweep over them.
_FORBIDDEN_AXES = {"checkpoint", "metrics"}


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A sweep manifest: base spec × axis grid (+ the root directory all
    sweep state lives under). Canonical-JSON round-trip like
    ``ExperimentSpec`` — sorted keys, 2-space indent, trailing newline —
    so a committed manifest is diffable and byte-stable."""

    dir: str = ""                 # sweep root ("" = require --ckpt-dir)
    base: ExperimentSpec = dataclasses.field(default_factory=ExperimentSpec)
    axes: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)

    # -- validation --------------------------------------------------------

    def validate(self) -> None:
        """Axis-grammar checks (names resolve, no duplicate targets,
        values are non-empty lists). Per-run validity — every expanded
        spec passing ``ExperimentSpec.validate()`` — is checked by
        :func:`expand`, which is where the specs exist."""
        if not isinstance(self.axes, dict):
            raise ValueError(
                f"axes must be an object of name -> value list, got "
                f"{type(self.axes).__name__}")
        targets: Dict[str, str] = {}
        for name, values in self.axes.items():
            target = _resolve_axis(name)
            if target in targets:
                raise ValueError(
                    f"axes {targets[target]!r} and {name!r} both target "
                    f"spec field {target} — merge them into one axis")
            targets[target] = name
            if not isinstance(values, (list, tuple)) or not values:
                raise ValueError(
                    f"axis {name!r} must list at least one value, got "
                    f"{values!r}")

    # -- JSON round-trip ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"dir": self.dir, "base": self.base.to_dict(),
                "axes": {k: list(v) for k, v in self.axes.items()}}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SweepSpec":
        if not isinstance(data, dict):
            raise ValueError(
                f"sweep manifest must be an object, got "
                f"{type(data).__name__}")
        unknown = sorted(set(data) - {"dir", "base", "axes"})
        if unknown:
            raise ValueError(
                f"unknown sweep manifest field(s) {', '.join(unknown)}; "
                "known: ['axes', 'base', 'dir']")
        base = ExperimentSpec.from_dict(data.get("base", {}))
        axes = data.get("axes", {})
        if not isinstance(axes, dict):
            raise ValueError("sweep manifest 'axes' must be an object")
        return cls(dir=data.get("dir", ""), base=base,
                   axes={k: list(v) for k, v in axes.items()})

    @classmethod
    def from_json(cls, text: str) -> "SweepSpec":
        return cls.from_dict(json.loads(text))


@dataclasses.dataclass(frozen=True)
class SweepRun:
    """One expanded grid point: a stable id, the axis values that
    produced it, and the fully-resolved spec (checkpoint/metrics paths
    cleared — the runner owns them)."""

    index: int
    id: str
    axis_values: Dict[str, Any]
    spec: ExperimentSpec


@dataclasses.dataclass(frozen=True)
class Fleet:
    """A schedulable unit: either one packed population fleet (members
    differ only in seed; ``packed=True``) or a singleton run."""

    id: str
    spec: ExperimentSpec          # the fleet-level spec (seeds = len(members))
    seeds: Tuple[int, ...]        # explicit replica seeds, member order
    members: Tuple[SweepRun, ...]
    packed: bool


# ---------------------------------------------------------------------------
# Axis resolution and application
# ---------------------------------------------------------------------------

def _resolve_axis(name: str) -> str:
    """Validate an axis name and return the canonical field path it
    targets. Raises with the known grammar on anything unresolvable."""
    path = _AXIS_ALIASES.get(name, name)
    top_fields = {f.name: f for f in dataclasses.fields(ExperimentSpec)}
    if "." in path:
        section, field = path.split(".", 1)
        if section in _FORBIDDEN_AXES:
            raise ValueError(
                f"axis {name!r}: the sweep runner owns every "
                f"{section} path; remove it from the grid")
        sub = _NESTED.get(section)
        if sub is None or section == "variant":
            raise ValueError(
                f"axis {name!r}: unknown spec section {section!r}; "
                f"sections: {sorted(set(_NESTED) - _FORBIDDEN_AXES)}")
        sub_fields = {f.name for f in dataclasses.fields(sub)}
        if field not in sub_fields:
            raise ValueError(
                f"axis {name!r}: {sub.__name__} has no field {field!r}; "
                f"known: {sorted(sub_fields)}")
        return path
    if path in _FORBIDDEN_AXES:
        raise ValueError(
            f"axis {name!r}: the sweep runner owns every {path} path; "
            "remove it from the grid")
    if path not in top_fields:
        raise ValueError(
            f"axis {name!r}: ExperimentSpec has no field {path!r}; "
            f"top-level fields: "
            f"{sorted(set(top_fields) - _FORBIDDEN_AXES)}, nested as "
            "'<section>.<field>' (alias 'lr' = 'algo.learning_rate')")
    return path


def _coerce(dc_type, field: str, value):
    """Int-given-for-float coercion, mirroring the spec JSON loader, so
    an expanded spec equals its canonical-JSON round-trip exactly."""
    default = {f.name: f.default for f in dataclasses.fields(dc_type)}[field]
    if isinstance(default, float) and isinstance(value, int) \
            and not isinstance(value, bool):
        return float(value)
    return value


def _apply_axis(spec: ExperimentSpec, name: str, value) -> ExperimentSpec:
    path = _resolve_axis(name)
    if path == "variant":
        from repro_torch.configs.dqn_nature import get_variant
        if not isinstance(value, str):
            raise ValueError(
                f"axis {name!r}: values must be variant preset names, "
                f"got {value!r}")
        return dataclasses.replace(spec, variant=get_variant(value))
    if "." in path:
        section, field = path.split(".", 1)
        sub = getattr(spec, section)
        value = _coerce(type(sub), field, value)
        return dataclasses.replace(
            spec, **{section: dataclasses.replace(sub, **{field: value})})
    return dataclasses.replace(
        spec, **{path: _coerce(ExperimentSpec, path, value)})


def _slug(value) -> str:
    if isinstance(value, dict):
        s = ",".join(f"{k}={value[k]}" for k in sorted(value)) or "default"
    else:
        s = str(value)
    return re.sub(r"[^A-Za-z0-9_.,=+-]+", "-", s)[:40]


# ---------------------------------------------------------------------------
# Expansion: base × grid -> deterministic spec list
# ---------------------------------------------------------------------------

def expand(sweep: SweepSpec) -> List[SweepRun]:
    """The canonically-ordered run list: the cartesian product over axes
    in **sorted axis-name order** (so the ordering survives the
    sorted-keys JSON round-trip), each axis's values in their **listed
    order**, last axis varying fastest. len == product of axis lengths;
    no axes = the base spec as a single run. Every expanded spec is
    validated and duplicates (e.g. a repeated seed value) are
    rejected — a sweep must not silently compute one run twice."""
    sweep.validate()
    names = sorted(sweep.axes)
    runs: List[SweepRun] = []
    seen: Dict[str, str] = {}
    for index, combo in enumerate(
            itertools.product(*(sweep.axes[n] for n in names)) if names
            else [()]):
        spec = sweep.base
        for name, value in zip(names, combo):
            spec = _apply_axis(spec, name, value)
        # the runner owns output paths; keep only the checkpoint cadence
        spec = dataclasses.replace(
            spec, checkpoint=CheckpointSpec(
                dir=None, every=sweep.base.checkpoint.every),
            metrics=MetricsSpec(jsonl=None))
        spec.validate()
        run_id = f"run{index:03d}" + "".join(
            f"-{n}={_slug(v)}" for n, v in zip(names, combo))
        key = spec.to_json()
        if key in seen:
            raise ValueError(
                f"duplicate grid point: {run_id} resolves to the same "
                f"spec as {seen[key]} (repeated axis value?)")
        seen[key] = run_id
        runs.append(SweepRun(index=index, id=run_id,
                             axis_values=dict(zip(names, combo)), spec=spec))
    return runs


# ---------------------------------------------------------------------------
# Packing: same-except-seed runs -> one population fleet
# ---------------------------------------------------------------------------

def _pack_key(spec: ExperimentSpec) -> str:
    """Canonical identity of everything except the seed. Two runs pack
    iff their keys match — which is exactly 'seed-aligned
    ``spec_compat_diff`` is empty', since the expanded specs already
    carry cleared checkpoint/metrics sections."""
    return dataclasses.replace(spec, seed=0).to_json()


def pack(runs: List[SweepRun]) -> List[Fleet]:
    """Group packable runs (population mode, ``seeds == 1``, identical
    but for ``seed``) into shared fleets on the replica axis; everything
    else becomes a singleton fleet. Fleet order is deterministic: by
    first-member expansion index. Packing never merges specs whose
    seed-aligned ``spec_compat_diff`` is non-empty (the key IS that
    predicate), so a fleet's replicas are guaranteed to share one
    program."""
    groups: Dict[str, List[SweepRun]] = {}
    order: List[str] = []
    for run in runs:
        packable = run.spec.mode == "population" and run.spec.seeds == 1
        key = _pack_key(run.spec) if packable else f"solo:{run.id}"
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(run)

    fleets: List[Fleet] = []
    for j, key in enumerate(order):
        members = tuple(groups[key])
        packed = len(members) > 1
        seeds = tuple(m.spec.seed for m in members)
        spec = (dataclasses.replace(members[0].spec, seeds=len(members))
                if packed else members[0].spec)
        fleets.append(Fleet(id=f"fleet{j:03d}-p{len(members)}", spec=spec,
                            seeds=seeds, members=members, packed=packed))
    return fleets


# ---------------------------------------------------------------------------
# Manifest persistence + mutation guard
# ---------------------------------------------------------------------------

def sweep_compat_diff(stored: SweepSpec, requested: SweepSpec) -> List[str]:
    """Field-level differences that make ``requested`` a *different
    sweep* than the one ``stored`` describes. ``dir`` is exempt (an
    output path, like the per-run checkpoint/metrics sections); the base
    spec diffs through ``spec_compat_diff`` so run extensions (more
    cycles, re-timed evals) stay compatible."""
    diffs = [f"base.{d}" for d in spec_compat_diff(stored.base,
                                                   requested.base)]
    for name in sorted(set(stored.axes) | set(requested.axes)):
        a, b = stored.axes.get(name), requested.axes.get(name)
        if a != b:
            diffs.append(f"axes.{name}: manifest={a!r}, requested={b!r}")
    return diffs


def save_manifest(root: str, sweep: SweepSpec) -> str:
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, MANIFEST_FILENAME)
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(sweep.to_json())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_manifest(root: str) -> Optional[SweepSpec]:
    path = os.path.join(root, MANIFEST_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    try:
        return SweepSpec.from_json(text)
    except ValueError as e:
        raise SpecCompatError(
            f"stored sweep manifest {path} is unreadable ({e}); delete "
            "it (and the fleets/ + runs/ state, if the sweep is dead) "
            "or restore it from the original manifest file") from None


# ---------------------------------------------------------------------------
# The runner: schedule fleets, checkpoint, resume, finalize per-run state
# ---------------------------------------------------------------------------

def _run_dir(root: str, run_id: str) -> str:
    return os.path.join(root, "runs", run_id)


def _write_json_atomic(path: str, obj) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load_result(root: str, run: SweepRun) -> Optional[Dict[str, Any]]:
    """The run's completion record, or None while it is pending. A
    completed run's stored spec must still match the manifest's
    expansion — a mutated per-run spec.json fails with the field-level
    diff rather than silently serving another run's carry."""
    path = os.path.join(_run_dir(root, run.id), "result.json")
    if not os.path.exists(path):
        return None
    stored = load_run_spec(_run_dir(root, run.id))
    if stored is not None:
        check_resume_compat(stored, run.spec)
    with open(path) as f:
        return json.load(f)


def run_sweep(sweep: SweepSpec, resume: bool = False,
              root: Optional[str] = None,
              on_cycle: Optional[Callable[[str, int], None]] = None,
              trace: bool = False,
              device: str = "cuda") -> List[Dict[str, Any]]:
    """Execute (or resume) a sweep on ``device``; returns one result row
    per expanded run: ``{"run", "fleet", "seed", "cycles", "step",
    "eval", "skipped"}`` in canonical run order.

    Scheduling: fleets run one after another in canonical order, each
    one program over its replicas (``core.population``'s replica axis);
    a fleet's trainer and carry are dropped before the next is built.
    ``on_cycle(fleet_id, cycle)`` fires after each cycle's state hits
    disk (progress hook; raising from it is a clean interrupt — the
    sweep resumes from exactly that point).

    ``trace=True`` records a phase trace per run under
    ``runs/<id>/trace.jsonl`` (``rl_train --sweep ... --trace 1``): the
    members of a packed fleet share one program, so each member's trace
    carries the *fleet's* cycle spans with the member's identity in the
    header — what that shared wall clock cost each run. Traces are
    diagnostics, not state: a resumed sweep records a fresh trace for
    the cycles it replays."""
    root = root or sweep.dir
    if not root:
        raise ValueError(
            "sweep has no root directory: set \"dir\" in the manifest "
            "or pass --ckpt-dir")
    runs = expand(sweep)
    fleets = pack(runs)

    stored = load_manifest(root)
    if stored is not None:
        diffs = sweep_compat_diff(stored, sweep)
        if diffs:
            raise SpecCompatError(
                f"manifest does not match the sweep stored in {root} "
                f"({len(diffs)} field(s) differ):\n  " + "\n  ".join(diffs)
                + "\n(fix the manifest, or point at a fresh directory)")
        if not resume:
            raise SpecCompatError(
                f"{root} already holds state for this sweep; pass "
                "--resume to continue it (completed runs are skipped, "
                "partial fleets restore bitwise) or point at a fresh "
                "directory")
    else:
        save_manifest(root, sweep)

    results: List[Dict[str, Any]] = []
    for fleet in fleets:
        done = {m.id: _load_result(root, m) for m in fleet.members}
        if all(r is not None for r in done.values()):
            print(f"[sweep] {fleet.id}: all {len(fleet.members)} run(s) "
                  "complete, skipping", flush=True)
            for m in fleet.members:
                results.append({**done[m.id], "skipped": True})
            continue
        results.extend(_run_fleet(root, fleet, resume=resume,
                                  on_cycle=on_cycle, trace=trace,
                                  device=device))
        # the fleet's trainer and carry went with _run_fleet's frame;
        # collect their reference cycles too, so the card's memory is
        # free before the next fleet allocates its own (a pong fleet
        # holds ~1 GB of replay per replica)
        gc.collect()
    return results


def _fleet_tracer(root: str, fleet: Fleet, trace: bool, device: str):
    """One tracer whose span stream lands in every member run's
    ``trace.jsonl`` (a packed fleet IS one program; the per-sink extra
    meta records which member each file belongs to)."""
    if not trace:
        return NullTracer()
    sinks = [JsonlSink(os.path.join(_run_dir(root, m.id), "trace.jsonl"),
                       extra_meta={"run": m.id, "seed": m.spec.seed})
             for m in fleet.members]
    return Tracer(sinks, meta={
        "kind": "sweep_fleet", "fleet": fleet.id, "packed": fleet.packed,
        "members": len(fleet.members), "env": fleet.spec.env,
        "variant": fleet.spec.variant.name,
        "cycles": fleet.spec.schedule.cycles,
        "cycle_steps": fleet.spec.schedule.cycle_steps,
        **device_meta(device)})


def _to_host(*cols: torch.Tensor) -> List[List[float]]:
    """(P,) tensors -> lists of Python floats in ONE device-to-host copy
    (float32 and int32 values are exact in float64)."""
    return torch.stack([c.to(torch.float64) for c in cols]).cpu().tolist()


def _run_fleet(root: str, fleet: Fleet, resume: bool,
               on_cycle: Optional[Callable[[str, int], None]],
               trace: bool = False,
               device: str = "cuda") -> List[Dict[str, Any]]:
    fdir = os.path.join(root, "fleets", fleet.id)
    tracer = _fleet_tracer(root, fleet, trace, device)
    with tracer.span("init", phase="build_trainer"):
        trainer = (build_packed_fleet(fleet.spec, list(fleet.seeds),
                                      device=device)
                   if fleet.packed else build_trainer(fleet.spec,
                                                      device=device))
    sched = fleet.spec.schedule

    start_cycle = 0
    carry = None
    if resume:
        fstored = load_run_spec(fdir)
        if fstored is not None:
            check_resume_compat(fstored, fleet.spec)
    save_run_spec(fdir, fleet.spec)
    if resume:
        with tracer.span("init", phase="restore"):
            step, carry, skipped = restore_latest(
                fdir, trainer.init_template(), device=trainer.device)
        for s in skipped:
            print(f"[sweep] WARNING: skipped unrestorable checkpoint {s}",
                  flush=True)
        if carry is not None:
            start_cycle = min(step, sched.cycles)
            print(f"[sweep] {fleet.id}: resumed at cycle {start_cycle}",
                  flush=True)
    if carry is None:
        with tracer.span("init", phase="init_carry"):
            carry = trainer.init_carry()
            if tracer.enabled:
                tracer.fence(carry)

    member_ids = [m.id for m in fleet.members]
    print(f"[sweep] {fleet.id}: cycles {start_cycle}->{sched.cycles} "
          f"({'packed, ' if fleet.packed else ''}runs "
          f"{member_ids[0]}..{member_ids[-1]})" if len(member_ids) > 1 else
          f"[sweep] {fleet.id}: cycles {start_cycle}->{sched.cycles} "
          f"(run {member_ids[0]})", flush=True)

    metrics_files = []
    for m in fleet.members:
        rdir = _run_dir(root, m.id)
        os.makedirs(rdir, exist_ok=True)
        mpath = os.path.join(rdir, "metrics.jsonl")
        if os.path.exists(mpath):
            trim_metrics_jsonl(mpath, start_cycle)
        metrics_files.append(open(mpath, "a", buffering=1))

    try:
        evals = None
        with tracer.span("train", start_cycle=start_cycle,
                         cycles=sched.cycles):
            for i in range(start_cycle, sched.cycles):
                with tracer.span("cycle", index=i + 1):
                    carry, m = trainer.cycle(carry)
                    if tracer.enabled:
                        tracer.fence(m)
                tracer.count("cycles", 1)
                tracer.count("env_steps",
                             trainer.replicas * sched.cycle_steps)
                evals = None
                if (i + 1) % sched.eval_every == 0 or i == sched.cycles - 1:
                    with tracer.span("eval", index=i + 1):
                        evals = trainer.eval(carry, trainer.eval_key(i))
                        if tracer.enabled:
                            tracer.fence(evals)
                with tracer.span("metrics", index=i + 1):
                    cols = [m["loss"], m["reward"], m["episodes"],
                            trainer.steps(carry)]
                    host = _to_host(*cols, *([] if evals is None
                                             else [evals]))
                    for r, (member, mf) in enumerate(zip(fleet.members,
                                                         metrics_files)):
                        row = {"cycle": i + 1, "run": member.id,
                               "env": member.spec.env,
                               "variant": member.spec.variant.name,
                               "seed": member.spec.seed,
                               "step": int(host[3][r]),
                               "loss": host[0][r],
                               "reward": host[1][r],
                               "episodes": host[2][r]}
                        if evals is not None:
                            row["eval"] = host[4][r]
                        mf.write(json.dumps(row) + "\n")
                if (i + 1) % fleet.spec.checkpoint.every == 0 \
                        or i == sched.cycles - 1:
                    with tracer.span("checkpoint", index=i + 1):
                        save_checkpoint(fdir, i + 1, carry)
                if on_cycle is not None:
                    on_cycle(fleet.id, i + 1)
    finally:
        tracer.close()
        for mf in metrics_files:
            mf.close()

    if evals is None:
        # resumed past the last training cycle (interrupted during
        # finalize): recompute the final evaluation with the same key
        # the uninterrupted run used, so result.json stays bitwise-equal
        evals = trainer.eval(carry, trainer.eval_key(sched.cycles - 1))
    steps, evh = _to_host(trainer.steps(carry), evals)

    rows: List[Dict[str, Any]] = []
    for r, member in enumerate(fleet.members):
        rdir = _run_dir(root, member.id)
        save_run_spec(rdir, member.spec)
        final = (tree_map(lambda x: x[r:r + 1], carry) if fleet.packed
                 else carry)
        save_checkpoint(rdir, sched.cycles, final)
        result = {"run": member.id, "fleet": fleet.id,
                  "seed": member.spec.seed, "cycles": sched.cycles,
                  "step": int(steps[r]), "eval": evh[r]}
        # written LAST and atomically: its existence is the completion
        # marker the resume path trusts
        _write_json_atomic(os.path.join(rdir, "result.json"), result)
        rows.append({**result, "skipped": False})
        print(f"[sweep] {member.id}: eval {result['eval']:+.2f} "
              f"at step {result['step']}", flush=True)
    # the per-run final carries are now the durable artifacts; keep only
    # the newest fleet checkpoint so a large grid stays disk-bounded
    prune_steps(fdir, keep_last=1)
    return rows
