"""The paper's experiment on PyTorch: a trainer built from an
``ExperimentSpec`` (``build_trainer``), on the card unless asked for the
CPU.

  PYTHONPATH=src python -m repro_torch.launch.rl_train \\
      --spec examples/specs/baseline_catch.json
  # a population: 4 replicas of rainbow on catch, one program on the card
  PYTHONPATH=src python -m repro_torch.launch.rl_train \\
      --spec examples/specs/rainbow_fleet.json [--seeds 16] \\
      [--obs-mode vector] [--device cpu]

  # checkpoints with resume, and per-cycle metrics as JSON lines
  PYTHONPATH=src python -m repro_torch.launch.rl_train \\
      --spec examples/specs/baseline_catch.json --ckpt-dir runs/catch \\
      --metrics-jsonl runs/catch/metrics.jsonl [--resume] \\
      [--trace runs/catch/trace.jsonl]

  # a whole sweep (base spec x axis grid) from one manifest, its
  # same-except-seed runs packed into population fleets; --resume skips
  # completed runs and restores partial fleets bitwise
  PYTHONPATH=src python -m repro_torch.launch.rl_train \\
      --sweep examples/specs/catch_lr_seeds_sweep.json [--resume] \\
      [--ckpt-dir ROOT] [--trace 1]

Flags override the spec's fields (no ``--spec``: the ExperimentSpec
defaults); ``--print-spec`` prints the resolved spec as canonical JSON
and exits. Every mode runs: ``population`` (the default) trains
``--seeds`` replicas seeded [--seed, --seed + P) as one program, each
replica following the standalone ``--seeds 1`` run with its seed; the
single-carry modes run one replica. ``--sweep`` runs a manifest through
``repro_torch.api.sweep`` (``--ckpt-dir`` overrides its root; with it,
``--spec`` is refused) and prints ``SWEEP OK runs=N trained=N
skipped=M``. ``--trace FILE`` records the run's phases (init, train,
cycle, eval, metrics, checkpoint) and its cycles and env-steps counters
as JSON lines with a Perfetto twin (with ``--sweep``, any value gives
each run a ``runs/<id>/trace.jsonl``); ``python -m
repro_torch.launch.trace_report FILE`` summarizes it. ``--ckpt-dir``
(or the spec's ``checkpoint.dir``) checkpoints the whole carry every
``--ckpt-every`` cycles and at the last one, in the JAX package's
layout, with the resolved spec stored beside it; ``--resume`` restarts
from the newest restorable checkpoint (a population's whole carry),
bitwise equal to the uninterrupted run, and is refused (exit 2, with
the field-level diff) when the requested spec no longer matches the
stored one. ``--metrics-jsonl`` appends one JSON line per (cycle,
replica), with the reference's fields, from one device-to-host copy per
cycle. The optimizer is the spec's (AdamW by default);
``--optimizer rmsprop`` (alias ``--paper-optimizer``) selects Mnih's
centered RMSProp, and ``--optimizer`` overrides the spec either way.
``--dryrun`` shrinks the run to a few seconds. ``--device cuda`` (the
default) raises when no card is visible.

Under ``torch.distributed.run`` a population's replicas split over the
processes, one card each (NCCL; gloo with ``--device cpu``), where
their count divides P (``core.population.replica_mesh``): each rank
runs its P/D replicas, and rank 0 prints, writes the metrics, the trace
and the checkpoints of the whole population:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.rl_train --spec examples/specs/rainbow_fleet.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.api.spec import (MODES, ExperimentSpec, SpecCompatError,
                                  check_resume_compat, load_run_spec,
                                  save_run_spec)
from repro_torch.api.sweep import SweepSpec, run_sweep
from repro_torch.api.trainers import build_trainer
from repro_torch.checkpoint import (latest_step, restore_latest,
                                    save_checkpoint, trim_metrics_jsonl)
from repro_torch.configs.dqn_nature import VARIANTS, get_variant
from repro_torch.telemetry import chrome_path_for, device_meta, make_tracer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rl_train")
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="ExperimentSpec JSON (flags override its fields)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved spec as canonical JSON and "
                         "exit (commit it, re-run with --spec)")
    ap.add_argument("--mode", default=None, choices=list(MODES))
    ap.add_argument("--env", default=None)
    ap.add_argument("--envs", type=int, default=None)
    ap.add_argument("--env-param", action="append", default=None,
                    metavar="KEY=VALUE",
                    help="static EnvParams override, repeatable (e.g. "
                         "--env-param size=16); invalid names or values "
                         "fail listing the game's valid ranges")
    ap.add_argument("--obs-mode", default=None, choices=["pixels", "vector"],
                    help="rendered uint8 frames or the env's float32 "
                         "state vector")
    ap.add_argument("--frame-size", type=int, default=None, choices=[10, 84])
    ap.add_argument("--optimizer", default=None, choices=["adamw", "rmsprop"],
                    help="override the spec's optimizer either way")
    ap.add_argument("--paper-optimizer", action="store_true",
                    help="Mnih's centered RMSProp (alias for --optimizer "
                         "rmsprop)")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS))
    ap.add_argument("--cycles", type=int, default=None)
    ap.add_argument("--cycle-steps", type=int, default=None)
    ap.add_argument("--prepopulate", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the whole carry here (the resolved "
                         "spec is stored beside the checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="cycles between checkpoints (with --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest restorable checkpoint in "
                         "--ckpt-dir (bitwise equal to the uninterrupted "
                         "run)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append per-(cycle, replica) metrics as JSON lines")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="Q-network compute dtype (paper default f32; "
                         "bf16 halves actor-inference bandwidth)")
    ap.add_argument("--dryrun", action="store_true",
                    help="one tiny run: W=4, 2 cycles of 32 steps")
    ap.add_argument("--sweep", default=None, metavar="FILE",
                    help="SweepSpec manifest (base spec x axis grid): "
                         "expand, pack same-except-seed runs into "
                         "population fleets, run them all; --ckpt-dir "
                         "overrides the manifest's root, --resume "
                         "continues a partial sweep")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a phase trace: JSON lines to FILE plus a "
                         "Perfetto twin beside it (summarize with "
                         "launch/trace_report.py); with --sweep, any value "
                         "gives each run runs/<id>/trace.jsonl")
    return ap.parse_args(argv)


def _parse_env_params(pairs):
    """--env-param KEY=VALUE list -> dict (numbers parsed as JSON)."""
    if not pairs:
        return None
    out = {}
    for p in pairs:
        if "=" not in p:
            raise ValueError(f"--env-param expects KEY=VALUE, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except ValueError:
            out[k] = v
    return out


def resolve_spec(args) -> ExperimentSpec:
    """(spec file or defaults) + flag overrides -> one ExperimentSpec."""
    if args.spec:
        with open(args.spec) as f:
            spec = ExperimentSpec.from_json(f.read())
    else:
        spec = ExperimentSpec()

    def sub(section, **kw):
        changed = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(section, **changed) if changed else section

    top = {k: v for k, v in {
        "mode": args.mode, "env": args.env, "envs": args.envs,
        "env_params": _parse_env_params(args.env_param),
        "obs_mode": args.obs_mode, "frame_size": args.frame_size,
        "seed": args.seed, "seeds": args.seeds,
        "variant": get_variant(args.variant) if args.variant else None,
    }.items() if v is not None}
    spec = dataclasses.replace(
        spec, **top,
        schedule=sub(spec.schedule, cycles=args.cycles,
                     cycle_steps=args.cycle_steps,
                     prepopulate=args.prepopulate,
                     eval_every=args.eval_every),
        algo=sub(spec.algo, optimizer=args.optimizer or
                 ("rmsprop" if args.paper_optimizer else None)),
        checkpoint=sub(spec.checkpoint, dir=args.ckpt_dir,
                       every=args.ckpt_every),
        metrics=sub(spec.metrics, jsonl=args.metrics_jsonl),
        exec=sub(spec.exec, compute_dtype=args.compute_dtype))
    if args.dryrun:
        spec = dataclasses.replace(
            spec, envs=4,
            schedule=dataclasses.replace(spec.schedule, cycles=2,
                                         cycle_steps=32, prepopulate=64,
                                         eval_every=2))
    return spec


def run_sweep_cli(args) -> int:
    """--sweep FILE: load the manifest and hand off to the sweep runner
    (``repro_torch.api.sweep``). Prints one summary line; a second
    ``--resume`` pass reports trained=0."""
    if args.spec:
        print("--sweep and --spec are mutually exclusive (the manifest "
              "carries its own base spec)", file=sys.stderr, flush=True)
        return 2
    try:
        with open(args.sweep) as f:
            sweep = SweepSpec.from_json(f.read())
        results = run_sweep(sweep, resume=args.resume,
                            root=args.ckpt_dir or None,
                            trace=bool(args.trace), device=args.device)
    except (OSError, ValueError, NotImplementedError) as e:
        # SpecCompatError is a ValueError: a changed manifest lands here
        print(f"sweep failed: {e}", file=sys.stderr, flush=True)
        return 2
    trained = sum(1 for r in results if not r["skipped"])
    skipped = len(results) - trained
    print(f"SWEEP OK runs={len(results)} trained={trained} "
          f"skipped={skipped}", flush=True)
    return 0


def _process_group(args) -> bool:
    """Under ``torch.distributed.run`` (WORLD_SIZE > 1): join the job's
    process group (NCCL on cards, one per rank; gloo on the CPU) and
    return True; a population's replicas then split over the ranks
    (``PopulationTrainer``). Otherwise False."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    if torch.device(args.device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def _first_rank() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.sweep:
        return run_sweep_cli(args)
    joined = _process_group(args)
    try:
        if _first_rank():
            return _main(args)
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            return _main(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _main(args) -> int:
    try:
        spec = resolve_spec(args)
    except (OSError, ValueError) as e:
        print(f"invalid spec: {e}", file=sys.stderr, flush=True)
        return 2
    if args.print_spec:
        print(spec.to_json(), end="")
        return 0
    try:
        spec.validate()
    except ValueError as e:
        print(f"invalid spec: {e}", file=sys.stderr, flush=True)
        return 2
    # With --trace FILE the tracer writes JSON lines and a Perfetto twin;
    # without it this is a counter-only tracer (nothing written) that the
    # throughput lines read. Tracing reads the host's clock and waits for
    # the card; it changes no tensor, so a traced run is bitwise equal
    # to an untraced one (tests/test_torch_telemetry.py).
    if not _first_rank():
        # one trace, one metrics file, one set of checkpoints: rank 0's
        args.trace = None
        spec = dataclasses.replace(spec, metrics=dataclasses.replace(
            spec.metrics, jsonl=None))
    tracer = make_tracer(args.trace, meta={
        "kind": "rl_train", "env": spec.env, "mode": spec.mode,
        "variant": spec.variant.name, "seeds": spec.seeds,
        "cycles": spec.schedule.cycles,
        "cycle_steps": spec.schedule.cycle_steps,
        **(device_meta(args.device) if args.trace else {})})
    try:
        rc = _train(args, spec, tracer)
    finally:
        tracer.close()
    if args.trace and rc == 0:
        print(f"trace written: {args.trace} (+ Perfetto twin "
              f"{chrome_path_for(args.trace)}); summarize with python -m "
              "repro_torch.launch.trace_report", flush=True)
    if args.dryrun and rc == 0:
        print(f"DRYRUN OK variant={spec.variant.name}", flush=True)
    return rc


def _train(args, spec: ExperimentSpec, tracer) -> int:
    """Build, restore or init, and run the spec's cycles under
    ``tracer``'s spans; returns the exit code."""
    try:
        with tracer.span("init", phase="build_trainer"):
            trainer = build_trainer(spec, device=args.device)
    except (ValueError, NotImplementedError) as e:
        print(f"invalid spec: {e}", file=sys.stderr, flush=True)
        return 2
    sched, ckpt_dir = spec.schedule, spec.checkpoint.dir
    tag = f"{spec.mode}/{spec.variant.name}"
    P = trainer.replicas
    seeds = (trainer.seeds.tolist() if spec.mode == "population"
             else [spec.seed])

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    # the guards come before any init: a resume whose spec differs from
    # the stored one, and a directory holding another run's checkpoints
    last = latest_step(ckpt_dir) if args.resume and ckpt_dir else None
    if last is not None:
        try:
            stored = load_run_spec(ckpt_dir)
            if stored is not None:
                check_resume_compat(stored, spec)
        except SpecCompatError as e:
            print(f"cannot resume {ckpt_dir}: {e}", file=sys.stderr,
                  flush=True)
            return 2
    if ckpt_dir and _first_rank():
        try:
            save_run_spec(ckpt_dir, spec)
        except SpecCompatError as e:
            print(f"refusing to reuse {ckpt_dir}: {e}", file=sys.stderr,
                  flush=True)
            return 2

    start_cycle, carry = 0, None
    if last is not None:
        # the template is the carry's structure only (meta tensors); a
        # torn checkpoint is skipped with a warning and the walk falls
        # back to the newest step that still restores
        with tracer.span("init", phase="restore"):
            step, carry, skipped = restore_latest(
                ckpt_dir, trainer.init_template(), device=trainer.device)
            if carry is not None:
                carry = trainer.own(carry)
        for s in skipped:
            print(f"WARNING: skipped unrestorable checkpoint {s}", flush=True)
        if carry is not None:
            start_cycle = step
            print(f"resumed {ckpt_dir} at cycle {step}", flush=True)
        else:
            print(f"no restorable checkpoint in {ckpt_dir}; starting fresh",
                  flush=True)
    if carry is None:
        t0 = time.perf_counter()
        with tracer.span("init", phase="init_carry"):
            carry = trainer.init_carry()
            sync()
        print(f"[{tag}] {spec.env} ({spec.obs_mode}) init_carry "
              f"{time.perf_counter() - t0:.2f} s on {trainer.device}",
              flush=True)

    metrics_f = None
    if spec.metrics.jsonl:
        os.makedirs(os.path.dirname(spec.metrics.jsonl) or ".",
                    exist_ok=True)
        if os.path.exists(spec.metrics.jsonl):
            trim_metrics_jsonl(spec.metrics.jsonl, start_cycle)
        metrics_f = open(spec.metrics.jsonl, "a", buffering=1)

    def emit(i, m, evals, steps):
        # one device-to-host copy per cycle (float32 and int32 values
        # are exact in float64)
        cols = [m["loss"], m["reward"], m["episodes"], steps]
        if evals is not None:
            cols.append(evals)
        host = torch.stack([c.to(torch.float64) for c in cols]).cpu().tolist()
        for r in range(P):
            row = {"cycle": i + 1, "env": spec.env, "mode": spec.mode,
                   "variant": spec.variant.name, "seed": seeds[r],
                   "step": int(host[3][r]), "loss": host[0][r],
                   "reward": host[1][r], "episodes": host[2][r]}
            if evals is not None:
                row["eval"] = host[4][r]
            metrics_f.write(json.dumps(row) + "\n")

    t0 = time.perf_counter()
    win_t, win_counters = t0, tracer.counters
    try:
        with tracer.span("train", start_cycle=start_cycle,
                         cycles=sched.cycles):
            for i in range(start_cycle, sched.cycles):
                with tracer.span("cycle", index=i + 1):
                    carry, m = trainer.cycle(carry)
                    if tracer.enabled:
                        tracer.fence(m)
                tracer.count("cycles", 1)
                tracer.count("env_steps", P * sched.cycle_steps)
                # on every rank: a population split over processes
                # gathers its replicas' steps (its own span there: what
                # a gather costs beside the cycle)
                if getattr(trainer, "mesh", None) is None:
                    steps_p = trainer.steps(carry)
                else:
                    with tracer.span("gather", index=i + 1):
                        steps_p = trainer.steps(carry)
                        if tracer.enabled:
                            tracer.fence(steps_p)
                evals = None
                if (i + 1) % sched.eval_every == 0 or i == sched.cycles - 1:
                    with tracer.span("eval", index=i + 1):
                        evals = trainer.eval(carry, trainer.eval_key(i))
                        sync()
                    steps = int(steps_p[0])
                    sps = tracer.counters["env_steps"] / max(
                        time.perf_counter() - t0, 1e-9)
                    print(f"[{tag}] cycle {i + 1:4d} steps {steps:7d} x{P} "
                          f"eval {float(evals.mean()):+.2f} "
                          f"[{float(evals.min()):+.2f},"
                          f"{float(evals.max()):+.2f}]"
                          f" loss {float(m['loss'].mean()):.4f} "
                          f"eps {float(m['eps'].mean()):.2f} | {sps:.0f} "
                          "env-steps/s", flush=True)
                if metrics_f is not None:
                    with tracer.span("metrics", index=i + 1):
                        emit(i, m, evals, steps_p)
                boundary = ((i + 1) % spec.checkpoint.every == 0
                            or i == sched.cycles - 1)
                if ckpt_dir and boundary:
                    with tracer.span("checkpoint", index=i + 1):
                        save_checkpoint(ckpt_dir, i + 1,
                                        trainer.whole(carry))
                if boundary:
                    # per-interval throughput from the tracer's counters:
                    # long runs stay observable without a trace file
                    sync()
                    now, c = time.perf_counter(), tracer.counters
                    dc = c["cycles"] - win_counters.get("cycles", 0)
                    ds = c["env_steps"] - win_counters.get("env_steps", 0)
                    dt = max(now - win_t, 1e-9)
                    print(f"[throughput] cycle {i + 1:4d}: {dc / dt:.2f} "
                          f"cycles/s, {ds / dt:.0f} env-steps/s "
                          f"(last {int(dc)} cycle(s))", flush=True)
                    win_t, win_counters = now, c
    finally:
        if metrics_f is not None:
            metrics_f.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
