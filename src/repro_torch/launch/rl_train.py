"""The paper's experiment on PyTorch: a trainer built from an
``ExperimentSpec`` (``build_trainer``), on the card unless asked for the
CPU.

  PYTHONPATH=src python -m repro_torch.launch.rl_train \\
      --spec examples/specs/baseline_catch.json
  PYTHONPATH=src python -m repro_torch.launch.rl_train \\
      --spec examples/specs/rainbow_fleet.json --mode concurrent --seeds 1 \\
      [--obs-mode vector] [--device cpu]

Flags override the spec's fields (no ``--spec``: the ExperimentSpec
defaults). Modes ``baseline``, ``synchronized`` and ``concurrent`` run;
``population`` and ``--seeds`` above 1, sweeps, checkpoints and traces
exit 2 naming the ROADMAP.md item that will port them. The optimizer is
the spec's (AdamW by default); ``--optimizer rmsprop`` (alias
``--paper-optimizer``) selects Mnih's centered RMSProp, and
``--optimizer`` overrides the spec either way. ``--device cuda`` (the
default) raises when no card is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch.api.spec import MODES, ExperimentSpec
from repro_torch.api.trainers import build_trainer
from repro_torch.configs.dqn_nature import VARIANTS, get_variant

# flag or mode -> the ROADMAP.md item (queue 1) that ports it
NOT_PORTED = {
    "population": "item 9 (population and sweeps)",
    "--seeds": "item 9 (population and sweeps)",
    "--sweep": "item 9 (population and sweeps)",
    "--ckpt-dir": "item 8 (checkpoints)",
    "--trace": "item 12 (telemetry)",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rl_train")
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="ExperimentSpec JSON (flags override its fields)")
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
    ap.add_argument("--sweep", default=None, metavar="FILE")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--trace", default=None, metavar="FILE")
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
    return dataclasses.replace(
        spec, **top,
        schedule=sub(spec.schedule, cycles=args.cycles,
                     cycle_steps=args.cycle_steps,
                     prepopulate=args.prepopulate,
                     eval_every=args.eval_every),
        algo=sub(spec.algo, optimizer=args.optimizer or
                 ("rmsprop" if args.paper_optimizer else None)))


def _refuse(what: str) -> int:
    print(f"{what} is not ported to repro_torch yet: ROADMAP.md, queue 1 "
          f"{NOT_PORTED[what]}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse_args(argv)
    for flag in ("--sweep", "--ckpt-dir", "--trace"):
        if getattr(args, flag[2:].replace("-", "_")):
            return _refuse(flag)
    try:
        spec = resolve_spec(args)
        spec.validate()
    except (OSError, ValueError) as e:
        print(f"invalid spec: {e}", file=sys.stderr, flush=True)
        return 2
    if spec.mode == "population":
        return _refuse("population")
    if spec.seeds > 1:
        return _refuse("--seeds")
    if spec.checkpoint.dir:
        print(f"note: the spec's checkpoint.dir {spec.checkpoint.dir!r} is "
              "ignored: checkpoints are not ported to repro_torch yet "
              f"(ROADMAP.md, queue 1 {NOT_PORTED['--ckpt-dir']})",
              file=sys.stderr, flush=True)
    try:
        trainer = build_trainer(spec, device=args.device)
    except ValueError as e:
        print(f"invalid spec: {e}", file=sys.stderr, flush=True)
        return 2
    sched = spec.schedule
    tag = f"{spec.mode}/{spec.variant.name}"

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    carry = trainer.init_carry()
    sync()
    print(f"[{tag}] {spec.env} ({spec.obs_mode}) init_carry "
          f"{time.perf_counter() - t0:.2f} s on {trainer.device}", flush=True)
    t0 = time.perf_counter()
    for i in range(sched.cycles):
        carry, m = trainer.cycle(carry)
        if (i + 1) % sched.eval_every == 0 or i == sched.cycles - 1:
            evals = trainer.eval(carry, trainer.eval_key(i))
            sync()
            steps = int(trainer.steps(carry)[0])
            sps = (i + 1) * sched.cycle_steps / max(time.perf_counter() - t0,
                                                    1e-9)
            print(f"[{tag}] cycle {i + 1:4d} steps {steps:7d} "
                  f"eval {float(evals[0]):+.2f} "
                  f"loss {float(m['loss'][0]):.4f} "
                  f"eps {float(m['eps'][0]):.2f} | {sps:.0f} env-steps/s",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
