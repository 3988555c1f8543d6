"""The paper's experiment on PyTorch: the concurrent trainer driven by an
``ExperimentSpec`` file, on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.rl_train \\
      --spec examples/specs/dqn_nature84.json --variant rainbow

Flags override the spec's fields. Only mode ``concurrent`` is ported:
the other modes (from ``--mode`` or the spec), sweeps, checkpoints and
traces exit 2 naming the ROADMAP.md item that will port them. ``--device cuda`` (the default)
raises when no card is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.api.spec import ExperimentSpec
from repro_torch.api.trainers import ConcurrentTrainer
from repro_torch.configs.dqn_nature import VARIANTS, get_variant

# flag or mode -> the ROADMAP.md item (queue 1) that ports it
NOT_PORTED = {
    "population": "item 9 (population and sweeps)",
    "baseline": "item 10 (sequential modes)",
    "synchronized": "item 10 (sequential modes)",
    "--sweep": "item 9 (population and sweeps)",
    "--ckpt-dir": "item 8 (checkpoints)",
    "--trace": "item 12 (telemetry)",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rl_train")
    ap.add_argument("--spec", required=True, metavar="FILE",
                    help="ExperimentSpec JSON (flags override its fields)")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS))
    ap.add_argument("--cycles", type=int, default=None)
    ap.add_argument("--cycle-steps", type=int, default=None)
    ap.add_argument("--prepopulate", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mode", default=None,
                    choices=["concurrent", "population", "baseline",
                             "synchronized"])
    ap.add_argument("--sweep", default=None, metavar="FILE")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--trace", default=None, metavar="FILE")
    return ap.parse_args(argv)


def resolve_spec(args) -> ExperimentSpec:
    with open(args.spec) as f:
        spec = ExperimentSpec.from_json(f.read())
    top = {k: v for k, v in {
        "mode": args.mode, "seed": args.seed,
        "variant": get_variant(args.variant) if args.variant else None,
    }.items() if v is not None}
    sched = {k: v for k, v in {
        "cycles": args.cycles, "cycle_steps": args.cycle_steps,
        "prepopulate": args.prepopulate, "eval_every": args.eval_every,
    }.items() if v is not None}
    return dataclasses.replace(
        spec, **top, schedule=dataclasses.replace(spec.schedule, **sched))


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
    if spec.mode != "concurrent":
        return _refuse(spec.mode)
    trainer = ConcurrentTrainer(spec, device=args.device)
    sched = spec.schedule

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    carry = trainer.init_carry()
    sync()
    print(f"[{spec.variant.name}] init_carry {time.perf_counter() - t0:.2f} s "
          f"on {trainer.device}", flush=True)
    t0 = time.perf_counter()
    for i in range(sched.cycles):
        carry, m = trainer.cycle(carry)
        if (i + 1) % sched.eval_every == 0 or i == sched.cycles - 1:
            evals = trainer.eval(carry, trainer.eval_key(i))
            sync()
            steps = int(trainer.steps(carry)[0])
            sps = (i + 1) * sched.cycle_steps / max(time.perf_counter() - t0,
                                                    1e-9)
            print(f"[{spec.variant.name}] cycle {i + 1:4d} steps {steps:7d} "
                  f"eval {float(evals[0]):+.2f} "
                  f"loss {float(m['loss'][0]):.4f} "
                  f"eps {float(m['eps'][0]):.2f} | {sps:.0f} env-steps/s",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
