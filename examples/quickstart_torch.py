"""Quickstart on the PyTorch port: the two faces of the framework.

1. The paper's system: DQN with Concurrent Training + Synchronized
   Execution learning the Catch pixel env (concurrent mode, the small
   10x10 network; the same settings as ``examples/quickstart.py``).
2. The LLM substrate: reduced granite-moe-1b-a400m training on the
   synthetic token stream.

Runs on the card by default; ``--device cpu`` runs it on the host, and
the other flags cut it down (a CPU smoke run takes seconds):

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
      --cycles 1 --cycle-steps 32 --prepopulate 64 --eval-episodes 4 \
      --lm-steps 2 --lm-seq 16
"""

import argparse
import math

import torch

from repro_torch import rng
from repro_torch.api import build_trainer
from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
from repro_torch.config import ExecConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.runtime import configure


def dqn(args) -> float:
    print("=== 1) DQN: Concurrent Training + Synchronized Execution ===")
    spec = ExperimentSpec(
        env="catch", mode="concurrent", envs=8, frame_size=10, net="small",
        schedule=ScheduleSpec(cycles=args.cycles,
                              cycle_steps=args.cycle_steps,
                              prepopulate=args.prepopulate,
                              eval_episodes=args.eval_episodes),
        algo=AlgoSpec(minibatch_size=32, replay_capacity=16384,
                      train_period=2, discount=0.9, optimizer="adamw",
                      learning_rate=1e-3, eps_anneal_steps=4000))
    trainer = build_trainer(spec, device=args.device)
    carry = trainer.init_carry()
    key = trainer.eval_key(0)
    print(f"  random-policy eval return: "
          f"{float(trainer.eval(carry, key)[0]):+.2f}")
    for _ in range(args.cycles):
        carry, m = trainer.cycle(carry)
    ret = float(trainer.eval(carry, key)[0])
    print(f"  after {int(trainer.steps(carry)[0])} env steps: loss "
          f"{float(m['loss'][0]):.4f}, eval return {ret:+.2f}  "
          f"(optimal = +1.00)")
    return ret


def llm(args) -> list:
    print("\n=== 2) LLM path: granite-moe (reduced) on the synthetic stream "
          "===")
    cfg = reduced_config("granite-moe-1b-a400m")
    ec = ExecConfig(compute_dtype="float32", remat=False)
    step, opt = make_train_step(cfg, ec, TrainConfig(learning_rate=3e-3,
                                                     warmup_steps=5))
    key = rng.PRNGKey(0, device=args.device)
    params = T.init_params(cfg, key, ec, param_dtype=torch.float32)
    opt_state = opt.init(params)
    data = SyntheticLM(cfg.vocab, seq_len=args.lm_seq, global_batch=8)
    losses = []
    for i in range(args.lm_steps):
        params, opt_state, metrics = step(params, opt_state,
                                          data.batch(i, device=args.device))
        losses.append(float(metrics["loss"]))
        if i % 10 == 0 or i == args.lm_steps - 1:
            print(f"  step {i:3d} loss {losses[-1]:.3f}")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--cycle-steps", type=int, default=256)
    ap.add_argument("--prepopulate", type=int, default=2048)
    ap.add_argument("--eval-episodes", type=int, default=64)
    ap.add_argument("--lm-steps", type=int, default=30)
    ap.add_argument("--lm-seq", type=int, default=64)
    args = ap.parse_args(argv)
    configure(args.device)
    ret = dqn(args)
    losses = llm(args)
    ok = math.isfinite(ret) and all(math.isfinite(x) for x in losses)
    print("done." if ok else "non-finite result")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
