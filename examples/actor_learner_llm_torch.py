"""The paper's technique on an LLM, on the PyTorch port: off-policy
actor/learner fine-tuning where the actor generates with the time-delayed
θ⁻ (Concurrent Training) over batched streams (Synchronized Execution)
while the learner updates θ from a frozen replay snapshot, through
``repro_torch.core.actor_learner`` (the settings of
``examples/actor_learner_llm.py``). Runs on the card unless ``--device
cpu`` is given.

  PYTHONPATH=src python examples/actor_learner_llm_torch.py [arch]
  PYTHONPATH=src python examples/actor_learner_llm_torch.py --device cpu \
      --cycles 2 --log-every 1
"""

import argparse
import math
import time

from repro_torch import rng
from repro_torch.config import ExecConfig
from repro_torch.configs import reduced_config
from repro_torch.core.actor_learner import ALConfig, make_actor_learner
from repro_torch.runtime import configure


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="starcoder2-3b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cycles", type=int, default=30)
    ap.add_argument("--log-every", type=int, default=5)
    args = ap.parse_args(argv)
    configure(args.device)
    cfg = reduced_config(args.arch)
    ec = ExecConfig(compute_dtype="float32", remat=False)
    al = ALConfig(n_streams=8, prompt_len=6, gen_len=12, replay_capacity=128,
                  updates_per_cycle=8, minibatch=16, learning_rate=3e-3,
                  reward_modulus=4)
    init, cycle = make_actor_learner(cfg, ec, al)
    carry = init(rng.PRNGKey(0, device=args.device))
    print(f"actor-learner on {args.arch} (reduced): reward = fraction of "
          f"generated tokens in residue class {al.reward_target} "
          f"(mod {al.reward_modulus})")
    t0 = time.time()
    ok = True
    for i in range(args.cycles):
        carry, m = cycle(carry)
        reward, loss = float(m["reward"]), float(m["loss"])
        ok = ok and math.isfinite(reward) and math.isfinite(loss)
        if (i + 1) % args.log_every == 0:
            print(f"  cycle {i + 1:3d}  reward {reward:.3f}  "
                  f"loss {loss:.3f}  ({time.time() - t0:.0f}s)")
    print("done: reward should trend upward as θ chases the synthetic "
          "signal." if ok else "non-finite result")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
