"""End-to-end run on the PyTorch port: the paper's full pipeline at the
Nature-CNN input geometry (84x84x4 uint8 frame stacks), training for a
few thousand env steps and printing periodic ε=0.05 evaluations, through
``repro_torch.launch.rl_train`` (the settings of ``examples/atari_dqn.py``).
Runs on the card unless ``--device cpu`` is given; any launcher flag
passes through (``--compute-dtype bfloat16`` trains the Q-network in
bfloat16).

  PYTHONPATH=src python examples/atari_dqn_torch.py [--env catch] [--cycles 40]
  PYTHONPATH=src python examples/atari_dqn_torch.py --device cpu \
      --frame-size 10 --net tiny --cycles 1 --cycle-steps 32 \
      --prepopulate 64 --envs 4
"""

import sys

from repro_torch.launch.rl_train import main

if __name__ == "__main__":
    args = sys.argv[1:]
    if "--frame-size" not in " ".join(args):
        # 84x84x4 conv stacks: keep the demo short; scale --cycles up
        args += ["--frame-size", "84", "--cycles", "8",
                 "--cycle-steps", "128", "--eval-every", "4",
                 "--prepopulate", "512", "--envs", "8"]
    raise SystemExit(main(args))
