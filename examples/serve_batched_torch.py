"""Batched serving on the PyTorch port: Synchronized Execution's insight
applied to LLM inference, W request streams sharing every decode step's
kernel launches, through ``repro_torch.launch.serve`` (the settings of
``examples/serve_batched.py``: reduced zamba2-2.7b, batch 8, a 16-token
prompt, 48 generated tokens). Runs on the card unless ``--device cpu``
is given; the other flags override the defaults.

  PYTHONPATH=src python examples/serve_batched_torch.py [--arch zamba2-2.7b]
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu --gen 4
"""

import sys

from repro_torch.launch.serve import main

DEFAULTS = {"--arch": "zamba2-2.7b", "--batch": "8", "--prompt-len": "16",
            "--gen": "48"}

if __name__ == "__main__":
    args = sys.argv[1:]
    for flag, value in DEFAULTS.items():
        if not any(a == flag or a.startswith(flag + "=") for a in args):
            args += [flag, value]
    raise SystemExit(main(args))
