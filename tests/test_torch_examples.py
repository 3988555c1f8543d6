"""The four PyTorch twins of ``examples/`` on the CPU, cut to a few
seconds each.

Each runs in a process of its own as ``__main__`` (one host thread), as
a user would run it with ``--device cpu`` and flags that cut its size;
the test checks its exit code, what it prints, and that the run imported
nothing of JAX or of the JAX package.
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

RUN = r"""
import runpy, sys
path, argv = sys.argv[1], sys.argv[2:]
sys.argv = [path] + argv
try:
    runpy.run_path(path, run_name="__main__")
    code = 0
except SystemExit as e:
    code = e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print("IMPORTED", bad)
sys.exit(code)
"""


def _run(name: str, *argv: str) -> str:
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", RUN,
                          str(ROOT / "examples" / name), *argv],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "IMPORTED []" in res.stdout, res.stdout[-2000:]
    return res.stdout


def _floats(pattern: str, text: str) -> list:
    return [float(x) for x in re.findall(pattern, text)]


def test_quickstart_torch():
    out = _run("quickstart_torch.py", "--device", "cpu", "--cycles", "1",
               "--cycle-steps", "32", "--prepopulate", "64",
               "--eval-episodes", "4", "--lm-steps", "2", "--lm-seq", "16")
    (ret,) = _floats(r"after 32 env steps: loss \S+, eval return (\S+)", out)
    assert -1.0 <= ret <= 1.0
    losses = _floats(r"step +\d+ loss (\S+)", out)
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert out.rstrip().splitlines()[-2] == "done."


def test_atari_dqn_torch():
    out = _run("atari_dqn_torch.py", "--device", "cpu", "--frame-size", "10",
               "--cycles", "1", "--cycle-steps", "32", "--prepopulate", "64",
               "--envs", "4", "--eval-every", "1")
    (line,) = [s for s in out.splitlines() if re.search(r"cycle +1 steps", s)]
    assert "steps      32 x1" in line
    (ret,) = _floats(r"eval (\S+) \[", line)
    (loss,) = _floats(r"loss (\S+)", line)
    assert -1.0 <= ret <= 1.0 and math.isfinite(loss)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mistral-nemo-12b"])
def test_serve_batched_torch(arch):
    out = _run("serve_batched_torch.py", "--device", "cpu", "--arch", arch,
               "--gen", "4")
    assert "generated shape: (8, 4)" in out        # the example's batch 8
    assert re.search(r"prefill: \S+ ms \(fused, batch 8 x 16 tokens\)", out)
    assert len(re.search(r"sample: \[(.*)\]", out).group(1).split(",")) == 4


def test_actor_learner_llm_torch():
    out = _run("actor_learner_llm_torch.py", "--device", "cpu",
               "--cycles", "2", "--log-every", "1")
    rewards = _floats(r"cycle +\d+  reward (\S+)", out)
    losses = _floats(r"cycle +\d+  reward \S+  loss (\S+)", out)
    assert len(rewards) == 2 and all(0.0 <= r <= 1.0 for r in rewards)
    assert all(math.isfinite(x) for x in losses)
    assert "starcoder2-3b (reduced)" in out
