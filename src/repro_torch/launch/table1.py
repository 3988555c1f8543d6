"""Table 1 of the paper on PyTorch: the wall-clock runtime of DQN under
{Standard, Concurrent, Synchronized, Both} x sampler threads {1, 2, 4,
8}, the port's counterpart of ``benchmarks/table1_speed.py::run_table1``.

  PYTHONPATH=src python -m repro_torch.launch.table1 [--steps 2000]
      [--frame-size 84|10] [--device cuda|cpu]

HostCatch envs step on the host, Nature-CNN inference and updates run
on the card (``core.host_runner``). Each row gives seconds, µs per env
step, inference and update transactions, % of Standard-1's seconds and
the speedup over it, the paper's relative quantities (its Tables 2-3).
Variants with synchronization need W >= 2 (the paper's "—" cells), so
14 cells run. ``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch import rng
from repro_torch.config import DQNConfig
from repro_torch.configs.dqn_nature import NatureCNNConfig
from repro_torch.core.host_runner import HostDQNRunner
from repro_torch.envs.games import get_env
from repro_torch.models.nature_cnn import q_forward, q_init
from repro_torch.runtime import configure

VARIANTS = [("standard", False, False), ("concurrent", True, False),
            ("synchronized", False, True), ("both", True, True)]
THREADS = (1, 2, 4, 8)


def table1_config(frame_size: int, n_actions: int) -> NatureCNNConfig:
    """The reference's network: the Nature stack at 84x84x4, a one-conv
    net at 10x10x2."""
    small = frame_size == 10
    return NatureCNNConfig(
        frame_size=frame_size, frame_stack=2 if small else 4,
        convs=((8, 3, 1),) if small else ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
        hidden=32 if small else 512, n_actions=n_actions)


def table1_dqn_config(steps: int, n_envs: int, frame_stack: int) -> DQNConfig:
    return DQNConfig(minibatch_size=32, replay_capacity=50_000,
                     target_update_period=max(steps // 8, 64),
                     train_period=4, n_envs=n_envs, frame_stack=frame_stack)


def run_table1(steps: int = 2000, frame_size: int = 84, seed: int = 0,
               device: str = "cuda", prepopulate: int = 256) -> List[Dict]:
    dev = configure(device)
    spec = get_env("catch")
    ncfg = table1_config(frame_size, spec.n_actions)
    rows = []
    for name, conc, sync in VARIANTS:
        for W in THREADS:
            if sync and W == 1:
                continue                     # "—" cells in Table 1
            dcfg = table1_dqn_config(steps, W, ncfg.frame_stack)
            params = q_init(ncfg, spec.n_actions, rng.PRNGKey(seed, dev))
            runner = HostDQNRunner(lambda p, o: q_forward(p, o, ncfg),
                                   params, dcfg, concurrent=conc,
                                   synchronized=sync, n_envs=W,
                                   frame_size=frame_size, seed=seed,
                                   device=device)
            res = runner.run(steps, prepopulate=prepopulate)
            rows.append({"variant": name, "threads": W,
                         "seconds": res.seconds, "steps": steps,
                         "us_per_step": res.seconds / steps * 1e6,
                         "infer_tx": res.inference_transactions,
                         "update_tx": res.update_transactions})
    base = next(r for r in rows
                if r["variant"] == "standard" and r["threads"] == 1)
    for r in rows:
        r["pct_of_std1"] = 100.0 * r["seconds"] / base["seconds"]
        r["speedup"] = base["seconds"] / r["seconds"]
    return rows


def format_rows(rows: List[Dict]) -> str:
    out = ["variant      W  seconds    us/step  infer_tx update_tx "
           "%std1   speedup"]
    for r in rows:
        out.append(f"{r['variant']:<12s} {r['threads']:d} "
                   f"{r['seconds']:8.3f} {r['us_per_step']:10.1f} "
                   f"{r['infer_tx']:9d} {r['update_tx']:9d} "
                   f"{r['pct_of_std1']:6.1f} {r['speedup']:7.2f}x")
    return "\n".join(out)


def format_tables(rows: List[Dict]) -> str:
    """The paper's layout: threads down, variants across, seconds and
    the speedup over Standard-1 in each cell."""
    out = ["Threads | " + " | ".join(v for v, _, _ in VARIANTS)]
    for W in THREADS:
        cells = []
        for name, _, _ in VARIANTS:
            r = [x for x in rows if x["variant"] == name and x["threads"] == W]
            cells.append(f"{r[0]['seconds']:6.2f}s ({r[0]['speedup']:.2f}x)"
                         if r else "   —")
        out.append(f"{W:7d} | " + " | ".join(cells))
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.table1")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--frame-size", type=int, default=84, choices=[10, 84])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    rows = run_table1(steps=args.steps, frame_size=args.frame_size,
                      seed=args.seed, device=args.device)
    print(format_rows(rows))
    print(format_tables(rows), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
