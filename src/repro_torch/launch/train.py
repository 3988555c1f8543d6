"""LLM training launcher on PyTorch: the port of ``repro.launch.train``,
on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

The weights are random, drawn from key 0 as the reference draws them,
and kept in float32; the batches are ``data.SyntheticLM``'s, equal to
the reference's, with, for an arch with cross-attention, step i's memory
drawn from key i (0.02 N(0, 1) of shape (batch, cross_memory_len,
d_model)), as the reference draws it. Reduced configs compute in
float32, full-size ones in bfloat16. The reference's ``--use-pallas``
and ``--kernel-backend`` are not taken: the port has no backend switch
(a CUDA tensor runs the kernels, with their plain-recompute backward, a
CPU tensor the plain versions). One process trains on one device: the
reference's launcher builds a host mesh but places nothing on it (its
parameters and batches stay where they are made), so there is nothing
to shard here; ``launch/dryrun.py`` places a step on a mesh. ``--device cuda`` (the
default) raises when no card is visible. ``--ckpt-dir`` writes
``{"params": ...}`` in the npz layout both packages read.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import rng
from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import ExecConfig, ModelConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.runtime import configure


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_memory(cfg: ModelConfig, batch: int, i: int,
                device) -> torch.Tensor:
    """Train step i's cross-attention memory, as the reference draws it:
    0.02 N(0, 1) of shape (batch, cross_memory_len, d_model) from key
    i."""
    return rng.normal(rng.PRNGKey(i, device=device),
                      (batch, cfg.cross_memory_len, cfg.d_model)) * 0.02


def run(args, cfg: Optional[ModelConfig] = None,
        on_step=None) -> Dict[str, Any]:
    """Train as the CLI does, printing its lines, and return ``losses``
    and ``ces`` (floats per step), ``params``, ``opt_state``,
    ``s_per_step`` (the mean from the first step's start, as printed) and
    ``init_s``. ``cfg`` replaces the arch's config (a depth cut);
    ``on_step(i, params, opt_state)``, if given, is called with step
    i's new state."""
    dev = configure(args.device)
    if cfg is None:
        cfg = reduced_config(args.arch) if args.reduced \
            else get_config(args.arch)
    ec = ExecConfig(remat=args.remat,
                    compute_dtype="float32" if args.reduced else "bfloat16")
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                     remat=args.remat)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch)
    step_fn, opt = make_train_step(cfg, ec, tc)
    t0 = time.time()
    params = T.init_params(cfg, rng.PRNGKey(0, device=dev), ec,
                           param_dtype=torch.float32)
    opt_state = opt.init(params)
    _sync(dev)
    init_s = time.time() - t0
    losses, ces = [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = data.batch(i, device=dev)
        if cfg.has_cross_attention:
            batch["memory"] = step_memory(cfg, args.batch, i, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if on_step is not None:
            on_step(i, params, opt_state)
        losses.append(metrics["loss"])
        ces.append(metrics["ce"])
        if (i + 1) % args.log_every == 0 or i == 0:
            print(f"step {i+1:4d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    _sync(dev)
    s_per_step = (time.time() - t0) / max(args.steps, 1)
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps, {"params": params})
        print("checkpoint:", path)
    return {"cfg": cfg, "ec": ec, "params": params, "opt_state": opt_state,
            "losses": [float(x) for x in losses],
            "ces": [float(x) for x in ces],
            "s_per_step": s_per_step, "init_s": init_s}


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
