"""Batched serving on PyTorch: prefill, then greedy decode with the KV
cache. The port of ``repro.launch.serve``, on the card unless asked for
the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \\
      --no-reduced --batch 8 --prompt-len 1024 --gen 64

The weights are random, drawn from key 0 as the reference draws them,
and so are the prompts and, for an arch with cross-attention, the memory
(0.02 N(0, 1) of shape (batch, cross_memory_len, d_model): the VLM's
patch embeddings, whisper's frame embeddings). A full cache
(``--window 0``) is filled by one fused prefill forward, which also
writes the memory's K/V; a ring cache (``--window W``) gets the memory's
K/V from ``prefill_cross_cache`` and is filled token by token through the
decode step, as the reference does. Reduced configs
run in float32, full-size ones in bfloat16 (the reference's rule).
``--device cuda`` (the default) raises when no card is visible.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import rng
from repro_torch.config import ExecConfig, ModelConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.runtime import configure


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="ring-buffer window (0 = full cache)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, params: Optional[Any] = None,
        cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Serve one batch as the CLI does and return what it measured:
    ``tokens`` (B, gen) int32, ``prefill_logits`` (the last prompt
    position's logits over the vocabulary, fused prefill only), the
    timings, ``memory`` (None without cross-attention) and ``params``
    (pass them back in to serve again without a new init). ``cfg``
    replaces the arch's config (a depth cut)."""
    dev = configure(args.device)
    if cfg is None:
        cfg = reduced_config(args.arch) if args.reduced \
            else get_config(args.arch)
    ec = ExecConfig(compute_dtype="float32" if args.reduced else "bfloat16")
    ring = args.window > 0
    cache_len = args.window if ring else args.prompt_len + args.gen
    serve = make_serve_step(cfg, ec, ring=ring)

    key = rng.PRNGKey(0, device=dev)
    t0 = time.perf_counter()
    fresh = params is None
    if fresh:
        params = T.init_params(cfg, key, ec)
        _sync(dev)
    init_s = time.perf_counter() - t0
    prompts = rng.randint(key, (args.batch, args.prompt_len), 0, cfg.vocab)
    memory = None
    if cfg.has_cross_attention:
        memory = rng.normal(key, (args.batch, cfg.cross_memory_len,
                                  cfg.d_model)) * 0.02

    _sync(dev)
    t0 = time.perf_counter()
    prefill_logits = None
    if ring:
        # ring caches prefill token by token (window semantics)
        cache = T.init_cache(cfg, ec, args.batch, cache_len, ring, device=dev)
        if memory is not None:
            cache = T.prefill_cross_cache(cfg, ec, params, cache, memory)
        for i in range(args.prompt_len):
            nxt, cache = serve(params, cache, prompts[:, i:i + 1])
    else:
        # fused prefill: one forward pass builds the decode cache
        logits, _, cache = T.forward(cfg, ec, params, prompts, memory,
                                     collect_cache_len=cache_len)
        prefill_logits = logits[:, -1, : cfg.vocab]
        nxt = torch.argmax(logits[:, -1:, : cfg.vocab], dim=-1)
        nxt = nxt.to(torch.int32)
        del logits
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = [nxt]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        nxt, cache = serve(params, cache, out[-1])
        out.append(nxt)
    _sync(dev)
    dt = time.perf_counter() - t0
    steps = max(args.gen - 1, 1)
    toks = torch.cat(out, dim=1)
    res = {"cfg": cfg, "ec": ec, "params": params, "tokens": toks,
           "memory": memory,
           "prefill_logits": prefill_logits, "cache": cache,
           "init_s": init_s, "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_step": dt / steps * 1e3,
           "tok_s": args.batch * (args.gen - 1) / dt if dt > 0 else 0.0,
           "param_count": P.param_count(T.model_param_spec(cfg, ec))}
    print(f"{cfg.arch_id} ({'reduced' if args.reduced else 'full'}, "
          f"{ec.compute_dtype}, {res['param_count']} parameters) on {dev}: "
          + (f"init {init_s:.2f} s" if fresh else "parameters passed in"))
    print("generated shape:", tuple(toks.shape))
    print(f"prefill: {res['prefill_ms']:.1f} ms "
          f"({'token by token into a ' + str(cache_len) + '-slot ring' if ring else 'fused'}"
          f", batch {args.batch} x {args.prompt_len} tokens)")
    print(f"decode throughput: {res['tok_s']:.1f} tok/s "
          f"({res['decode_ms_per_step']:.2f} ms/step)")
    print("sample:", toks[0, :16].tolist())
    return res


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
