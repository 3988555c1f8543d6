"""Step functions of the LLM serve path: the port of ``make_prefill_step``
and ``make_serve_step`` of ``repro.launch.steps``.

  prefill_step  full forward, last-position logits
  serve_step    one-token decode + greedy sample

Parameters and caches are explicit arguments, as in the reference; the
serve step updates the cache in place and returns it.
"""

from __future__ import annotations

import torch

from repro_torch.config import ExecConfig, ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, ec: ExecConfig):
    def prefill_step(params, batch):
        logits, _ = T.forward(cfg, ec, params, batch["tokens"],
                              batch.get("memory"))
        return logits[:, -1, : cfg.vocab]
    return prefill_step


def make_serve_step(cfg: ModelConfig, ec: ExecConfig, ring: bool = False):
    """One new token against the cache: (params, cache, tokens (B,1)) ->
    (next_token (B,1) int32, cache). The greedy pick is the first maximal
    logit over the unpadded vocabulary, as ``jnp.argmax`` takes it."""
    def serve_step(params, cache, tokens):
        logits, cache = T.decode_step(cfg, ec, params, cache, tokens,
                                      ring=ring)
        nxt = torch.argmax(logits[:, :, : cfg.vocab], dim=-1)
        return nxt.to(torch.int32), cache
    return serve_step
