"""Step functions of the LLM paths: the port of ``make_optimizer``,
``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` of
``repro.launch.steps``.

  train_step    full fwd+bwd+AdamW update
  prefill_step  full forward, last-position logits
  serve_step    one-token decode + greedy sample

Parameters, optimizer state and caches are explicit arguments, as in the
reference. The train step is a pure function: it returns new parameter
and optimizer trees and writes nothing in place; the serve step updates
the cache in place and returns it. ``abstract_train_state`` and
``abstract_cache`` give the dry run's stand-ins on the ``meta`` device
(the reference's ``eval_shape``): no memory.
"""

from __future__ import annotations

import torch

from repro_torch.config import ExecConfig, ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.sharding.partition import whole
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import apply_updates, value_and_grad
from repro_torch.optim.schedule import warmup_cosine


def make_optimizer(tc: TrainConfig, total_steps: int = 10_000):
    lr = warmup_cosine(tc.learning_rate, tc.warmup_steps, total_steps)
    return adamw(lr, tc.beta1, tc.beta2, weight_decay=tc.weight_decay,
                 grad_clip=tc.grad_clip)


def make_train_step(cfg: ModelConfig, ec: ExecConfig, tc: TrainConfig):
    """(train_step, optimizer): ``train_step(params, opt_state, batch)``
    -> (params, opt_state, {"loss", "ce"}) for a batch of ``tokens``,
    ``labels`` and ``mask``."""
    opt = make_optimizer(tc)

    def loss_fn(params, batch):
        logits, aux = T.forward(cfg, ec, params, batch["tokens"],
                                batch.get("memory"))
        ce = softmax_cross_entropy(logits, batch["labels"], cfg.vocab,
                                   batch["mask"])
        return ce + aux, ce

    def train_step(params, opt_state, batch):
        (loss, ce), grads = value_and_grad(loss_fn, params, batch,
                                           has_aux=True)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "ce": ce}

    return train_step, opt


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
        # on a sharded vocabulary the pick needs the whole row
        logits = whole(logits[:, :, : cfg.vocab], -1)
        nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), cache
    return serve_step


def abstract_train_state(cfg: ModelConfig, ec: ExecConfig, tc: TrainConfig):
    """(params, opt_state) as ``meta`` tensors: the reference's float32
    parameters and the AdamW state over them."""
    params = T.abstract_params(cfg, ec)
    return params, make_optimizer(tc).init(params)


def abstract_cache(cfg: ModelConfig, ec: ExecConfig, batch: int,
                   cache_len: int, ring: bool):
    """The decode cache as ``meta`` tensors."""
    return T.init_cache(cfg, ec, batch, cache_len, ring, device="meta")
