"""DQN losses and the gradient update: the port of ``repro.core.dqn``.

``q_loss_variant`` is Eq. (1) with Huber clipping plus the variant
toggles (double, n-step bootstrap γⁿ, PER importance weights, NoisyNet
keys); ``c51_loss_variant`` is the distributional cross-entropy against
the ``categorical_projection`` of the target distribution.
``make_update_fn`` takes gradients with autograd where the reference
uses ``jax.value_and_grad``; ``.detach()`` stands for ``stop_gradient``.

Every pick of one action's row from a tensor that needs a gradient is a
product with a one-hot mask, not a gather: the backward of a gather is a
scatter-add, whose CUDA form is not deterministic, and the product gives
the same values and gradients.

A population's minibatch has a leading replica axis R ((R, B, ...)
against (R, ...) parameters). Each loss is then (R,), every replica's
mean over its own minibatch, and the update takes one gradient of their
sum: replica r's parameters reach only its own loss, so each gets its
own gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch import rng
from repro_torch.config import DQNConfig, VariantConfig
from repro_torch.kernels import ops as kops
from repro_torch.optim.base import apply_updates


def _with_noise(q_forward: Callable, noise_key: Optional[torch.Tensor]):
    """Forward call site i draws its noise from fold_in(noise_key, i)."""
    if noise_key is None:
        return lambda p, o, i: q_forward(p, o)
    return lambda p, o, i: q_forward(p, o, rng.fold_in(noise_key, i))


def _pick(x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """x[..., b, action[..., b]] along the action axis (the one after
    action's axes), as a one-hot product."""
    ax = action.dim()
    classes = torch.arange(x.shape[ax], device=x.device)
    onehot = (action.long()[..., None] == classes).to(x.dtype)
    if x.dim() == ax + 2:
        onehot = onehot[..., None]
    return (x * onehot).sum(dim=ax)


def _take(x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """x[..., b, action[..., b]] along the action axis for a tensor
    without a gradient."""
    ax = action.dim()
    idx = action.long().reshape(action.shape + (1,) * (x.dim() - ax))
    return torch.gather(x, ax, idx.expand(action.shape + (1,)
                                          + x.shape[ax + 1:])).squeeze(ax)


def _detached(params):
    return {k: v.detach() for k, v in params.items()}


def q_loss_variant(params, target_params, batch: Dict[str, torch.Tensor],
                   q_forward: Callable, discount: float,
                   variant: VariantConfig,
                   noise_key: Optional[torch.Tensor] = None):
    """Variant-aware Eq. (1). Returns (loss, per-sample |td|): the loss
    is a scalar, or (R,) for a population's minibatch."""
    qf = _with_noise(q_forward, noise_key)
    q = qf(params, batch["obs"], 0)                              # (B, A)
    qa = _pick(q, batch["action"])
    with torch.no_grad():
        q_next = qf(target_params, batch["next_obs"], 1)
        if variant.double:
            q_next_online = qf(_detached(params), batch["next_obs"], 2)
            bootstrap = _take(q_next, torch.argmax(q_next_online, dim=-1))
        else:
            bootstrap = q_next.max(dim=-1).values
        disc_n = discount ** variant.n_step
        y = batch["reward"] + disc_n * torch.where(
            batch["done"], torch.zeros_like(bootstrap), bootstrap)
    td = y - qa
    abs_td = torch.abs(td)
    huber = torch.where(abs_td <= 1.0, 0.5 * td * td, abs_td - 0.5)
    if "weight" in batch:
        loss = (batch["weight"] * huber).mean(dim=-1)
    else:
        loss = huber.mean(dim=-1)
    return loss, abs_td.detach()


def c51_loss_variant(params, target_params, batch: Dict[str, torch.Tensor],
                     q_logits: Callable, discount: float,
                     variant: VariantConfig,
                     noise_key: Optional[torch.Tensor] = None):
    """Distributional (C51) cross-entropy loss (Bellemare et al. 2017).
    Returns (loss, per-sample cross-entropy), the latter being the PER
    priority signal; the loss is a scalar, or (R,) for a population."""
    qf = _with_noise(q_logits, noise_key)
    logits = qf(params, batch["obs"], 0)                         # (B, A, K)
    logp_a = _pick(torch.log_softmax(logits, dim=-1), batch["action"])
    with torch.no_grad():
        z = kops.support(variant.num_atoms, variant.v_min, variant.v_max,
                         device=logits.device)
        tgt_probs = torch.softmax(qf(target_params, batch["next_obs"], 1),
                                  dim=-1)                        # (B, A, K)
        if variant.double:
            online_next = qf(_detached(params), batch["next_obs"], 2)
            q_next = (torch.softmax(online_next, dim=-1) * z).sum(dim=-1)
        else:
            q_next = (tgt_probs * z).sum(dim=-1)                 # (B, A)
        p_t = _take(tgt_probs, torch.argmax(q_next, dim=-1))     # (B, K)
        disc_n = discount ** variant.n_step
        m = kops.categorical_projection(
            p_t, batch["reward"], batch["done"], v_min=variant.v_min,
            v_max=variant.v_max, gamma_n=disc_n)
    ce = -(m * logp_a).sum(dim=-1)                               # (B,)
    if "weight" in batch:
        loss = (batch["weight"] * ce).mean(dim=-1)
    else:
        loss = ce.mean(dim=-1)
    return loss, ce.detach()


def make_update_fn(q_forward: Callable, opt, cfg: DQNConfig,
                   variant: Optional[VariantConfig] = None,
                   q_logits: Optional[Callable] = None):
    """One minibatch gradient step:
    update(params, target_params, opt_state, batch, noise_key=None)
    -> (params', opt_state', loss, per-sample priority signal), the loss
    (R,) for a population.
    ``variant=None`` takes ``cfg.variant`` with the n-step discount
    neutralized (the reference's legacy contract for 1-step paths)."""
    v = variant if variant is not None else dataclasses.replace(
        cfg.variant, n_step=1)
    if v.distributional:
        assert q_logits is not None, \
            "distributional variants need the q_logits callable"

        def loss_fn(params, target_params, batch, noise_key):
            return c51_loss_variant(params, target_params, batch, q_logits,
                                    cfg.discount, v, noise_key)
    else:
        def loss_fn(params, target_params, batch, noise_key):
            return q_loss_variant(params, target_params, batch, q_forward,
                                  cfg.discount, v, noise_key)

    def update(params, target_params, opt_state, batch, noise_key=None):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            loss, td_abs = loss_fn(leaves, target_params, batch, noise_key)
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        grads = dict(zip(leaves, grads))
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach(), td_abs

    return update
