"""Carry reference state across to the port.

The reference's arrays, pulled to the host as numpy arrays (for example
with ``jax.device_get``), become the port's tensors on a chosen device.
Layouts stay the reference's: for the DQN carry, frames (B, H, W, C)
uint8, conv kernels HWIO, ``fc_w`` (flat, hidden) with its rows in the
NHWC flatten order that ``models.nature_cnn`` reproduces; for the
transformer, the stacked ``layers/b0_attn/*`` parameters and the
(n_sb, B, Hkv, L, hd) caches, and the recurrent blocks' states, which
are tuples of arrays (the mLSTM's (C, n, m), the sLSTM's (c, n, h, m)).
Keys become (..., 2) int64 tensors of uint32 words; every other array
keeps its dtype. Optimizer state crosses for both optimizers (centered
RMSProp's moments, AdamW's moments and step), and both carries: the
concurrent ``TrainerCarry`` and the sequential modes' ``BaselineCarry``,
and the actor-learner's: the fused ``ALCarry`` and the state of a
``DisaggregatedActorLearner`` (parameters, AdamW state, replay).
A population carry is the concurrent carry with a leading replica axis
on every leaf, and crosses through the same functions: every conversion
here is per leaf and keeps the leading axes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.actor_learner import ALCarry
from repro_torch.core.baseline import BaselineCarry
from repro_torch.core.concurrent import TrainerCarry
from repro_torch.core.synchronized import SamplerState


def tensor_from_jax(x: Any, device="cpu") -> torch.Tensor:
    """One array; uint32 (key words) widen to int64, and bfloat16 (which
    numpy holds as ml_dtypes' type) crosses as float32 exactly."""
    dt = np.asarray(x).dtype
    if dt.name == "bfloat16":
        a = np.array(x, dtype=np.float32, order="C", copy=True)
        return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
    a = np.array(x, dtype=np.int64 if dt == np.uint32 else None, order="C",
                 copy=True)
    return torch.from_numpy(a).to(device)


def _dict(tree: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: tensor_from_jax(v, device) for k, v in tree.items()}


def params_from_jax(params: Mapping[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """The Q-network's flat parameter dict."""
    return _dict(params, device)


def opt_state_from_jax(opt_state: Mapping[str, Any], device="cpu") -> Dict:
    """An optimizer's state: centered RMSProp's ``s`` and ``g`` moment
    dicts, or AdamW's ``m`` and ``v`` dicts (flat, or nested as the
    transformer's parameters) and its int32 ``step``."""
    return {k: tree_from_jax(v, device) for k, v in opt_state.items()}


def _sampler(s: Any, device) -> SamplerState:
    return SamplerState(_dict(s.env_states, device),
                        tensor_from_jax(s.stack, device),
                        tensor_from_jax(s.key, device))


def _i32(x: Any, device) -> torch.Tensor:
    return tensor_from_jax(x, device).to(torch.int32)


def carry_from_jax(carry: Any, device="cpu") -> TrainerCarry:
    """A reference ``TrainerCarry`` (params, opt_state, replay, sampler,
    step, seed) as the port's; a population's, with its leading replica
    axis, as the port's population carry."""
    return TrainerCarry(params_from_jax(carry.params, device),
                        opt_state_from_jax(carry.opt_state, device),
                        _dict(carry.replay, device),
                        _sampler(carry.sampler, device),
                        _i32(carry.step, device), _i32(carry.seed, device))


def baseline_carry_from_jax(carry: Any, device="cpu") -> BaselineCarry:
    """A reference ``BaselineCarry`` (params, target_params, opt_state,
    replay, sampler, step, group) as the port's."""
    return BaselineCarry(params_from_jax(carry.params, device),
                         params_from_jax(carry.target_params, device),
                         opt_state_from_jax(carry.opt_state, device),
                         _dict(carry.replay, device),
                         _sampler(carry.sampler, device),
                         _i32(carry.step, device), _i32(carry.group, device))


def tree_from_jax(tree: Any, device="cpu") -> Any:
    """A nested dict (or tuple) of arrays (transformer parameters, a
    decode cache, a carry's parts) as the same nesting of tensors on
    ``device``, leading axes kept; a cache's int32 ``pos`` and bool
    ``ring`` become device scalars. A NamedTuple stays a tuple of its
    fields."""
    if isinstance(tree, Mapping):
        return {k: tree_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_from_jax(v, device) for v in tree)
    return tensor_from_jax(tree, device)


def al_carry_from_jax(carry: Any, device="cpu") -> ALCarry:
    """A reference ``ALCarry`` (params, opt_state, seqs, rewards, cursor,
    size, step) as the port's."""
    return ALCarry(tree_from_jax(carry.params, device),
                   opt_state_from_jax(carry.opt_state, device),
                   _i32(carry.seqs, device),
                   tensor_from_jax(carry.rewards, device),
                   _i32(carry.cursor, device), _i32(carry.size, device),
                   _i32(carry.step, device))


def disaggregated_from_jax(dst: Any, params: Any, opt_state: Any, seqs: Any,
                           advs: Any, cursor: int, size: int,
                           step: int) -> Any:
    """Load a reference ``DisaggregatedActorLearner``'s state (its
    ``params``, ``opt_state``, ``seqs`` and ``advs`` as numpy arrays, its
    Python-int ``cursor``, ``size`` and ``step``) into the port's
    ``dst``, on ``dst``'s learner device; returns ``dst``."""
    dev = dst.learner_device
    dst.params = tree_from_jax(params, dev)
    dst.opt_state = opt_state_from_jax(opt_state, dev)
    dst.seqs = _i32(seqs, dev)
    dst.advs = tensor_from_jax(advs, dev)
    dst.cursor, dst.size, dst.step = int(cursor), int(size), int(step)
    return dst
