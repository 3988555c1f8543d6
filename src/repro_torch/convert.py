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
keeps its dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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


def opt_state_from_jax(opt_state: Mapping[str, Mapping[str, Any]],
                       device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """Centered RMSProp state: the ``s`` and ``g`` moment dicts."""
    return {k: _dict(v, device) for k, v in opt_state.items()}


def carry_from_jax(carry: Any, device="cpu") -> TrainerCarry:
    """A reference ``TrainerCarry`` (params, opt_state, replay, sampler,
    step, seed) as the port's."""
    s = carry.sampler
    sampler = SamplerState(_dict(s.env_states, device),
                           tensor_from_jax(s.stack, device),
                           tensor_from_jax(s.key, device))
    return TrainerCarry(params_from_jax(carry.params, device),
                        opt_state_from_jax(carry.opt_state, device),
                        _dict(carry.replay, device), sampler,
                        tensor_from_jax(carry.step, device).to(torch.int32),
                        tensor_from_jax(carry.seed, device).to(torch.int32))


def tree_from_jax(tree: Any, device="cpu") -> Any:
    """A nested dict (or tuple) of arrays (transformer parameters, a
    decode cache) as the same nesting of tensors on ``device``; a cache's
    int32 ``pos`` and bool ``ring`` become device scalars."""
    if isinstance(tree, Mapping):
        return {k: tree_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_from_jax(v, device) for v in tree)
    return tensor_from_jax(tree, device)
