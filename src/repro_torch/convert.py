"""Carry a reference ``TrainerCarry`` across to the port.

The reference's carry, pulled to the host as numpy arrays (for example
with ``jax.device_get``), becomes the port's ``TrainerCarry`` on a chosen
device. Layouts stay the reference's: frames (B, H, W, C) uint8, conv
kernels HWIO, ``fc_w`` (flat, hidden) with its rows in the NHWC flatten
order that ``models.nature_cnn`` reproduces. Keys become (..., 2) int64
tensors of uint32 words; every other array keeps its dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.concurrent import TrainerCarry
from repro_torch.core.synchronized import SamplerState


def tensor_from_jax(x: Any, device="cpu") -> torch.Tensor:
    """One array; uint32 (key words) widen to int64."""
    a = np.array(x, dtype=np.int64 if np.asarray(x).dtype == np.uint32
                 else None, order="C", copy=True)
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
