"""The Nature-DQN convolutional Q-network (Mnih et al. 2015): the port of
``repro.models.nature_cnn``.

Parameters are a flat dict of tensors in the reference's layouts: conv
kernels HWIO, linear weights (in, out). Frames come in as
(B, H, W, C) uint8 and are scaled to [0, 1] on the device. The convs run
in NCHW through ``torch.nn.functional.conv2d`` on kernels permuted to
OIHW; the last conv's output is permuted back to NHWC before the
flatten, so ``fc_w``'s rows keep the reference's order. A config with
``vector_dim > 0`` (the ``mlp`` and ``mlp_tiny`` presets) takes
(B, D, K) float32 state-vector stacks instead: no convs and no /255,
the stack flattened straight into ``fc_w``.

A population's parameters have a leading replica axis R on every leaf
and its frames a leading R before the batch: (R, B, H, W, C) in,
(R, B, A) out. The R replicas' convs run as one grouped convolution
(``groups=R``, the replicas' channels side by side) and their linears as
batched products; a noise key (R, 2) gives each replica its own draws.

Head families: dueling (V + A - mean A), C51 (``num_atoms > 1``:
``q_logits`` gives (B, A, K) logits, ``q_forward`` their expectation over
the support) and NoisyNet (noisy post-conv linears; ``noise_key=None``
is the μ-only path). The trunk's linear draws its noise from
``fold_in(noise_key, 0)``, the heads from ``fold_in(noise_key, 1)``
(value or output) and ``fold_in(noise_key, 2)`` (advantage).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs.dqn_nature import NatureCNNConfig
from repro_torch.kernels.ops import support
from repro_torch.models import params as P
from repro_torch.models.layers import noisy_linear

Params = Dict[str, torch.Tensor]


def _linear_spec(spec: Dict[str, Any], name: str, d_in: int, d_out: int,
                 cfg: NatureCNNConfig, axes=("mlp", None)) -> None:
    spec[f"{name}_w"] = P.Leaf((d_in, d_out), axes, fan_in=d_in)
    spec[f"{name}_b"] = P.Leaf((d_out,), (axes[1],), init="zeros")
    if cfg.noisy:
        sigma = cfg.noisy_sigma0 / float(np.sqrt(d_in))
        spec[f"{name}_w_sigma"] = P.Leaf((d_in, d_out), axes, init="const",
                                         value=sigma)
        spec[f"{name}_b_sigma"] = P.Leaf((d_out,), (axes[1],), init="const",
                                         value=sigma)


def q_param_spec(cfg: NatureCNNConfig, n_actions: int) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if cfg.vector_dim:
        # vector mode: an fc-only trunk on the stacked state vectors
        flat = cfg.vector_dim * cfg.frame_stack
    else:
        in_ch = cfg.frame_stack
        size = cfg.frame_size
        for i, (out_ch, k, s) in enumerate(cfg.convs):
            spec[f"conv{i}_w"] = P.Leaf((k, k, in_ch, out_ch),
                                        (None, None, None, "mlp"),
                                        fan_in=k * k * in_ch)
            spec[f"conv{i}_b"] = P.Leaf((out_ch,), ("mlp",), init="zeros")
            size = (size - k) // s + 1
            in_ch = out_ch
        flat = size * size * in_ch
    K = cfg.num_atoms
    spec["fc_w"] = P.Leaf((flat, cfg.hidden), (None, "mlp"), fan_in=flat)
    spec["fc_b"] = P.Leaf((cfg.hidden,), ("mlp",), init="zeros")
    if cfg.noisy:
        sigma = cfg.noisy_sigma0 / float(np.sqrt(flat))
        spec["fc_w_sigma"] = P.Leaf((flat, cfg.hidden), (None, "mlp"),
                                    init="const", value=sigma)
        spec["fc_b_sigma"] = P.Leaf((cfg.hidden,), ("mlp",), init="const",
                                    value=sigma)
    if cfg.dueling:
        _linear_spec(spec, "val", cfg.hidden, K, cfg)
        _linear_spec(spec, "adv", cfg.hidden, n_actions * K, cfg)
    else:
        _linear_spec(spec, "out", cfg.hidden, n_actions * K, cfg)
    return spec


def q_init(cfg: NatureCNNConfig, n_actions: int, key: torch.Tensor) -> Params:
    """Parameters on ``key``'s device."""
    return P.init_tree(q_param_spec(cfg, n_actions), key)


def _affine(params: Params, name: str, x: torch.Tensor, cfg: NatureCNNConfig,
            noise_key: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.noisy:
        return noisy_linear(x, params[f"{name}_w"], params[f"{name}_w_sigma"],
                            params[f"{name}_b"], params[f"{name}_b_sigma"],
                            key=noise_key)
    return x @ params[f"{name}_w"] + params[f"{name}_b"].unsqueeze(-2)


def _convs(params: Params, frames: torch.Tensor,
           cfg: NatureCNNConfig) -> torch.Tensor:
    """(R, B, H, W, C) frames -> (R, B, flat) NHWC-flattened features.
    The R replicas run as one grouped convolution: the input's channels
    are the replicas' C channels side by side, each kernel (R, k, k, I,
    O) becomes R O output filters over its own replica's I channels."""
    R, B = frames.shape[:2]
    scale = torch.full((), 255.0, dtype=torch.float32, device=frames.device)
    x = (frames.to(torch.float32) / scale).permute(1, 0, 4, 2, 3)
    x = x.reshape((B, -1) + x.shape[3:])                  # (B, R C, H, W)
    for i, (_, k, s) in enumerate(cfg.convs):
        w = params[f"conv{i}_w"]                          # (R, k, k, I, O)
        w = w.permute(0, 4, 3, 1, 2).reshape((-1,) + (w.shape[3], k, k))
        x = F.conv2d(x, w, stride=s, groups=R)
        x = torch.relu(x + params[f"conv{i}_b"].reshape(-1)[:, None, None])
    x = x.reshape((B, R, -1) + x.shape[2:])               # (B, R, O, h, w)
    return x.permute(1, 0, 3, 4, 2).reshape(R, B, -1)     # NHWC flatten


def _trunk(params: Params, frames: torch.Tensor, cfg: NatureCNNConfig,
           noise_key: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.vector_dim:
        # (..., B, D, K) float32 state vectors, already in [0, 1]: no /255
        x = frames.to(torch.float32).flatten(-2)
    elif params["fc_w"].dim() == 3:                       # a population
        x = _convs(params, frames, cfg)
    else:
        x = _convs({k: v[None] for k, v in params.items()}, frames[None],
                   cfg)[0]
    kfc = rng.fold_in(noise_key, 0) if noise_key is not None else None
    return torch.relu(_affine(params, "fc", x, cfg, kfc))


def _head_keys(noise_key: Optional[torch.Tensor]):
    if noise_key is None:
        return None, None
    return rng.fold_in(noise_key, 1), rng.fold_in(noise_key, 2)


def q_logits(params: Params, frames: torch.Tensor, cfg: NatureCNNConfig,
             noise_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """frames: (B, H, W, C) uint8 -> categorical logits (B, A, K) float32
    ((R, B, ...) -> (R, B, A, K) for a population)."""
    x = _trunk(params, frames, cfg, noise_key)
    K = cfg.num_atoms
    kv, ka = _head_keys(noise_key)
    if cfg.dueling:
        v = _affine(params, "val", x, cfg, kv)                 # (B, K)
        a = _affine(params, "adv", x, cfg, ka).unflatten(-1, (-1, K))
        return v.unsqueeze(-2) + a - a.mean(dim=-2, keepdim=True)
    return _affine(params, "out", x, cfg, kv).unflatten(-1, (-1, K))


def q_forward(params: Params, frames: torch.Tensor, cfg: NatureCNNConfig,
              noise_key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """frames: (B, H, W, C) uint8 -> Q-values (B, n_actions) float32
    ((R, B, ...) -> (R, B, A) for a population). C51 configs return the
    expectation of softmax(logits) over the support."""
    if cfg.num_atoms > 1:
        logits = q_logits(params, frames, cfg, noise_key)
        z = support(cfg.num_atoms, cfg.v_min, cfg.v_max, device=frames.device)
        return (torch.softmax(logits, dim=-1) * z).sum(dim=-1)
    x = _trunk(params, frames, cfg, noise_key)
    kv, ka = _head_keys(noise_key)
    if cfg.dueling:
        v = _affine(params, "val", x, cfg, kv)
        a = _affine(params, "adv", x, cfg, ka)
        return v + a - a.mean(dim=-1, keepdim=True)
    return _affine(params, "out", x, cfg, kv)
