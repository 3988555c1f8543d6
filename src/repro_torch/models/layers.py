"""NoisyNet layers (Fortunato et al. 2018): the port of
``repro.models.layers.factorized_noise`` and ``noisy_linear``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import rng


def factorized_noise(key: torch.Tensor, n: int) -> torch.Tensor:
    """f(ε) = sign(ε)·√|ε| with ε ~ N(0, 1)."""
    x = rng.normal(key, (n,))
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def noisy_linear(x: torch.Tensor, w_mu: torch.Tensor, w_sigma: torch.Tensor,
                 b_mu: torch.Tensor, b_sigma: torch.Tensor,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Factorized-Gaussian noisy affine map:
    w = μ_w + σ_w ⊙ (f(ε_in) ⊗ f(ε_out)), b = μ_b + σ_b ⊙ f(ε_out).
    ``key=None`` is the noise-free μ-only path."""
    if key is None:
        return x @ w_mu + b_mu
    k = rng.split(key)
    ein = factorized_noise(k[0], w_mu.shape[0])
    eout = factorized_noise(k[1], w_mu.shape[1])
    w = w_mu + w_sigma * torch.outer(ein, eout)
    b = b_mu + b_sigma * eout
    return x @ w + b
