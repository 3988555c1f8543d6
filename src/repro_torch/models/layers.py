"""Shared layer math: the port of ``repro.models.layers``: norms, RoPE,
MLPs and the cross-entropy loss of the transformer stack, and the
NoisyNet layers (Fortunato et al. 2018) of the Q-network.

``rms_norm`` goes through the RMSNorm kernel op (``kernels/ops``); the
MLP products are plain 2-D products (``linear``) in the input's type, as
the reference leaves them to XLA.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch._guards import detect_fake_mode

from repro_torch import rng
from repro_torch.kernels import ops
from repro_torch.roofline import cost


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with a float32 mean square, in x's type (kernel 5)."""
    return ops.rmsnorm(x, gamma, eps)


def _rope_freqs(head_dim: int, theta: float, device: torch.device):
    """The (head_dim//2,) float32 frequencies, made in numpy as the
    reference makes them and copied to ``device`` once: a host-to-device
    copy on every decode step would make the host wait for the card.
    Under ``FakeTensorMode`` (the dry run) they are made anew and not
    kept. Either way a cost counter does not see the copy, so a step
    counts the same on a card and on fake tensors."""
    if detect_fake_mode() is not None:
        return _make_rope_freqs(head_dim, theta, device)
    return _kept_rope_freqs(head_dim, theta, device)


def _make_rope_freqs(head_dim: int, theta: float, device: torch.device):
    freqs = theta ** (-np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    with cost.quiet():
        return torch.from_numpy(np.asarray(freqs, dtype=np.float32)).to(device)


_kept_rope_freqs = functools.lru_cache(maxsize=16)(_make_rope_freqs)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """(..., head_dim//2) float32 rotation angles for integer positions."""
    freqs = _rope_freqs(head_dim, float(theta), positions.device)
    return positions[..., None].to(torch.float32) * freqs


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """The rotation of ``rotate`` for integer positions (B, S) or (S,):
    float32 (cos, sin) of shape (B or 1, S, 1, head_dim), cos on both
    halves of the head dim and sin negated on the first. A stack makes
    them once for all its layers."""
    ang = rope_angles(positions, head_dim, theta)    # (B,S,D/2) or (S,D/2)
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([-sin, sin], dim=-1)[:, :, None, :])


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Half-split RoPE of x (B, S, H, D) by ``rope_tables``: the first and
    second halves of the head dim are the pair's two coordinates. It is
    the reference's [x1 cos - x2 sin, x2 cos + x1 sin] bit for bit (a
    product with -sin is the negated product, and a + (-b) is a - b), in
    five kernels instead of eight."""
    cos, sin = tables
    d = x.shape[-1]
    rot = torch.cat([x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return (x * cos + rot * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,) absolute token
    positions."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) by w (d, n) as one product over the rows of x: what
    ``torch.matmul`` folds to for a dense x."""
    if x.dim() <= 2:
        return torch.matmul(x, w)
    y = torch.matmul(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (..., n hd) as (..., n, hd)."""
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """x (..., n, hd) as (..., n hd)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, contract=linear) -> torch.Tensor:
    """``contract``: the product of x by an input weight (``Ranks.
    contract`` on a rank whose weights' rows are split)."""
    dt = x.dtype
    g = contract(x, w_gate.to(dt))
    u = contract(x, w_up.to(dt))
    return linear(F.silu(g) * u, w_down.to(dt))


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: Optional[torch.Tensor],
             contract=linear) -> torch.Tensor:
    """As ``swiglu``; without ``b_down`` the output bias is left out."""
    dt = x.dtype
    h = contract(x, w_up.to(dt)) + b_up.to(dt)
    h = F.gelu(h, approximate="tanh")
    h = linear(h, w_down.to(dt))
    return h if b_down is None else h + b_down.to(dt)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE, the reference's: padded vocab entries of
    ``logits`` are set to -1e9 so that the normalizer ignores them, the
    log-sum-exp is taken in float32, and with ``mask`` the mean is over
    max(sum(mask), 1). The label's logit is picked by a one-hot product,
    so that its backward is deterministic on the card."""
    vpad = logits.shape[-1]
    logits = logits.to(torch.float32)
    ids = torch.arange(vpad, device=logits.device)
    if vpad != vocab:
        logits = torch.where(ids >= vocab, -1e9, logits)
    lse = torch.logsumexp(logits, dim=-1)
    hot = (labels.long()[..., None] == ids).to(torch.float32)
    nll = lse - torch.sum(logits * hot, dim=-1)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def factorized_noise(key: torch.Tensor, n: int) -> torch.Tensor:
    """f(ε) = sign(ε)·√|ε| with ε ~ N(0, 1)."""
    x = rng.normal(key, (n,))
    return torch.sign(x) * rng.sqrt_f32(torch.abs(x))


def noisy_linear(x: torch.Tensor, w_mu: torch.Tensor, w_sigma: torch.Tensor,
                 b_mu: torch.Tensor, b_sigma: torch.Tensor,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Factorized-Gaussian noisy affine map:
    w = μ_w + σ_w ⊙ (f(ε_in) ⊗ f(ε_out)), b = μ_b + σ_b ⊙ f(ε_out).
    ``key=None`` is the noise-free μ-only path. With a leading replica
    axis R (x (R, B, in), weights (R, in, out), biases (R, out), keys
    (R, 2)) each replica draws its noise from its own key and the
    products are batched. The weights are drawn in their own dtype and
    cast to x's, in which the product runs."""
    dt = x.dtype
    if key is None:
        return x @ w_mu.to(dt) + b_mu.to(dt).unsqueeze(-2)
    k = rng.split(key)
    ein = factorized_noise(k[..., 0, :], w_mu.shape[-2])
    eout = factorized_noise(k[..., 1, :], w_mu.shape[-1])
    w = w_mu + w_sigma * (ein[..., :, None] * eout[..., None, :])
    b = b_mu + b_sigma * eout
    return x @ w.to(dt) + b.to(dt).unsqueeze(-2)
