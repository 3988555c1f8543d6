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
from repro_torch.kernels import ops, route
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


def _rows_whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor t (B, ..., n) with the dims between its first and last
    whole on every rank (gathered where sharded) and no partial sum: its
    rows then fold into (B ..., n) as DTensor places them. Anything else
    comes back as it is."""
    if not route.is_sharded(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p.is_partial() or (
        isinstance(p, Shard) and 0 < p.dim < t.dim() - 1) else p
        for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(
        t.device_mesh, pl)


class _RowsWholeGrad(torch.autograd.Function):
    """The identity forward; the backward applies ``_rows_whole`` to the
    gradient, which DTensor may return sharded along a middle dim (a
    partial sum reduce-scattered there), where the product's rows could
    not fold it."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _rows_whole(g)


def _for_product(x: torch.Tensor, w: torch.Tensor):
    """DTensors x (..., d) and w (d, n) placed for their product, on each
    mesh dim: where x's rows are sharded (a batch), w is whole there (a
    sharded weight gathered, as FSDP gathers it); else, where w's rows
    are sharded, x's columns are the rank's own (a local slice), and
    where w's columns are sharded, x is whole along d. Otherwise DTensor
    would move x's rows to w instead, or gather w and multiply it whole,
    or compute each rank's weight gradient whole, on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x, w
    last = Shard(x.dim() - 1)
    rows = [isinstance(px, Shard) and px.dim < x.dim() - 1
            for px in x.placements]
    wpl = [Replicate() if r else pw for r, pw in zip(rows, w.placements)]
    xpl = [last if pw == Shard(0) and px == Replicate()
           else Replicate() if pw == Shard(1) and px == last else px
           for px, pw in zip(x.placements, wpl)]
    if xpl != list(x.placements):
        x = x.redistribute(x.device_mesh, xpl)
    if wpl != list(w.placements):
        w = w.redistribute(w.device_mesh, wpl)
    return x, w


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) by w (d, n) as one product over the rows of x: what
    ``torch.matmul`` folds to for a dense x. A DTensor's ``matmul`` of a
    decode step's (B, 1, d) broadcasts w to a batched product instead,
    copying the weight shard once per row. On a DTensor x the rows fold
    only with no middle dim sharded (``_rows_whole``), in the forward
    and, for the gradient, in the backward; a partial sum (a residual
    stream after a row-parallel product) is summed first, as DTensor
    would otherwise gather w and run the whole product on every rank;
    and x is placed for w's sharding (``_for_product``)."""
    if not route.is_sharded(x, w):
        if x.dim() <= 2:
            return torch.matmul(x, w)
        y = torch.matmul(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    x, w = _for_product(_rows_whole(x), w)
    if x.dim() <= 2:
        return torch.matmul(x, w)
    y = torch.matmul(x.reshape(-1, x.shape[-1]), w)
    return _RowsWholeGrad.apply(y.reshape(*x.shape[:-1], w.shape[-1]))


def _heads_whole(x: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor x (..., n hd) sharded along its last dim over ways that
    do not divide n heads, gathered whole along it; else x."""
    if not route.is_sharded(x):
        return x
    from torch.distributed.tensor import Shard
    last = x.dim() - 1
    ways = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == last:
            ways *= x.device_mesh.size(i)
    return whole_along(x, last) if n % ways else x


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (..., n hd) as (..., n, hd). A DTensor sharded along the last dim
    over ways that do not divide n heads (xlstm's 4 heads on 16
    ``model`` ranks) is gathered whole along it first."""
    x = _heads_whole(x, n)
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


class _HeadsWholeGrad(torch.autograd.Function):
    """The identity forward; the backward gathers a gradient of (...,
    n hd) that ``split_heads`` would gather."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, n: int) -> torch.Tensor:
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _heads_whole(g, ctx.n), None


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """x (..., n, hd) as (..., n hd). On a DTensor, a gradient that comes
    back sharded over ways that do not divide the n heads is gathered
    before it is split into them again."""
    n = x.shape[-2]
    y = x.reshape(*x.shape[:-2], n * x.shape[-1])
    return _HeadsWholeGrad.apply(y, n) if route.is_sharded(y) else y


def whole_along(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with its dim ``dim`` whole on every rank: a DTensor sharded
    along it is gathered there (a collective the cost counter sees);
    anything else comes back as it is."""
    if not route.is_sharded(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim %= t.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = linear(x, w_gate.to(dt))
    u = linear(x, w_up.to(dt))
    return linear(F.silu(g) * u, w_down.to(dt))


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = linear(x, w_up.to(dt)) + b_up.to(dt)
    h = F.gelu(h, approximate="tanh")
    return linear(h, w_down.to(dt)) + b_down.to(dt)


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
