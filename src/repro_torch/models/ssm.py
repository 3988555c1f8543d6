"""Mamba2 block (state-space duality, SSD): the port of
``repro.models.ssm``.

The full-sequence path (prefill) runs the chunked SSD scan through the
``ssm_scan`` op (kernel 6 of ``kernels/ops``): on the card its CUDA
kernel, on the CPU its plain version (the sequential recurrence), which
take the place of the reference's ``ssd_chunked``. The decode step is the
O(1) recurrent update in plain torch, as in the reference.

Recurrence (per head h, channels P, state N):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t
    y_t = C_t · h_t + D * x_t
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.models.layers import rms_norm


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.state_dim


def mamba2_param_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, Pd, N = ssm_dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "in_proj": P.Leaf((d, 2 * d_inner + 2 * N + H), ("embed", "ssm_inner"), fan_in=d),
        "conv_w": P.Leaf((s.conv_width, conv_ch), ("conv", "ssm_conv")),
        "conv_b": P.Leaf((conv_ch,), ("ssm_conv",), init="zeros"),
        "A_log": P.Leaf((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": P.Leaf((H,), ("ssm_heads",), init="zeros"),
        "D": P.Leaf((H,), ("ssm_heads",), init="ones"),
        "norm": P.Leaf((d_inner,), ("ssm_inner",), init="ones"),
        "out_proj": P.Leaf((d_inner, d), ("ssm_inner", "embed"), fan_in=d_inner),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in x's type, tap by tap as the reference sums
    it. x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, :S] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + xp[:, i: i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _split_in_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, H, Pd, N = ssm_dims(cfg)
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)


def _forward(p, x: torch.Tensor, cfg: ModelConfig):
    """``mamba2_forward`` that also returns the conv's input (B, S, C),
    whose last W - 1 rows seed the decode cache."""
    d_inner, H, Pd, N = ssm_dims(cfg)
    proj = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xin, Bm, Cm, dt = _split_in_proj(cfg, proj)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    xh = xin.reshape(*xin.shape[:2], H, Pd)
    y, h_final = ops.ssm_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(*y.shape[:2], d_inner)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"].to(y.dtype)), h_final, conv_in


def mamba2_forward(p, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block. x: (B, S, d) -> (y, final state
    (B, H, P, N) float32)."""
    y, h_final, _ = _forward(p, x, cfg)
    return y, h_final


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype,
                      device) -> Dict[str, torch.Tensor]:
    d_inner, H, Pd, N = ssm_dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "state": torch.zeros((batch, H, Pd, N), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def mamba2_decode_step(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent update. x: (B, 1, d). Returns (y, new cache);
    the cache passed in is not modified."""
    d_inner, H, Pd, N = ssm_dims(cfg)
    f32 = torch.float32
    proj = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xin, Bm, Cm, dt = _split_in_proj(cfg, proj)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                # (B,1,C)
    window = torch.cat([cache["conv"], conv_in], dim=1)       # (B,W,C)
    w = p["conv_w"].to(x.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window, w)
                      + p["conv_b"].to(x.dtype))
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"].to(f32))  # (B,H)
    A = -torch.exp(p["A_log"].to(f32))
    xh = xin.reshape(-1, H, Pd).to(f32)                       # (B,H,P)
    decay = torch.exp(dt * A[None, :])
    h = cache["state"] * decay[:, :, None, None]
    h = h + (dt[:, :, None, None] * Bm.to(f32)[:, None, None, :]
             * xh[..., None])
    y = torch.einsum("bn,bhpn->bhp", Cm.to(f32), h)
    y = y + xh * p["D"].to(f32)[None, :, None]
    y = y.reshape(-1, 1, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(y.dtype))
    return out, {"state": h, "conv": window[:, 1:]}
