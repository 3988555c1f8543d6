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

On a mesh whose ``model`` ranks split the heads (``sharding/
partition.py``) a rank runs the block on its heads: its columns of z, x
and dt, all of B and C, its conv channels; y is normalized whole and
multiplied by the rank's rows of out_proj.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.models.layers import linear, rms_norm
from repro_torch.sharding.ranks import PLAIN, Ranks

# the block's leaves, in the order ``sharding/partition.py`` passes them
PARAMS = ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm",
          "out_proj")


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


def _mix(proj: torch.Tensor, conv_w, conv_b, dt_bias, A_log, D, dims,
         chunk: int):
    """The block between its two products, on in_proj's output ``proj``
    (B, S, 2 d_inner + 2 N + H) for ``dims`` = (d_inner, H, P, N): the
    conv, the SSD scan, the skip and the gate. Returns (y (B, S, d_inner)
    before the norm, the final state, the conv's input)."""
    d_inner, H, Pd, N = dims
    z, xin, Bm, Cm, dt = torch.split(proj, [d_inner, d_inner, N, N, H],
                                     dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, conv_w, conv_b))
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))
    xh = xin.reshape(*xin.shape[:2], H, Pd)
    y, h_final = ops.ssm_scan(xh, dt, A, Bm, Cm, chunk=chunk)
    y = y + xh * D.to(y.dtype)[None, None, :, None]
    y = y.reshape(*y.shape[:2], d_inner)
    return y * F.silu(z), h_final, conv_in


def _cols(t: torch.Tensor, *spans) -> torch.Tensor:
    """The spans (start, width) of t's last dim, side by side."""
    return torch.cat([t.narrow(-1, a, b) for a, b in spans], dim=-1)


def _head_split(cfg: ModelConfig, ranks: Ranks):
    """(heads, their channels, the x channels' start) of this rank's
    heads: all of them on one rank."""
    d_inner, H, Pd, N = ssm_dims(cfg)
    hl = H // ranks.n_model
    return hl, hl * Pd, ranks.model_rank * hl * Pd


def _forward(p, x: torch.Tensor, cfg: ModelConfig, ranks: Ranks = PLAIN):
    """``mamba2_forward`` that also returns the conv's input (B, S, C),
    whose last W - 1 rows seed the decode cache: the rank's heads'
    channels of x and all of B and C, on a rank of heads split over the
    model ranks (in_proj, the conv and the norm whole)."""
    d_inner, H, Pd, N = ssm_dims(cfg)
    hl, dl, c0 = _head_split(cfg, ranks)
    w, cw, cb = p["in_proj"], p["conv_w"], p["conv_b"]
    if dl < d_inner:
        conv = ((c0, dl), (d_inner, 2 * N))
        w = _cols(w, (c0, dl), (d_inner + c0, dl), (2 * d_inner, 2 * N),
                  (2 * d_inner + 2 * N + c0 // Pd, hl))
        cw, cb = _cols(cw, *conv), _cols(cb, *conv)
    proj = ranks.contract(x, w.to(x.dtype))
    y, h_final, conv_in = _mix(proj, cw, cb, p["dt_bias"], p["A_log"],
                               p["D"], (dl, hl, Pd, N), cfg.ssm.chunk)
    return _out(p, y, cfg, ranks), h_final, conv_in


def _out(p, y: torch.Tensor, cfg: ModelConfig, ranks: Ranks):
    """The norm over the whole inner width (the rank's channels gathered
    first) and out_proj on the rank's rows."""
    y = rms_norm(ranks.gather(y, -1), p["norm"], cfg.norm_eps)
    rows = p["out_proj"].shape[0]
    if rows < y.shape[-1]:
        y = y.narrow(-1, ranks.model_rank * rows, rows)
    return linear(y, p["out_proj"].to(y.dtype))


def conv_tail(conv_in: torch.Tensor, cfg: ModelConfig,
              ranks: Ranks = PLAIN) -> torch.Tensor:
    """The last W - 1 rows of the conv's input (``_forward``), all its
    channels: the rank's x channels gathered over the model ranks."""
    tail = conv_in[:, -(cfg.ssm.conv_width - 1):]
    if ranks.model is None:
        return tail
    dl = _head_split(cfg, ranks)[1]
    return torch.cat([ranks.gather(tail[..., :dl], -1), tail[..., dl:]],
                     dim=-1)


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
                       cfg: ModelConfig, ranks: Ranks = PLAIN
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent update. x: (B, 1, d). Returns (y, new cache);
    the cache passed in is not modified."""
    d_inner, H, Pd, N = ssm_dims(cfg)
    f32 = torch.float32
    proj = ranks.contract(x, p["in_proj"].to(x.dtype))
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
    out = linear(y, p["out_proj"].to(y.dtype))
    return out, {"state": h, "conv": window[:, 1:]}


def decode_into(p, x: torch.Tensor, state: torch.Tensor,
                conv: torch.Tensor, cfg: ModelConfig,
                ranks: Ranks = PLAIN) -> torch.Tensor:
    """``mamba2_decode_step`` with the new state and conv window written
    into ``state`` and ``conv`` in place; returns y. On a rank of heads
    split over the model ranks: in_proj's output of the rank's columns
    gathered whole, the conv window whole (every rank writes the same),
    the conv, the state and y of the rank's heads."""
    if ranks.model is None:
        y, new = mamba2_decode_step(p, x, {"state": state, "conv": conv},
                                    cfg, ranks)
        state.copy_(new["state"])
        conv.copy_(new["conv"])
        return y
    d_inner, H, Pd, N = ssm_dims(cfg)
    hl, dl, c0 = _head_split(cfg, ranks)
    f32 = torch.float32
    proj = ranks.contract(x, p["in_proj"].to(x.dtype))
    if proj.shape[-1] < 2 * d_inner + 2 * N + H:
        proj = ranks.gather(proj, -1)
    z, xin, Bm, Cm, dt = _split_in_proj(cfg, proj)
    window = torch.cat([conv, torch.cat([xin, Bm, Cm], dim=-1)], dim=1)
    spans = ((c0, dl), (d_inner, 2 * N))
    w = _cols(p["conv_w"], *spans).to(x.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", _cols(window, *spans), w)
                      + _cols(p["conv_b"], *spans).to(x.dtype))
    xin, Bm, Cm = torch.split(conv_out, [dl, N, N], dim=-1)
    dt = F.softplus(dt[:, 0, c0 // Pd: c0 // Pd + hl].to(f32)
                    + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    xh = xin.reshape(-1, hl, Pd).to(f32)
    h = state * torch.exp(dt * A[None, :])[:, :, None, None]
    h = h + (dt[:, :, None, None] * Bm.to(f32)[:, None, None, :]
             * xh[..., None])
    y = torch.einsum("bn,bhpn->bhp", Cm.to(f32), h)
    y = y + xh * p["D"].to(f32)[None, :, None]
    y = y.reshape(-1, 1, dl).to(x.dtype) * F.silu(z.narrow(-1, c0, dl))
    state.copy_(h)
    conv.copy_(window[:, 1:])
    return _out(p, y, cfg, ranks)
