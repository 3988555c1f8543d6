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

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, route
from repro_torch.models import params as P
from repro_torch.models.layers import linear, rms_norm


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
    it. x: (B, S, C); w: (W, C). On DTensors each rank convolves its
    batch rows and, where w's channels are sharded, its channels
    (``local_map``: DTensor has no placement for the padding on some
    versions)."""
    if route.is_sharded(x, w, b):
        return _sharded_causal_conv(x, w, b)
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, :S] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + xp[:, i: i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _sharded_causal_conv(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in (x, w, b) if isinstance(t, DTensor)).device_mesh
    whole = [Replicate()] * mesh.ndim
    x, w, b = (t if isinstance(t, DTensor)
               else DTensor.from_local(t, mesh, whole, run_check=False)
               for t in (x, w, b))
    C = x.shape[2]
    ways, chans = 1, []
    for i, p in enumerate(w.placements):
        if p == Shard(1) and C % (ways * mesh.size(i)) == 0:
            ways *= mesh.size(i)
            chans.append(i)
    xpl = [Shard(2) if i in chans else Shard(0) if p == Shard(0)
           else Replicate() for i, p in enumerate(x.placements)]
    wpl = [Shard(1) if i in chans else Replicate() for i in range(mesh.ndim)]
    bpl = [Shard(0) if i in chans else Replicate() for i in range(mesh.ndim)]
    wgrad = [q if i in chans else Partial() if xpl[i] == Shard(0)
             else Replicate() for i, q in enumerate(wpl)]
    bgrad = [q if i in chans else Partial() if xpl[i] == Shard(0)
             else Replicate() for i, q in enumerate(bpl)]
    return local_map(_causal_conv, out_placements=xpl,
                     in_placements=(xpl, wpl, bpl),
                     in_grad_placements=(xpl, wgrad, bgrad),
                     device_mesh=mesh, redistribute_inputs=True)(x, w, b)


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


def _forward(p, x: torch.Tensor, cfg: ModelConfig):
    """``mamba2_forward`` that also returns the conv's input (B, S, C),
    whose last W - 1 rows seed the decode cache (on sharded heads only
    those rows, ``_sharded_forward``)."""
    if route.is_sharded(x, p["in_proj"]) and _head_dims(p["A_log"]):
        return _sharded_forward(p, x, cfg)
    proj = linear(x, p["in_proj"].to(x.dtype))
    y, h_final, conv_in = _mix(proj, p["conv_w"], p["conv_b"],
                               p["dt_bias"], p["A_log"], p["D"],
                               ssm_dims(cfg), cfg.ssm.chunk)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return linear(y, p["out_proj"].to(y.dtype)), h_final, conv_in


def _head_dims(per_head: torch.Tensor) -> list:
    """The mesh dims along which a DTensor leaf of one entry per head
    (``A_log``) is sharded."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(per_head, DTensor):
        return []
    return [i for i, p in enumerate(per_head.placements) if p == Shard(0)]


def _sharded_forward(p, x: torch.Tensor, cfg: ModelConfig):
    """``_forward`` on DTensors whose heads are sharded n ways (the
    reference's ``ssm_heads`` rule): each rank runs ``_mix`` on its heads,
    from its columns of z, x and dt of a whole in_proj, all of B and C,
    and the conv channels of its x and of B and C. The in_proj's columns
    are sharded as one block that the five parts do not split evenly,
    so DTensor alone would gather its output and run the block whole on
    every rank. x's gradient is summed over the head ranks inside
    (``route.SumGradOverRanks``). y is normalized whole, and each rank
    multiplies its columns of it by its rows of out_proj (``linear``).
    Only the last W - 1 rows of the conv's input come back."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    d_inner, H, Pd, N = ssm_dims(cfg)
    dims = _head_dims(p["A_log"])
    mesh = p["A_log"].device_mesh
    n = math.prod(mesh.size(i) for i in dims)
    hl, dl = H // n, H // n * Pd
    keep = cfg.ssm.conv_width - 1
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    xpl = [q if i not in dims and q == Shard(0) else Replicate()
           for i, q in enumerate(x.placements)]
    batch = [i for i, q in enumerate(xpl) if q == Shard(0)]

    def pl(head, other):
        return [head if i in dims else other(i) for i in range(mesh.ndim)]

    whole = pl(Replicate(), lambda i: Replicate())
    per_head = pl(Shard(0), lambda i: Replicate())
    # a rank's gradients are its part of the sum over the ranks that
    # share an input
    shared = pl(Partial(), lambda i: Partial() if i in batch
                else Replicate())
    head_grad = pl(Shard(0), lambda i: Partial() if i in batch
                   else Replicate())

    def local(xl, w, cw, cb, dtb, alog, dv):
        r = route.mesh_rank(mesh, dims)
        xl = route.SumGradOverRanks.apply(xl, [(mesh, i) for i in dims])

        def cols(t, *spans):
            return torch.cat([t.narrow(-1, a, b) for a, b in spans], dim=-1)
        w = cols(w, (r * dl, dl), (d_inner + r * dl, dl),
                 (2 * d_inner, 2 * N), (2 * d_inner + 2 * N + r * hl, hl))
        conv = ((r * dl, dl), (d_inner, 2 * N))
        y, h, conv_in = _mix(linear(xl, w.to(xl.dtype)), cols(cw, *conv),
                             cols(cb, *conv), dtb, alog, dv,
                             (dl, hl, Pd, N), cfg.ssm.chunk)
        tail = conv_in[:, -keep:]
        return y, h, tail[..., :dl], tail[..., dl:]

    y, h, x_tail, bc_tail = local_map(
        local,
        out_placements=(pl(Shard(2), xpl.__getitem__),
                        pl(Shard(1), xpl.__getitem__),
                        pl(Shard(2), xpl.__getitem__), xpl),
        in_placements=(xpl, whole, whole, whole, per_head, per_head,
                       per_head),
        in_grad_placements=(xpl, shared, shared,
                            shared, head_grad, head_grad, head_grad),
        device_mesh=mesh, redistribute_inputs=True)(
        x, p["in_proj"], p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
        p["D"])
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return (linear(y, p["out_proj"].to(y.dtype)), h,
            torch.cat([x_tail, bc_tail], dim=-1))


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
    proj = linear(x, p["in_proj"].to(x.dtype))
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
