"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with block-diagonal recurrent weights), the port of
``repro.models.xlstm``.

The mLSTM has no kernel: its full-sequence path is the reference's
chunkwise-parallel form (``mlstm_chunked``, the default of
``ExecConfig.mlstm_chunked``) in plain torch, with the step recurrence
where the sequence does not divide into chunks. The sLSTM's
full-sequence path runs the ``slstm_scan`` op (kernel 7 of
``kernels/ops``): on the card its CUDA kernel, for any S, on the CPU its
plain version. Decode is the single-step update of both, in plain torch,
as in the reference.

mLSTM stabilized recurrence (per head, head dim P):
    m_t = max(f̃_t + m_{t-1}, ĩ_t)
    i'  = exp(ĩ_t - m_t);  f' = exp(f̃_t + m_{t-1} - m_t)
    C_t = f' C_{t-1} + i' (k_t ⊗ v_t);   n_t = f' n_{t-1} + i' k_t
    h_t = (C_t^T q_t) / max(|n_t · q_t|, 1)
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, route
from repro_torch.kernels.ref import slstm_cell
from repro_torch.models import params as P
from repro_torch.models.layers import (linear, rms_norm, split_heads,
                                       whole_along)
from repro_torch.models.ssm import _causal_conv

State = Tuple[torch.Tensor, ...]

# leaves the reference reads in float32 (``.astype(jnp.float32)``), so
# they keep float32 whatever the compute dtype: the sLSTM's recurrent R
F32_LEAVES = ("r",)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.xlstm.expand * cfg.d_model
    H = cfg.n_heads
    return d_inner, H, d_inner // H


def mlstm_param_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    d = cfg.d_model
    d_inner, H, Pd = mlstm_dims(cfg)
    w = cfg.xlstm.conv_width
    return {
        "up_proj": P.Leaf((d, 2 * d_inner), ("embed", "ssm_inner"), fan_in=d),
        "conv_w": P.Leaf((w, d_inner), ("conv", "ssm_inner")),
        "conv_b": P.Leaf((d_inner,), ("ssm_inner",), init="zeros"),
        "w_q": P.Leaf((d_inner, d_inner), ("ssm_inner_in", "ssm_inner"), fan_in=d_inner),
        "w_k": P.Leaf((d_inner, d_inner), ("ssm_inner_in", "ssm_inner"), fan_in=d_inner),
        "w_v": P.Leaf((d_inner, d_inner), ("ssm_inner_in", "ssm_inner"), fan_in=d_inner),
        "w_gates": P.Leaf((d_inner, 2 * H), ("ssm_inner", None), fan_in=d_inner),
        "b_gates": P.Leaf((2 * H,), (None,), init="zeros"),
        "norm": P.Leaf((d_inner,), ("ssm_inner",), init="ones"),
        "down_proj": P.Leaf((d_inner, d), ("ssm_inner", "embed"), fan_in=d_inner),
    }


def _mlstm_qkv_gates(p, x: torch.Tensor, cfg: ModelConfig):
    """The pre-recurrence compute. x: (B, S, d). Returns q, k, v
    (B, S, H, P), the raw gates i, f (B, S, H) float32, the output gate's
    input z and the conv's input xm (both (B, S, d_inner))."""
    d_inner, H, Pd = mlstm_dims(cfg)
    dt = x.dtype
    # the columns of xm and z whole on every rank before the split, as in
    # ``_slstm_ffn``
    up = whole_along(linear(x, p["up_proj"].to(dt)), -1)
    xm, z = torch.split(up, d_inner, dim=-1)
    xc = F.silu(_causal_conv(xm, p["conv_w"], p["conv_b"]))
    q = linear(xc, p["w_q"].to(dt))
    k = linear(xc, p["w_k"].to(dt)) * (Pd ** -0.5)
    v = linear(xm, p["w_v"].to(dt))
    gates = linear(xc, p["w_gates"].to(dt))
    gates = gates.to(torch.float32) + p["b_gates"].to(torch.float32)
    i_t, f_t = torch.split(gates, H, dim=-1)
    return (split_heads(q, H), split_heads(k, H), split_heads(v, H), i_t,
            f_t, z, xm)


def _mlstm_step(state: State, q, k, v, i_t, f_t):
    """One stabilized step. q/k/v: (B, H, P); i_t/f_t: (B, H)."""
    C, n, m = state
    f32 = torch.float32
    k32, q32 = k.to(f32), q.to(f32)
    f_log = route.elementwise(F.logsigmoid, f_t)
    m_new = torch.maximum(f_log + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_log + m - m_new)
    kv = k32[..., :, None] * v.to(f32)[..., None, :]
    C = f_p[..., None, None] * C + i_p[..., None, None] * kv
    n = f_p[..., None] * n + i_p[..., None] * k32
    num = torch.einsum("bhpr,bhp->bhr", C, q32)
    den = torch.clamp(torch.abs(torch.einsum("bhp,bhp->bh", n, q32)),
                      min=1.0)
    return (C, n, m_new), num / den[..., None]


def mlstm_chunked(q, k, v, i_t, f_t, state: State, chunk: int):
    """Chunkwise-parallel mLSTM, equal to the step recurrence: within a
    chunk the stabilizer unrolls to m = cumF + max(m0, cummax(ĩ - cumF)),
    the intra-chunk terms are an (L, L) decay-masked attention, and the
    carried (C, n, m) state is touched once per chunk.

    q/k/v: (B, S, H, P); i_t/f_t: (B, S, H) raw gate pre-activations.
    On DTensors ``_sharded_chunked``."""
    if route.is_sharded(q, k, v, i_t, f_t, *state):
        return _sharded_chunked(q, k, v, i_t, f_t, state, chunk)
    B, S, H, Pd = q.shape
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    f32 = torch.float32
    q, k, v, i_t, f_t = (t.to(f32) for t in (q, k, v, i_t, f_t))
    ii = torch.arange(L, device=q.device)
    lower = ii[None, :] <= ii[:, None]                      # (L,L): j <= i
    tri = lower[None, :, :, None]                           # (1,L,L,1)
    ones = lower.to(f32)

    def chunk_step(c, carry):
        C, n, m0 = carry
        sl = slice(c * L, (c + 1) * L)
        qk_, kk_, vk_, ik_, fk_ = q[:, sl], k[:, sl], v[:, sl], \
            i_t[:, sl], f_t[:, sl]
        f_log = route.elementwise(F.logsigmoid, fk_)        # (B,L,H)
        cumF = torch.einsum("ij,bjh->bih", ones, f_log)
        M = torch.cummax(ik_ - cumF, dim=1).values
        m = cumF + torch.maximum(m0[:, None, :], M)         # (B,L,H)
        D = torch.exp(cumF[:, :, None, :] - cumF[:, None, :, :]
                      + ik_[:, None, :, :] - m[:, :, None, :])
        D = torch.where(tri, D, 0.0)                        # (B,Li,Lj,H)
        S_ = torch.einsum("bihp,bjhp->bijh", qk_, kk_) * D
        num = torch.einsum("bijh,bjhp->bihp", S_, vk_)
        den = torch.sum(S_, dim=2)                          # (B,Li,H)
        wc = torch.exp(cumF + m0[:, None, :] - m)           # (B,L,H)
        num = num + torch.einsum("bihp,bhpr->bihr", qk_, C) * wc[..., None]
        den = den + torch.einsum("bihp,bhp->bih", qk_, n) * wc
        h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
        total, m_end = cumF[:, -1], m[:, -1]                # (B,H)
        w_prev = torch.exp(total + m0 - m_end)
        w_in = torch.exp(total[:, None, :] - cumF + ik_ - m_end[:, None, :])
        C = C * w_prev[..., None, None] + torch.einsum(
            "bjhp,bjhr->bhpr", w_in[..., None] * kk_, vk_)
        n = n * w_prev[..., None] + torch.einsum("bjh,bjhp->bhp", w_in, kk_)
        return h, (C, n, m_end)

    hs, state = route.steps(chunk_step, tuple(state), S // L)
    return torch.cat(hs, dim=1), state


def _sharded_chunked(q, k, v, i_t, f_t, state: State, chunk: int):
    """``mlstm_chunked`` on DTensors, each rank on its batch rows. Where
    the ``model`` ranks are a multiple n of the H heads and split the
    head dim P into r = n / H slices (xlstm-125m: 4 heads of 384 on 16
    ranks), as the reference's partitioner splits the heads' columns, a
    rank runs the recurrence of one head for one slice of v's P: q, k,
    the gates and n are the head's, C the columns of its slice. hs then
    comes back as (B, S, n, P / r), sharded n ways: the rank's columns
    of (B, S, H P). The state is gathered whole. Elsewhere every rank
    runs all heads: hs (B, S, H, P)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    H, Pd = q.shape[2], q.shape[3]
    mesh = next(t for t in (q, k, v, i_t, f_t, *state)
                if isinstance(t, DTensor)).device_mesh
    whole = [Replicate()] * mesh.ndim
    q, k, v, i_t, f_t, *state = (
        t if isinstance(t, DTensor)
        else DTensor.from_local(t, mesh, whole, run_check=False)
        for t in (q, k, v, i_t, f_t, *state))
    batch = [i for i, p in enumerate(q.placements) if p == Shard(0)]
    rest = [i for i in range(mesh.ndim) if i not in batch]
    n = math.prod(mesh.size(i) for i in rest)
    r = n // H if n % H == 0 else 0
    if not rest or not r or Pd % r:
        x4, x3 = ("b", None, None, None), ("b", None, None)
        hs, *st = route.sharded(
            lambda *a: _flat_chunked(*a, chunk=chunk),
            (x4, x4, x4, x3, x3, x4, x3, ("b", None)),
            (x4, x4, x3, ("b", None)), q, k, v, i_t, f_t, *state)
        return hs, tuple(st)
    pv = Pd // r
    xpl = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    split = [Shard(0) if i in batch else Shard(1) for i in range(mesh.ndim)]
    hpl = [Shard(0) if i in batch else Shard(2) for i in range(mesh.ndim)]
    grad = [Shard(0) if i in batch else Partial() for i in range(mesh.ndim)]

    def local(q, k, v, i_t, f_t, C, n_, m):
        j = route.mesh_rank(mesh, rest)
        h, c = j // r, j % r * pv
        one = lambda t: t.narrow(2, h, 1)                  # noqa: E731
        hs, (C, n_, m) = mlstm_chunked(
            one(q), one(k), one(v).narrow(3, c, pv), one(i_t), one(f_t),
            (C.narrow(1, h, 1).narrow(3, c, pv), n_.narrow(1, h, 1),
             m.narrow(1, h, 1)), chunk)
        return hs, C, n_, m

    hs, C, n_, m = local_map(
        local, out_placements=(hpl, split, split, split),
        in_placements=(xpl,) * 8, in_grad_placements=(grad,) * 8,
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, i_t, f_t,
                                                    *state)
    # the state whole: each head's r slices of C side by side, n and m
    # once per head
    C = whole_along(C, 1)
    B = C.shape[0]
    C = C.reshape(B, H, r, Pd, pv).permute(0, 1, 3, 2, 4).reshape(
        B, H, Pd, Pd)
    return hs, (C, whole_along(n_, 1)[:, ::r], whole_along(m, 1)[:, ::r])


def _flat_chunked(q, k, v, i_t, f_t, C, n, m, chunk: int):
    hs, state = mlstm_chunked(q, k, v, i_t, f_t, (C, n, m), chunk)
    return (hs, *state)


def _mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state=None,
                   chunked: bool = True):
    """``mlstm_forward`` that also returns the conv's input xm
    (B, S, d_inner), whose last W - 1 rows seed the decode cache."""
    d_inner, H, Pd = mlstm_dims(cfg)
    B, S, _ = x.shape
    q, k, v, i_t, f_t, z, xm = _mlstm_qkv_gates(p, x, cfg)
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    chunk = cfg.xlstm.chunk
    if chunked and S % min(chunk, S) == 0:
        hh, state = mlstm_chunked(q, k, v, i_t, f_t, state, chunk)
    else:
        hs = []
        for t in range(S):
            state, ht = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                    i_t[:, t], f_t[:, t])
            hs.append(ht)
        hh = torch.stack(hs, dim=1)
    h = hh.reshape(B, S, d_inner).to(x.dtype)
    h = rms_norm(h, p["norm"], cfg.norm_eps)
    h = h * F.silu(z)
    return linear(h, p["down_proj"].to(x.dtype)), state, xm


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state=None,
                  chunked: bool = True):
    """x: (B, S, d) -> (y, final state (C, n, m)). The chunkwise form
    when the sequence divides into chunks (and ``chunked``), else the
    step recurrence."""
    y, state, _ = _mlstm_forward(p, x, cfg, state, chunked)
    return y, state


def mlstm_init_state(cfg: ModelConfig, batch: int, device) -> State:
    d_inner, H, Pd = mlstm_dims(cfg)
    f32 = torch.float32
    return (torch.zeros((batch, H, Pd, Pd), dtype=f32, device=device),
            torch.zeros((batch, H, Pd), dtype=f32, device=device),
            torch.full((batch, H), -1e9, dtype=f32, device=device))


def mlstm_init_cache(cfg: ModelConfig, batch: int, dtype, device):
    d_inner, H, Pd = mlstm_dims(cfg)
    return {
        "state": mlstm_init_state(cfg, batch, device),
        "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, d_inner),
                            dtype=dtype, device=device),
    }


def mlstm_decode_step(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """x: (B, 1, d). Returns (y, new cache); the cache passed in is not
    modified."""
    d_inner, H, Pd = mlstm_dims(cfg)
    dt = x.dtype
    up = whole_along(linear(x, p["up_proj"].to(dt)), -1)
    xm, z = torch.split(up, d_inner, dim=-1)                # (B,1,e)
    window = torch.cat([cache["conv"], xm], dim=1)
    w = p["conv_w"].to(dt)
    xc = F.silu(torch.einsum("bwc,wc->bc", window, w) + p["conv_b"].to(dt))
    q = split_heads(torch.matmul(xc, p["w_q"].to(dt)), H)
    k = split_heads(torch.matmul(xc, p["w_k"].to(dt)), H) * (Pd ** -0.5)
    v = split_heads(torch.matmul(xm[:, 0], p["w_v"].to(dt)), H)
    gates = torch.matmul(xc, p["w_gates"].to(dt))
    gates = gates.to(torch.float32) + p["b_gates"].to(torch.float32)
    i_t, f_t = torch.split(gates, H, dim=-1)
    state, h = _mlstm_step(cache["state"], q, k, v, i_t, f_t)
    h = h.reshape(-1, 1, d_inner).to(dt)
    h = rms_norm(h, p["norm"], cfg.norm_eps)
    h = h * F.silu(z)
    y = linear(h, p["down_proj"].to(dt))
    return y, {"state": state, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_param_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    d = cfg.d_model
    H = cfg.n_heads
    Pd = d // H
    f_ff = int(d * cfg.xlstm.proj_factor_slstm)
    return {
        # input weights for z,i,f,o (4*d) and recurrent block-diagonal R per
        # gate: (4, H, Pd, Pd)
        "w_in": P.Leaf((d, 4 * d), ("embed", None), fan_in=d),
        "r": P.Leaf((4, H, Pd, Pd), (None, "heads", "head_dim", "head_dim"), fan_in=Pd),
        "b": P.Leaf((4 * d,), (None,), init="zeros"),
        "norm": P.Leaf((d,), ("embed",), init="ones"),
        "ffn_up": P.Leaf((d, 2 * f_ff), ("embed", "mlp"), fan_in=d),
        "ffn_down": P.Leaf((f_ff, d), ("mlp", "embed"), fan_in=f_ff),
    }


def _slstm_step(p, state: State, wx: torch.Tensor,
                cfg: ModelConfig) -> State:
    """state: (c, n, h, m) each (B, d) float32; wx: (B, 4d), this step's
    input contribution."""
    return slstm_cell(state, wx, p["r"].to(torch.float32),
                      p["b"].to(torch.float32), cfg.n_heads)


def _slstm_ffn(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The post-recurrence norm and gated GELU (tanh form) FFN. On
    DTensors the up projection's columns, sharded as one block that the
    gate and up halves split at a rank boundary, are gathered whole
    before the split, as the reference's partitioner does."""
    h = rms_norm(h, p["norm"], cfg.norm_eps)
    up = whole_along(linear(h, p["ffn_up"].to(h.dtype)), -1)
    g, u = torch.chunk(up, 2, dim=-1)
    return linear(F.gelu(g, approximate="tanh") * u,
                  p["ffn_down"].to(h.dtype))


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state=None):
    """x: (B, S, d) -> (y, final state), the recurrence through the
    ``slstm_scan`` op."""
    B, S, d = x.shape
    wx = linear(x, p["w_in"].to(x.dtype))
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    hs, state = ops.slstm_scan(wx, p["r"], p["b"], state, cfg.n_heads)
    return _slstm_ffn(p, hs.to(x.dtype), cfg), state


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> State:
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), dtype=torch.float32,  # noqa: E731
                            device=device)
    return (z(), z(), z(), torch.full((batch, d), -1e9, dtype=torch.float32,
                                      device=device))


def slstm_decode_step(p, x: torch.Tensor, state: State, cfg: ModelConfig):
    """x: (B, 1, d). Returns (y, new state)."""
    wx = linear(x, p["w_in"].to(x.dtype))[:, 0]
    state = _slstm_step(p, state, wx, cfg)
    return _slstm_ffn(p, state[2][:, None].to(x.dtype), cfg), state
