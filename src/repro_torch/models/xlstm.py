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

On a mesh (``sharding/partition.py``) a ``model`` rank runs the mLSTM
recurrence of its part of the state: where the model ranks are a
multiple n of the H heads, as the reference's partitioner splits them,
one head and 1 / (n / H) of v's head dim in the chunked form (the
prefill and training), and in the decode step the rows of C and n that
the cache places on the rank (the k side of every head: the
reference's ranks keep each head's state split over the k dim across
steps), whose C^T q and n . q are then summed over the ranks. The
products before the recurrence are split by their columns and gathered.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, route
from repro_torch.kernels.ref import slstm_cell
from repro_torch.models import params as P
from repro_torch.models.layers import linear, rms_norm, split_heads
from repro_torch.models.ssm import _causal_conv
from repro_torch.sharding.ranks import PLAIN, Ranks

State = Tuple[torch.Tensor, ...]

# leaves the reference reads in float32 (``.astype(jnp.float32)``), so
# they keep float32 whatever the compute dtype: the sLSTM's recurrent R
F32_LEAVES = ("r",)
# the blocks' leaves, in the order ``sharding/partition.py`` passes them
MLSTM_PARAMS = ("up_proj", "conv_w", "conv_b", "w_q", "w_k", "w_v",
                "w_gates", "b_gates", "norm", "down_proj")
SLSTM_PARAMS = ("w_in", "r", "b", "norm", "ffn_up", "ffn_down")


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


def _whole(t: torch.Tensor, width: int, ranks: Ranks) -> torch.Tensor:
    """t (..., w): where w < ``width`` the rank's columns of the model
    ranks' split, gathered whole; else t."""
    return ranks.gather(t, -1) if t.shape[-1] < width else t


def _mlstm_qkv_gates(p, x: torch.Tensor, cfg: ModelConfig,
                     ranks: Ranks = PLAIN, window=None):
    """The pre-recurrence compute. x: (B, S, d), or the decode step's
    (B, 1, d) with its conv ``window`` (B, W - 1, d_inner) of earlier
    inputs. Returns q, k, v (B, S, H, P), or (B, H, P) for a step, the
    raw gates i, f (B, S, H) or (B, H) float32, the output gate's input
    z, the conv's input xm (both (B, S, d_inner)) and the new window's
    inputs (``window`` and xm). A rank of split columns multiplies its
    columns (of the conv, w_q, w_k, w_v and w_gates' rows) and gathers
    the results whole."""
    d_inner, H, Pd = mlstm_dims(cfg)
    dt = x.dtype
    up = _whole(ranks.contract(x, p["up_proj"].to(dt)), 2 * d_inner, ranks)
    xm, z = torch.split(up, d_inner, dim=-1)
    cw, cb = p["conv_w"], p["conv_b"]
    mine = xm
    if cw.shape[1] < d_inner:        # the rank's conv channels
        mine = xm.narrow(-1, ranks.model_rank * cw.shape[1], cw.shape[1])
    if window is None:
        xc_r = F.silu(_causal_conv(mine, cw, cb))
        xv = xm
    else:
        window = torch.cat([window, xm], dim=1)
        win = window
        if cw.shape[1] < d_inner:
            win = window.narrow(-1, ranks.model_rank * cw.shape[1],
                                cw.shape[1])
        xc_r = F.silu(torch.einsum("bwc,wc->bc", win, cw.to(dt))
                      + cb.to(dt))
        xv = xm[:, 0]
    xc = _whole(xc_r, d_inner, ranks)
    q = _whole(linear(xc, p["w_q"].to(dt)), d_inner, ranks)
    k = _whole(linear(xc, p["w_k"].to(dt)) * (Pd ** -0.5), d_inner, ranks)
    v = _whole(linear(xv, p["w_v"].to(dt)), d_inner, ranks)
    gates = linear(xc_r, p["w_gates"].to(dt))
    if p["w_gates"].shape[0] < d_inner:
        gates = ranks.reduce(gates)
    gates = gates.to(torch.float32) + p["b_gates"].to(torch.float32)
    i_t, f_t = torch.split(gates, H, dim=-1)
    return (split_heads(q, H), split_heads(k, H), split_heads(v, H), i_t,
            f_t, z, xm, window)


def _mlstm_step(state: State, q, k, v, i_t, f_t):
    """One stabilized step. q/k/v: (B, H, P); i_t/f_t: (B, H)."""
    C, n, m = state
    f32 = torch.float32
    k32, q32 = k.to(f32), q.to(f32)
    f_log = F.logsigmoid(f_t)
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

    q/k/v: (B, S, H, P) (v's P may be a slice of the head dim: C then
    holds those columns); i_t/f_t: (B, S, H) raw gate pre-activations."""
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
        f_log = F.logsigmoid(fk_)                           # (B,L,H)
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


def _chunk_split(cfg: ModelConfig, ranks: Ranks):
    """(first head, heads, first column of v, columns) of the recurrence
    a model rank runs in the chunked form: its share of the heads, or,
    where the ranks are a multiple r of the heads, one head and 1 / r of
    v's head dim; every head on one rank, or where neither divides."""
    d_inner, H, Pd = mlstm_dims(cfg)
    n, j = ranks.n_model, ranks.model_rank
    if n > 1 and H % n == 0:
        return j * (H // n), H // n, 0, Pd
    if n > 1 and n % H == 0 and Pd % (n // H) == 0:
        r = n // H
        return j // r, 1, j % r * (Pd // r), Pd // r
    return 0, H, 0, Pd


def _rank_state(state: State, split) -> State:
    h0, hl, c0, pv = split
    C, n, m = state
    return (C.narrow(1, h0, hl).narrow(3, c0, pv), n.narrow(1, h0, hl),
            m.narrow(1, h0, hl))


def whole_state(state: State, cfg: ModelConfig, ranks: Ranks) -> State:
    """The chunked form's final state of a rank (``_chunk_split``) as the
    whole (C, n, m), gathered over the model ranks: each head's slices
    of C side by side, n and m once per head."""
    d_inner, H, Pd = mlstm_dims(cfg)
    h0, hl, c0, pv = _chunk_split(cfg, ranks)
    if hl == H:
        return state
    C, n, m = (ranks.gather(t, 1) for t in state)
    if pv == Pd:
        return C, n, m
    r = Pd // pv
    B = C.shape[0]
    C = C.reshape(B, H, r, Pd, pv).permute(0, 1, 3, 2, 4).reshape(
        B, H, Pd, Pd)
    return C, n[:, ::r], m[:, ::r]


def _mlstm_out(p, hh: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
               ranks: Ranks, dt) -> torch.Tensor:
    """The norm over the whole inner width (a rank's columns gathered),
    the output gate and down_proj on the rank's rows."""
    d_inner = mlstm_dims(cfg)[0]
    h = _whole(hh.reshape(*hh.shape[:2], -1).to(dt), d_inner, ranks)
    h = rms_norm(h, p["norm"], cfg.norm_eps)
    h = h * F.silu(z)
    rows = p["down_proj"].shape[0]
    if rows < d_inner:
        h = h.narrow(-1, ranks.model_rank * rows, rows)
    return linear(h, p["down_proj"].to(dt))


def _mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state=None,
                   chunked: bool = True, ranks: Ranks = PLAIN):
    """``mlstm_forward`` that also returns the conv's input xm
    (B, S, d_inner), whose last W - 1 rows seed the decode cache. On a
    rank of split columns the state is the rank's (``_chunk_split``;
    ``whole_state`` gathers it)."""
    d_inner, H, Pd = mlstm_dims(cfg)
    B, S, _ = x.shape
    q, k, v, i_t, f_t, z, xm, _ = _mlstm_qkv_gates(p, x, cfg, ranks)
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    split = _chunk_split(cfg, ranks)
    h0, hl, c0, pv = split
    if hl < H:
        q, k, i_t, f_t = (t.narrow(2, h0, hl) for t in (q, k, i_t, f_t))
        v = v.narrow(2, h0, hl).narrow(3, c0, pv)
        state = _rank_state(state, split)
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
    return _mlstm_out(p, hh, z, cfg, ranks, x.dtype), state, xm


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
    q, k, v, i_t, f_t, z, _, window = _mlstm_qkv_gates(
        p, x, cfg, window=cache["conv"])
    state, h = _mlstm_step(cache["state"], q, k, v, i_t, f_t)
    return (_mlstm_out(p, h[:, None], z, cfg, PLAIN, x.dtype),
            {"state": state, "conv": window[:, 1:]})


def decode_into(p, x: torch.Tensor, state: State, conv: torch.Tensor,
                cfg: ModelConfig, ranks: Ranks = PLAIN) -> torch.Tensor:
    """``mlstm_decode_step`` with the new state and conv window written
    into ``state`` and ``conv`` in place; returns y. On a rank each of C,
    n and m is the rank's as the cache places it: its heads, or for C
    and n its rows of the k side of every head (the products with q of
    which are then summed over the model ranks); the conv window is
    whole (every rank writes the same)."""
    if ranks.model is None:
        y, new = mlstm_decode_step(p, x, {"state": state, "conv": conv}, cfg)
        for dst, src in zip(state, new["state"]):
            dst.copy_(src)
        conv.copy_(new["conv"])
        return y
    d_inner, H, Pd = mlstm_dims(cfg)
    q, k, v, i_t, f_t, z, _, window = _mlstm_qkv_gates(p, x, cfg, ranks,
                                                       window=conv)
    C, n, m = state
    r = ranks.model_rank

    def mine(t, dim, full):
        """The rank's span (start, width) of dim ``dim`` of a state
        tensor whose whole width is ``full``."""
        w = t.shape[dim]
        return (r * w if w < full else 0), w

    f32 = torch.float32
    m_all = ranks.gather(m, 1) if m.shape[1] < H else m
    f_log = F.logsigmoid(f_t)
    m_new = torch.maximum(f_log + m_all, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_log + m_all - m_new)
    (h0, hc), (p0, pc) = mine(C, 1, H), mine(C, 2, Pd)
    qc = q.narrow(1, h0, hc).narrow(2, p0, pc).to(f32)
    kc = k.narrow(1, h0, hc).narrow(2, p0, pc).to(f32)
    kv = kc[..., :, None] * v.narrow(1, h0, hc).to(f32)[..., None, :]
    C_new = (f_p.narrow(1, h0, hc)[..., None, None] * C
             + i_p.narrow(1, h0, hc)[..., None, None] * kv)
    num = torch.einsum("bhpr,bhp->bhr", C_new, qc)
    (g0, hn), (s0, pn) = mine(n, 1, H), mine(n, 2, Pd)
    qn = q.narrow(1, g0, hn).narrow(2, s0, pn).to(f32)
    n_new = (f_p.narrow(1, g0, hn)[..., None] * n
             + i_p.narrow(1, g0, hn)[..., None]
             * k.narrow(1, g0, hn).narrow(2, s0, pn).to(f32))
    den = torch.einsum("bhp,bhp->bh", n_new, qn)
    if pc < Pd:
        num = ranks.reduce(num)
    if pn < Pd:
        den = ranks.reduce(den)
    if hc < H:
        num = ranks.gather(num, 1)
    if hn < H:
        den = ranks.gather(den, 1)
    h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    C.copy_(C_new)
    n.copy_(n_new)
    m.copy_(m_new.narrow(1, *mine(m, 1, H)))
    conv.copy_(window[:, 1:])
    return _mlstm_out(p, h[:, None], z, cfg, ranks, x.dtype)


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


def _slstm_ffn(p, h: torch.Tensor, cfg: ModelConfig,
               ranks: Ranks = PLAIN) -> torch.Tensor:
    """The post-recurrence norm and gated GELU (tanh form) FFN. On a rank
    of split columns the up projection's columns, split as one block
    that the gate and up halves split at a rank boundary, are gathered
    whole before the split, as the reference's partitioner does, and
    the product of the rank's rows of ffn_down taken."""
    h = rms_norm(h, p["norm"], cfg.norm_eps)
    up = ranks.contract(h, p["ffn_up"].to(h.dtype))
    f_ff = int(cfg.d_model * cfg.xlstm.proj_factor_slstm)
    g, u = torch.chunk(_whole(up, 2 * f_ff, ranks), 2, dim=-1)
    a = F.gelu(g, approximate="tanh") * u
    rows = p["ffn_down"].shape[0]
    if rows < a.shape[-1]:
        a = a.narrow(-1, ranks.model_rank * rows, rows)
    return linear(a, p["ffn_down"].to(h.dtype))


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig, state=None,
                  ranks: Ranks = PLAIN):
    """x: (B, S, d) -> (y, final state), the recurrence through the
    ``slstm_scan`` op (whole on every model rank)."""
    B, S, d = x.shape
    wx = ranks.contract(x, p["w_in"].to(x.dtype))
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    hs, state = ops.slstm_scan(wx, p["r"], p["b"], state, cfg.n_heads)
    return _slstm_ffn(p, hs.to(x.dtype), cfg, ranks), state


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> State:
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), dtype=torch.float32,  # noqa: E731
                            device=device)
    return (z(), z(), z(), torch.full((batch, d), -1e9, dtype=torch.float32,
                                      device=device))


def slstm_decode_step(p, x: torch.Tensor, state: State, cfg: ModelConfig,
                      ranks: Ranks = PLAIN):
    """x: (B, 1, d). Returns (y, new state)."""
    wx = ranks.contract(x, p["w_in"].to(x.dtype))[:, 0]
    state = _slstm_step(p, state, wx, cfg)
    return _slstm_ffn(p, state[2][:, None].to(x.dtype), cfg, ranks), state


def slstm_decode_into(p, x: torch.Tensor, state: State, cfg: ModelConfig,
                      ranks: Ranks = PLAIN) -> torch.Tensor:
    """``slstm_decode_step`` with the new state written into ``state`` in
    place; returns y."""
    y, new = slstm_decode_step(p, x, state, cfg, ranks)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return y
