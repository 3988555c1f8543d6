"""Plain PyTorch versions of the port's kernels.

They mirror ``repro.kernels.ref`` step for step, so on the CPU they give
the reference's results. The kernel wrappers call them for CPU tensors,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.

Layouts (kernel-native, as the reference's):
  flash_attention: q (B, H, S, D), k/v (B, Hkv, S, D)   -> (B, H, S, D)
  decode_attention: q (B, H, D), k/v (B, Hkv, L, D)     -> (B, H, D)
  ssm_scan: x (B, H, S, P), dt (B, H, S), A (H,), Bm/Cm (B, S, N)
  rmsnorm: x (..., D), gamma (D,)
  slstm_scan: wx (B, S, 4d), R (4, H, Pd, Pd), b (4d,), state 4x(B, d)
  segment_tree_sample: tree (2P,) sum-tree, targets (n,) -> (n,) int32
  categorical_projection: probs (B, K), rewards/dones (B,) -> (B, K)
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


NEG_INF = float("-inf")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal (and optionally windowed) GQA attention, one-shot; the
    probabilities are cast to q's type before the PV product."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if Hkv != H:
        k = torch.repeat_interleave(k, H // Hkv, dim=1)
        v = torch.repeat_interleave(v, H // Hkv, dim=1)
    scale = D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: Union[int, torch.Tensor],
                     return_lse: bool = False):
    """One query token per head against a cache masked to
    ``pos < min(cache_len, L)``. With ``return_lse`` also the float32
    (B, H) log-sum-exp of the scaled scores over those positions (-inf
    where there are none)."""
    B, H, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    if Hkv != H:
        k = torch.repeat_interleave(k, H // Hkv, dim=1)
        v = torch.repeat_interleave(v, H // Hkv, dim=1)
    scale = D ** -0.5
    s = torch.einsum("bhd,bhld->bhl", q, k).to(torch.float32) * scale
    pos = torch.arange(L, device=q.device).reshape(1, 1, L)
    if isinstance(cache_len, torch.Tensor):
        n = torch.clamp(cache_len.to(q.device), max=L)
    else:
        n = min(int(cache_len), L)
    s = torch.where(pos < n, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhl,bhld->bhd", p, v)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The naive sequential SSD recurrence, the ground truth, from a zero
    state: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t.
    Returns y (B, H, S, P) in x's type and the final state (B, H, P, N)
    in float32."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    x32, dt32 = x.to(torch.float32), dt.to(torch.float32)
    B32, C32 = Bm.to(torch.float32), Cm.to(torch.float32)
    A32 = A.to(torch.float32)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt32[:, :, t] * A32[None, :])             # (B,H)
        h = h * decay[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt32[:, :, t], B32[:, t], x32[:, :, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C32[:, t], h))
    return torch.stack(ys, dim=2).to(x.dtype), h


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm with a float32 mean square, cast back to x's type."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.to(torch.float32)).to(dt)


def segment_tree_sample(tree: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Root-to-leaf descent over a heap-layout sum-tree.

    ``tree``: (2P,) float32, P a power of two, ``tree[1]`` the total mass,
    node i's children 2i and 2i+1, leaves at [P, 2P). ``targets``: (n,)
    float32 points on the CDF. Returns (n,) int32 leaf indices: the leaf
    whose inclusive prefix sum first exceeds the target. A target >= the
    total lands on the last leaf. Leading axes are trees: (R, 2P) trees
    answer (R, n) targets, row by row."""
    P = tree.shape[-1] // 2
    depth = P.bit_length() - 1
    idx = torch.ones(targets.shape, dtype=torch.int64, device=targets.device)
    t = targets.to(torch.float32)
    for _ in range(depth):
        left = tree.gather(-1, 2 * idx)
        go_left = t < left
        idx = torch.where(go_left, 2 * idx, 2 * idx + 1)
        t = torch.where(go_left, t, t - left)
    return (idx - P).to(torch.int32)


def categorical_projection(probs: torch.Tensor, rewards: torch.Tensor,
                           dones: torch.Tensor, *, v_min: float, v_max: float,
                           gamma_n: float) -> torch.Tensor:
    """The per-atom clamp/scatter C51 projection (Bellemare et al. 2017,
    Alg. 1). ``probs``: (B, K) masses over z_j = v_min + jΔ;
    ``rewards``/``dones``: (B,) float32. Atom j moves to
    Tz_j = clip(r + γⁿ(1-done)·z_j, v_min, v_max) and its mass splits
    between l = ⌊b⌋ and l+1, b = (Tz_j - v_min)/Δ. Like the reference's
    scatter, an update at an index >= K is dropped. Returns (B, K)."""
    B, K = probs.shape
    dev = probs.device
    delta = (v_max - v_min) / (K - 1) if K > 1 else 0.0
    db = torch.full((), delta if delta > 0.0 else 1.0, dtype=torch.float32,
                    device=dev)
    z = v_min + delta * torch.arange(K, dtype=torch.float32, device=dev)
    p32 = probs.to(torch.float32)
    d32 = dones.to(torch.float32)
    tz = torch.clamp(rewards.to(torch.float32)[:, None]
                     + gamma_n * (1.0 - d32[:, None]) * z[None, :],
                     v_min, v_max)
    b = (tz - v_min) / db
    low = torch.floor(b)
    li = low.to(torch.int64)
    ui = torch.clamp(li + 1, max=K - 1)
    wl = 1.0 - (b - low)
    wu = b - low
    in_range = li < K
    m = torch.zeros((B, K), dtype=torch.float32, device=dev)
    m.scatter_add_(1, torch.where(in_range, li, 0),
                   torch.where(in_range, p32 * wl, 0.0))
    m.scatter_add_(1, ui, p32 * wu)
    return m


def slstm_cell(state: Tuple[torch.Tensor, ...], wx_t: torch.Tensor,
               R32: torch.Tensor, b32: torch.Tensor, n_heads: int
               ) -> Tuple[torch.Tensor, ...]:
    """One sLSTM step: ``wx_t`` (B, 4d) is the step's input contribution,
    R32 (4, H, Pd, Pd) and b32 (4d,) float32, the state (c, n, h, m) each
    (B, d) float32. Returns the new state."""
    c, n, h, m = state
    B, d = h.shape
    H = n_heads
    rec = torch.einsum("bhp,ghpq->bghq", h.reshape(B, H, d // H),
                       R32).reshape(B, 4 * d)
    pre = wx_t.to(torch.float32) + rec + b32[None]
    z_t, i_t, f_t, o_t = torch.split(pre, d, dim=-1)
    f_log = F.logsigmoid(f_t)
    m_new = torch.maximum(f_log + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_log + m - m_new)
    c = f_p * c + i_p * torch.tanh(z_t)
    n = f_p * n + i_p
    h = torch.sigmoid(o_t) * c / torch.clamp(n, min=1.0)
    return c, n, h, m_new


def slstm_scan(wx: torch.Tensor, R: torch.Tensor, b: torch.Tensor,
               state: Tuple[torch.Tensor, ...], n_heads: int
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The sequential sLSTM recurrence with exp-gate stabilisation.
    wx: (B, S, 4d) input contributions (gates z, i, f, o in that order);
    R: (4, H, Pd, Pd) block-diagonal recurrent weights; b: (4d,);
    state: (c, n, h, m), each (B, d) float32. Returns hs (B, S, d) in
    wx's type and the final state."""
    R32, b32 = R.to(torch.float32), b.to(torch.float32)
    hs = []
    for t in range(wx.shape[1]):
        state = slstm_cell(state, wx[:, t], R32, b32, n_heads)
        hs.append(state[2])
    return torch.stack(hs, dim=1).to(wx.dtype), tuple(state)
