"""Plain PyTorch versions of the two kernels of the DQN path.

They mirror ``repro.kernels.ref`` step for step, so on the CPU they give
the reference's bits. The kernel wrappers call them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""

from __future__ import annotations

import torch


def segment_tree_sample(tree: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Root-to-leaf descent over a heap-layout sum-tree.

    ``tree``: (2P,) float32, P a power of two, ``tree[1]`` the total mass,
    node i's children 2i and 2i+1, leaves at [P, 2P). ``targets``: (n,)
    float32 points on the CDF. Returns (n,) int32 leaf indices: the leaf
    whose inclusive prefix sum first exceeds the target. A target >= the
    total lands on the last leaf."""
    P = tree.shape[0] // 2
    depth = P.bit_length() - 1
    idx = torch.ones(targets.shape, dtype=torch.int64, device=targets.device)
    t = targets.to(torch.float32)
    for _ in range(depth):
        left = tree[2 * idx]
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
