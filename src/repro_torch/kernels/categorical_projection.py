"""The C51 Bellman projection op.

``support`` is the fixed atom grid. ``categorical_projection`` projects
the Bellman-shifted target distribution back onto it: on a CUDA tensor
it launches the kernel of ``csrc/categorical_projection.cu`` (the
gather, or hat, form of the TPU kernel ``categorical_projection_kernel``
in ``src/repro/kernels/categorical_projection.py``), on a CPU tensor it
runs the plain scatter version of ``kernels/ref.py``. The two agree to
float rounding (they add in another order); the op runs on a detached
target, so it needs no backward.

At the DQN path's shapes (B = 32, K = 51) the kernel is latency-bound,
not bound by bytes or operations: its launch, one load, b_j's division,
then each output's chain of K dependent adds. One block per row: each
thread computes its atom's position b_j once into shared memory, then
each output sums all K terms in increasing j; ``projection_hat`` replays
that schedule on the CPU bit for bit. Every output element is written by
the kernel (see the note in the source), so the output comes from
``build.output``, without deterministic mode's NaN fill. The projection
is per row, so a population's (R, B, K) targets go through one launch
as R B rows. Fake tensors take a shape-only branch (``route``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, route
from repro_torch.kernels.ref import (
    categorical_projection as categorical_projection_plain)

__all__ = ["MAX_ATOMS", "linspace", "support", "categorical_projection",
           "categorical_projection_plain", "projection_hat",
           "categorical_projection_work"]

MAX_ATOMS = 512


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """jnp.linspace's float32 formula, made on the device: start*(1-s) +
    stop*s on s = iota/(num-1), then the exact endpoint. (torch.linspace
    rounds differently; XLA's CPU code may differ from this by an ulp.)"""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    s = (torch.arange(div, dtype=torch.float32, device=device)
         / torch.full((), float(div), dtype=torch.float32, device=device))
    out = start * (1.0 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def support(num_atoms: int, v_min: float, v_max: float,
            device=None) -> torch.Tensor:
    """The (K,) atom grid z_j = v_min + jΔ; K == 1 is the single atom
    v_min."""
    return linspace(v_min, v_max, num_atoms, device)


def _spacing(K: int, v_min: float, v_max: float):
    """The atom spacing delta and the divisor of b_j (delta, or 1 where
    delta is 0), as the kernel takes them."""
    delta = (v_max - v_min) / (K - 1) if K > 1 else 0.0
    return delta, delta if delta > 0.0 else 1.0


def projection_hat(probs: torch.Tensor, rewards: torch.Tensor,
                   dones: torch.Tensor, *, v_min: float, v_max: float,
                   gamma_n: float) -> torch.Tensor:
    """The kernel's schedule on the CPU: b_j = (clip(r + g z_j, v_min,
    v_max) - v_min) / delta, g = gamma_n (1 - d), with its float32
    operations in its order (the scalars rounded to float32 as the
    kernel receives them), then the full K-term gather
    m_i = sum over all j, in j order, of p_j max(0, 1 - |b_j - i|).
    Leading axes before (B, K) are rows too."""
    lead, K = probs.shape[:-1], probs.shape[-1]
    probs, rewards, dones = (probs.reshape(-1, K), rewards.reshape(-1),
                             dones.reshape(-1))
    delta, db = _spacing(K, v_min, v_max)
    f32 = lambda x: torch.full((), x, dtype=torch.float32)  # noqa: E731
    lo, hi = f32(v_min), f32(v_max)
    g = f32(gamma_n) * (f32(1.0) - dones.to(torch.float32))
    z = lo + f32(delta) * torch.arange(K, dtype=torch.float32)
    tz = torch.minimum(torch.maximum(
        rewards.to(torch.float32)[:, None] + g[:, None] * z[None], lo), hi)
    b = (tz - lo) / f32(db)
    p = probs.to(torch.float32)
    fi = torch.arange(K, dtype=torch.float32)[None]
    acc = torch.zeros_like(p)
    for j in range(K):
        w = torch.clamp(1.0 - torch.abs(b[:, j:j + 1] - fi), min=0.0)
        acc = acc + p[:, j:j + 1] * w
    return acc.reshape(lead + (K,))


def _lib() -> ctypes.CDLL:
    lib = build.library("categorical_projection")
    fn = lib.categorical_projection
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def categorical_projection(probs: torch.Tensor, rewards: torch.Tensor,
                           dones: torch.Tensor, *, v_min: float, v_max: float,
                           gamma_n: float) -> torch.Tensor:
    """probs: (B, K) float32; rewards: (B,) float32; dones: (B,) bool or
    float; or a population's (R, B, K), (R, B) and (R, B), taken as R B
    rows. Returns the projected masses in probs' shape, float32. CUDA
    tensors go through the kernel, one launch for all rows (counted in
    ``categorical_projection.launches``), CPU tensors through the plain
    version."""
    if probs.dim() not in (2, 3):
        raise ValueError(f"probs must be (B, K) or (R, B, K), got "
                         f"{tuple(probs.shape)}")
    shape, K = probs.shape, probs.shape[-1]
    if rewards.shape != shape[:-1] or dones.shape != shape[:-1]:
        raise ValueError(f"rewards and dones must be {tuple(shape[:-1])} "
                         f"for probs {tuple(shape)}, got "
                         f"{tuple(rewards.shape)} and {tuple(dones.shape)}")
    probs = probs.reshape(-1, K)
    rewards = rewards.reshape(-1)
    d32 = dones.reshape(-1).to(torch.float32)
    kw = {"v_min": v_min, "v_max": v_max, "gamma_n": gamma_n}
    return route.call("categorical_projection",
                      lambda: categorical_projection_work(probs), _launch,
                      categorical_projection_plain, _shape_only, kw,
                      probs, rewards, d32,
                      differentiable=False).reshape(shape)


def categorical_projection_work(probs: torch.Tensor):
    """(flops, bytes) of one call on (B, K) rows: probs, rewards and
    dones read and (B, K) written once; per row g = gamma_n (1 - d) (2
    operations) and per (row, source atom) 14 (b_j, its floor and
    ceiling, the two weights, two products and two adds)."""
    B, K = probs.shape
    return B * 2 + B * K * 14, (2 * B * K + 2 * B) * 4


def _shape_only(probs, rewards, dones, v_min, v_max, gamma_n):
    return torch.empty(probs.shape, dtype=torch.float32, device=probs.device)


def _launch(probs: torch.Tensor, rewards: torch.Tensor, d32: torch.Tensor,
            v_min: float, v_max: float, gamma_n: float) -> torch.Tensor:
    """The kernel's launch on (B, K) rows, counted in
    ``categorical_projection.launches``."""
    K = probs.shape[-1]
    if probs.dtype != torch.float32 or rewards.dtype != torch.float32:
        raise ValueError(f"probs and rewards must be float32, got "
                         f"{probs.dtype} and {rewards.dtype}")
    B = probs.shape[0]
    if not 1 <= K <= MAX_ATOMS:
        raise ValueError(f"atom count {K} outside [1, {MAX_ATOMS}]")
    if rewards.device != probs.device or d32.device != probs.device:
        raise ValueError("probs, rewards and dones must share a device")
    delta, db = _spacing(K, v_min, v_max)
    probs = probs.contiguous()
    rewards = rewards.contiguous()
    d32 = d32.contiguous()
    out = build.output(probs.shape, torch.float32, probs.device)
    err = _lib().categorical_projection(
        probs.data_ptr(), rewards.data_ptr(), d32.data_ptr(), out.data_ptr(),
        B, K, v_min, v_max, gamma_n, delta, db, build.stream_of(probs))
    if err != 0:
        raise RuntimeError(
            f"categorical_projection kernel launch failed: CUDA error {err}")
    categorical_projection.launches += 1
    return out


categorical_projection.launches = 0
