"""The prefill attention op: causal GQA flash attention.

``flash_attention`` takes the model's layout, q (B, S, H, D) and k, v
(B, S, Hkv, D), and returns (B, S, H, D) in q's type. On a CUDA tensor it
launches the kernel of ``csrc/flash_attention.cu``, which reads these
layouts through their strides (no transpose, no head-dim padding in
device memory): bfloat16 with a head dim that is a multiple of 16 (up to
256) runs on the tensor cores (wgmma fed by TMA through an mbarrier
ring); float32, and bfloat16 with D % 16 == 8, run the scalar float32
body. On a CPU tensor it runs the plain version of ``kernels/ref.py`` in
the kernel layout (B, H, S, D). A call that must record a gradient
goes through ``recompute.PlainRecompute``: the kernel forward, the plain
version's autograd backward (the reference's ``custom_vjp`` rule). Fake
tensors take a shape-only branch and DTensors run on their local shards,
along batch and query heads, a rank's KV heads those its query heads
read (``route``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, route
from repro_torch.kernels.ref import flash_attention as _plain

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_work",
           "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The plain version in the model's layout."""
    o = _plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=causal, window=window)
    return o.transpose(1, 2)


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Hkv, D), H % Hkv == 0; float32 or
    bfloat16. ``window``: keys with kpos > qpos - window only. CUDA
    tensors go through the kernel (its launches are counted in
    ``flash_attention.launches``); CPU tensors through the plain
    version; fake tensors through the shape-only branch (``route``). On
    the card a call that needs a gradient gets it from the plain version
    (``recompute``)."""
    if route.is_sharded(q, k, v):
        lab, kv = ("b", None, "h", None), ("b", None, "kv", None)
        return route.sharded(
            lambda q, k, v: flash_attention(q, k, v, causal, window),
            (lab, kv, kv), lab, q, k, v)
    return route.call("flash_attention",
                      lambda: flash_attention_work(q, k, causal, window),
                      _launch, flash_attention_plain, _shape_only,
                      {"causal": causal, "window": window}, q, k, v)


def _pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the mask keeps."""
    if not causal:
        return S * S
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_attention_work(q: torch.Tensor, k: torch.Tensor, causal: bool,
                         window: Optional[int]):
    """(flops, bytes) of one call: q, k, v read and the output written
    once; 4 D operations per (query head, kept pair) (QK^T and PV)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    return (4 * D * B * H * _pairs(S, causal, window),
            (2 * B * S * H * D + 2 * B * S * Hkv * D) * q.element_size())


def _shape_only(q, k, v, causal, window) -> torch.Tensor:
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    """The kernel's launch, counted in ``flash_attention.launches``."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    shape = f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
    if (k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hkv == 0
            or H % Hkv):
        raise ValueError(f"flash_attention: inconsistent shapes {shape}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes a head dim that "
                         f"is a multiple of 8 and at most {MAX_HEAD_DIM} "
                         f"(bfloat16 with a multiple of 16 runs on the "
                         f"tensor cores, the rest on the scalar body); got "
                         f"{shape}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got "
                         f"{window}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share one device")
    code = build.dtype_code("flash_attention", q, k, v)
    q, k, v = (build.vector_ready(t) for t in (q, k, v))
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*[t.stride(i) for t in (q, k, v, out)
                                      for i in (0, 1, 2)])
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        Hkv, D, strides, float(D ** -0.5), int(causal),
        0 if window is None else int(window), code, build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed at {shape} "
                           f"{q.dtype}: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
