"""The SSD scan op: the chunked Mamba2 state-space scan of the prefill.

``ssm_scan`` takes the model's layout, x (B, S, H, P), dt (B, S, H)
float32 (after the softplus), A (H,) float32 and Bm, Cm (B, S, N), and
returns y (B, S, H, P) in x's type and the final state (B, H, P, N) in
float32, from a zero state. The chunk rule is the reference's: L =
min(chunk, S), and S must be a multiple of L. On a CUDA tensor it
launches the kernel of ``csrc/ssm_scan.cu``, which reads these layouts
through their strides (no transpose); on a CPU tensor it runs the plain
version of ``kernels/ref.py`` (the sequential recurrence) in the kernel
layout (B, H, S, P). Forward only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssm_scan as _plain

__all__ = ["ssm_scan", "ssm_scan_plain", "chunk_length"]


def chunk_length(S: int, chunk: int) -> int:
    """The reference's chunk rule: L = min(chunk, S), S % L == 0."""
    L = min(chunk, S)
    if L <= 0 or S % L:
        raise ValueError(f"ssm_scan: the sequence length {S} is not a "
                         f"multiple of the chunk min({chunk}, {S}) = {L}")
    return L


def ssm_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version in the model's layout."""
    y, h = _plain(x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm)
    return y.transpose(1, 2), h


def _lib() -> ctypes.CDLL:
    lib = build.library("ssm_scan")
    fn = lib.ssm_scan
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssm_scan_limits.argtypes = [ctypes.c_int]
    lib.ssm_scan_limits.restype = ctypes.c_int
    return lib


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) float32; A: (H,) float32; Bm, Cm:
    (B, S, N) of x's type (float32 or bfloat16). CUDA tensors go through
    the kernel (its launches are counted in ``ssm_scan.launches``); CPU
    tensors through the plain version."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk_length(S, chunk)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, Bm, Cm)
    shape = (f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
             f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N)
            or Cm.shape != Bm.shape):
        raise ValueError(f"ssm_scan: inconsistent shapes {shape}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssm_scan: all inputs must share one device")
    code = build.dtype_code("ssm_scan", x, Bm, Cm)
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssm_scan: dt and A must be float32, got "
                        f"{dt.dtype} and {A.dtype}")
    lib = _lib()
    lmax, pmax, nmax = (lib.ssm_scan_limits(i) for i in range(3))
    if L > lmax or P > pmax or N > nmax:
        raise ValueError(f"ssm_scan: the kernel takes a chunk of at most "
                         f"{lmax}, P <= {pmax} and N <= {nmax}; got L = {L} "
                         f"at {shape}")
    x, dt, Bm, Cm = (_last_contiguous(t) for t in (x, dt, Bm, Cm))
    A = A.contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 10)(
        *[x.stride(i) for i in range(3)], *[dt.stride(i) for i in range(3)],
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
    err = lib.ssm_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                       state.data_ptr(), B, S, H, P, N, L, strides, code,
                       build.stream_of(x))
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed at {shape} "
                           f"{x.dtype}, chunk {L}: CUDA error {err}")
    ssm_scan.launches += 1
    return y, state


ssm_scan.launches = 0
