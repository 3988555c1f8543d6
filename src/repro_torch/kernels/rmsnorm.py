"""The RMSNorm op: rows of x scaled by rsqrt(mean(x^2) + eps) and a gain.

On a CUDA tensor ``rmsnorm`` launches the kernel of ``csrc/rmsnorm.cu``
(one block per row); on a CPU tensor it runs the plain version of
``kernels/ref.py``. The two agree to float rounding: the kernel sums the
squares in another order. Forward only: the serve path needs no
gradient.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

__all__ = ["rmsnorm", "rmsnorm_plain"]


def _lib() -> ctypes.CDLL:
    lib = build.library("rmsnorm")
    fn = lib.rmsnorm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16; gamma: (D,) float32. Returns x's
    shape and type. CUDA tensors go through the kernel (its launches are
    counted in ``rmsnorm.launches``); CPU tensors through the plain
    version."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gamma, eps)
    D = x.shape[-1]
    code = build.dtype_code("rmsnorm", x)
    if gamma.shape != (D,) or gamma.dtype != torch.float32:
        raise ValueError(f"rmsnorm: gamma must be ({D},) float32, got "
                         f"{tuple(gamma.shape)} {gamma.dtype}")
    if gamma.device != x.device:
        raise ValueError("rmsnorm: gamma must be on x's device")
    x2 = x.reshape(-1, D).contiguous()
    gamma = gamma.contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    vec = int(D % (16 // x2.element_size()) == 0 and x2.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    err = _lib().rmsnorm(x2.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows,
                         D, float(eps), code, vec, build.stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed at ({rows}, {D}) "
                           f"{x.dtype}: CUDA error {err}")
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
