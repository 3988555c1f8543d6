"""The sLSTM scan op: the sequential sLSTM recurrence of the prefill.

``slstm_scan`` takes the input contributions wx (B, S, 4d) (gates z, i,
f, o), the block-diagonal recurrent weights R (4, H, Pd, Pd) float32, the
bias b (4d,) float32 and the state (c, n, h, m), each (B, d) float32,
and returns hs (B, S, d) in wx's type and the final state. On a CUDA
tensor it launches the kernel of ``csrc/slstm_scan.cu`` (any S); on a
CPU tensor it runs the plain version of ``kernels/ref.py``. Forward
only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import slstm_scan as slstm_scan_plain

__all__ = ["slstm_scan", "slstm_scan_plain"]

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _lib() -> ctypes.CDLL:
    lib = build.library("slstm_scan")
    fn = lib.slstm_scan
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.slstm_scan_smem.argtypes = [ctypes.c_int]
    lib.slstm_scan_smem.restype = ctypes.c_longlong
    return lib


def slstm_scan(wx: torch.Tensor, R: torch.Tensor, b: torch.Tensor,
               state: State, n_heads: int) -> Tuple[torch.Tensor, State]:
    """wx: (B, S, 4d) float32 or bfloat16; R: (4, H, Pd, Pd), b: (4d,) and
    the state's four (B, d) tensors float32; H = n_heads, d = H Pd. CUDA
    tensors go through the kernel (its launches are counted in
    ``slstm_scan.launches``); CPU tensors through the plain version."""
    if wx.device.type == "cpu":
        return slstm_scan_plain(wx, R, b, state, n_heads)
    B, S, d4 = wx.shape
    d, H = d4 // 4, n_heads
    Pd = d // H if H else 0
    shape = (f"wx {tuple(wx.shape)}, R {tuple(R.shape)}, b {tuple(b.shape)}, "
             f"state {[tuple(s.shape) for s in state]}")
    if (d4 % 4 or H <= 0 or d % H or R.shape != (4, H, Pd, Pd)
            or b.shape != (d4,) or len(state) != 4
            or any(s.shape != (B, d) for s in state)):
        raise ValueError(f"slstm_scan: inconsistent shapes {shape} with "
                         f"{n_heads} heads")
    if any(t.device != wx.device for t in (R, b, *state)):
        raise ValueError("slstm_scan: all inputs must share one device")
    code = build.dtype_code("slstm_scan", wx)
    if any(t.dtype != torch.float32 for t in (R, b, *state)):
        raise TypeError(f"slstm_scan: R, b and the state must be float32, "
                        f"got {[t.dtype for t in (R, b, *state)]}")
    lib = _lib()
    if Pd % 4 or lib.slstm_scan_smem(Pd) > build.MAX_SMEM_BYTES:
        raise ValueError(f"slstm_scan: the kernel takes a head size that is "
                         f"a multiple of 4 and at most 768; got {shape}")
    if wx.stride(-1) != 1:
        wx = wx.contiguous()
    # dense, as the kernel finds R[g, head] at (g * H + head) * Pd * Pd
    R = build.vector_ready(R.contiguous())
    b = b.contiguous()
    c0, n0, h0, m0 = (s.contiguous() for s in state)
    hs = torch.empty((B, S, d), dtype=wx.dtype, device=wx.device)
    out = tuple(torch.empty((B, d), dtype=torch.float32, device=wx.device)
                for _ in range(4))
    err = lib.slstm_scan(
        wx.data_ptr(), R.data_ptr(), b.data_ptr(), c0.data_ptr(),
        n0.data_ptr(), h0.data_ptr(), m0.data_ptr(), hs.data_ptr(),
        *[t.data_ptr() for t in out], B, S, H, Pd, wx.stride(0),
        wx.stride(1), code, build.stream_of(wx))
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed at {shape} "
                           f"{wx.dtype}: CUDA error {err}")
    slstm_scan.launches += 1
    return hs, out


slstm_scan.launches = 0
