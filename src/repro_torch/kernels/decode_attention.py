"""The decode attention op: one new token per sequence against a KV cache.

``decode_attention`` takes the model's layout, q (B, 1, H, D) and caches
(B, Hkv, L, D), and a count ``cache_len`` of valid positions (a device
int32 scalar, so the decode loop never waits for the card), and returns
(B, 1, H, D). Positions ``pos < min(cache_len, L)`` are attended: a ring
cache passes cache_len > L once it has wrapped. On a CUDA tensor it
launches the kernel of ``csrc/decode_attention.cu``; on a CPU tensor it
runs the plain version of ``kernels/ref.py``. Forward only.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention as _plain

__all__ = ["decode_attention", "decode_attention_plain"]


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           cache_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """The plain version in the model's layout."""
    B, _, H, D = q.shape
    return _plain(q.reshape(B, H, D), k_cache, v_cache, cache_len)[:, None]


def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    fn = lib.decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.decode_attention_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.decode_attention_smem.restype = ctypes.c_longlong
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, Hkv, L, D), H % Hkv == 0; float32 or
    bfloat16; cache_len: () int32 on q's device (an int is placed there).
    CUDA tensors go through the kernel (its launches are counted in
    ``decode_attention.launches``); CPU tensors through the plain
    version."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    B, one, H, D = q.shape
    _, Hkv, L, _ = k_cache.shape
    shape = (f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)} and "
             f"{tuple(v_cache.shape)}")
    if (one != 1 or k_cache.shape != (B, Hkv, L, D)
            or v_cache.shape != k_cache.shape or Hkv == 0 or H % Hkv
            or L == 0):
        raise ValueError(f"decode_attention: inconsistent shapes {shape}")
    if D % 8:
        raise ValueError(f"decode_attention: the kernel takes a head dim "
                         f"that is a multiple of 8; got {shape}")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("decode_attention: q and the caches must share one "
                         "device")
    code = build.dtype_code("decode_attention", q, k_cache, v_cache)
    lib = _lib()
    smem = lib.decode_attention_smem(D, H // Hkv)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention: head dim {D} with {H // Hkv} "
                         f"query heads per KV head needs {smem} bytes of "
                         f"shared memory, over the card's "
                         f"{build.MAX_SMEM_BYTES}; got {shape}")
    if not isinstance(cache_len, torch.Tensor):
        cache_len = torch.full((), int(cache_len), dtype=torch.int32,
                               device=q.device)
    if (cache_len.numel() != 1 or cache_len.dtype != torch.int32
            or cache_len.device != q.device):
        raise TypeError(f"decode_attention: cache_len must be one int32 on "
                        f"{q.device}, got {cache_len.dtype} "
                        f"{tuple(cache_len.shape)} on {cache_len.device}")
    q = q.contiguous()
    k_cache, v_cache = (build.vector_ready(t) for t in (k_cache, v_cache))
    cache_len = cache_len.contiguous()
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 8)(
        q.stride(0), *[t.stride(i) for t in (k_cache, v_cache)
                       for i in (0, 1, 2)], out.stride(0))
    err = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), B, H, Hkv, L, D, strides,
        float(D ** -0.5), code, build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed at "
                           f"{shape} {q.dtype}: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
