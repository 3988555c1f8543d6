"""The decode attention op: one new token per sequence against a KV cache.

``decode_attention`` takes the model's layout, q (B, 1, H, D) and caches
(B, Hkv, L, D), and a count ``cache_len`` of valid positions (a device
int32 scalar, so the decode loop never waits for the card), and returns
(B, 1, H, D). Positions ``pos < min(cache_len, L)`` are attended: a ring
cache passes cache_len > L once it has wrapped. On a CUDA tensor it
launches the kernel of ``csrc/decode_attention.cu``, which splits the
cache over a cluster of blocks and combines their partial softmax
states in the same launch; on a CPU tensor it runs the plain version of
``kernels/ref.py``. ``decode_attention_split`` emulates the kernel's
split and fixed-order combine in plain PyTorch, and
``kernel_split_plan`` reports the split the kernel picks; the tests use
both. With ``return_lse`` each also returns the rows' log-sum-exp of the
scaled scores, which the kernel writes in its combine: what a caller
that splits L over ranks combines the ranks' outputs by. Forward only.
Fake tensors take a shape-only branch (``route``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from repro_torch.kernels import build, route
from repro_torch.kernels.ref import decode_attention as _plain

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_split", "kernel_split_plan", "split_chunk",
           "decode_attention_work", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           cache_len: Union[int, torch.Tensor],
                           return_lse: bool = False):
    """The plain version in the model's layout: (B, 1, H, D), and with
    ``return_lse`` the float32 (B, 1, H) log-sum-exp."""
    B, _, H, D = q.shape
    out = _plain(q.reshape(B, H, D), k_cache, v_cache, cache_len,
                 return_lse=return_lse)
    if return_lse:
        return out[0][:, None], out[1][:, None]
    return out[:, None]


def split_chunk(L: int, splits: int) -> int:
    """Positions per split of a cache of capacity L, as the kernel cuts
    it: split i covers [i chunk, (i + 1) chunk)."""
    return (-(-L // splits) + 7) // 8 * 8


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           cache_len: Union[int, torch.Tensor],
                           splits: int, return_lse: bool = False):
    """The kernel's schedule in plain PyTorch (float32 throughout): each
    of ``splits`` chunks of the cache yields (m, l, acc) over its share
    of the valid prefix, or (-1e30, 0, 0) if it has none, and the chunks
    are combined in split order: m* = max m_i, l = sum e^(m_i - m*) l_i,
    out = sum e^(m_i - m*) acc_i / max(l, 1e-30), and the log-sum-exp
    m* + log(l) (-inf where l is 0). Layouts as ``decode_attention``."""
    B, _, H, D = q.shape
    Hkv, L = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    dev = q.device
    chunk = split_chunk(L, splits)
    n = min(int(cache_len), L)
    qf = q.reshape(B, Hkv, G, D).float()
    kf, vf = k_cache.float(), v_cache.float()
    s = torch.einsum("bkgd,bkld->bkgl", qf, kf) * D ** -0.5
    parts = []
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, n)
        if hi <= lo:
            parts.append((torch.full((B, Hkv, G), -1e30, device=dev),
                          torch.zeros(B, Hkv, G, device=dev),
                          torch.zeros(B, Hkv, G, D, device=dev)))
            continue
        si = s[..., lo:hi]
        m = si.amax(-1)
        p = torch.exp(si - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgl,bkld->bkgd", p, vf[:, :, lo:hi])))
    m_star = parts[0][0]
    for m, _, _ in parts[1:]:
        m_star = torch.maximum(m_star, m)
    l = torch.zeros_like(m_star)
    o = torch.zeros(B, Hkv, G, D, device=dev)
    for m, li, acc in parts:
        w = torch.exp(m - m_star)
        l = l + w * li
        o = o + w[..., None] * acc
    out = o / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, 1, H, D).to(q.dtype)
    if return_lse:
        return out, (m_star + torch.log(l)).reshape(B, 1, H)
    return out


def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    fn = lib.decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.decode_attention_smem.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_smem.restype = ctypes.c_longlong
    lib.decode_attention_split_plan.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.decode_attention_split_plan.restype = ctypes.c_int
    return lib


def kernel_split_plan(B: int, H: int, Hkv: int, L: int, D: int,
                      dtype: torch.dtype) -> Tuple[int, int]:
    """(splits, chunk) that the kernel picks for these shapes on this
    card: the splits double, up to 8, while each keeps at least 64
    positions and the grid fits on the card at once."""
    splits, chunk = ctypes.c_int(), ctypes.c_int()
    err = _lib().decode_attention_split_plan(
        B, H, Hkv, L, D, build.DTYPE_CODES[dtype], ctypes.byref(splits),
        ctypes.byref(chunk))
    if err != 0:
        raise RuntimeError(f"decode_attention_split_plan: CUDA error {err}")
    return splits.value, chunk.value


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor],
                     return_lse: bool = False):
    """q: (B, 1, H, D); caches: (B, Hkv, L, D), H % Hkv == 0; float32 or
    bfloat16; cache_len: () int32 on q's device (an int is placed there).
    Returns (B, 1, H, D) in q's type; with ``return_lse`` also the float32
    (B, 1, H) log-sum-exp of the scaled scores over the valid positions,
    -inf where there are none. CUDA tensors go through the kernel (its
    launches are counted in ``decode_attention.launches``); CPU tensors
    through the plain version; fake tensors through the shape-only
    branch (``route``)."""
    return route.call("decode_attention",
                      lambda: decode_attention_work(q, k_cache, return_lse),
                      _launch, decode_attention_plain, _shape_only,
                      {"cache_len": cache_len, "return_lse": return_lse},
                      q, k_cache, v_cache, differentiable=False)


def decode_attention_work(q: torch.Tensor, k_cache: torch.Tensor,
                          return_lse: bool = False):
    """(flops, bytes) of one call, from the shapes alone: q read and the
    output written once, all L rows of both caches read once, and
    cache_len, and with ``return_lse`` the float32 log-sum-exp written;
    4 D operations per (query head, row). An upper bound
    where the cache is not full: the kernel reads min(cache_len, L)
    rows, but cache_len lives on the device, and reading it here would
    make the host wait on every step."""
    B, _, H, D = q.shape
    _, Hkv, L, _ = k_cache.shape
    return (4 * D * B * H * L,
            (2 * B * H * D + 2 * B * Hkv * L * D) * q.element_size() + 4
            + (4 * B * H if return_lse else 0))


def _shape_only(q, k_cache, v_cache, cache_len, return_lse=False):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if return_lse:
        return out, torch.empty(q.shape[:3], dtype=torch.float32,
                                device=q.device)
    return out


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            cache_len: Union[int, torch.Tensor], return_lse: bool = False):
    """The kernel's launch, counted in ``decode_attention.launches``."""
    B, one, H, D = q.shape
    _, Hkv, L, _ = k_cache.shape
    shape = (f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)} and "
             f"{tuple(v_cache.shape)}")
    if (one != 1 or k_cache.shape != (B, Hkv, L, D)
            or v_cache.shape != k_cache.shape or Hkv == 0 or H % Hkv
            or L == 0):
        raise ValueError(f"decode_attention: inconsistent shapes {shape}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: the kernel takes a head dim "
                         f"that is a multiple of 8 and at most "
                         f"{MAX_HEAD_DIM}; got {shape}")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("decode_attention: q and the caches must share one "
                         "device")
    code = build.dtype_code("decode_attention", q, k_cache, v_cache)
    lib = _lib()
    smem = lib.decode_attention_smem(D, H // Hkv, code)
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
    lse = (build.output((B, 1, H), torch.float32, q.device)
           if return_lse else None)
    strides = (ctypes.c_int64 * 8)(
        q.stride(0), *[t.stride(i) for t in (k_cache, v_cache)
                       for i in (0, 1, 2)], out.stride(0))
    err = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, Hkv, L, D, strides,
        float(D ** -0.5), code, build.stream_of(q))
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed at "
                           f"{shape} {q.dtype}: CUDA error {err}")
    decode_attention.launches += 1
    return out if lse is None else (out, lse)


decode_attention.launches = 0
