"""The PER sampling op: inverse-CDF lookup over a heap-layout sum-tree.

``tree_build`` turns the (P,) leaf masses into the (2P,) tree in plain
torch, as the reference leaves it to XLA outside its kernel.
``segment_tree_sample`` answers a batch of targets: on a CUDA tensor it
launches the kernel of ``csrc/segment_tree.cu``, on a CPU tensor it runs
the plain version of ``kernels/ref.py``. The kernel is bitwise equal to
the plain version for any floats (see the note in the source).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import segment_tree_sample as segment_tree_sample_plain

__all__ = ["next_pow2", "tree_build", "segment_tree_sample",
           "segment_tree_sample_plain"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def tree_build(priority: torch.Tensor) -> torch.Tensor:
    """(P,) leaf masses -> (2P,) heap-layout sum-tree; ``tree[0]`` is
    unused padding, ``tree[1]`` the total. P must be a power of two."""
    P = priority.shape[0]
    assert P & (P - 1) == 0, f"leaf count {P} not a power of two"
    levels = [priority.to(torch.float32)]
    while levels[-1].shape[0] > 1:
        levels.append(levels[-1].reshape(-1, 2).sum(dim=1))
    pad = torch.zeros((1,), dtype=torch.float32, device=priority.device)
    return torch.cat([pad] + levels[::-1])


def _lib() -> ctypes.CDLL:
    lib = build.library("segment_tree")
    fn = lib.segment_tree_sample
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def segment_tree_sample(tree: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """tree: (2P,) float32 sum-tree; targets: (n,) float32. Returns (n,)
    int32 leaf indices. CUDA tensors go through the kernel (its launches
    are counted in ``segment_tree_sample.launches``); CPU tensors through
    the plain version."""
    if tree.device.type == "cpu":
        return segment_tree_sample_plain(tree, targets)
    two_p = tree.shape[0]
    if tree.dim() != 1 or two_p < 2 or two_p & (two_p - 1):
        raise ValueError(f"tree must be (2P,) with P a power of two, got "
                         f"{tuple(tree.shape)}")
    if tree.dtype != torch.float32 or targets.dtype != torch.float32:
        raise TypeError(f"float32 tree and targets expected, got "
                        f"{tree.dtype} and {targets.dtype}")
    if targets.dim() != 1 or targets.device != tree.device:
        raise ValueError("targets must be (n,) on the tree's device")
    tree = tree.contiguous()
    targets = targets.contiguous()
    out = torch.empty(targets.shape, dtype=torch.int32, device=tree.device)
    stream = torch.cuda.current_stream(tree.device).cuda_stream
    err = _lib().segment_tree_sample(tree.data_ptr(), targets.data_ptr(),
                                     out.data_ptr(), targets.shape[0],
                                     two_p // 2, stream)
    if err != 0:
        raise RuntimeError(f"segment_tree kernel launch failed: CUDA error {err}")
    segment_tree_sample.launches += 1
    return out


segment_tree_sample.launches = 0
