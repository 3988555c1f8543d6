"""The PER sampling op: a heap-layout sum-tree and its inverse-CDF lookup.

``tree_build`` turns the (P,) leaf masses into the (2P,) tree and
``segment_tree_sample`` answers a batch of targets. Both also take a
leading axis of R trees, one per replica of a population: (R, P) leaves
give (R, 2P) trees, and an (R, 2P) tree answers (R, n) targets, row r
from tree r. On a CUDA tensor each launches its kernel of
``csrc/segment_tree.cu``, with the launches of one tree whatever R is;
on a CPU tensor each runs its plain version (``tree_build_plain``, and
``segment_tree_sample_plain`` of ``kernels/ref.py``). Both kernels are
bitwise equal to their plain versions for any floats, tree by tree.

They replace the TPU kernel ``segment_tree_kernel``
(``src/repro/kernels/segment_tree.py``) and the XLA code of its
``tree_build``. At the DQN path's shapes both are latency-bound, not
bound by bytes or operations: the descent by its launch plus its chain
of dependent loads, which it cuts from log2(P) loads to
ceil(log2(P) / DESCENT_LEVELS) rounds of independent loads (a warp per
target loads the left children of 7 levels at once and walks them in
shared memory); the build by its launches, at most two for
P <= 2^22 (one block per BUILD_SPAN leaves, summed level by level in
shared memory, then the spans' roots). Every output element is written
by its kernel (see the note in the source), so the outputs come from
``build.output``, without deterministic mode's NaN fill.

``segment_tree_rounds`` and ``tree_build_blocked`` replay the two
kernels' schedules on the CPU, with the kernels' index arithmetic. Fake
tensors take a shape-only branch (``route``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.kernels import build, route
from repro_torch.kernels.ref import segment_tree_sample as segment_tree_sample_plain

__all__ = ["next_pow2", "tree_build", "tree_build_plain", "tree_build_plan",
           "tree_build_blocked", "segment_tree_sample",
           "segment_tree_sample_plain", "segment_tree_rounds",
           "descent_rounds", "empty_launch", "DESCENT_LEVELS", "BUILD_SPAN",
           "tree_build_work", "segment_tree_work"]

# tree levels the descent loads per round (csrc/segment_tree.cu, kLevels)
DESCENT_LEVELS = 7
# nodes one block of the build sums (at most 4096, the kernel's kMaxSpan)
BUILD_SPAN = 2048


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _check_pow2(P: int) -> None:
    if P < 1 or P & (P - 1):
        raise ValueError(f"leaf count {P} not a power of two")


def tree_build_plain(priority: torch.Tensor) -> torch.Tensor:
    """(..., P) leaf masses -> (..., 2P) heap-layout sum-trees;
    ``tree[..., 0]`` is unused padding, ``tree[..., 1]`` the total. P
    must be a power of two."""
    P = priority.shape[-1]
    assert P & (P - 1) == 0, f"leaf count {P} not a power of two"
    lead = priority.shape[:-1]
    levels = [priority.to(torch.float32)]
    while levels[-1].shape[-1] > 1:
        levels.append(levels[-1].reshape(lead + (-1, 2)).sum(dim=-1))
    pad = torch.zeros(lead + (1,), dtype=torch.float32,
                      device=priority.device)
    return torch.cat([pad] + levels[::-1], dim=-1)


def tree_build_plan(P: int) -> List[Tuple[int, int]]:
    """The build's launches for P leaves: (N, S) per launch, the level of
    N nodes summed in spans of S = min(N, BUILD_SPAN), first the leaves,
    then the spans' roots, until a launch reaches the root."""
    _check_pow2(P)
    plan, N = [], P
    while True:
        S = min(N, BUILD_SPAN)
        plan.append((N, S))
        N //= S
        if N == 1:
            return plan


def tree_build_blocked(priority: torch.Tensor) -> torch.Tensor:
    """The build kernel's schedule on the CPU: per launch of
    ``tree_build_plan``, each block's span summed in its shared-memory
    heap level by level, each level written to the tree at the kernel's
    indices. (R, P) leaves run as the kernel runs them: the R trees'
    blocks side by side in each launch, block b on tree b // spans. The
    trees start as NaN, so an element the schedule did not write
    shows."""
    P = priority.shape[-1]
    leaves = priority.reshape(-1, P).to(torch.float32)
    R = leaves.shape[0]
    tree = torch.full((R, 2 * P), float("nan"), dtype=torch.float32)
    for launch, (N, S) in enumerate(tree_build_plan(P)):
        spans = N // S
        src = leaves if launch == 0 else tree[:, N:2 * N]
        heap = torch.empty((R * spans, 2 * S), dtype=torch.float32)
        heap[:, S:] = src.reshape(R * spans, S)
        if launch == 0:
            tree[:, N:2 * N] = src
        n = S // 2
        while n >= 1:
            heap[:, n:2 * n] = (heap[:, 2 * n:4 * n:2]
                                + heap[:, 2 * n + 1:4 * n:2])
            tree[:, spans * n:2 * spans * n] = heap[:, n:2 * n].reshape(R, -1)
            n //= 2
        if spans == 1:
            tree[:, 0] = 0.0
    return tree.reshape(priority.shape[:-1] + (2 * P,))


def descent_rounds(P: int) -> List[int]:
    """Levels walked per round of the descent over a tree of P leaves."""
    _check_pow2(P)
    depth = P.bit_length() - 1
    return [min(DESCENT_LEVELS, depth - d)
            for d in range(0, depth, DESCENT_LEVELS)]


def segment_tree_rounds(tree: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """The descent kernel's schedule on the CPU: per round, each target's
    left children of the round's levels gathered in the kernel's order
    (element e: level l = bit length of e + 1, node v 2^l + 2m with
    m = e + 1 - 2^(l-1)), then walked with the plain version's steps.
    (R, 2P) trees and (R, n) targets run as the kernel runs them: the
    R n targets in a row, target i reading tree i // n at its offset in
    the trees laid end to end."""
    P = tree.shape[-1] // 2
    flat = tree.reshape(-1)
    n = max(targets.shape[-1], 1) if targets.dim() else 1
    base = 2 * P * (torch.arange(targets.numel(), dtype=torch.int64) // n)
    v = torch.ones((targets.numel(),), dtype=torch.int64)
    t = targets.reshape(-1).to(torch.float32)
    for k in descent_rounds(P):
        e = torch.arange((1 << k) - 1, dtype=torch.int64)
        lvl = torch.tensor([(x + 1).bit_length() for x in e.tolist()],
                           dtype=torch.int64)
        m = e + 1 - (1 << (lvl - 1))
        s = flat[base[:, None] + (v[:, None] << lvl[None])
                 + 2 * m[None]]                            # (R n, 2^k - 1)
        q = torch.zeros_like(v)
        for lv in range(1, k + 1):
            left = s.gather(1, ((1 << (lv - 1)) - 1 + q)[:, None])[:, 0]
            go_left = t < left
            q = torch.where(go_left, 2 * q, 2 * q + 1)
            t = torch.where(go_left, t, t - left)
        v = (v << k) + q
    return (v - P).to(torch.int32).reshape(targets.shape)


def _lib() -> ctypes.CDLL:
    lib = build.library("segment_tree")
    fn = lib.segment_tree_sample
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.tree_build_levels
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def tree_build(priority: torch.Tensor) -> torch.Tensor:
    """(P,) leaf masses -> (2P,) heap-layout sum-tree, or (R, P) ->
    (R, 2P), P a power of two. CUDA tensors go through the build kernel,
    one launch per entry of ``tree_build_plan`` for all R trees together
    (counted in ``tree_build.launches``); CPU tensors through
    ``tree_build_plain``."""
    return route.call("tree_build", lambda: tree_build_work(priority),
                      _launch_build, tree_build_plain, _build_shape_only, {},
                      priority, differentiable=False)


def tree_build_work(priority: torch.Tensor):
    """(flops, bytes) of one call: the R P leaves read and the (R, 2P)
    trees written once, P - 1 adds a tree."""
    P = priority.shape[-1]
    R = priority.numel() // max(P, 1)
    return R * (P - 1), 3 * R * P * 4


def _build_shape_only(priority: torch.Tensor) -> torch.Tensor:
    return torch.empty(priority.shape[:-1] + (2 * priority.shape[-1],),
                       dtype=torch.float32, device=priority.device)


def _launch_build(priority: torch.Tensor) -> torch.Tensor:
    """The build's launches, counted in ``tree_build.launches``."""
    if priority.dim() not in (1, 2):
        raise ValueError(f"priority must be (P,) or (R, P), got "
                         f"{tuple(priority.shape)}")
    P = priority.shape[-1]
    R = priority.shape[0] if priority.dim() == 2 else 1
    plan = tree_build_plan(P)
    leaves = priority.to(torch.float32).contiguous()
    tree = build.output(priority.shape[:-1] + (2 * P,), torch.float32,
                        priority.device)
    if R == 0:
        return tree
    lib, stream = _lib(), build.stream_of(tree)
    for launch, (N, S) in enumerate(plan):
        err = lib.tree_build_levels(leaves.data_ptr() if launch == 0 else None,
                                    tree.data_ptr(), N, S, R, P, stream)
        if err != 0:
            raise RuntimeError(f"tree_build kernel launch failed: CUDA error {err}")
        tree_build.launches += 1
    return tree


tree_build.launches = 0


def segment_tree_sample(tree: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """tree: (2P,) float32 sum-tree and targets (n,) float32, or R trees
    (R, 2P) and their targets (R, n). Returns (n,) or (R, n) int32 leaf
    indices. CUDA tensors go through the kernel, one launch whatever R is
    (counted in ``segment_tree_sample.launches``); CPU tensors through
    the plain version."""
    return route.call("segment_tree", lambda: segment_tree_work(tree,
                                                                targets),
                      _launch_sample, segment_tree_sample_plain,
                      _sample_shape_only, {}, tree, targets,
                      differentiable=False)


def segment_tree_work(tree: torch.Tensor, targets: torch.Tensor):
    """(flops, bytes) of one call: per target the log2(P) nodes of its
    path read, the target read and its index written; 3 float32
    operations a level."""
    n, depth = targets.numel(), (tree.shape[-1] // 2).bit_length() - 1
    return n * depth * 3, n * depth * 4 + n * 4 + n * 4


def _sample_shape_only(tree: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    return torch.empty(targets.shape, dtype=torch.int32, device=tree.device)


def _launch_sample(tree: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The descent's launch, counted in ``segment_tree_sample.launches``."""
    two_p = tree.shape[-1]
    if tree.dim() not in (1, 2) or two_p < 2 or two_p & (two_p - 1):
        raise ValueError(f"tree must be (2P,) or (R, 2P) with P a power of "
                         f"two, got {tuple(tree.shape)}")
    if tree.dtype != torch.float32 or targets.dtype != torch.float32:
        raise TypeError(f"float32 tree and targets expected, got "
                        f"{tree.dtype} and {targets.dtype}")
    if targets.dim() != tree.dim() or targets.shape[:-1] != tree.shape[:-1] \
            or targets.device != tree.device:
        raise ValueError(f"targets must be (n,) or (R, n) on the tree's "
                         f"device, with the tree's R; got "
                         f"{tuple(targets.shape)} for a "
                         f"{tuple(tree.shape)} tree")
    tree = tree.contiguous()
    targets = targets.contiguous()
    out = build.output(targets.shape, torch.int32, tree.device)
    err = _lib().segment_tree_sample(tree.data_ptr(), targets.data_ptr(),
                                     out.data_ptr(), targets.shape[-1],
                                     targets.numel(), two_p // 2,
                                     build.stream_of(tree))
    if err != 0:
        raise RuntimeError(f"segment_tree kernel launch failed: CUDA error {err}")
    segment_tree_sample.launches += 1
    return out


segment_tree_sample.launches = 0


def empty_launch(device) -> None:
    """Launch the empty kernel of ``csrc/segment_tree.cu`` on ``device``'s
    current stream: the time any launch takes, the floor of the two
    latency-bound kernels above."""
    err = _lib().empty_launch(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
