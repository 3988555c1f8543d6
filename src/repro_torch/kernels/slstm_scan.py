"""The sLSTM scan op: the sequential sLSTM recurrence of the prefill.

``slstm_scan`` takes the input contributions wx (B, S, 4d) (gates z, i,
f, o), the block-diagonal recurrent weights R (4, H, Pd, Pd) float32, the
bias b (4d,) float32 and the state (c, n, h, m), each (B, d) float32,
and returns hs (B, S, d) in wx's type and the final state. On a CUDA
tensor it launches the kernel of ``csrc/slstm_scan.cu`` (any S) with the
body ``cluster_plan`` picks for the shape: R resident across a
thread-block cluster with h exchanged through distributed shared memory,
or R streamed from L2 where a head's R does not fit the cluster. On a
CPU tensor it runs the plain version of ``kernels/ref.py``.
``slstm_scan_cluster`` replays the cluster body's schedule in plain
PyTorch for the tests. A call that must record a gradient goes through
``recompute.PlainRecompute``: the kernel forward, the plain version's
autograd backward, from hs and the final state to wx, R, b and the
incoming state (the reference has no vjp here and trains xLSTM through
its XLA scan; the port has no such switch, so it takes the same rule as
the other kernels). Fake tensors take a shape-only branch (the dry run
never steps the recurrence; ``route``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, route
from repro_torch.kernels.ref import slstm_scan as slstm_scan_plain

__all__ = ["slstm_scan", "slstm_scan_plain", "slstm_scan_cluster",
           "cluster_plan", "SlstmPlan", "slstm_scan_work"]

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# as csrc/slstm_scan.cu: batch rows per cluster or block, the cluster
# body's threads at most, steps in its wx ring; the stream body's threads
# and slices at most
BT = 8
CLUSTER_THREADS = 384
RING = 4
STREAM_THREADS, STREAM_SPLITS = 768, 8
# ranks tried from the most, and slices of the Pd rows per rank's sum
RANKS = (16, 8, 4, 2, 1)
SPLITS = (16, 8)
PORTABLE_RANKS = 8


class SlstmPlan(NamedTuple):
    body: str            # "cluster" or "stream"
    ranks: int           # blocks per cluster (1 for the stream body)
    splits: int          # slices of the Pd rows in one block's sum
    smem_bytes: int      # shared memory per block


def _part_stride(U: int) -> int:
    W = 4 * U
    return W + (U - W) % 32


def cluster_smem(Pd: int, ranks: int, splits: int, itemsize: int) -> int:
    """Shared memory per block of the cluster body: R's 4 U columns over
    Pd rows, h double-buffered, the partial sums and the wx ring."""
    U = Pd // ranks
    return ((Pd * 4 * U + 2 * BT * Pd + splits * BT * _part_stride(U)) * 4
            + RING * BT * 4 * U * itemsize)


def _stream_splits(Pd: int) -> int:
    return min(max(STREAM_THREADS // Pd, 1), STREAM_SPLITS)


def stream_smem(Pd: int) -> int:
    """Shared memory per block of the stream body."""
    return (_stream_splits(Pd) * BT * 4 * Pd + 4 * BT * Pd) * 4


def _cluster_ok(Pd: int, ranks: int, splits: int) -> bool:
    if Pd % ranks:
        return False
    U = Pd // ranks
    return (U % 4 == 0 and splits in SPLITS and splits <= Pd // 4
            and U * splits <= CLUSTER_THREADS)


def cluster_plan(B: int, H: int, Pd: int, itemsize: int = 2,
                 max_active: Optional[Callable[[int, int], int]] = None
                 ) -> SlstmPlan:
    """The body and shape the kernel takes for batch B, H heads of size
    Pd and wx of ``itemsize`` bytes. The cluster body with the most ranks
    whose R columns fall into 16-byte pieces and fit a block's shared
    memory, with the most slices that keep a block within its threads;
    more than 8 ranks (a non-portable cluster size) only where
    ``max_active(ranks, splits)`` (the card's
    cudaOccupancyMaxActiveClusters; unknown off the card) holds every
    cluster of the launch at once, and any size only where it holds one.
    Else the stream body."""
    clusters = H * -(-B // BT)
    for ranks in RANKS:
        for splits in SPLITS:
            if not _cluster_ok(Pd, ranks, splits):
                continue
            smem = cluster_smem(Pd, ranks, splits, itemsize)
            if smem > build.MAX_SMEM_BYTES:
                continue
            if max_active is None:
                if ranks > PORTABLE_RANKS:
                    continue
            elif max_active(ranks, splits) < (
                    clusters if ranks > PORTABLE_RANKS else 1):
                continue
            return SlstmPlan("cluster", ranks, splits, smem)
    return SlstmPlan("stream", 1, _stream_splits(Pd), stream_smem(Pd))


def slstm_scan_cluster(wx: torch.Tensor, R: torch.Tensor, b: torch.Tensor,
                       state: State, n_heads: int, ranks: int
                       ) -> Tuple[torch.Tensor, State]:
    """The cluster body's schedule in plain PyTorch (float32): rank r of
    ``ranks`` holds R's columns of units [r U, (r + 1) U) of all four
    gates over all Pd rows and the state of those units; at step t each
    rank computes its units' pre-activations from the full h_{t-1} in its
    own buffer of parity t % 2, updates its units, and writes its slice
    of h_t into every rank's buffer of parity (t + 1) % 2. Arguments and
    results as ``slstm_scan``."""
    B, S, d4 = wx.shape
    d, H = d4 // 4, n_heads
    Pd = d // H
    if Pd % ranks:
        raise ValueError(f"slstm_scan_cluster: {ranks} ranks do not divide "
                         f"the head size {Pd}")
    U = Pd // ranks
    R32 = R.to(torch.float32)
    bias = b.to(torch.float32).reshape(4, H, Pd)
    w = wx.to(torch.float32).reshape(B, S, 4, H, Pd)
    c, n, h, m = (s.to(torch.float32).reshape(B, H, Pd) for s in state)
    c, n, m = c.clone(), n.clone(), m.clone()
    cols = [slice(r * U, (r + 1) * U) for r in range(ranks)]
    bufs = [[h.clone(), torch.empty_like(h)] for _ in range(ranks)]
    h_own = [h[..., sl].clone() for sl in cols]
    hs = torch.empty((B, S, H, Pd), dtype=torch.float32, device=wx.device)
    for t in range(S):
        cur, nxt = t % 2, (t + 1) % 2
        for r, sl in enumerate(cols):
            rec = torch.einsum("bhp,ghpu->bghu", bufs[r][cur],
                               R32[..., sl])
            pre = w[:, t, :, :, sl] + rec + bias[None, :, :, sl]
            z, i, f, o = pre.unbind(1)
            f_log = F.logsigmoid(f)
            m_new = torch.maximum(f_log + m[..., sl], i)
            i_p = torch.exp(i - m_new)
            f_p = torch.exp(f_log + m[..., sl] - m_new)
            c[..., sl] = f_p * c[..., sl] + i_p * torch.tanh(z)
            n[..., sl] = f_p * n[..., sl] + i_p
            m[..., sl] = m_new
            h_own[r] = torch.sigmoid(o) * c[..., sl] / torch.clamp(
                n[..., sl], min=1.0)
        for r, sl in enumerate(cols):   # every rank's slice to every rank
            for q in range(ranks):
                bufs[q][nxt][..., sl] = h_own[r]
            hs[:, t, :, sl] = h_own[r]
    h = torch.cat(h_own, dim=-1)
    final = tuple(s.reshape(B, d) for s in (c, n, h, m))
    return hs.reshape(B, S, d).to(wx.dtype), final


def _lib() -> ctypes.CDLL:
    lib = build.library("slstm_scan")
    fn = lib.slstm_scan
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.slstm_scan_smem.argtypes = [ctypes.c_int] * 5
    lib.slstm_scan_smem.restype = ctypes.c_longlong
    lib.slstm_scan_max_clusters.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    lib.slstm_scan_max_clusters.restype = ctypes.c_int
    lib.slstm_scan_floor.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.slstm_scan_floor.restype = ctypes.c_int
    return lib


def exchange_floor(B: int, S: int, H: int, Pd: int, plan: SlstmPlan,
                   device) -> torch.Tensor:
    """Launch the cluster body's serial floor at this shape: S steps of
    its h exchange through distributed shared memory and its cluster
    barrier alone, with the plan's cluster and block (for timing; not on
    any path). Returns its (tiles * 8, H * Pd) float32 output."""
    if plan.body != "cluster":
        raise ValueError(f"exchange_floor: {plan} is not the cluster body")
    out = build.output((-(-B // BT) * BT, H * Pd), torch.float32, device)
    err = _lib().slstm_scan_floor(out.data_ptr(), B, S, H, Pd, plan.ranks,
                                  plan.splits, build.stream_of(out))
    if err != 0:
        raise RuntimeError(f"slstm_scan_floor at ({B}, {S}, {H}, {Pd}) "
                           f"{plan}: CUDA error {err}")
    return out


_max_active_cache = {}


def max_active_clusters(Pd: int, ranks: int, splits: int,
                        dtype: torch.dtype) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster body at this shape on
    the current card (cached)."""
    key = (torch.cuda.current_device(), Pd, ranks, splits, dtype)
    if key not in _max_active_cache:
        out = ctypes.c_int()
        err = _lib().slstm_scan_max_clusters(
            Pd, ranks, splits, build.DTYPE_CODES[dtype], ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"slstm_scan_max_clusters at Pd {Pd}, "
                               f"{ranks} ranks: CUDA error {err}")
        _max_active_cache[key] = out.value
    return _max_active_cache[key]


def kernel_plan(B: int, H: int, Pd: int, dtype: torch.dtype) -> SlstmPlan:
    """The plan the kernel takes on the current card."""
    return cluster_plan(
        B, H, Pd, torch.finfo(dtype).bits // 8,
        lambda ranks, splits: max_active_clusters(Pd, ranks, splits, dtype))


def slstm_scan(wx: torch.Tensor, R: torch.Tensor, b: torch.Tensor,
               state: State, n_heads: int) -> Tuple[torch.Tensor, State]:
    """wx: (B, S, 4d) float32 or bfloat16; R: (4, H, Pd, Pd), b: (4d,) and
    the state's four (B, d) tensors float32; H = n_heads, d = H Pd. CUDA
    tensors go through the kernel (its launches are counted in
    ``slstm_scan.launches``); CPU tensors through the plain version; fake
    tensors through the shape-only branch (``route``). On the card a call
    that needs a gradient gets it from the plain version
    (``recompute``)."""
    hs, *out = route.call("slstm_scan",
                          lambda: slstm_scan_work(wx, R, n_heads),
                          _flat(_launch), _flat(slstm_scan_plain),
                          _flat(_shape_only), {"n_heads": n_heads},
                          wx, R, b, *state)
    return hs, tuple(out)


def slstm_scan_work(wx: torch.Tensor, R: torch.Tensor, n_heads: int):
    """(flops, bytes) of one call: wx, R, b and the state read and hs and
    the state written once; per row and step the recurrent product (2 x
    4d x Pd) and ~30 float32 operations per unit for the gates."""
    B, S, d4 = wx.shape
    d = d4 // 4
    Pd = d // n_heads
    item = wx.element_size()
    nbytes = (B * S * d4 * item + R.numel() * 4 + d4 * 4 + 8 * B * d * 4
              + B * S * d * item)
    return B * S * (2 * d4 * Pd + 30 * d), nbytes


def _shape_only(wx, R, b, state, n_heads):
    B, S, d4 = wx.shape
    d = d4 // 4
    return (torch.empty((B, S, d), dtype=wx.dtype, device=wx.device),
            tuple(torch.empty((B, d), dtype=torch.float32, device=wx.device)
                  for _ in range(4)))


def _flat(scan: Callable) -> Callable:
    """``scan`` taking the state's four tensors as arguments of their own
    and returning (hs, c, n, h, m): the form of ``PlainRecompute``."""
    def flat(wx, R, b, c, n, h, m, n_heads):
        hs, state = scan(wx, R, b, (c, n, h, m), n_heads)
        return (hs, *state)
    return flat


def _launch(wx: torch.Tensor, R: torch.Tensor, b: torch.Tensor, state: State,
            n_heads: int) -> Tuple[torch.Tensor, State]:
    """The kernel's launch, counted in ``slstm_scan.launches``."""
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
    if Pd % 4 or Pd > STREAM_THREADS:
        raise ValueError(f"slstm_scan: the kernel takes a head size that is "
                         f"a multiple of 4 and at most {STREAM_THREADS}; got "
                         f"{shape}")
    lib = _lib()
    plan = kernel_plan(B, H, Pd, wx.dtype)
    if plan.smem_bytes > build.MAX_SMEM_BYTES:
        raise ValueError(f"slstm_scan: {shape} needs {plan.smem_bytes} bytes "
                         f"of shared memory per block, over the card's "
                         f"{build.MAX_SMEM_BYTES}")
    if wx.stride(-1) != 1:
        wx = wx.contiguous()
    if plan.body == "cluster" and (
            wx.stride(0) % 4 or wx.stride(1) % 4
            or wx.data_ptr() % (4 * wx.element_size())):
        # the cluster body copies wx in pieces of 4 values
        wx = wx.clone(memory_format=torch.contiguous_format)
    # dense, as the kernel finds R[g, head] at (g * H + head) * Pd * Pd
    R = build.vector_ready(R.contiguous())
    b = b.contiguous()
    c0, n0, h0, m0 = (s.contiguous() for s in state)
    hs = build.output((B, S, d), wx.dtype, wx.device)
    out = tuple(build.output((B, d), torch.float32, wx.device)
                for _ in range(4))
    err = lib.slstm_scan(
        wx.data_ptr(), R.data_ptr(), b.data_ptr(), c0.data_ptr(),
        n0.data_ptr(), h0.data_ptr(), m0.data_ptr(), hs.data_ptr(),
        *[t.data_ptr() for t in out], B, S, H, Pd, wx.stride(0),
        wx.stride(1), int(plan.body == "cluster"), plan.ranks, plan.splits,
        code, build.stream_of(wx))
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed at {shape} "
                           f"{wx.dtype} ({plan}): CUDA error {err}")
    slstm_scan.launches += 1
    return hs, out


slstm_scan.launches = 0
