"""The SSD scan op: the chunked Mamba2 state-space scan of the prefill.

``ssm_scan`` takes the model's layout, x (B, S, H, P), dt (B, S, H)
float32 (after the softplus), A (H,) float32 and Bm, Cm (B, S, N), and
returns y (B, S, H, P) in x's type and the final state (B, H, P, N) in
float32, from a zero state. The chunk rule is the reference's: L =
min(chunk, S), and S must be a multiple of L. On a CUDA tensor it
launches the kernel of ``csrc/ssm_scan.cu``, which reads these layouts
through their strides (no transpose), with the body ``ssd_plan`` picks:
for bf16 at P = N = 64 and L a multiple of 16, the cluster body (chunks
in parallel, the products on the tensor cores, the state passed from
chunk to chunk through distributed shared memory); else the scalar body.
On a CPU tensor it runs the plain version of ``kernels/ref.py`` (the
sequential recurrence) in the kernel layout (B, H, S, P).
``ssm_scan_cluster`` replays the cluster body's schedule in plain
PyTorch for the tests. A call that must record a gradient goes through
``recompute.PlainRecompute``: the kernel forward, the plain version's
autograd backward (the reference's ``custom_vjp`` rule), y and the final
state both differentiable. Fake tensors take a shape-only branch (the
dry run never steps the recurrence; ``route``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, route
from repro_torch.kernels.ref import ssm_scan as _plain

__all__ = ["ssm_scan", "ssm_scan_plain", "ssm_scan_cluster", "chunk_length",
           "ssd_plan", "kernel_plan", "SsdPlan", "ssm_scan_work"]

# as csrc/ssm_scan.cu: the scalar body's tile limits and shared memory;
# the cluster body's head size and state, bf16 row of its tiles, x tiles
# in its ring, bytes of a message (the state in float32)
LMAX, PMAX, NMAX = 128, 64, 64
SCALAR_SMEM = (2 * NMAX * (LMAX + 4) + LMAX * (LMAX + 4) + LMAX * NMAX
               + LMAX * PMAX + NMAX * PMAX + 4 * LMAX) * 4
CLUSTER_P = CLUSTER_N = 64
ROW, STAGES = 72, 4
MSG_BYTES = CLUSTER_P * CLUSTER_N * 4
# heads per block the plan takes; ranks tried from the most
HEADS = 16
RANKS = (16, 8, 4, 2)
PORTABLE_RANKS = 8


class SsdPlan(NamedTuple):
    body: str            # "cluster" or "scalar"
    ranks: int           # blocks per cluster (1 for the scalar body)
    heads: int           # heads per block (1 for the scalar body)
    smem_bytes: int      # shared memory per block


def chunk_length(S: int, chunk: int) -> int:
    """The reference's chunk rule: L = min(chunk, S), S % L == 0."""
    L = min(chunk, S)
    if L <= 0 or S % L:
        raise ValueError(f"ssm_scan: the sequence length {S} is not a "
                         f"multiple of the chunk min({chunk}, {S}) = {L}")
    return L


def cluster_smem(heads: int) -> int:
    """Shared memory per block of the cluster body: its four mbarriers,
    two message slots, the x ring, the B and C tiles, x exp(cum_L - cum)
    dt as two bf16 tiles, y's staging tile, three float32 vectors of LMAX
    per head (cum, dt, the decay's column factor) and cum_L and
    exp(cum_L) per head."""
    return (64 + 2 * MSG_BYTES + (STAGES + 4) * LMAX * ROW * 2
            + LMAX * CLUSTER_P * 2 + 3 * heads * LMAX * 4
            + 2 * -(-heads * 4 // 16) * 16)


def takes_cluster(P: int, N: int, L: int, dtype: torch.dtype) -> bool:
    """Whether the cluster body takes this shape: bf16, P = N = 64 and a
    chunk that is a multiple of 16, up to 128."""
    return (dtype == torch.bfloat16 and P == CLUSTER_P and N == CLUSTER_N
            and L % 16 == 0 and 16 <= L <= LMAX)


def ssd_plan(B: int, S: int, H: int, P: int, N: int, L: int,
             dtype: torch.dtype,
             max_active: Optional[Callable[[int, int], int]] = None
             ) -> SsdPlan:
    """The body and shape the kernel takes. The cluster body where it
    takes the shape, with up to ``HEADS`` heads per block and the most
    ranks, a power of two, that do not exceed the S / L chunks: at least
    two where there are several chunks (one rank cannot pass the state on
    to itself), one for a single chunk. Where the chunks wrap past the
    last rank, fewer than 2 x ranks heads per block: a rank runs at most
    two messages ahead of the next one, and rank 0 reads the last rank's
    messages only after its own earlier chunk, so more heads than that
    slack around the ring deadlock (``ssm_scan_cluster`` raises there).
    More than 8 ranks (a non-portable cluster size) only where
    ``max_active(ranks, heads)`` (the card's
    cudaOccupancyMaxActiveClusters; unknown off the card) holds every
    cluster of the launch at once, and any size only where it holds one.
    Else the scalar body."""
    if takes_cluster(P, N, L, dtype) and S % L == 0:
        n_chunks = S // L
        for ranks in RANKS + ((1,) if n_chunks == 1 else ()):
            if ranks > n_chunks:
                continue
            heads = min(HEADS, H, 2 * ranks - 1 if n_chunks > ranks else H)
            clusters = B * -(-H // heads)
            if max_active is None:
                if ranks > PORTABLE_RANKS:
                    continue
            elif max_active(ranks, heads) < (
                    clusters if ranks > PORTABLE_RANKS else 1):
                continue
            return SsdPlan("cluster", ranks, heads, cluster_smem(heads))
    return SsdPlan("scalar", 1, 1, SCALAR_SMEM)


def _bf16_pair(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel feeds a float32 value to a bf16 product: the sum
    of hi, t cut to its top 16 bits (a bf16, exact), and lo = bf16(t -
    hi)."""
    hi = (t.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi + (t - hi).to(torch.bfloat16).to(torch.float32)


def ssm_scan_cluster(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128,
                     ranks: int = 8, heads: int = HEADS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cluster body's schedule in plain PyTorch (float32). Per (b,
    group of ``heads`` heads) a cluster of ``ranks`` ranks; rank r holds
    chunks r, r + ranks, ... and for each, head by head: the chunk's own
    terms (W x and h_in, from C B^T, cum and dt), then h_{c-1} from its
    inbox (two message slots that rank r - 1 fills, or past the cluster
    the last rank), h_c = exp(cum_L) h_{c-1} + h_in into rank r + 1's
    inbox (the rank holding the last chunk writes the final state), and
    the cross term exp(cum_i) C h_{c-1}^T. The ranks run as coroutines
    that block where the kernel waits on an mbarrier: a read of a slot
    not filled yet, or a message into a slot whose release it has not
    seen (a sender waits for the release of its message before last; a
    receiver releases a message once it has passed its own state on,
    every message but the last two it takes). A deadlock, an overwritten
    message or a message left unread raises.
    For bf16 inputs the products' float32 operands are rounded where the
    kernel rounds them, each to a pair of bf16 (W, x exp(cum_L - cum) dt,
    and h_{c-1} in the cross term), and y is returned in bf16. Arguments
    and results as ``ssm_scan``."""
    Bn, S, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk_length(S, chunk)
    n_chunks = S // L
    if ranks < 1 or (ranks == 1 and n_chunks > 1):
        raise ValueError(f"ssm_scan_cluster: {ranks} ranks cannot pass the "
                         f"state over {n_chunks} chunks")
    op = _bf16_pair if x.dtype == torch.bfloat16 else (lambda t: t)
    xf, Bf, Cf = (t.to(torch.float32) for t in (x, Bm, Cm))
    dtf, Af = dt.to(torch.float32), A.to(torch.float32)
    y = torch.empty((Bn, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bn, H, P, N), dtype=torch.float32, device=x.device)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()

    for h0 in range(0, H, heads):
        nh = min(heads, H - h0)
        owned = [range(r, n_chunks, ranks) for r in range(ranks)]
        n_recv = [nh * sum(c >= 1 for c in owned[r]) for r in range(ranks)]
        inbox = [[None, None] for _ in range(ranks)]   # per receiving rank
        filled = [[0, 0] for _ in range(ranks)]        # its full phases
        released = [[0, 0] for _ in range(ranks)]      # per sender: empty

        def rank_program(r: int) -> Iterator[None]:
            mr = ms = 0
            for c in owned[r]:
                t0 = c * L
                Bc, Cc = Bf[:, t0:t0 + L], Cf[:, t0:t0 + L]     # (B, L, N)
                G = Cc @ Bc.transpose(1, 2)                     # (B, L, L)
                for k in range(nh):
                    h = h0 + k
                    dtk = dtf[:, t0:t0 + L, h]                  # (B, L)
                    cum = torch.cumsum(dtk * Af[h], dim=1)
                    total = cum[:, -1:]
                    diff = cum[:, :, None] - cum[:, None, :]
                    decay = torch.exp(torch.where(causal, diff,
                                                  float("-inf")))
                    W = op(G * decay * dtk[:, None, :])
                    xc = xf[:, t0:t0 + L, h]                    # (B, L, P)
                    y_c = W @ xc
                    sdec = torch.exp(total - cum) * dtk
                    h_c = op(xc * sdec[..., None]).transpose(1, 2) @ Bc
                    if c >= 1:
                        s = mr & 1
                        while filled[r][s] <= mr >> 1:
                            yield
                        h_prev, inbox[r][s] = inbox[r][s], None
                        h_c = h_prev * torch.exp(total)[..., None] + h_c
                    if c + 1 < n_chunks:
                        s, nxt = ms & 1, (r + 1) % ranks
                        while ms >= 2 and released[r][s] < ms >> 1:
                            yield
                        if inbox[nxt][s] is not None:
                            raise RuntimeError(
                                f"ssm_scan_cluster: rank {r} overwrote an "
                                f"unread message in rank {nxt}'s slot {s}")
                        inbox[nxt][s] = h_c
                        filled[nxt][s] += 1
                        ms += 1
                    else:
                        state[:, h] = h_c
                    if c >= 1:
                        if mr + 2 < n_recv[r]:
                            released[(r - 1) % ranks][mr & 1] += 1
                        mr += 1
                        cross = Cc @ op(h_prev).transpose(1, 2)
                        y_c = y_c + torch.exp(cum)[..., None] * cross
                    y[:, t0:t0 + L, h] = y_c
            if mr != n_recv[r]:
                raise RuntimeError(f"ssm_scan_cluster: rank {r} took {mr} "
                                   f"of its {n_recv[r]} messages")

        live = [rank_program(r) for r in range(ranks)]
        while live:
            before = (sum(map(sum, filled)), sum(map(sum, released)))
            still = []
            for prog in live:
                try:
                    next(prog)
                    still.append(prog)
                except StopIteration:
                    pass
            if len(still) == len(live) and before == (
                    sum(map(sum, filled)), sum(map(sum, released))):
                raise RuntimeError("ssm_scan_cluster: the ranks deadlock")
            live = still
        if any(m is not None for box in inbox for m in box):
            raise RuntimeError("ssm_scan_cluster: a message was left unread")
    return y.to(x.dtype), state


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
                   + [ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssm_scan_limits.argtypes = [ctypes.c_int]
    lib.ssm_scan_limits.restype = ctypes.c_int
    lib.ssm_scan_smem.argtypes = [ctypes.c_int] * 2
    lib.ssm_scan_smem.restype = ctypes.c_longlong
    lib.ssm_scan_max_clusters.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)])
    lib.ssm_scan_max_clusters.restype = ctypes.c_int
    return lib


_max_active_cache = {}


def max_active_clusters(ranks: int, heads: int) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster body with ``ranks``
    blocks of ``heads`` heads on the current card (cached)."""
    key = (torch.cuda.current_device(), ranks, heads)
    if key not in _max_active_cache:
        out = ctypes.c_int()
        err = _lib().ssm_scan_max_clusters(ranks, heads, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"ssm_scan_max_clusters at {ranks} ranks, "
                               f"{heads} heads: CUDA error {err}")
        _max_active_cache[key] = out.value
    return _max_active_cache[key]


def kernel_plan(B: int, S: int, H: int, P: int, N: int, L: int,
                dtype: torch.dtype) -> SsdPlan:
    """The plan the kernel takes on the current card."""
    return ssd_plan(B, S, H, P, N, L, dtype, max_active_clusters)


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) float32; A: (H,) float32; Bm, Cm:
    (B, S, N) of x's type (float32 or bfloat16). CUDA tensors go through
    the kernel (its launches are counted in ``ssm_scan.launches``); CPU
    tensors through the plain version; fake tensors through the
    shape-only branch (``route``). On the card a call that needs a
    gradient gets it from the plain version (``recompute``)."""
    chunk_length(x.shape[1], chunk)
    return route.call("ssm_scan", lambda: ssm_scan_work(x, Bm, chunk),
                      _launch, _plain_out, _shape_only, {"chunk": chunk},
                      x, dt, A, Bm, Cm)


def ssm_scan_work(x: torch.Tensor, Bm: torch.Tensor, chunk: int):
    """(flops, bytes) of one call: x, Bm, Cm, dt and A read and y and the
    state written once. Operations: the fewer of the chunked form's (C
    B^T once per (b, chunk) over its L(L+1)/2 causal pairs, 2N each; per
    (b, h, chunk) W x over those pairs, 2P each, C h_prev and the state
    update, 2 L P N each) and the sequential recurrence's (5 P N per
    token and head)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk_length(S, chunk)
    item = x.element_size()
    nbytes = ((2 * B * S * H * P + 2 * B * S * N) * item + B * S * H * 4
              + H * 4 + B * H * P * N * 4)
    pairs = L * (L + 1) // 2
    flops = min(B * (S // L) * pairs * 2 * N
                + B * H * (S // L) * (pairs * 2 * P + 4 * L * P * N),
                B * S * H * 5 * P * N)
    return flops, nbytes


def _plain_out(x, dt, A, Bm, Cm, chunk):
    return ssm_scan_plain(x, dt, A, Bm, Cm)


def _shape_only(x, dt, A, Bm, Cm, chunk):
    B, S, H, P = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device))


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch, counted in ``ssm_scan.launches``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk_length(S, chunk)
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
    plan = kernel_plan(B, S, H, P, N, L, x.dtype)
    if plan.body == "cluster":
        # the cluster body copies rows of x, Bm and Cm in 16-byte pieces
        x, Bm, Cm = (build.vector_ready(t) for t in (x, Bm, Cm))
    # both bodies write every element of y and of the state
    y = build.output((B, S, H, P), x.dtype, x.device)
    state = build.output((B, H, P, N), torch.float32, x.device)
    strides = (ctypes.c_int64 * 10)(
        *[x.stride(i) for i in range(3)], *[dt.stride(i) for i in range(3)],
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
    err = lib.ssm_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                       state.data_ptr(), B, S, H, P, N, L, strides, code,
                       int(plan.body == "cluster"), plan.ranks, plan.heads,
                       build.stream_of(x))
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed at {shape} "
                           f"{x.dtype}, chunk {L} ({plan}): CUDA error {err}")
    ssm_scan.launches += 1
    return y, state


ssm_scan.launches = 0
