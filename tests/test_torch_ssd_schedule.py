"""The SSD scan's cluster schedule, emulated on the CPU.

``ssm_scan_cluster`` replays the CUDA kernel's cluster body in plain
PyTorch: per (b, head group) a cluster of ranks over the chunks (rank r
holding chunks r, r + ranks, ...), each chunk's own terms computed on
their own, and the carried state passed from rank to rank, past the
last rank back to the first, through two message slots per rank with
the kernel's flow control. It is held against the JAX package's Pallas
kernel in interpret mode (float32 inputs, atol = rtol = 5e-4, the
reference's own backend tolerance) and against
``repro.kernels.ref.ssm_scan`` on bf16 inputs, where it rounds the
products' float32 operands to bf16 pairs as the kernel does (2e-2, the
reference's bf16 tolerance), on inputs made with numpy from a seed: one
to three
chunks, more chunks than ranks, S below the chunk, and head groups that
do not divide the heads. ``ssd_plan``'s choice of body is checked at
zamba2-2.7b's shape and at shapes that go to the scalar body. The kernel
itself is held against the plain version on a card by
``tests/test_torch_cuda_kernels.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import ssm_scan as sk

PALLAS = dict(atol=5e-4, rtol=5e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
# (B, S, H, P, N, chunk, ranks, heads)
CASES = [(2, 48, 3, 8, 16, 16, 2, 2),     # 3 chunks over 2 ranks: wraps
         (1, 112, 3, 16, 8, 16, 4, 3),    # 7 chunks over 4 ranks
         (2, 32, 2, 8, 8, 32, 1, 8),      # one chunk, one rank
         (1, 64, 4, 8, 8, 16, 8, 3),      # more ranks than chunks; 3 + 1
         (2, 12, 2, 8, 8, 16, 1, 2),      # S below the chunk: L = S
         (1, 288, 2, 8, 8, 16, 16, 2)]    # 18 chunks over 16 ranks


def ssm_inputs(seed, B, S, H, P, N):
    """x, dt (post-softplus), A (negative), Bm, Cm in the model layout, as
    float32 numpy arrays."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(r.standard_normal(H))).astype(np.float32)
    Bm = r.standard_normal((B, S, N)).astype(np.float32)
    Cm = r.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@functools.lru_cache(maxsize=None)
def _pallas(B, S, H, P, N, chunk):
    """Inputs and the Pallas kernel's result (interpret mode)."""
    arrs = ssm_inputs(S + H, B, S, H, P, N)
    jx, jdt, jA, jB, jC = (jnp.asarray(a) for a in arrs)
    y, h = jops.ssm_scan(jx, jdt, jA, jB, jC, chunk, True)
    return arrs, np.asarray(y), np.asarray(h)


@pytest.mark.parametrize("B,S,H,P,N,chunk,ranks,heads", CASES)
def test_cluster_schedule_matches_pallas(B, S, H, P, N, chunk, ranks, heads):
    arrs, y_p, h_p = _pallas(B, S, H, P, N, chunk)
    y, h = sk.ssm_scan_cluster(*(torch.from_numpy(a) for a in arrs),
                               chunk=chunk, ranks=ranks, heads=heads)
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert h.shape == (B, H, P, N) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_p, **PALLAS)
    np.testing.assert_allclose(h.numpy(), h_p, **PALLAS)


@pytest.mark.parametrize("B,S,H,P,N,chunk,ranks,heads", CASES)
def test_cluster_schedule_bfloat16_matches_reference(B, S, H, P, N, chunk,
                                                     ranks, heads):
    """bf16 x, Bm and Cm, the operands rounded where the kernel rounds
    them: y in bf16 and the state in float32 against the reference's
    sequential recurrence on the same bf16 inputs."""
    x, dt, A, Bm, Cm = ssm_inputs(S + 1, B, S, H, P, N)
    xb, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    y, h = sk.ssm_scan_cluster(xb, torch.from_numpy(dt), torch.from_numpy(A),
                               Bb, Cb, chunk=chunk, ranks=ranks, heads=heads)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jx, jB, jC = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (xb, Bb, Cb))
    y_ref, h_ref = jref.ssm_scan(jx.transpose(0, 2, 1, 3),
                                 jnp.asarray(dt).transpose(0, 2, 1),
                                 jnp.asarray(A), jB, jC)
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(y_ref, np.float32).transpose(0, 2, 1, 3), **BF16)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **BF16)


def test_cluster_schedule_needs_two_ranks_for_several_chunks():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in ssm_inputs(3, 1, 32, 2, 8, 8))
    with pytest.raises(ValueError, match="cannot pass the state"):
        sk.ssm_scan_cluster(x, dt, A, Bm, Cm, chunk=16, ranks=1)
    y, h = sk.ssm_scan_cluster(x, dt, A, Bm, Cm, chunk=16, ranks=2)
    y_p, h_p = sk.ssm_scan_plain(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ranks,heads,n_chunks,deadlocks", [
    (2, 3, 3, False), (2, 3, 6, False),   # the plan's most: 2 x ranks - 1
    (2, 5, 3, True), (2, 4, 4, True),     # past the ring's slack
    (4, 7, 5, False), (4, 8, 6, True)])
def test_cluster_schedule_deadlocks_past_twice_the_ranks(ranks, heads,
                                                         n_chunks, deadlocks):
    """Where the chunks wrap past the last rank, a block of 2 x ranks
    heads or more can deadlock: each rank runs at most two messages ahead
    of the next, and rank 0 takes the last rank's messages only after its
    own earlier chunk. The plan stays below that."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in ssm_inputs(4, 1, 16 * n_chunks, heads, 8, 8))
    if deadlocks:
        with pytest.raises(RuntimeError, match="deadlock"):
            sk.ssm_scan_cluster(x, dt, A, Bm, Cm, chunk=16, ranks=ranks,
                                heads=heads)
    else:
        y, h = sk.ssm_scan_cluster(x, dt, A, Bm, Cm, chunk=16, ranks=ranks,
                                   heads=heads)
        y_p, h_p = sk.ssm_scan_plain(x, dt, A, Bm, Cm)
        torch.testing.assert_close(y, y_p, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(h, h_p, atol=1e-4, rtol=1e-4)
    plan = sk.ssd_plan(1, 64 * n_chunks, 16, 64, 64, 64, torch.bfloat16)
    assert plan.ranks >= n_chunks or plan.heads < 2 * plan.ranks


def test_plan_at_zamba2_prefill_takes_the_cluster_body():
    """zamba2-2.7b's prefill (B 8, S 1024, H 80, P 64, N 64, chunk 128,
    bf16): 8 chunks, so a cluster of 8 ranks, 16 heads per block (5 head
    groups), within the card's 227 KB of shared memory per block."""
    plan = sk.ssd_plan(8, 1024, 80, 64, 64, 128, torch.bfloat16)
    assert plan == sk.SsdPlan("cluster", 8, 16, sk.cluster_smem(16))
    assert plan.smem_bytes <= build.MAX_SMEM_BYTES == 232448
    # two message slots of the state in float32, four x tiles, B, C and
    # x sdec as two bf16 tiles, y's tile, and the per-head vectors
    assert plan.smem_bytes == (64 + 2 * 64 * 64 * 4 + 8 * 128 * 72 * 2
                               + 128 * 64 * 2 + 3 * 16 * 128 * 4 + 2 * 64)
    # the card's answer does not change the ranks when 8 chunks fit 8
    assert sk.ssd_plan(8, 1024, 80, 64, 64, 128, torch.bfloat16,
                       max_active=lambda r, h: 16) == plan


def test_plan_many_chunks_takes_16_ranks_only_where_all_clusters_fit():
    """18 chunks: 16 ranks where the card holds every cluster of the
    launch at once, else 8; none at all sends it to the scalar body."""
    shape = (1, 2304, 2, 64, 64, 128, torch.bfloat16)
    assert sk.ssd_plan(*shape).ranks == 8
    assert sk.ssd_plan(*shape, max_active=lambda r, h: 1).ranks == 16
    assert sk.ssd_plan(*shape[:2], 80, *shape[3:],
                       max_active=lambda r, h: 4).ranks == 8   # 5 clusters
    assert sk.ssd_plan(*shape, max_active=lambda r, h: 0).body == "scalar"
    # 3 chunks: 2 ranks, and 3 heads per block (below 2 x ranks)
    assert sk.ssd_plan(2, 384, 4, 64, 64, 128, torch.bfloat16)[:3] == (
        "cluster", 2, 3)
    assert sk.ssd_plan(1, 64, 4, 64, 64, 64, torch.bfloat16).ranks == 1


@pytest.mark.parametrize("B,S,H,P,N,L,dtype", [
    (8, 1024, 80, 64, 64, 128, torch.float32),   # float32: the scalar body
    (2, 64, 3, 16, 8, 16, torch.bfloat16),       # P 16, N 8
    (1, 100, 2, 64, 64, 100, torch.bfloat16),    # L no multiple of 16
    (1, 64, 2, 64, 32, 64, torch.bfloat16),      # N 32
    (1, 64, 2, 32, 64, 64, torch.bfloat16)])     # P 32
def test_plan_sends_other_shapes_to_the_scalar_body(B, S, H, P, N, L, dtype):
    plan = sk.ssd_plan(B, S, H, P, N, L, dtype)
    assert plan == sk.SsdPlan("scalar", 1, 1, sk.SCALAR_SMEM)
    assert sk.SCALAR_SMEM <= build.MAX_SMEM_BYTES
