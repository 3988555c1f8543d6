"""The sLSTM scan's cluster schedule, emulated on the CPU.

``slstm_scan_cluster`` replays the CUDA kernel's cluster body in plain
PyTorch: each rank holds its units' columns of R and their state, and
the ranks exchange their slices of h through buffers kept by step
parity. It is held against the JAX package's Pallas kernel in interpret
mode (atol = rtol = 5e-4, the reference's own backend tolerance) and
against ``repro.kernels.ref.slstm_scan`` (1e-5), at every rank count of
{1, 2, 4, 8, 16} that divides the head size, at head sizes 32 and 64,
with S no multiple of 16 and warm and cold states, on inputs made with
numpy from a seed. ``cluster_plan``'s choice of body is checked at
xlstm-125m's shape and at head sizes whose R does not fit a cluster.
The kernel itself is held against the plain version on a card by
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
from repro_torch.kernels import slstm_scan as sk

EXACT = dict(atol=1e-5, rtol=1e-5)
PALLAS = dict(atol=5e-4, rtol=5e-4)
RANKS = (1, 2, 4, 8, 16)
# (B, S, H, Pd, warm): S 7 and 20 are no multiples of 16; B 10 is more
# than one batch tile of the kernel
CASES = [(2, 7, 2, 32, False), (3, 20, 2, 32, True),
         (2, 7, 2, 64, True), (10, 20, 1, 64, False)]


def slstm_inputs(seed, B, S, H, Pd, warm: bool):
    """wx, R (scaled by Pd^-1/2 as the model's init), b and a state; a
    warm state is a random (c, n, h, m) with n >= 1, else the model's
    initial (0, 0, 0, -1e9)."""
    r = np.random.default_rng(seed)
    d = H * Pd
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    wx = f(B, S, 4 * d)
    R = f(4, H, Pd, Pd) / np.float32(np.sqrt(Pd))
    b = 0.1 * f(4 * d)
    if warm:
        state = (f(B, d), 1.0 + np.abs(f(B, d)), np.tanh(f(B, d)), f(B, d))
    else:
        z = np.zeros((B, d), np.float32)
        state = (z, z, z, np.full((B, d), -1e9, np.float32))
    return wx, R, b, state


@functools.lru_cache(maxsize=None)
def _case(B, S, H, Pd, warm):
    """Inputs, and the Pallas kernel's and the reference's results."""
    wx, R, b, state = slstm_inputs(B * S + Pd, B, S, H, Pd, warm)
    j = jnp.asarray
    jstate = tuple(map(j, state))
    pallas = jops.slstm_scan(j(wx), j(R), j(b), jstate, n_heads=H, chunk=S,
                             interpret=True)
    ref = jref.slstm_scan(j(wx), j(R), j(b), jstate, H)
    as_np = lambda out: (np.asarray(out[0]),  # noqa: E731
                         tuple(np.asarray(s) for s in out[1]))
    return (wx, R, b, state), as_np(pallas), as_np(ref)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("B,S,H,Pd,warm", CASES)
def test_cluster_schedule_matches_pallas_and_reference(B, S, H, Pd, warm,
                                                       ranks):
    (wx, R, b, state), pallas, ref = _case(B, S, H, Pd, warm)
    t = torch.from_numpy
    hs, st = sk.slstm_scan_cluster(t(wx), t(R), t(b), tuple(map(t, state)),
                                   H, ranks)
    assert hs.shape == (B, S, H * Pd) and hs.dtype == torch.float32
    assert len(st) == 4 and all(s.shape == (B, H * Pd) for s in st)
    for want, tol in ((ref, EXACT), (pallas, PALLAS)):
        np.testing.assert_allclose(hs.numpy(), want[0], **tol)
        for a, e in zip(st, want[1]):
            np.testing.assert_allclose(a.numpy(), e, **tol)


def test_cluster_schedule_takes_bfloat16_and_rejects_uneven_ranks():
    wx, R, b, state = slstm_inputs(5, 2, 9, 2, 32, True)
    t = torch.from_numpy
    wxb = t(wx).to(torch.bfloat16)
    hs, st = sk.slstm_scan_cluster(wxb, t(R), t(b), tuple(map(t, state)), 2,
                                   8)
    want, want_st = sk.slstm_scan_plain(wxb, t(R), t(b),
                                        tuple(map(t, state)), 2)
    assert hs.dtype == torch.bfloat16
    torch.testing.assert_close(hs.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    for a, e in zip(st, want_st):
        torch.testing.assert_close(a, e, atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="do not divide"):
        sk.slstm_scan_cluster(wxb, t(R), t(b), tuple(map(t, state)), 2, 3)


def test_cluster_plan_at_xlstm_width_fits_a_cluster():
    """xlstm-125m's prefill (B 8, H 4, Pd 192, bf16 wx): the cluster
    body, at least 8 ranks whose R columns fall into 16-byte pieces,
    within the card's 227 KB of shared memory per block; 16 ranks only
    where the card admits every cluster of the launch at once."""
    plan = sk.cluster_plan(8, 4, 192)
    assert plan.body == "cluster" and plan.ranks == 8
    assert 192 // plan.ranks % 4 == 0
    assert plan.smem_bytes <= build.MAX_SMEM_BYTES == 232448
    assert plan.smem_bytes == sk.cluster_smem(192, plan.ranks, plan.splits, 2)
    # R's share alone: 4 gates x 24 units x 192 rows, float32
    assert plan.smem_bytes > 4 * 24 * 192 * 4
    assert plan.splits >= 8 and 24 * plan.splits <= sk.CLUSTER_THREADS
    admits_all = sk.cluster_plan(8, 4, 192, max_active=lambda r, s: 4)
    assert admits_all.body == "cluster" and admits_all.ranks == 16
    too_few = sk.cluster_plan(8, 4, 192, max_active=lambda r, s: 3)
    assert too_few.ranks == 8
    none = sk.cluster_plan(8, 4, 192, max_active=lambda r, s: 0)
    assert none.body == "stream"


@pytest.mark.parametrize("Pd", [512, 768])
def test_cluster_plan_streams_R_that_does_not_fit(Pd):
    """A head's R of 4 MB (Pd 512) or 9 MB (Pd 768) does not fit 16
    blocks' shared memory: the stream body, within 227 KB."""
    for max_active in (None, lambda r, s: 64):
        plan = sk.cluster_plan(8, 4, Pd, max_active=max_active)
        assert plan.body == "stream" and plan.ranks == 1
        assert plan.smem_bytes == sk.stream_smem(Pd) <= build.MAX_SMEM_BYTES
    assert 4 * Pd * Pd * 4 > 16 * build.MAX_SMEM_BYTES


def test_cluster_plan_small_heads_and_many_tiles():
    """Head sizes whose units cannot fall into 16-byte columns take the
    stream body; a batch of several tiles keeps the cluster body."""
    assert sk.cluster_plan(2, 4, 8).body == "stream"
    small = sk.cluster_plan(11, 2, 32)
    assert small.body == "cluster" and 32 // small.ranks % 4 == 0
    assert sk.cluster_plan(64, 4, 192).body == "cluster"
