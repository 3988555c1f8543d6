"""The port's sLSTM scan op against the JAX reference, on the CPU.

On a CPU tensor ``ops.slstm_scan`` runs its plain PyTorch version (the
sequential recurrence of ``kernels/ref.py``), held here against
``repro.kernels.ref.slstm_scan`` (atol = rtol = 1e-5) and against the
reference's Pallas kernel in interpret mode (atol = rtol = 5e-4, the
reference's own backend tolerance), on inputs made with numpy from a
seed: several 16-step chunks, one chunk shorter than 16, and zero and
non-zero initial states. The CUDA kernel, which takes any S, is held
against the plain version on a card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import slstm_scan as sk

EXACT = dict(atol=1e-5, rtol=1e-5)
PALLAS = dict(atol=5e-4, rtol=5e-4)


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


CASES = [(2, 48, 4, 8, 16, False),   # three chunks
         (3, 32, 2, 16, 16, True),   # two chunks, a warm state
         (2, 10, 4, 8, 16, True)]    # S below the chunk: L = S


@pytest.mark.parametrize("B,S,H,Pd,chunk,warm", CASES)
def test_slstm_scan_plain_matches_reference(B, S, H, Pd, chunk, warm):
    wx, R, b, state = slstm_inputs(S + B, B, S, H, Pd, warm)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    hs, st = ops.slstm_scan(t(wx), t(R), t(b), tuple(map(t, state)), H)
    assert hs.shape == (B, S, H * Pd) and hs.dtype == torch.float32
    assert len(st) == 4 and all(s.shape == (B, H * Pd) for s in st)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    jstate = tuple(map(j, state))
    hs_ref, st_ref = jref.slstm_scan(j(wx), j(R), j(b), jstate, H)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_ref), **EXACT)
    for a, e in zip(st, st_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **EXACT)
    hs_p, st_p = jops.slstm_scan(j(wx), j(R), j(b), jstate, n_heads=H,
                                 chunk=chunk, interpret=True)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_p), **PALLAS)
    for a, e in zip(st, st_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **PALLAS)


def test_slstm_scan_any_length_and_bfloat16():
    """The op takes an S that is no multiple of 16 (the Pallas kernel's
    blocking), and bf16 wx gives bf16 hs beside a float32 state, as the
    reference's plain version (2e-2, its bf16 tolerance)."""
    wx, R, b, state = slstm_inputs(3, 2, 21, 2, 8, True)
    before = sk.slstm_scan.launches
    wxb = torch.from_numpy(wx).to(torch.bfloat16)
    hs, st = ops.slstm_scan(wxb, torch.from_numpy(R), torch.from_numpy(b),
                            tuple(torch.from_numpy(s) for s in state), 2)
    assert hs.dtype == torch.bfloat16 and hs.shape == (2, 21, 16)
    assert all(s.dtype == torch.float32 for s in st)
    assert sk.slstm_scan.launches == before
    hs_ref, st_ref = jref.slstm_scan(
        jnp.asarray(wxb.float().numpy(), jnp.bfloat16), jnp.asarray(R),
        jnp.asarray(b), tuple(jnp.asarray(s) for s in state), 2)
    np.testing.assert_allclose(hs.float().numpy(),
                               np.asarray(hs_ref, np.float32), atol=2e-2,
                               rtol=2e-2)
    for a, e in zip(st, st_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=2e-2,
                                   rtol=2e-2)
