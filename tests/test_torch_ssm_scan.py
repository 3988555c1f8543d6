"""The port's SSD scan op against the JAX reference, on the CPU.

On a CPU tensor ``ops.ssm_scan`` runs its plain PyTorch version (the
sequential recurrence of ``kernels/ref.py``), held here against
``repro.kernels.ref.ssm_scan`` (the same recurrence: atol = rtol = 1e-5)
and against the reference's Pallas kernel in interpret mode, which runs
the chunked form (atol = rtol = 5e-4, the reference's own backend
tolerance, ``tests/test_backend_dispatch.py``), on inputs made with numpy
from a seed. The cases cover several chunks, one chunk and S below the
chunk. The CUDA kernel is held against the plain version on a card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as sk

EXACT = dict(atol=1e-5, rtol=1e-5)
PALLAS = dict(atol=5e-4, rtol=5e-4)


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


CASES = [(2, 64, 3, 8, 16, 16),    # four chunks
         (1, 48, 2, 16, 8, 16),    # three chunks, P > N
         (2, 32, 2, 8, 8, 32),     # one chunk
         (2, 12, 4, 16, 16, 16)]   # S below the chunk: L = S


@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_ssm_scan_plain_matches_reference(B, S, H, P, N, chunk):
    arrs = ssm_inputs(S, B, S, H, P, N)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrs)
    jx, jdt, jA, jB, jC = (jnp.asarray(a) for a in arrs)
    y, h = ops.ssm_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert h.shape == (B, H, P, N) and h.dtype == torch.float32
    y_ref, h_ref = jref.ssm_scan(jx.transpose(0, 2, 1, 3),
                                 jdt.transpose(0, 2, 1), jA, jB, jC)
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(y_ref).transpose(0, 2, 1, 3),
                               **EXACT)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **EXACT)
    y_p, h_p = jops.ssm_scan(jx, jdt, jA, jB, jC, chunk, True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_p), **PALLAS)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_p), **PALLAS)


def test_ssm_scan_bfloat16_keeps_types():
    """bf16 x, Bm, Cm: y comes back in bf16 and the state in float32, as
    the reference's plain version rounds them (2e-2, its bf16 tolerance)."""
    arrs = ssm_inputs(7, 2, 32, 2, 8, 8)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrs)
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    y, h = ops.ssm_scan(xb, dt, A, Bb, Cb, chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jx, jB, jC = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (xb, Bb, Cb))
    y_ref, h_ref = jref.ssm_scan(jx.transpose(0, 2, 1, 3),
                                 jnp.asarray(arrs[1]).transpose(0, 2, 1),
                                 jnp.asarray(arrs[2]), jB, jC)
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(y_ref, np.float32).transpose(0, 2, 1, 3),
        atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("S,chunk", [(24, 16), (40, 32)])
def test_ssm_scan_keeps_the_chunk_rule(S, chunk):
    """S must be a multiple of min(chunk, S), as the reference asserts;
    the op raises on the CPU as on the card, and counts no launch."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in ssm_inputs(0, 1, S, 2, 8, 8))
    before = sk.ssm_scan.launches
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.ssm_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert sk.chunk_length(S, S) == S
    ops.ssm_scan(x, dt, A, Bm, Cm, chunk=S)
    assert sk.ssm_scan.launches == before
