"""The port's LLM kernel ops against the JAX reference, on the CPU.

On a CPU tensor each op runs its plain PyTorch version (``kernels/ref.py``
of the port); these are held against the reference's Pallas kernels in
interpret mode and against ``repro.kernels.ref``, on inputs made with
numpy from a seed. Tolerances are the reference's own
(``tests/test_kernels.py``): atol = rtol = 2e-4 in float32 and 2e-2 in
bfloat16. The CUDA kernels are held against the plain versions on a card
by ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    t = 2e-2 if dtype == "bfloat16" else 2e-4
    return dict(atol=t, rtol=t)


def _pair(seed, shape, dtype):
    """The same numpy normal draw as a jax array and a torch tensor."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, dtype=jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (2, 128, 4, 2, 64),      # GQA
    (1, 128, 4, 1, 80),      # MQA, head dim not a power of two
    (1, 128, 2, 2, 32),      # MHA
])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_pallas_and_ref(B, S, H, Hkv, D, window,
                                                dtype):
    jq, tq = _pair(1, (B, S, H, D), dtype)
    jk, tk = _pair(2, (B, S, Hkv, D), dtype)
    jv, tv = _pair(3, (B, S, Hkv, D), dtype)
    got = ops.flash_attention(tq, tk, tv, True, window)
    assert got.shape == (B, S, H, D) and got.dtype == tq.dtype
    pallas = jops.flash_attention(jq, jk, jv, True, window, True, 64)
    ref = jref.flash_attention(jq.transpose(0, 2, 1, 3),
                               jk.transpose(0, 2, 1, 3),
                               jv.transpose(0, 2, 1, 3), causal=True,
                               window=window).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("S,window", [(100, None), (77, 16)])
def test_flash_attention_any_length(S, window):
    """The model takes any prompt length (the Pallas wrapper asks for a
    multiple of its block): the plain version against the reference's."""
    jq, tq = _pair(4, (2, S, 4, 32), "float32")
    jk, tk = _pair(5, (2, S, 2, 32), "float32")
    jv, tv = _pair(6, (2, S, 2, 32), "float32")
    got = ops.flash_attention(tq, tk, tv, True, window)
    ref = jref.flash_attention(jq.transpose(0, 2, 1, 3),
                               jk.transpose(0, 2, 1, 3),
                               jv.transpose(0, 2, 1, 3), causal=True,
                               window=window).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(ref), **_tol("float32"))


@pytest.mark.parametrize("H,Hkv", [(12, 12), (12, 3), (12, 1)])  # groups 1, 4, 12
@pytest.mark.parametrize("cache_len", [37, 64, 100])  # partial, full, ring
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_matches_pallas_and_ref(H, Hkv, cache_len, dtype):
    B, L, D = 2, 64, 32
    jq, tq = _pair(7, (B, 1, H, D), dtype)
    jk, tk = _pair(8, (B, Hkv, L, D), dtype)
    jv, tv = _pair(9, (B, Hkv, L, D), dtype)
    n = torch.full((), cache_len, dtype=torch.int32)
    got = ops.decode_attention(tq, tk, tv, n)
    assert got.shape == (B, 1, H, D) and got.dtype == tq.dtype
    pallas = jops.decode_attention(jq, jk, jv, jnp.int32(cache_len),
                                   interpret=True, block=32)
    ref = jref.decode_attention(jq[:, 0], jk, jv, jnp.int32(cache_len))[:, None]
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("shape", [(7, 96), (2, 5, 128), (3, 768),
                                   (2, 2560)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_matches_pallas_and_ref(shape, dtype):
    jx, tx = _pair(10, shape, dtype)
    jg, tg = _pair(11, shape[-1:], "float32")
    got = ops.rmsnorm(tx, tg, 1e-5)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    pallas = jops.rmsnorm(jx, jg, 1e-5, True)
    ref = jref.rmsnorm(jx, jg, 1e-5)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("rows", [1, 8, 8 * 1024])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_rmsnorm_plan_loads_each_vector_once(rows, itemsize):
    """At every width the serve paths normalise (mistral's and zamba2's
    Mamba2 inner width 5120, zamba2's 2560, xlstm's mLSTM inner width
    1536 and its 768), at decode and prefill row counts, the RMSNorm
    kernel's layout covers the row in 16-byte vectors exactly: the
    threads of a row times their vectors per thread equal the row's
    vectors, so each is loaded once and none is masked, within the
    threads the kernel's instance takes."""
    for D in (5120, 2560, 1536, 768):
        plan = rn.rmsnorm_plan(rows, D, itemsize)
        assert plan.vec and plan.units * (16 // itemsize) == D
        assert 32 * plan.warps_per_row * plan.vpt == plan.units
        assert plan.vpt in rn.VEC_VPTS
        threads = 32 * plan.warps_per_row * plan.rows_per_block
        assert threads <= rn.max_threads(True, plan.vpt)
    ragged = rn.rmsnorm_plan(rows, 21, itemsize)
    assert not ragged.vec and 32 * ragged.warps_per_row * ragged.vpt >= 21
    assert rn.rmsnorm_plan(rows, 5120, itemsize, aligned=False).vec is False
    longest = 16384 if itemsize == 4 else 32768
    assert rn.rmsnorm_plan(rows, longest, itemsize).vec
    with pytest.raises(ValueError, match="longer than the kernel holds"):
        rn.rmsnorm_plan(rows, longest + 16, itemsize)
