"""The Hopper attention kernels' schedules, emulated on the CPU.

``decode_attention_split`` replays the decode kernel's split of the cache
and its fixed-order combine of the splits' (m, l, acc) in plain PyTorch.
It is held against the JAX package's Pallas decode kernel in interpret
mode (run through ``repro.kernels.ops``, as ``tests/test_kernels.py``
runs it) and against the port's plain version, at every split count the
kernel may pick and at cache lengths on and between the split
boundaries, past the prefix and past L (a ring). Flash attention's plain
version is held against the Pallas flash kernel at the head dims and
ragged lengths the wgmma body takes (D 80 and 96, S not a multiple of
its 128-row tile). Tolerances are the reference's own: atol = rtol =
2e-4 in float32 and 2e-2 in bfloat16. The kernels themselves are held
against these plain versions on a card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SPLITS = (1, 2, 4, 8)


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


def test_split_chunks_cover_the_cache():
    """For the split counts the kernel may pick (one, or at least 64
    positions a split), the chunks tile [0, L) in order, each a multiple
    of 8 positions, and only the last may run past L."""
    for L in (16, 64, 100, 1088, 4096):
        for splits in SPLITS:
            if splits > 1 and L // splits < 64:
                continue
            chunk = da.split_chunk(L, splits)
            assert chunk % 8 == 0
            assert (splits - 1) * chunk < L <= splits * chunk


# L = 64: split boundaries at 16 (4 splits) and 8 (8 splits); cache_len 1
# leaves all but the first split past the prefix, 23 ends mid-split, 64
# fills the cache, 100 is a ring that has wrapped
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (12, 1)])  # G 1, 4, 12
@pytest.mark.parametrize("D", [80, 128])
@pytest.mark.parametrize("cache_len", [1, 16, 23, 64, 100])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_split_matches_pallas_and_plain(H, Hkv, D, cache_len, dtype):
    B, L = 2, 64
    jq, tq = _pair(11, (B, 1, H, D), dtype)
    jk, tk = _pair(12, (B, Hkv, L, D), dtype)
    jv, tv = _pair(13, (B, Hkv, L, D), dtype)
    pallas = jops.decode_attention(jq, jk, jv, jnp.int32(cache_len),
                                   interpret=True, block=32)
    plain = da.decode_attention_plain(tq, tk, tv, cache_len)
    for splits in SPLITS:
        got = da.decode_attention_split(tq, tk, tv, cache_len, splits)
        assert got.shape == (B, 1, H, D) and got.dtype == tq.dtype
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
        np.testing.assert_allclose(_np(got), _np(plain), **_tol(dtype))


def test_decode_split_takes_a_device_cache_len():
    """cache_len as the model passes it: a () int32 tensor."""
    _, tq = _pair(14, (1, 1, 8, 64), "float32")
    _, tk = _pair(15, (1, 2, 40, 64), "float32")
    _, tv = _pair(16, (1, 2, 40, 64), "float32")
    n = torch.full((), 29, dtype=torch.int32)
    np.testing.assert_allclose(
        _np(da.decode_attention_split(tq, tk, tv, n, 4)),
        _np(da.decode_attention_plain(tq, tk, tv, 29)), **_tol("float32"))


# S = 192 and 320: whole 64-row Pallas blocks, but not whole 128-row
# tiles of the wgmma body, whose last q tile and k tile are ragged
@pytest.mark.parametrize("S", [192, 320])
@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_head_dims_of_the_wgmma_body(S, D, window, dtype):
    B, H, Hkv = 1, 4, 2
    jq, tq = _pair(21, (B, S, H, D), dtype)
    jk, tk = _pair(22, (B, S, Hkv, D), dtype)
    jv, tv = _pair(23, (B, S, Hkv, D), dtype)
    got = ops.flash_attention(tq, tk, tv, True, window)
    assert got.shape == (B, S, H, D) and got.dtype == tq.dtype
    pallas = jops.flash_attention(jq, jk, jv, True, window, True, 64)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
