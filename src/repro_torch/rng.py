"""A bit-exact PyTorch version of the ``jax.random`` functions the DQN
path calls: threefry2x32 in jax's partitionable mode
(``jax_threefry_partitionable=True``, the default since jax 0.5).

Keys are ``(..., 2)`` int64 tensors holding the two uint32 words of a
raw jax key. All arithmetic runs in int64 and is masked to 32 bits,
because torch's uint32 dtype lacks most operators on CUDA. Every
function is batched over the leading key dimensions, so the call sites
that ``jax.vmap`` a draw over per-stream keys pass a ``(W, 2)`` key
tensor and get ``(W, *shape)`` back.

The algorithms follow jax's ``_src/prng.py`` and ``_src/random.py``:

* ``split(key, n)[i]`` and ``fold_in(key, i)`` are both the hash of the
  counter pair ``(0, i)``;
* ``random_bits(key, shape)`` hashes the 64-bit flat index of each
  element (high word, low word) and xors the two output words;
* ``uniform`` fills the 23 mantissa bits of a float in [1, 2) and
  subtracts 1;
* ``randint`` draws two bit arrays from ``split(key)`` and combines them
  through the ``span``/``multiplier`` modulus of jax's ``_randint``;
* ``normal`` is ``sqrt(2) * erfinv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, with erfinv by the polynomial XLA uses for
  float32. Its ``log1p`` is torch's, not XLA's, so ``normal`` agrees with
  jax to a few ulps, not bit for bit;
* ``gumbel`` is jax's default ("low") mode, ``-log(-log(u))`` for ``u``
  uniform on ``[tiny, 1)``, and ``categorical`` the Gumbel-max
  ``argmax(logits + gumbel)``. torch's float32 ``log`` is within an ulp
  of XLA's, so ``gumbel`` agrees with jax to 2 ulps of max(|g|, 1)
  (``tests/test_torch_actor_learner.py``), and a categorical draw is
  jax's wherever its top two scores are further apart than that.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "randint", "normal", "gumbel", "categorical", "choice",
           "threefry2x32", "sqrt_f32"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

IntLike = Union[int, torch.Tensor]


def _i64(x: IntLike, like: torch.Tensor) -> torch.Tensor:
    """An int or integer tensor as an int64 tensor on ``like``'s device.
    A Python int is filled in on the device: a host-to-device copy of a
    scalar would make the host wait for the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=like.device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key words ``(k1, k2)``; all four broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _hash(key: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    """Hash counters ``(hi, lo)`` of shape S under keys ``(..., 2)``:
    returns two ``(..., *S)`` word tensors."""
    lead = key.shape[:-1]
    pad = (1,) * hi.dim()
    k1 = key[..., 0].reshape(lead + pad)
    k2 = key[..., 1].reshape(lead + pad)
    return threefry2x32(k1, k2, hi, lo)


def _iota_2x32(shape: Sequence[int], device, offset: int = 0) -> tuple:
    """The flat 64-bit element index of ``shape``, plus ``offset``, as
    (high, low) words."""
    n = math.prod(shape)
    flat = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return (flat >> 32).reshape(tuple(shape)), (flat & MASK).reshape(tuple(shape))


def PRNGKey(seed: IntLike, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` for an int32 seed: the key ``(0, seed)``,
    with a negative seed wrapped to uint32. A tensor seed gives one key
    per element."""
    if isinstance(seed, torch.Tensor):
        low = seed.to(torch.int64) & MASK
        return torch.stack([torch.zeros_like(low), low], dim=-1)
    return torch.arange(2, dtype=torch.int64, device=device) * (int(seed) & MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    hi, lo = _iota_2x32((num,), key.device)
    b1, b2 = _hash(key, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``. ``data`` is an int or an integer tensor
    broadcastable against the leading key dimensions."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
        b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    else:
        b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & MASK)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = (),
                offset: int = 0) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits`` for uint32),
    returned as int64 values in [0, 2**32). ``offset`` shifts the element
    counters: the bits of elements [offset, offset + n) of a larger draw,
    so a draw made in chunks equals the whole one bit for bit."""
    hi, lo = _iota_2x32(tuple(shape), key.device, offset)
    b1, b2 = _hash(key, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval); ``offset``
    as in :func:`random_bits`."""
    bits = random_bits(key, shape, offset)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(floats * float(hi - lo) + float(lo), min=float(lo))


def randint(key: torch.Tensor, shape: Sequence[int], minval: IntLike,
            maxval: IntLike) -> torch.Tensor:
    """``jax.random.randint`` with the default int32 dtype. ``minval`` and
    ``maxval`` may be tensors broadcastable against ``(..., *shape)``."""
    keys = split(key)
    hi_bits = random_bits(keys[..., 0, :], shape)
    lo_bits = random_bits(keys[..., 1, :], shape)
    lo = _i64(minval, key)
    hi = _i64(maxval, key)
    span = (hi - lo) & MASK
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    mult = torch.remainder(torch.full_like(span, 65536), span)
    mult = torch.remainder(mult * mult, span)
    off = (torch.remainder(hi_bits, span) * mult) & MASK
    off = (off + torch.remainder(lo_bits, span)) & MASK
    off = torch.remainder(off, span)
    return (lo + off).to(torch.int32)


def choice(key: torch.Tensor, a: torch.Tensor, shape: Sequence[int] = ()):
    """``jax.random.choice`` with replacement and no ``p``: uniform draws
    from the 1-D tensor ``a``."""
    idx = randint(key, shape, 0, a.shape[0])
    return a[idx.long()]


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles' single-precision erfinv, the polynomial XLA evaluates for float32
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's. On the CPU torch's
    vectorised float32 sqrt is not: it misses by an ulp on some inputs
    and, on some runs, by up to ~2e-4 relative (an approximate
    reciprocal-root path), so it is taken there in float64 and rounded
    once. CUDA's float32 sqrt is IEEE-exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by XLA's polynomial: within a few ulps of jax's
    (torch.erfinv is further away); ±1 map to ±max float."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = torch.where(lt, a, b) + p * w
    big = torch.finfo(torch.float32).max
    return torch.where(torch.abs(x) == 1.0, x * big, p * x)


def normal(key: torch.Tensor, shape: Sequence[int] = (),
           offset: int = 0) -> torch.Tensor:
    """``jax.random.normal`` in float32; ``offset`` as in
    :func:`random_bits`."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, offset)
    return erfinv(u) * _SQRT2


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, jax's default mode."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement and no ``shape``: one
    int32 draw per distribution along ``axis`` of float32 ``logits``,
    the first maximum of ``logits + gumbel``."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits, dim=axis).to(torch.int32)
