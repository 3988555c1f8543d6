"""repro_torch.rng against jax.random (threefry2x32, partitionable mode).

The same seeds go to both; keys, bits, uniforms and integers must be
equal bit for bit. ``normal`` is held to rtol 1e-6: torch's erfinv and
XLA's differ in the last ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng

SEEDS = [0, 1, 17, 2**31 - 1, -5]
SHAPES = [(), (5,), (3, 4), (64,)]


def _t(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.numpy()


def test_partitionable_threefry_is_the_reference_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(kt), np.asarray(kj).astype(np.int64))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(
            _np(rng.split(kt, n)), np.asarray(jax.random.split(kj, n)))
    for d in (0, 1, 23, 123456, 2**31 - 1):
        np.testing.assert_array_equal(
            _np(rng.fold_in(kt, d)), np.asarray(jax.random.fold_in(kj, d)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_exact(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(
        _np(rng.random_bits(kt, shape)),
        np.asarray(jax.random.bits(kj, shape, jnp.uint32)).astype(np.int64))
    u = _np(rng.uniform(kt, shape))
    uj = np.asarray(jax.random.uniform(kj, shape))
    np.testing.assert_array_equal(u.view(np.int32), uj.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 3), (1, 9), (0, 16384), (0, 7919),
                                   (-3, 5), (4, 4)])
def test_randint_exact(seed, lo, hi):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            _np(rng.randint(kt, shape, lo, hi)),
            np.asarray(jax.random.randint(kj, shape, lo, hi)))


def test_randint_tensor_maxval():
    """``replay_sample`` draws below the buffer's fill level, a tensor."""
    kj = jax.random.PRNGKey(7)
    for size in (0, 1, 300, 16384):
        want = jax.random.randint(kj, (32,), 0, jnp.maximum(jnp.int32(size), 1))
        got = rng.randint(_t(kj), (32,), 0,
                          torch.clamp(torch.tensor(size, dtype=torch.int32),
                                      min=1))
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_to_erfinv_rounding(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    for shape in SHAPES + [(3136,)]:
        np.testing.assert_allclose(_np(rng.normal(kt, shape)),
                                   np.asarray(jax.random.normal(kj, shape)),
                                   rtol=1e-6, atol=0)


def test_choice_without_p():
    a = jnp.array([-1, 1], jnp.int32)
    for seed in range(20):
        kj = jax.random.PRNGKey(seed)
        assert int(rng.choice(_t(kj), torch.tensor([-1, 1], dtype=torch.int32))) \
            == int(jax.random.choice(kj, a))


def test_batched_keys_match_vmap():
    """The vmapped call sites (per-stream keys) batch over leading key
    dimensions."""
    ks = jax.random.split(jax.random.PRNGKey(3), 6)
    kt = _t(ks)
    np.testing.assert_array_equal(
        _np(rng.split(kt, 3)),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(ks)))
    np.testing.assert_array_equal(
        _np(rng.randint(kt, (), 0, 3)),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 3))(ks)))
    np.testing.assert_array_equal(
        _np(rng.uniform(kt, (4,))).view(np.int32),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (4,)))(ks))
        .view(np.int32))
    np.testing.assert_array_equal(
        _np(rng.fold_in(kt, torch.arange(6))),
        np.asarray(jax.vmap(jax.random.fold_in)(ks, jnp.arange(6))))
    np.testing.assert_allclose(
        _np(rng.normal(kt, (5,))),
        np.asarray(jax.vmap(lambda k: jax.random.normal(k, (5,)))(ks)),
        rtol=1e-6, atol=0)


def test_nested_fold_in_of_replica_key():
    """``core/concurrent.py:79``: fold_in(fold_in(PRNGKey(tag), seed), step)
    with traced int32 seed and step."""
    from repro.core.concurrent import replica_key as jax_replica_key
    from repro_torch.core.concurrent import replica_key
    for tag, seed, step in ((17, 0, 0), (23, 3, 512), (29, 2**31 - 1, 10**6)):
        want = jax_replica_key(tag, jnp.int32(seed), jnp.int32(step))
        got = replica_key(tag, torch.tensor(seed, dtype=torch.int32),
                          torch.tensor(step, dtype=torch.int32))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
