"""The port's kernel ops against the JAX reference.

On the CPU the wrappers run their plain PyTorch versions; those are held
against ``repro.kernels.ref`` and against the Pallas TPU kernels in
interpret mode, on inputs made with numpy from a seed. The segment tree
uses integer masses, so all three agree exactly; the projection is held
to atol = rtol = 1e-6. The CUDA kernels are held against the plain
versions on a card by ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import categorical_projection as cp
from repro_torch.kernels import ops
from repro_torch.kernels import segment_tree as st

PROJ_TOL = dict(atol=1e-6, rtol=1e-6)


def _tree_case(seed, P, n, zero_tail=True):
    """Integer leaf masses (exact prefix sums), a zero tail, and targets
    over [0, total], the last one exactly the total."""
    r = np.random.default_rng(seed)
    leaves = r.integers(0, 9, size=P).astype(np.float32)
    if zero_tail and P > 1:
        leaves[(3 * P) // 4:] = 0.0
    leaves[0] = max(leaves[0], 1.0)
    total = float(leaves.sum())
    targets = np.floor(r.uniform(0.0, total, size=n)).astype(np.float32)
    targets[-1] = total
    return leaves, targets


def _proj_case(seed, B, K):
    r = np.random.default_rng(seed)
    logits = 3.0 * r.standard_normal((B, K))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    rewards = (15.0 * r.standard_normal(B)).astype(np.float32)
    dones = (r.uniform(size=B) < 0.3).astype(np.float32)
    return probs, rewards, dones


@pytest.mark.parametrize("P", [1, 8, 256, 2048, 16384])
def test_tree_build_and_next_pow2(P):
    leaves, _ = _tree_case(P, P, 1)
    np.testing.assert_array_equal(
        ops.tree_build(torch.from_numpy(leaves)).numpy(),
        np.asarray(jops.tree_build(jnp.asarray(leaves))))
    for n in (P - 1, P, P + 1):
        assert ops.next_pow2(n) == jops.next_pow2(n)


@pytest.mark.parametrize("P,n", [(1, 3), (8, 5), (256, 37), (2048, 64),
                                 (16384, 32)])
def test_segment_tree_matches_ref_and_pallas(P, n):
    leaves, targets = _tree_case(P + n, P, n)
    jtree = jops.tree_build(jnp.asarray(leaves))
    tree = torch.from_numpy(np.array(jtree))
    got = ops.segment_tree_sample(tree, torch.from_numpy(targets)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jref.segment_tree_sample(jtree, jnp.asarray(targets))))
    np.testing.assert_array_equal(
        got, np.asarray(jops.segment_tree_sample(jtree, jnp.asarray(targets),
                                                 interpret=True)))


def test_segment_tree_float_masses_bitwise_vs_ref():
    """With float masses the descent (ref and port) is still bit-exact."""
    r = np.random.default_rng(5)
    leaves = r.uniform(0.0, 1.0, size=4096).astype(np.float32)
    leaves[3000:] = 0.0
    jtree = jops.tree_build(jnp.asarray(leaves))
    targets = (r.uniform(0.0, 1.05, size=512) * float(jtree[1])).astype(np.float32)
    got = st.segment_tree_sample_plain(torch.from_numpy(np.array(jtree)),
                                       torch.from_numpy(targets))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jref.segment_tree_sample(jtree, jnp.asarray(targets))))


@pytest.mark.parametrize("B,K", [(3, 2), (13, 51), (32, 51), (64, 128)])
def test_categorical_projection_matches_ref_and_pallas(B, K):
    probs, rewards, dones = _proj_case(B * K, B, K)
    kw = dict(v_min=-10.0, v_max=10.0, gamma_n=0.9 ** 3)
    got = ops.categorical_projection(torch.from_numpy(probs),
                                     torch.from_numpy(rewards),
                                     torch.from_numpy(dones), **kw).numpy()
    want = np.asarray(jref.categorical_projection(
        jnp.asarray(probs), jnp.asarray(rewards), jnp.asarray(dones), **kw))
    np.testing.assert_allclose(got, want, **PROJ_TOL)
    # The Pallas kernel forms z_j in float64 where the reference (and the
    # port) form it in float32, so its b_j can sit an ulp away and a mass
    # moves by up to ~2e-6; the reference's own test holds the two to
    # 1e-5 (test_backend_dispatch.py), and so does this one.
    pallas = np.asarray(jops.categorical_projection(
        jnp.asarray(probs), jnp.asarray(rewards), jnp.asarray(dones),
        interpret=True, **kw))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.sum(-1), probs.sum(-1), atol=1e-5)


@pytest.mark.parametrize("K,v_min,v_max,gamma_n", [(1, -1.0, -1.0, 0.99),
                                                   (8, 2.0, 2.0, 0.9)])
def test_categorical_projection_degenerate_supports(K, v_min, v_max, gamma_n):
    """K=1 and v_min == v_max send all mass to atom 0, in every version."""
    probs, rewards, dones = _proj_case(K, 7, K)
    kw = dict(v_min=v_min, v_max=v_max, gamma_n=gamma_n)
    got = ops.categorical_projection(torch.from_numpy(probs),
                                     torch.from_numpy(rewards),
                                     torch.from_numpy(dones), **kw).numpy()
    for interpret in (False, True):
        want = jops.categorical_projection(
            jnp.asarray(probs), jnp.asarray(rewards), jnp.asarray(dones),
            backend=None if interpret else "ref", interpret=interpret, **kw)
        np.testing.assert_allclose(got, np.asarray(want), **PROJ_TOL)
    np.testing.assert_allclose(got[:, 0], probs.sum(-1), atol=1e-6)
    np.testing.assert_array_equal(got[:, 1:], 0.0)


@pytest.mark.parametrize("K,v_min,v_max", [(51, -10.0, 10.0), (33, -1.0, 1.0),
                                           (1, -10.0, 10.0), (2, 0.0, 1.0)])
def test_support_matches_jnp_linspace(K, v_min, v_max):
    """The port evaluates jnp.linspace's float32 formula exactly; XLA's CPU
    code divides by a reciprocal and contracts the products, so the two
    grids may differ by an ulp (9.5e-7 at |z| = 10)."""
    np.testing.assert_allclose(ops.support(K, v_min, v_max).numpy(),
                               np.asarray(jops.support(K, v_min, v_max)),
                               rtol=0, atol=2e-6)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version and launches nothing."""
    before = (st.segment_tree_sample.launches, cp.categorical_projection.launches)
    leaves, targets = _tree_case(0, 64, 9)
    tree = ops.tree_build(torch.from_numpy(leaves))
    t = torch.from_numpy(targets)
    assert torch.equal(ops.segment_tree_sample(tree, t),
                       st.segment_tree_sample_plain(tree, t))
    probs, rewards, dones = (torch.from_numpy(a) for a in _proj_case(0, 4, 51))
    kw = dict(v_min=-10.0, v_max=10.0, gamma_n=0.81)
    assert torch.equal(ops.categorical_projection(probs, rewards, dones, **kw),
                       cp.categorical_projection_plain(probs, rewards, dones,
                                                       **kw))
    assert (st.segment_tree_sample.launches,
            cp.categorical_projection.launches) == before
