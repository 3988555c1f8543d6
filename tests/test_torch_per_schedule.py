"""The schedules of the PER tree build, the segment-tree descent and the
C51 projection kernels, replayed on the CPU.

``tree_build_blocked``, ``segment_tree_rounds`` and ``projection_hat``
replay the CUDA kernels' block, round and gather orders with their index
arithmetic. Each is held against its plain version and against the JAX
package: the tree bit for bit against
``repro.kernels.segment_tree.tree_build``, the descent bit for bit
against ``repro.kernels.ref.segment_tree_sample`` (and the Pallas kernel
in interpret mode on integer masses, where its compare-count agrees
exactly), the projection against the plain scatter (1e-6) and the Pallas
kernel in interpret mode (1e-5, as in ``tests/test_torch_kernels.py``).
A population's R trees (the replica axis) go through the same functions:
the batched plain versions and schedules equal, tree by tree and bit for
bit, the one-tree calls, and the projection of (R, B, K) rows equals R
separate calls. Inputs are made with numpy from a seed. The kernels themselves are held
against these on a card by ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import categorical_projection as cp
from repro_torch.kernels import segment_tree as st

PROJ_TOL = dict(atol=1e-6, rtol=1e-6)
PALLAS_TOL = dict(atol=1e-5, rtol=1e-5)
SIZES = [1, 2, 8, 256, 1 << 20]


def _leaves(seed, P, integer: bool):
    """Masses over the first 3/4 of the leaves and a zero tail."""
    r = np.random.default_rng(seed)
    if integer:
        leaves = r.integers(0, 9, size=P).astype(np.float32)
    else:
        leaves = r.uniform(0.0, 1.0, size=P).astype(np.float32)
    leaves[(3 * P) // 4:] = 0.0
    leaves[0] = max(leaves[0], 1.0)
    return leaves


def _targets(seed, tree: np.ndarray, n: int):
    """Random targets over [0, 1.05 total), every left-subtree sum on the
    leftmost path (a tie with a node), the total and beyond it."""
    r = np.random.default_rng(seed)
    total = float(tree[1])
    P = tree.shape[0] // 2
    spine = [tree[1 << lv] for lv in range(1, P.bit_length())]
    t = np.concatenate([r.uniform(0.0, 1.05 * total, size=n), spine,
                        [total, 1.5 * total]]).astype(np.float32)
    return t


@pytest.mark.parametrize("P", SIZES + [128, 16384])
@pytest.mark.parametrize("integer", [True, False])
def test_segment_tree_rounds_bitwise(P, integer):
    leaves = _leaves(P, P, integer)
    jtree = jops.tree_build(jnp.asarray(leaves))
    tree = torch.from_numpy(np.array(jtree))
    targets = _targets(P + 1, np.array(jtree), 64)
    if integer:   # exactly on inclusive prefix sums too
        cum = np.cumsum(leaves, dtype=np.float64)
        pick = np.random.default_rng(P + 2).integers(0, P, size=16)
        targets = np.concatenate([targets, cum[pick].astype(np.float32)])
    t = torch.from_numpy(targets)
    got = st.segment_tree_rounds(tree, t)
    assert got.dtype == torch.int32
    assert torch.equal(got, st.segment_tree_sample_plain(tree, t))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jref.segment_tree_sample(jtree, jnp.asarray(targets))))
    inside = t < tree[1]
    assert bool((got[inside] < max((3 * P) // 4, 1)).all())
    if integer:   # exact sums: past the total is the right spine
        assert bool((got[~inside] == P - 1).all())


@pytest.mark.parametrize("P", [1, 2, 8, 16, 64, 256])
def test_segment_tree_rounds_matches_pallas_on_integer_masses(P):
    leaves = _leaves(P + 7, P, integer=True)
    jtree = jops.tree_build(jnp.asarray(leaves))
    total = float(jtree[1])
    targets = np.floor(np.random.default_rng(P).uniform(0.0, total, 40))
    targets = np.concatenate([targets, [total]]).astype(np.float32)
    got = st.segment_tree_rounds(torch.from_numpy(np.array(jtree)),
                                 torch.from_numpy(targets))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jops.segment_tree_sample(jtree, jnp.asarray(targets),
                                            interpret=True)))


def test_descent_rounds():
    assert st.descent_rounds(1) == []
    assert st.descent_rounds(2) == [1]
    assert st.descent_rounds(16384) == [7, 7]
    assert st.descent_rounds(1 << 20) == [7, 7, 6]
    with pytest.raises(ValueError):
        st.descent_rounds(12)


@pytest.mark.parametrize("P", SIZES + [4, 16, 2048, 4096, 8192, 1 << 16,
                                 1 << 23])
def test_tree_build_blocked_bitwise_vs_jax(P):
    leaves = _leaves(P + 3, P, integer=False)
    want = np.asarray(jops.tree_build(jnp.asarray(leaves)))
    blocked = st.tree_build_blocked(torch.from_numpy(leaves))
    assert not bool(torch.isnan(blocked).any())      # every element written
    np.testing.assert_array_equal(blocked.numpy(), want)
    np.testing.assert_array_equal(
        st.tree_build_plain(torch.from_numpy(leaves)).numpy(), want)


def test_tree_build_plan():
    assert st.tree_build_plan(1) == [(1, 1)]
    assert st.tree_build_plan(16384) == [(16384, 2048), (8, 8)]
    assert st.tree_build_plan(1 << 20) == [(1 << 20, 2048), (512, 512)]
    assert st.tree_build_plan(1 << 23) == [(1 << 23, 2048), (4096, 2048),
                                           (2, 2)]
    for lg in range(23):                   # at most 2 launches to 2^22
        assert len(st.tree_build_plan(1 << lg)) <= 2
    with pytest.raises(ValueError):
        st.tree_build_plan(12)


def test_cpu_tree_build_takes_the_plain_version():
    before = st.tree_build.launches
    leaves = torch.from_numpy(_leaves(0, 64, integer=False))
    assert torch.equal(st.tree_build(leaves), st.tree_build_plain(leaves))
    assert st.tree_build.launches == before


def _proj_case(seed, B, K):
    r = np.random.default_rng(seed)
    logits = 3.0 * r.standard_normal((B, K))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    probs[0] = 0.0
    probs[0, K // 2] = 1.0                  # one peaked row
    rewards = (15.0 * r.standard_normal(B)).astype(np.float32)
    dones = (r.uniform(size=B) < 0.3).astype(np.float32)
    dones[:2] = 1.0
    return probs, rewards, dones


# (B, K, v_min, v_max, gamma_n): the path's K, the widest, K = 1 and
# v_min == v_max (all mass on atom 0), gamma^n = 1, and g < 0
PROJ_CASES = [(32, 51, -10.0, 10.0, 0.9 ** 3), (6, 512, -10.0, 10.0, 0.9 ** 3),
              (7, 1, -1.0, -1.0, 0.99), (7, 8, 2.0, 2.0, 0.9),
              (5, 2, 0.0, 1.0, 0.97), (13, 51, -10.0, 10.0, 1.0),
              (9, 51, -10.0, 10.0, -0.5)]


@pytest.mark.parametrize("B,K,v_min,v_max,gamma_n", PROJ_CASES)
def test_projection_hat_matches_plain(B, K, v_min, v_max, gamma_n):
    probs, rewards, dones = (torch.from_numpy(a)
                             for a in _proj_case(B * K, B, K))
    kw = dict(v_min=v_min, v_max=v_max, gamma_n=gamma_n)
    got = cp.projection_hat(probs, rewards, dones, **kw)
    plain = cp.categorical_projection_plain(probs, rewards, dones, **kw)
    torch.testing.assert_close(got, plain, **PROJ_TOL)
    torch.testing.assert_close(got.sum(-1), probs.sum(-1), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("B,K,v_min,v_max,gamma_n", PROJ_CASES)
def test_projection_hat_bitwise_vs_numpy_gather(B, K, v_min, v_max, gamma_n):
    """Bit for bit against the gather written out in numpy float32, one
    operation at a time in the kernel's order."""
    probs, rewards, dones = _proj_case(B * K + 1, B, K)
    f = np.float32
    delta = (v_max - v_min) / (K - 1) if K > 1 else 0.0
    db = f(delta if delta > 0.0 else 1.0)
    g = f(gamma_n) * (f(1.0) - dones)
    z = f(v_min) + f(delta) * np.arange(K, dtype=f)
    tz = np.minimum(np.maximum(rewards[:, None] + g[:, None] * z[None],
                               f(v_min)), f(v_max))
    b = (tz - f(v_min)) / db
    want = np.zeros((B, K), f)
    for i in range(K):
        for j in range(K):
            w = np.maximum(f(1.0) - np.abs(b[:, j] - f(i)), f(0.0))
            want[:, i] = want[:, i] + probs[:, j] * w
    got = cp.projection_hat(torch.from_numpy(probs), torch.from_numpy(rewards),
                            torch.from_numpy(dones), v_min=v_min, v_max=v_max,
                            gamma_n=gamma_n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,K,v_min,v_max,gamma_n", PROJ_CASES)
def test_projection_hat_matches_jax(B, K, v_min, v_max, gamma_n):
    """Within 1e-5 of the Pallas kernel in interpret mode (its z_j is
    formed in float64, see tests/test_torch_kernels.py); at K = 512, where
    the unrolled Pallas body is slow to trace, within 1e-6 of the JAX
    reference scatter."""
    probs, rewards, dones = _proj_case(B + K, B, K)
    kw = dict(v_min=v_min, v_max=v_max, gamma_n=gamma_n)
    got = cp.projection_hat(torch.from_numpy(probs),
                            torch.from_numpy(rewards),
                            torch.from_numpy(dones), **kw).numpy()
    j = (jnp.asarray(probs), jnp.asarray(rewards), jnp.asarray(dones))
    if K == 512:
        np.testing.assert_allclose(
            got, np.asarray(jref.categorical_projection(*j, **kw)), **PROJ_TOL)
    else:
        np.testing.assert_allclose(
            got, np.asarray(jops.categorical_projection(*j, interpret=True,
                                                        **kw)), **PALLAS_TOL)


# ---------------------------------------------------------------------------
# the replica axis: R trees (one per replica of a population) at once
# ---------------------------------------------------------------------------

def _replica_leaves(seed, R, P):
    """R replicas' masses, each with its own zero tail (empty at r = 0),
    over [0, 1) floats."""
    r = np.random.default_rng(seed)
    leaves = r.uniform(0.0, 1.0, size=(R, P)).astype(np.float32)
    for i in range(1, R):
        leaves[i, P - (i * P) // (2 * R):] = 0.0
    leaves[:, 0] = np.maximum(leaves[:, 0], 1.0)
    return leaves


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("P", [1, 2, 8, 256, 16384])
def test_replica_tree_build_bitwise_per_tree(R, P):
    leaves = torch.from_numpy(_replica_leaves(R * P, R, P))
    plain = st.tree_build_plain(leaves)
    blocked = st.tree_build_blocked(leaves)
    assert plain.shape == blocked.shape == (R, 2 * P)
    assert not bool(torch.isnan(blocked).any())      # every element written
    for r in range(R):
        want = st.tree_build_plain(leaves[r])
        assert torch.equal(plain[r], want), r
        assert torch.equal(blocked[r], want), r
    assert torch.equal(st.tree_build(leaves), plain)   # the CPU route


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("P", [1, 2, 8, 256, 16384])
def test_replica_descent_bitwise_per_tree(R, P):
    """(R, 2P) trees and (R, n) targets: each row as the one-tree plain
    version and schedule give it, targets at and beyond each tree's
    total and on its leftmost spine included."""
    leaves = _replica_leaves(R * P + 1, R, P)
    trees = st.tree_build_plain(torch.from_numpy(leaves))
    rows = [_targets(R * P + 2 + r, trees[r].numpy(), 24) for r in range(R)]
    n = min(len(t) for t in rows)
    t = torch.from_numpy(np.stack([row[-n:] for row in rows]))
    got = st.segment_tree_sample_plain(trees, t)
    rounds = st.segment_tree_rounds(trees, t)
    assert got.shape == (R, n) and got.dtype == torch.int32
    assert torch.equal(rounds, got)
    for r in range(R):
        want = st.segment_tree_sample_plain(trees[r], t[r])
        assert torch.equal(got[r], want), r
        assert torch.equal(st.segment_tree_rounds(trees[r], t[r]), want), r
        np.testing.assert_array_equal(
            want.numpy(), np.asarray(jref.segment_tree_sample(
                jnp.asarray(trees[r].numpy()), jnp.asarray(t[r].numpy()))))
    assert torch.equal(st.segment_tree_sample(trees, t), got)   # CPU route


@pytest.mark.parametrize("R", [1, 3, 16])
def test_replica_projection_equals_separate_calls(R):
    B, K = 8, 51
    cases = [_proj_case(R * 100 + r, B, K) for r in range(R)]
    probs, rewards, dones = (torch.from_numpy(np.stack(a))
                             for a in zip(*cases))
    kw = dict(v_min=-10.0, v_max=10.0, gamma_n=0.9 ** 3)
    got = cp.categorical_projection(probs, rewards, dones, **kw)
    hat = cp.projection_hat(probs, rewards, dones, **kw)
    assert got.shape == hat.shape == (R, B, K)
    for r in range(R):
        assert torch.equal(got[r], cp.categorical_projection(
            probs[r], rewards[r], dones[r], **kw))
        assert torch.equal(hat[r], cp.projection_hat(
            probs[r], rewards[r], dones[r], **kw))
    flat = cp.categorical_projection(probs.reshape(-1, K),
                                     rewards.reshape(-1), dones.reshape(-1),
                                     **kw)
    assert torch.equal(got.reshape(-1, K), flat)
