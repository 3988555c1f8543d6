"""The CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and nvcc, skip without them, and import
nothing of JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports jax.) The segment tree is
held bit for bit, the projection to atol = rtol = 1e-6.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import categorical_projection as cp
from repro_torch.kernels import ops
from repro_torch.kernels import segment_tree as st

PROJ_TOL = dict(atol=1e-6, rtol=1e-6)


def _proj_case(seed, B, K):
    r = np.random.default_rng(seed)
    logits = 3.0 * r.standard_normal((B, K))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    rewards = (15.0 * r.standard_normal(B)).astype(np.float32)
    dones = (r.uniform(size=B) < 0.3).astype(np.float32)
    return probs, rewards, dones


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda_kernels.py")


@pytest.mark.cuda
@pytest.mark.parametrize("P,n", [(1, 3), (8, 5), (2048, 64), (16384, 32)])
def test_cuda_segment_tree_bitwise(P, n):
    _need_card()
    r = np.random.default_rng(P)
    leaves = r.uniform(0.0, 1.0, size=P).astype(np.float32)
    leaves[(3 * P) // 4:] = 0.0
    tree = ops.tree_build(torch.from_numpy(leaves).cuda())
    targets = torch.from_numpy(
        (r.uniform(0.0, 1.05, size=n) * float(tree[1])).astype(np.float32)).cuda()
    before = st.segment_tree_sample.launches
    got = ops.segment_tree_sample(tree, targets)
    torch.cuda.synchronize()
    assert st.segment_tree_sample.launches == before + 1
    assert torch.equal(got, st.segment_tree_sample_plain(tree, targets))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,v_min,v_max", [(32, 51, -10.0, 10.0),
                                             (7, 1, -1.0, -1.0),
                                             (7, 8, 2.0, 2.0),
                                             (64, 512, -10.0, 10.0)])
def test_cuda_categorical_projection(B, K, v_min, v_max):
    _need_card()
    probs, rewards, dones = (torch.from_numpy(a).cuda()
                             for a in _proj_case(K, B, K))
    kw = dict(v_min=v_min, v_max=v_max, gamma_n=0.9 ** 3)
    got = ops.categorical_projection(probs, rewards, dones, **kw)
    want = cp.categorical_projection_plain(probs, rewards, dones, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **PROJ_TOL)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    with pytest.raises(ValueError):
        ops.segment_tree_sample(torch.zeros(12, device="cuda"),
                                torch.zeros(3, device="cuda"))
    with pytest.raises(TypeError):
        ops.segment_tree_sample(torch.zeros(16, device="cuda"),
                                torch.zeros(3, device="cuda",
                                            dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.categorical_projection(torch.zeros(2, 513, device="cuda"),
                                   torch.zeros(2, device="cuda"),
                                   torch.zeros(2, device="cuda"),
                                   v_min=-1.0, v_max=1.0, gamma_n=0.9)
