"""The CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and nvcc, skip without them, and import
nothing of JAX, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports jax.) The tree build
and the segment tree are held bit for bit (one tree, and R trees in the
launches of one), the projection to atol =
rtol = 1e-6 of its plain version and bit for bit against
``projection_hat``, the CPU replay of its schedule; RMSNorm, flash
attention, decode attention, the SSD scan and the sLSTM scan to
atol = rtol = 2e-4 in float32 and 2e-2 in bfloat16 (the reference's own
kernel tolerances), at the shapes ``chip_smoke.py`` checks.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import categorical_projection as cp
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import segment_tree as st
from repro_torch.kernels import slstm_scan as sl
from repro_torch.kernels import ssm_scan as ss

PROJ_TOL = dict(atol=1e-6, rtol=1e-6)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    return dict(atol=t, rtol=t)


def _normal(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).cuda().to(dtype)


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
@pytest.mark.parametrize("P,n", [(1, 3), (8, 5), (2048, 64), (16384, 32),
                                 (1 << 20, 4096)])
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
@pytest.mark.parametrize("P", [1, 2, 8, 2048, 16384, 1 << 20,
                               1 << 23])   # 3 launches
def test_cuda_tree_build_bitwise(P):
    _need_card()
    r = np.random.default_rng(P)
    leaves = r.uniform(0.0, 1.0, size=P).astype(np.float32)
    leaves[(3 * P) // 4:] = 0.0
    cuda = torch.from_numpy(leaves).cuda()
    before = st.tree_build.launches
    got = st.tree_build(cuda)
    torch.cuda.synchronize()
    assert st.tree_build.launches == before + len(st.tree_build_plan(P))
    assert torch.equal(got, st.tree_build_plain(cuda))
    assert torch.equal(got.cpu(),
                       st.tree_build_blocked(torch.from_numpy(leaves)))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 4, 16])
@pytest.mark.parametrize("P,n", [(8, 5), (2048, 64), (16384, 32)])
def test_cuda_replica_tree_build_and_descent_bitwise(R, P, n):
    """R trees (a population's replicas) in the launches of one: the
    build and the descent bitwise equal, tree by tree, to the one-tree
    plain versions."""
    _need_card()
    r = np.random.default_rng(R * P)
    leaves = r.uniform(0.0, 1.0, size=(R, P)).astype(np.float32)
    for i in range(R):
        leaves[i, P - (i * P) // (2 * R):] = 0.0
    cuda = torch.from_numpy(leaves).cuda()
    before = (st.tree_build.launches, st.segment_tree_sample.launches)
    trees = st.tree_build(cuda)
    targets = torch.from_numpy(
        r.uniform(0.0, 1.05, size=(R, n)).astype(np.float32)).cuda()
    targets = targets * trees[:, 1:2]
    targets[:, -1] = trees[:, 1]                 # exactly each total
    got = st.segment_tree_sample(trees, targets)
    torch.cuda.synchronize()
    assert (st.tree_build.launches, st.segment_tree_sample.launches) == (
        before[0] + len(st.tree_build_plan(P)), before[1] + 1)
    for i in range(R):
        assert torch.equal(trees[i], st.tree_build_plain(cuda[i]))
        assert torch.equal(got[i], st.segment_tree_sample_plain(
            trees[i], targets[i]))
    assert torch.equal(trees.cpu(), st.tree_build_blocked(
        torch.from_numpy(leaves)))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [4, 16])
def test_cuda_replica_projection_one_launch(R):
    _need_card()
    B, K = 32, 51
    cases = [_proj_case(R + i, B, K) for i in range(R)]
    probs, rewards, dones = (torch.from_numpy(np.stack(a))
                             for a in zip(*cases))
    kw = dict(v_min=-10.0, v_max=10.0, gamma_n=0.9 ** 3)
    before = cp.categorical_projection.launches
    got = ops.categorical_projection(probs.cuda(), rewards.cuda(),
                                     dones.cuda(), **kw)
    torch.cuda.synchronize()
    assert cp.categorical_projection.launches == before + 1
    assert got.shape == (R, B, K)
    assert torch.equal(got.cpu(), cp.projection_hat(probs, rewards, dones,
                                                    **kw))


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
@pytest.mark.parametrize("B,K,v_min,v_max,gamma_n",
                         [(32, 51, -10.0, 10.0, 0.9 ** 3),
                          (7, 1, -1.0, -1.0, 0.99), (7, 8, 2.0, 2.0, 0.9),
                          (64, 512, -10.0, 10.0, 0.9 ** 3),
                          (13, 51, -10.0, 10.0, 1.0),
                          (9, 51, -10.0, 10.0, -0.5)])
def test_cuda_categorical_projection_matches_its_schedule(B, K, v_min, v_max,
                                                          gamma_n):
    """Bit for bit against the CPU replay of its schedule, the full
    K-term gather in j order."""
    _need_card()
    probs, rewards, dones = (torch.from_numpy(a)
                             for a in _proj_case(K + B, B, K))
    kw = dict(v_min=v_min, v_max=v_max, gamma_n=gamma_n)
    before = cp.categorical_projection.launches
    got = ops.categorical_projection(probs.cuda(), rewards.cuda(),
                                     dones.cuda(), **kw)
    torch.cuda.synchronize()
    assert cp.categorical_projection.launches == before + 1
    assert torch.equal(got.cpu(),
                       cp.projection_hat(probs, rewards, dones, **kw))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    with pytest.raises(ValueError):
        ops.segment_tree_sample(torch.zeros(12, device="cuda"),
                                torch.zeros(3, device="cuda"))
    with pytest.raises(ValueError):
        ops.tree_build(torch.zeros(12, device="cuda"))
    with pytest.raises(TypeError):
        ops.segment_tree_sample(torch.zeros(16, device="cuda"),
                                torch.zeros(3, device="cuda",
                                            dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.categorical_projection(torch.zeros(2, 513, device="cuda"),
                                   torch.zeros(2, device="cuda"),
                                   torch.zeros(2, device="cuda"),
                                   v_min=-1.0, v_max=1.0, gamma_n=0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D", [(8 * 1024, 5120), (7, 96), (3, 20),
                                    (8, 5120), (8, 2560), (8 * 1024, 2560),
                                    (8, 768), (8 * 1024, 768), (5, 4097),
                                    (3, 16384)])   # the longest f32 row
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_rmsnorm(rows, D, dtype):
    _need_card()
    dt = DTYPES[dtype]
    x = _normal(rows, (rows, D), dt)
    gamma = _normal(D, (D,), torch.float32)
    before = rn.rmsnorm.launches
    got = ops.rmsnorm(x, gamma, 1e-5)
    want = rn.rmsnorm_plain(x, gamma, 1e-5)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    assert got.dtype == dt and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 300, 32, 8, 128),
                                         (1, 256, 24, 2, 128),
                                         (1, 128, 4, 1, 80),
                                         (2, 200, 8, 2, 64),
                                         # the wgmma body at D 80, groups
                                         # 1 and 4, whole and ragged tiles
                                         (2, 1024, 4, 4, 80),
                                         (2, 1024, 8, 2, 80),
                                         (2, 300, 4, 4, 80),
                                         (2, 300, 8, 2, 80),
                                         (1, 77, 4, 4, 80),
                                         (1, 77, 8, 2, 80),
                                         (1, 256, 4, 2, 96),
                                         (1, 300, 4, 1, 112)])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_flash_attention(B, S, H, Hkv, D, window, dtype):
    _need_card()
    dt = DTYPES[dtype]
    q = _normal(1, (B, S, H, D), dt)
    k = _normal(2, (B, S, Hkv, D), dt)
    v = _normal(3, (B, S, Hkv, D), dt)
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, True, window)
    want = fa.flash_attention_plain(q, k, v, True, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,L,D,cache_len", [
    (8, 32, 8, 1088, 128, 1), (8, 32, 8, 1088, 128, 517),
    (8, 32, 8, 1088, 128, 1088), (2, 32, 8, 16, 128, 40),
    (2, 24, 2, 1088, 128, 517), (3, 12, 1, 100, 80, 77),
    (8, 32, 32, 1088, 80, 1088), (8, 32, 32, 1088, 80, 300),
    (8, 16, 16, 1088, 128, 1088), (8, 6, 6, 1500, 64, 1500),
    (8, 32, 8, 1601, 128, 1601)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_decode_attention(B, H, Hkv, L, D, cache_len, dtype):
    """Group sizes 4, 12 and 12 (MQA); cache_len 40 > L = 16 is a ring
    cache that has wrapped; one query head per KV head at D 128, which
    in float32 takes half the subtiles to fit in shared memory; the cross
    caches of whisper (L 1500) and the VLM (odd L 1601). The caches are
    layer slices of a stacked (layers, B, Hkv, L, D) tensor, as in the
    model."""
    _need_card()
    dt = DTYPES[dtype]
    q = _normal(4, (B, 1, H, D), dt)
    kc = _normal(5, (2, B, Hkv, L, D), dt)[1]
    vc = _normal(6, (2, B, Hkv, L, D), dt)[1]
    n = torch.full((), cache_len, dtype=torch.int32, device="cuda")
    before = da.decode_attention.launches
    got = ops.decode_attention(q, kc, vc, n)
    want = da.decode_attention_plain(q, kc, vc, n)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,L,D", [(8, 32, 8, 1088, 128),
                                         (8, 32, 32, 1088, 80),
                                         (8, 32, 8, 16, 128),
                                         (8, 16, 16, 1088, 128),
                                         (8, 6, 6, 1500, 64),
                                         (8, 32, 8, 1601, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_decode_attention_at_split_boundaries(B, H, Hkv, L, D, dtype):
    """cache_len on, just before and just after the boundaries of the
    split the kernel picks (a cluster of `splits` blocks, `chunk`
    positions each), at L and past it (a ring); the kernel against the
    plain version and against the emulation of its own split."""
    _need_card()
    dt = DTYPES[dtype]
    splits, chunk = da.kernel_split_plan(B, H, Hkv, L, D, dt)
    assert 1 <= splits <= 8 and chunk == da.split_chunk(L, splits)
    q = _normal(7, (B, 1, H, D), dt)
    kc = _normal(8, (B, Hkv, L, D), dt)
    vc = _normal(9, (B, Hkv, L, D), dt)
    lens = {1, L - 1, L, L + 5}
    for i in range(1, splits):
        lens |= {i * chunk - 1, i * chunk, i * chunk + 1}
    for n in sorted(x for x in lens if x >= 1):
        nd = torch.full((), n, dtype=torch.int32, device="cuda")
        got = ops.decode_attention(q, kc, vc, nd)
        want = da.decode_attention_plain(q, kc, vc, nd)
        emu = da.decode_attention_split(q, kc, vc, n, splits)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_tol(dt))
        torch.testing.assert_close(got.float(), emu.float(), **_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024, 32, 8, 128),
                                   (8, 1024, 32, 32, 80)])
def test_cuda_attention_kernels_are_bitwise_repeatable(shape):
    """Two launches of each attention kernel on the same inputs give the
    same bits (no atomics; the decode splits combine in a fixed order),
    at the serve paths' shapes in bf16."""
    _need_card()
    B, S, H, Hkv, D = shape
    bf = torch.bfloat16
    q = _normal(10, (B, S, H, D), bf)
    k = _normal(11, (B, S, Hkv, D), bf)
    v = _normal(12, (B, S, Hkv, D), bf)
    a = ops.flash_attention(q, k, v, True, None)
    b = ops.flash_attention(q, k, v, True, None)
    L = S + 64
    qd = _normal(13, (B, 1, H, D), bf)
    kc = _normal(14, (B, Hkv, L, D), bf)
    vc = _normal(15, (B, Hkv, L, D), bf)
    nd = torch.full((), L - 3, dtype=torch.int32, device="cuda")
    c = ops.decode_attention(qd, kc, vc, nd)
    d = ops.decode_attention(qd, kc, vc, nd)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(c, d)


@pytest.mark.cuda
def test_cuda_llm_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    x = torch.zeros(2, 1, 4, 12, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(x, x[:, :, :2], x[:, :, :2])
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.decode_attention(x, torch.zeros(2, 2, 5, 12, device="cuda"),
                             torch.zeros(2, 2, 5, 12, device="cuda"), 3)
    with pytest.raises(TypeError):
        ops.rmsnorm(torch.zeros(2, 8, device="cuda", dtype=torch.float16),
                    torch.ones(8, device="cuda"))
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.zeros(2, 8, device="cuda"),
                    torch.ones(8, device="cuda", dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (8, 1024, 80, 64, 64, 128),   # zamba2-2.7b's prefill: 8 chunks
    (2, 384, 4, 64, 64, 128),     # 3 chunks
    (1, 100, 2, 64, 64, 128),     # S below the chunk: L = S = 100
    (2, 64, 3, 16, 8, 16),        # small heads and state, 4 chunks
    (1, 2304, 2, 64, 64, 128),    # 18 chunks: more than a cluster's ranks
    (2, 192, 12, 64, 64, 64)])    # L 64, head groups of 8 and 4
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_ssm_scan(B, S, H, P, N, chunk, dtype):
    """x, Bm and Cm are slices of one wider tensor, as the model's conv
    output hands them over (strided rows). bf16 at P = N = 64 and a chunk
    that is a multiple of 16 takes the cluster body, the rest the scalar
    body."""
    _need_card()
    dt_ = DTYPES[dtype]
    L = ss.chunk_length(S, chunk)
    plan = ss.kernel_plan(B, S, H, P, N, L, dt_)
    assert plan.body == ("cluster" if dt_ == torch.bfloat16 and P == N == 64
                         and L % 16 == 0 else "scalar")
    r = np.random.default_rng(S)
    conv = _normal(S, (B, S, H * P + 2 * N), dt_)
    x = conv[..., : H * P].reshape(B, S, H, P)
    Bm, Cm = conv[..., H * P: H * P + N], conv[..., H * P + N:]
    dt = torch.nn.functional.softplus(_normal(S + 1, (B, S, H),
                                              torch.float32))
    A = -torch.from_numpy(np.exp(r.standard_normal(H)).astype(np.float32)).cuda()
    before = ss.ssm_scan.launches
    y, h = ops.ssm_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y_p, h_p = ss.ssm_scan_plain(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ss.ssm_scan.launches == before + 1
    assert y.dtype == dt_ and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), **_tol(dt_))
    torch.testing.assert_close(h, h_p, **_tol(dt_))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Pd,warm", [
    (8, 1024, 4, 192, False),     # xlstm-125m's prefill
    (3, 37, 4, 192, True),        # S no multiple of 16, a warm state
    (11, 20, 2, 32, True),        # two batch tiles, the second partial
    (2, 1, 4, 8, False),
    (20, 24, 4, 192, True),       # the cluster body over three batch tiles
    (11, 16, 4, 512, True)])      # the stream body, two batch tiles
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_slstm_scan(B, S, H, Pd, warm, dtype):
    """At Pd 192 and 32 the kernel takes its cluster body; at Pd 512
    (R does not fit a cluster) and 8 (units not in 16-byte columns) its
    stream body."""
    _need_card()
    dt_ = DTYPES[dtype]
    plan = sl.kernel_plan(B, H, Pd, dt_)
    assert plan.body == ("stream" if Pd in (8, 512) else "cluster")
    d = H * Pd
    wx = _normal(S, (B, S, 4 * d), dt_)
    R = _normal(S + 1, (4, H, Pd, Pd), torch.float32) / float(np.sqrt(Pd))
    b = 0.1 * _normal(S + 2, (4 * d,), torch.float32)
    if warm:
        f = [_normal(S + 3 + i, (B, d), torch.float32) for i in range(4)]
        state = (f[0], 1.0 + f[1].abs(), torch.tanh(f[2]), f[3])
    else:
        z = torch.zeros((B, d), device="cuda")
        state = (z, z, z, torch.full((B, d), -1e9, device="cuda"))
    before = sl.slstm_scan.launches
    hs, st_k = ops.slstm_scan(wx, R, b, state, H)
    hs_p, st_p = sl.slstm_scan_plain(wx, R, b, state, H)
    torch.cuda.synchronize()
    assert sl.slstm_scan.launches == before + 1
    assert hs.dtype == dt_ and hs.shape == (B, S, d)
    torch.testing.assert_close(hs.float(), hs_p.float(), **_tol(dt_))
    for a, e in zip(st_k, st_p):
        torch.testing.assert_close(a, e, **_tol(dt_))


@pytest.mark.cuda
def test_cuda_slstm_scan_is_bitwise_repeatable():
    """Two launches of the sLSTM scan on the same inputs give the same
    bits (each pre-activation summed in a fixed order by fixed threads,
    no atomics), at xlstm-125m's prefill shape in bf16 with a warm
    state, on the cluster body."""
    _need_card()
    B, S, H, Pd = 8, 1024, 4, 192
    d = H * Pd
    bf = torch.bfloat16
    assert sl.kernel_plan(B, H, Pd, bf).body == "cluster"
    wx = _normal(20, (B, S, 4 * d), bf)
    R = _normal(21, (4, H, Pd, Pd), torch.float32) / float(np.sqrt(Pd))
    b = 0.1 * _normal(22, (4 * d,), torch.float32)
    f = [_normal(23 + i, (B, d), torch.float32) for i in range(4)]
    state = (f[0], 1.0 + f[1].abs(), torch.tanh(f[2]), f[3])
    hs_a, st_a = ops.slstm_scan(wx, R, b, state, H)
    hs_b, st_b = ops.slstm_scan(wx, R, b, state, H)
    torch.cuda.synchronize()
    assert torch.equal(hs_a, hs_b)
    assert all(torch.equal(x, y) for x, y in zip(st_a, st_b))


@pytest.mark.cuda
def test_cuda_scan_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    x = torch.zeros(1, 256, 2, 8, device="cuda")
    dt = torch.zeros(1, 256, 2, device="cuda")
    A = torch.zeros(2, device="cuda")
    Bm = torch.zeros(1, 256, 8, device="cuda")
    with pytest.raises(ValueError, match="chunk of at most"):
        ops.ssm_scan(x, dt, A, Bm, Bm, chunk=256)
    with pytest.raises(TypeError):
        ops.ssm_scan(x, dt.double(), A, Bm, Bm, chunk=128)
    state = tuple(torch.zeros(1, 12, device="cuda") for _ in range(4))
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.slstm_scan(torch.zeros(1, 3, 48, device="cuda"),
                       torch.zeros(4, 2, 6, 6, device="cuda"),
                       torch.zeros(48, device="cuda"), state, 2)
    with pytest.raises(TypeError):
        ops.slstm_scan(torch.zeros(1, 3, 48, device="cuda"),
                       torch.zeros(4, 3, 4, 4, device="cuda",
                                   dtype=torch.bfloat16),
                       torch.zeros(48, device="cuda"), state, 3)
