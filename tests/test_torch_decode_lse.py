"""Decode attention's log-sum-exp (``return_lse``), on the CPU.

The kernel writes each row's log-sum-exp of the scaled scores, m* +
log(l), in its cluster combine; a caller that splits the cache's L
positions over ranks (``--kv-seq-shard``) combines the ranks' outputs
by it. Here the plain version and the emulation of the kernel's split
schedule are held to ``torch.logsumexp`` of the scaled, masked scores
and to each other, to float32 rounding; the output with the log-sum-exp
is bitwise the call's without it; an empty row gives -inf; and the
shape-only branch and the analytic work account for the extra output.
The card's kernel is held to the plain version by ``chip_smoke.py``.
"""

import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.roofline.cost import CostCounter

# (B, H, Hkv, L, D), each at cache lengths (a ring's wrapped count too)
CASES = (((2, 4, 2, 37, 16), (1, 20, 37, 50)),
         ((1, 6, 6, 64, 8), (0, 64)),
         ((3, 8, 1, 130, 32), (0, 65, 130)))
DTYPES = (torch.float32, torch.bfloat16)


def _inputs(case, dtype, seed=0):
    B, H, Hkv, L, D = case
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g).to(dtype)
    k, v = (torch.randn(B, Hkv, L, D, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v


def _want(q, k, n):
    """logsumexp over the valid positions of the scores, scaled, in
    float32 from the inputs' float32 copies (B, 1, H)."""
    B, _, H, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    kk = torch.repeat_interleave(k.float(), H // Hkv, dim=1)
    s = torch.einsum("bhd,bhld->bhl", q.float().reshape(B, H, D), kk)
    s = torch.where(torch.arange(L) < min(n, L), s * D ** -0.5,
                    float("-inf"))
    return torch.logsumexp(s, dim=-1)[:, None]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,lens", CASES)
def test_plain_and_split_lse_match_logsumexp(case, lens, dtype):
    """The plain version's and the split emulation's log-sum-exp against
    ``torch.logsumexp`` of the scaled, masked scores and against each
    other, to float32 rounding; -inf for an empty row (cache_len 0). The
    plain version of a bf16 call scores in bf16, so it is held on the
    inputs' float32 copies, as the kernel scores in float32."""
    q, k, v = _inputs(case, dtype)
    for n in lens:
        want = _want(q, k, n)
        f = (lambda t: t.float())
        _, plain = da.decode_attention_plain(f(q), f(k), f(v), n,
                                             return_lse=True)
        for splits in (1, 2, 3, 8):
            _, split = da.decode_attention_split(q, k, v, n, splits,
                                                 return_lse=True)
            assert split.dtype == torch.float32
            assert split.shape == (case[0], 1, case[1])
            if n == 0:
                assert torch.isneginf(split).all()
                continue
            torch.testing.assert_close(split, want, rtol=2e-6, atol=2e-6)
            torch.testing.assert_close(split, plain, rtol=2e-6, atol=2e-6)
        if n == 0:
            assert torch.isneginf(plain).all()
        else:
            torch.testing.assert_close(plain, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,lens", CASES)
def test_output_with_lse_is_bitwise_the_default(case, lens, dtype):
    """``return_lse`` adds an output and changes none: the wrapper's, the
    plain version's and the split emulation's outputs are bitwise those
    of the calls without it (a cache_len given as an int or a tensor)."""
    q, k, v = _inputs(case, dtype, seed=1)
    for n in lens:
        for cl in (n, torch.full((), n, dtype=torch.int32)):
            o, lse = da.decode_attention(q, k, v, cl, return_lse=True)
            assert torch.equal(o, da.decode_attention(q, k, v, cl),) or (
                n == 0 and torch.isnan(o).all())
            assert lse.dtype == torch.float32
            o2, _ = da.decode_attention_plain(q, k, v, cl, return_lse=True)
            assert torch.equal(o2, o) or n == 0
        o3, _ = da.decode_attention_split(q, k, v, n, 2, return_lse=True)
        assert torch.equal(o3, da.decode_attention_split(q, k, v, n, 2))


def test_lse_shape_only_and_work():
    """On fake tensors the shape-only branch returns the output and a
    float32 (B, 1, H); under the counter the call adds the log-sum-exp's
    4 B H bytes to its work, and its flops are the same."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, k, v = _inputs((2, 4, 2, 37, 16), torch.bfloat16)
    with FakeTensorMode() as fm:
        fq, fk, fv = (fm.from_tensor(t) for t in (q, k, v))
        with CostCounter() as with_lse:
            o, lse = da.decode_attention(fq, fk, fv, 5, return_lse=True)
        with CostCounter() as without:
            da.decode_attention(fq, fk, fv, 5)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (2, 1, 4) and lse.dtype == torch.float32
    assert with_lse.flops == without.flops
    assert with_lse.bytes == without.bytes + 4 * 2 * 4
    assert da.decode_attention_work(q, k, True) == (
        da.decode_attention_work(q, k)[0],
        da.decode_attention_work(q, k)[1] + 4 * 2 * 4)
