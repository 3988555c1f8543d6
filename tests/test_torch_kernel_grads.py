"""The backward of the four LLM kernels (flash attention, RMSNorm, the SSD
scan and the sLSTM scan), on the CPU.

On the card each wrapper routes a call that needs a gradient through
``kernels.recompute.PlainRecompute``: the kernel forward, the plain
version's autograd backward. The kernel cannot run here, so the plain
version stands in for the launch: the Function's input gradients must
then be bitwise those of autograd through the plain version, at the same
inputs and cotangents. The wrappers' routing is checked on meta tensors
(neither CPU nor CUDA): with grad on they go through the Function, under
``torch.no_grad()`` straight to the launch. And the plain gradients are
held against the reference's ops (``custom_vjp`` through
``kernels/ref.py``; the sLSTM's ref scan through XLA autodiff) to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import slstm_scan as sl
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels.recompute import PlainRecompute, _tuple


def _inputs(seed, shapes):
    r = np.random.default_rng(seed)
    return [np.asarray(r.normal(size=s) * scale + shift, np.float32)
            for s, scale, shift in shapes]


def _cases():
    """name -> (plain version in the Function's form, kwargs, numpy
    inputs, reference op returning the outputs' tuple)."""
    B, S, H, Hkv, D = 2, 8, 4, 2, 8
    flash_in = _inputs(0, [((B, S, H, D), 1, 0), ((B, S, Hkv, D), 1, 0),
                           ((B, S, Hkv, D), 1, 0)])
    norm_in = _inputs(1, [((3, 5, 16), 2, 0), ((16,), 0.5, 1)])
    Hs, P, N = 3, 4, 5
    ssm_in = _inputs(2, [((B, S, Hs, P), 1, 0), ((B, S, Hs), 0.1, 0.5),
                         ((Hs,), 0.3, -1), ((B, S, N), 1, 0),
                         ((B, S, N), 1, 0)])
    Hl, Pd = 2, 4
    d = Hl * Pd
    sl_in = _inputs(3, [((B, 5, 4 * d), 1, 0), ((4, Hl, Pd, Pd), 0.3, 0),
                        ((4 * d,), 0.1, 0), ((B, d), 0.5, 0),
                        ((B, d), 0.1, 1.5), ((B, d), 0.3, 0),
                        ((B, d), 0.2, 0)])
    return {
        "flash": (fa.flash_attention_plain, {"causal": True, "window": None},
                  flash_in,
                  lambda q, k, v: (jops.flash_attention(
                      q, k, v, True, None, backend="ref"),)),
        "flash_window": (fa.flash_attention_plain,
                         {"causal": True, "window": 3},
                         flash_in, lambda q, k, v: (jops.flash_attention(
                             q, k, v, True, 3, backend="ref"),)),
        "rmsnorm": (rn.rmsnorm_plain, {"eps": 1e-5}, norm_in,
                    lambda x, g: (jops.rmsnorm(x, g, 1e-5, backend="ref"),)),
        "ssm_scan": (ss._plain_out, {"chunk": 4}, ssm_in,
                     lambda *a: jops.ssm_scan(*a, chunk=4, backend="ref")),
        "slstm_scan": (sl._flat(sl.slstm_scan_plain), {"n_heads": Hl}, sl_in,
                       lambda wx, R, b, c, n, h, m: (lambda hs, st: (
                           hs, *st))(*jops.slstm_scan(
                               wx, R, b, (c, n, h, m), Hl, backend="ref"))),
    }


CASES = _cases()


def _cotangents(outs, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g) for o in outs]


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_gradients_bitwise_plain_autograd(name):
    plain, kwargs, arrays, _ = CASES[name]
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = PlainRecompute.apply(None, plain, plain, kwargs, *xs)
    want_outs = _tuple(plain(*xs, **kwargs))
    assert len(outs) == len(want_outs)
    cots = _cotangents(want_outs, 5)
    got = torch.autograd.grad(outs, xs, cots)
    want = torch.autograd.grad(want_outs, xs, cots)
    for o, w in zip(outs, want_outs):
        assert torch.equal(o, w)
        assert o.grad_fn is not None
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and torch.equal(g, w), (name, i)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_takes_only_some_inputs_and_outputs(name):
    """A cotangent for the first output alone, gradients for every other
    input: the rest get None and the grads are those of the plain
    version's first output."""
    plain, kwargs, arrays, _ = CASES[name]
    xs = [torch.from_numpy(a).requires_grad_(i % 2 == 1)
          for i, a in enumerate(arrays)]
    if not any(x.requires_grad for x in xs):
        xs[0].requires_grad_()
    wanted = [x for x in xs if x.requires_grad]
    outs = PlainRecompute.apply(None, plain, plain, kwargs, *xs)
    (cot,) = _cotangents(outs[:1], 6)
    got = torch.autograd.grad(outs[0], wanted, cot)
    want = torch.autograd.grad(_tuple(plain(*xs, **kwargs))[0], wanted, cot)
    for g, w in zip(got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_gradients_match_reference_vjp(name):
    plain, kwargs, arrays, jfn = CASES[name]
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = _tuple(plain(*xs, **kwargs))
    cots = _cotangents(outs, 7)
    got = torch.autograd.grad(outs, xs, cots)
    jouts, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    want = vjp(tuple(jnp.asarray(c.numpy()) for c in cots))
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   rtol=1e-5, atol=1e-5)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} input {i}")


def _meta(arrays, grad):
    return [torch.empty(a.shape, device="meta").requires_grad_(grad)
            for a in arrays]


WRAPPERS = {
    "flash": lambda q, k, v: (fa.flash_attention(q, k, v, True, None),),
    "rmsnorm": lambda x, g: (rn.rmsnorm(x, g, 1e-5),),
    "ssm_scan": lambda *a: ss.ssm_scan(*a, chunk=4),
    "slstm_scan": lambda wx, R, b, *st: (lambda hs, s: (hs, *s))(
        *sl.slstm_scan(wx, R, b, tuple(st), 2)),
}
MODULES = {"flash": fa, "rmsnorm": rn, "ssm_scan": ss, "slstm_scan": sl}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_routes_gradients_through_the_function(name, monkeypatch):
    """Off the CPU, a call that needs a gradient goes through
    PlainRecompute (its launch the wrapper's own), one without a
    gradient straight to the launch; both launch once."""
    mod, arrays = MODULES[name], CASES[name][2]
    launched = []
    plain = CASES[name][0]

    if name == "slstm_scan":
        def fake(wx, R, b, state, n_heads):
            launched.append(1)
            hs, *st = plain(wx, R, b, *state, n_heads=n_heads)
            return hs, tuple(st)
    elif name == "ssm_scan":
        def fake(x, dt, A, Bm, Cm, chunk):
            launched.append(1)
            return plain(x, dt, A, Bm, Cm, chunk=chunk)
    else:
        def fake(*a, **k):
            launched.append(1)
            return plain(*a, **k)
    monkeypatch.setattr(mod, "_launch", fake)
    outs = WRAPPERS[name](*_meta(arrays, True))
    assert all(o.grad_fn is not None for o in outs[:1])
    assert "PlainRecompute" in type(outs[0].grad_fn).__name__
    assert len(launched) == 1
    with torch.no_grad():
        outs = WRAPPERS[name](*_meta(arrays, True))
    assert outs[0].grad_fn is None and len(launched) == 2
    outs = WRAPPERS[name](*_meta(arrays, False))
    assert outs[0].grad_fn is None and len(launched) == 3


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_wrapper_is_the_plain_version(name):
    arrays = CASES[name][2]
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = WRAPPERS[name](*xs)
    assert "PlainRecompute" not in type(outs[0].grad_fn).__name__
    plain, kwargs = CASES[name][0], dict(CASES[name][1])
    want = _tuple(plain(*xs, **kwargs))
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
