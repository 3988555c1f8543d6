"""The port's AdamW, its schedule and global-norm clipping against
``repro.optim``.

AdamW runs 5 steps on the same numpy-seeded parameters and gradients in
both packages, with the clip on and off, weight decay 0 and 0.1, and a
constant and a ``warmup_cosine`` rate: updates, both moments and the
step counter agree to 1e-6 relative to each leaf's largest magnitude
(XLA fuses ``b1 * m + (1 - b1) * g`` into fused multiply-adds, which
round once where torch rounds twice, so an element that cancels to near
zero can differ by an ulp of its terms; the clip's global norm also sums
in another order). ``warmup_cosine``, ``global_norm`` and
``clip_by_global_norm`` are held on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim.base import clip_by_global_norm as jclip
from repro.optim.base import global_norm as jnorm
from repro.optim.schedule import warmup_cosine as jwarmup
from repro_torch.optim.adamw import adamw as tadamw
from repro_torch.optim.base import apply_updates
from repro_torch.optim.base import clip_by_global_norm as tclip
from repro_torch.optim.base import global_norm as tnorm
from repro_torch.optim.schedule import warmup_cosine as twarmup

REL = dict(rtol=1e-6, atol=1e-12)


def _close(got, want, err_msg):
    """1e-6 relative, elementwise and to the leaf's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=err_msg)


SHAPES = {"fc_w": (12, 8), "fc_b": (8,), "conv0_w": (3, 3, 2, 4),
          "out_w": (8, 3), "adv_b": (3,)}


def _tree(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("grad_clip", [1.0, None])
def test_adamw_matches_reference(grad_clip, weight_decay, schedule):
    rng = np.random.default_rng(3)
    if schedule == "constant":
        jlr, tlr = 1e-3, 1e-3
    else:
        jlr, tlr = jwarmup(1e-2, 2, 5), twarmup(1e-2, 2, 5)
    jopt = jadamw(jlr, weight_decay=weight_decay, grad_clip=grad_clip)
    topt = tadamw(tlr, weight_decay=weight_decay, grad_clip=grad_clip)
    params = _tree(rng, 0.5)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _t(params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    jupdate = jax.jit(jopt.update)
    for step in range(5):
        grads = _tree(rng, 2.0)          # global norm ~25: the clip bites
        ju, js = jupdate({k: jnp.asarray(v) for k, v in grads.items()}, js,
                         jp)
        tu, ts = topt.update(_t(grads), ts, tp)
        for k in SHAPES:
            _close(tu[k].numpy(), ju[k], f"update {k}, step {step}")
            for moment in ("m", "v"):
                _close(ts[moment][k].numpy(), js[moment][k],
                       f"{moment} {k}, step {step}")
        assert int(ts["step"]) == int(js["step"]) == step + 1
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = apply_updates(tp, tu)


def test_warmup_cosine_matches_reference():
    for args in ((1e-3, 10, 100), (3e-4, 0, 50), (1.0, 5, 5, 0.2)):
        jf, tf = jwarmup(*args), twarmup(*args)
        steps = np.arange(0, 120, 3, dtype=np.int32)
        want = np.asarray(jax.jit(jax.vmap(jf))(jnp.asarray(steps)))
        got = tf(torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, err_msg=str(args), **REL)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_clip_by_global_norm_matches_reference(scale):
    tree = _tree(np.random.default_rng(5), scale)
    want_norm = jnorm({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_allclose(float(tnorm(_t(tree))), float(want_norm),
                               **REL)
    jc, jn = jclip({k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    tc, tn = tclip(_t(tree), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), **REL)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **REL)
    clipped = float(tnorm(tc))
    assert clipped <= 1.0 + 1e-6
    if float(tn) < 1.0:                       # below the limit: untouched
        for k in SHAPES:
            assert torch.equal(tc[k], _t(tree)[k]), k
