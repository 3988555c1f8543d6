"""The port's Nature CNN, losses and RMSProp against the JAX reference.

Full Nature geometry (84x84x4 frames, pong's 3 actions, batch 4) with
the variant heads; parameters come from the reference's init through
``repro_torch.convert``; frames, actions and rewards are made with numpy
from a seed. Held to atol = rtol = 1e-5: the convolutions and matmuls sum
in another order than XLA's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import DQNConfig as JDQNConfig
from repro.configs import dqn_nature as jcfg
from repro.core.dqn import make_update_fn as jax_update_fn
from repro.models import nature_cnn as jnet
from repro.optim import centered_rmsprop as jax_rmsprop
from repro_torch import rng
from repro_torch.config import DQNConfig
from repro_torch.configs import dqn_nature as tcfg
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core.dqn import make_update_fn
from repro_torch.models import nature_cnn as tnet
from repro_torch.optim.rmsprop import centered_rmsprop

TOL = dict(atol=1e-5, rtol=1e-5)
B, A = 4, 3


def _configs(variant: str):
    jv, tv = jcfg.get_variant(variant), tcfg.get_variant(variant)
    jc = jcfg.cnn_config_for(jv, jcfg.cnn_geometry("nature", 84, A))
    tc = tcfg.cnn_config_for(tv, tcfg.cnn_geometry("nature", 84, A))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jv, tv, jc, tc


def _frames(seed, n=B):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 84, 84, 4),
                                                dtype=np.uint8)


def _params(jc):
    jp = jnet.q_init(jc, A, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("variant,noisy_key", [
    ("rainbow", False), ("rainbow", True), ("dqn", False), ("dueling", False),
    ("noisy", True)])
def test_q_forward_and_logits_full_geometry(variant, noisy_key):
    jv, tv, jc, tc = _configs(variant)
    jp, tp = _params(jc)
    frames = _frames(1)
    jk = jax.random.PRNGKey(5) if noisy_key else None
    tk = torch.from_numpy(np.asarray(jk).astype(np.int64)) if noisy_key else None
    got = tnet.q_forward(tp, torch.from_numpy(frames), tc, noise_key=tk)
    want = jnet.q_forward(jp, jnp.asarray(frames), jc, noise_key=jk)
    assert got.shape == (B, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if tc.num_atoms > 1:
        got = tnet.q_logits(tp, torch.from_numpy(frames), tc, noise_key=tk)
        want = jnet.q_logits(jp, jnp.asarray(frames), jc, noise_key=jk)
        assert got.shape == (B, A, tc.num_atoms)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_param_init_matches_reference():
    """The port's own init draws the reference's numbers (normal to a few
    ulps), in the reference's layouts."""
    _, _, jc, tc = _configs("rainbow")
    jp = jax.device_get(jnet.q_init(jc, A, jax.random.PRNGKey(3)))
    tp = tnet.q_init(tc, A, rng.PRNGKey(3))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == np.shape(jp[k]), k
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


def _batch(seed, weights):
    r = np.random.default_rng(seed)
    b = {"obs": _frames(seed), "next_obs": _frames(seed + 1),
         "action": r.integers(0, A, size=B).astype(np.int32),
         "reward": r.choice(np.float32([0.0, 1.0, 1.9]), size=B),
         "done": np.array([False, True, False, False])}
    if weights:
        b["weight"] = r.uniform(0.2, 1.0, size=B).astype(np.float32)
    return b


@pytest.mark.parametrize("variant", ["rainbow", "rainbow_lite", "dqn"])
def test_loss_and_one_rmsprop_update(variant):
    """The loss, its per-sample priority signal (C51 cross-entropy or
    |td|) and one centered-RMSProp step on the online parameters."""
    jv, tv, jc, tc = _configs(variant)
    jp, tp = _params(jc)
    jt, tt = jp, tp                                  # θ⁻ = θ, as at a sync
    nb = _batch(7, weights=jv.prioritized)
    jcfg_d = JDQNConfig(discount=0.9, variant=jv)
    tcfg_d = DQNConfig(discount=0.9, variant=tv)
    jopt, topt = jax_rmsprop(2.5e-4), centered_rmsprop(2.5e-4)
    jqf = lambda p, o, k=None: jnet.q_forward(p, o, jc, noise_key=k)  # noqa: E731
    jql = lambda p, o, k=None: jnet.q_logits(p, o, jc, noise_key=k)  # noqa: E731
    tqf = lambda p, o, k=None: tnet.q_forward(p, o, tc, noise_key=k)  # noqa: E731
    tql = lambda p, o, k=None: tnet.q_logits(p, o, tc, noise_key=k)  # noqa: E731
    jupd = jax.jit(jax_update_fn(jqf, jopt, jcfg_d, jv, q_logits=jql,
                                 kernel_backend="ref"))
    tupd = make_update_fn(tqf, topt, tcfg_d, tv, q_logits=tql)
    jk = jax.random.PRNGKey(11) if jv.noisy else None
    tk = torch.from_numpy(np.asarray(jk).astype(np.int64)) if jv.noisy else None
    # a non-zero optimizer state, so the centered moments matter
    jos = jax.tree.map(lambda x: x + 1e-4, jopt.init(jp))
    tos = opt_state_from_jax(jax.device_get(jos))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jp2, jos2, jloss, jtd = jupd(jp, jt, jos, jb, jk)
    tp2, tos2, tloss, ttd = tupd(tp, tt, tos, tb, tk)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), **TOL)
    for k in jp2:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                   err_msg=k, **TOL)
        for m in ("s", "g"):
            np.testing.assert_allclose(tos2[m][k].numpy(),
                                       np.asarray(jos2[m][k]),
                                       err_msg=f"{m}.{k}", **TOL)
