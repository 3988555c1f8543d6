"""The port's six games and vector observations against the JAX ones.

Each game (defaults, and a set of ``env_params`` overrides) resets W=6
envs from the same keys in both packages, then runs 50 auto-reset steps
on numpy-seeded actions: states, rewards, dones, renders, the 10x10
(or native) frames and the state vectors must be exactly equal. The
refusals of out-of-range parameters carry the reference's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import games as jgames
from repro.envs import preprocess as jpre
from repro_torch.convert import tensor_from_jax
from repro_torch.envs import games as tgames
from repro_torch.envs import preprocess as tpre

W = 6
STEPS = 50
CASES = [
    ("catch", {}),
    ("catch", {"size": 12, "paddle_width": 5, "ball_speed": 2}),
    ("breakout", {}),
    ("breakout", {"size": 8, "brick_rows": 2, "paddle_width": 1}),
    ("pong", {}),
    ("pong", {"size": 7, "paddle_width": 1, "max_steps": 30}),
    ("seeker", {}),
    ("seeker", {"size": 8, "n_hazards": 4, "max_steps": 25}),
    ("freeway", {}),
    ("freeway", {"size": 7, "car_speed": 2, "max_steps": 20}),
    ("dodge", {}),
    ("dodge", {"size": 6, "spawn_prob": 0.6}),
]


def _assert_state_equal(tstate, jstate, where):
    assert sorted(tstate) == sorted(jstate), where
    for k, w in jstate.items():
        w = np.asarray(w)
        g = tstate[k].numpy()
        assert g.dtype == w.dtype, (where, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {k}")


def _eq(t: torch.Tensor, j, where: str):
    j = np.asarray(j)
    assert t.numpy().dtype == j.dtype, (where, t.dtype, j.dtype)
    np.testing.assert_array_equal(t.numpy(), j, err_msg=where)


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_game_matches_reference(name, params):
    torch.set_num_threads(1)
    jspec = jgames.make_env(name, **params)
    tspec = tgames.make_env(name, **params)
    assert (tspec.n_actions, tspec.channels, tspec.max_steps, tspec.size,
            tspec.obs_dim) == (jspec.n_actions, jspec.channels,
                               jspec.max_steps, jspec.size, jspec.obs_dim)
    assert tspec.params == tgames.GAMES[name][0](**params)
    jreset = jax.jit(jax.vmap(jspec.reset))
    jstep = jax.jit(jax.vmap(
        lambda s, a, k: jgames.step_autoreset(jspec, s, a, k)))
    jrender = jax.jit(jax.vmap(jspec.render))
    jobserve = jax.jit(jax.vmap(jspec.observe))
    jpipe = jpre.pixel_obs(jspec.size)
    tpipe = tpre.pixel_obs(tspec.size)
    jvec, tvec = jpre.vector_obs(jspec), tpre.vector_obs(tspec)
    assert tvec.shape == jvec.shape and tvec.dtype == torch.float32
    # compiled, as the reference's trainer runs them: XLA divides by a
    # constant through its float32 reciprocal, which the port follows
    jframe = jax.jit(lambda s: jpre.obs_batch(jpipe, jspec, s))
    jvector = jax.jit(lambda s: jpre.obs_batch(jvec, jspec, s))

    seed = sum(map(ord, name)) + len(params)
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(jax.random.fold_in(key, 0), W)
    js = jreset(keys)
    ts = tspec.reset(tensor_from_jax(keys))
    _assert_state_equal(ts, js, "reset")
    actions = np.random.default_rng(seed).integers(
        0, jspec.n_actions, size=(STEPS, W)).astype(np.int32)
    dones = 0
    for t in range(STEPS):
        keys = jax.random.split(jax.random.fold_in(key, t + 1), W)
        js, jr, jd = jstep(js, jnp.asarray(actions[t]), keys)
        ts, tr, td = tgames.step_autoreset(
            tspec, ts, torch.from_numpy(actions[t]), tensor_from_jax(keys))
        _assert_state_equal(ts, js, f"step {t}")
        _eq(tr, jr, f"reward at step {t}")
        _eq(td, jd, f"done at step {t}")
        _eq(tspec.render(ts), jrender(js), f"render at step {t}")
        _eq(tspec.observe(ts), jobserve(js), f"observe at step {t}")
        _eq(tpre.obs_batch(tvec, tspec, ts), jvector(js),
            f"vector obs at step {t}")
        _eq(tpre.obs_batch(tpipe, tspec, ts), jframe(js),
            f"frame at step {t}")
        dones += int(td.sum())
    if name != "freeway" or params:
        assert dones > 0, "no episode ended: auto-reset went unexercised"


def test_frame84_of_every_default_game_matches_reference():
    """The 84x84 Nature frame (8x upscale, 2-pixel border) of each
    default game, 2- and 3-channel grids alike."""
    for name in tgames.GAMES:
        jspec, tspec = jgames.get_env(name), tgames.get_env(name)
        keys = jax.random.split(jax.random.PRNGKey(7), 3)
        js = jax.vmap(jspec.reset)(keys)
        ts = tspec.reset(tensor_from_jax(keys))
        want = jax.jit(lambda s: jpre.obs_batch(jpre.pixel_obs(84), jspec,
                                                s))(js)
        _eq(tpre.obs_batch(tpre.pixel_obs(84), tspec, ts), want, name)


def test_registry_matches_reference():
    assert sorted(tgames.GAMES) == sorted(jgames.GAMES)
    for name in tgames.GAMES:
        t, j = tgames.get_env(name), jgames.get_env(name)
        assert (t.name, t.n_actions, t.channels, t.max_steps, t.obs_dim,
                t.reward_range) == (j.name, j.n_actions, j.channels,
                                    j.max_steps, j.obs_dim, j.reward_range)
        assert tgames.GAMES[name][0].describe() == \
            jgames.GAMES[name][0].describe()
    assert tgames.get_env("catch", size=12).size == 12


BAD = [
    ("catch", {"size": 3}),
    ("catch", {"paddle_width": 4}),
    ("catch", {"size": 5, "paddle_width": 7}),
    ("catch", {"ball_speed": 4}),
    ("catch", {"size": 10.0}),
    ("breakout", {"brick_rows": 8}),
    ("pong", {"width": 3}),
    ("seeker", {"size": 5, "n_hazards": 7}),
    ("seeker", {"n_hazards": 17}),
    ("freeway", {"car_speed": 1.5}),
    ("dodge", {"spawn_prob": 0.95}),
    ("dodge", {"spawn_prob": "high"}),
    ("tetris", {}),
]


@pytest.mark.parametrize("name,params", BAD,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(BAD)])
def test_refusals_match_reference(name, params):
    with pytest.raises(ValueError) as want:
        jgames.make_env(name, **params)
    with pytest.raises(ValueError) as got:
        tgames.make_env(name, **params)
    assert str(got.value) == str(want.value)
    if name != "tetris":
        with pytest.raises(ValueError) as got:
            tgames.get_env(name, **params)
        assert str(got.value) == str(want.value)
