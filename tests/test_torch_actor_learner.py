"""The port's actor-learner (fused and disaggregated) and its sampler
against the JAX reference, on the CPU.

The reference runs its plain XLA path (``use_pallas=False``, float32;
its DQN kernels through their plain versions, the CPU default) and its
state crosses to the port through ``convert``. Tokens, cursors, sizes,
steps and the mean rewards are held exactly, advantages, parameters,
AdamW state and losses to 1e-4 relative. Before tokens are held equal,
each cycle asserts that the reference's top-2 margin of
``log(probs + 1e-9) + gumbel`` at every sampled token exceeds that
tolerance, so that the equality means something.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ExecConfig as JExec
from repro.configs import reduced_config as jreduced
from repro.core.actor_learner import ALConfig as JALConfig
from repro.core.actor_learner import make_actor_learner as jmake
from repro.core.actor_learner import synthetic_reward as jreward
from repro.core.disaggregated import DisaggregatedActorLearner as JDisagg
from repro.models import transformer as JT
from repro_torch import rng
from repro_torch.config import ExecConfig
from repro_torch.configs import reduced_config
from repro_torch.convert import al_carry_from_jax, disaggregated_from_jax
from repro_torch.core.actor_learner import (ALConfig, make_actor_learner,
                                            synthetic_reward)
from repro_torch.core.disaggregated import DisaggregatedActorLearner
from repro_torch.optim.base import flatten

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-4
JEC = JExec(compute_dtype="float32", remat=False)
EC = ExecConfig(compute_dtype="float32")
SMALL = dict(n_streams=8, prompt_len=4, gen_len=8, replay_capacity=32,
             updates_per_cycle=3, minibatch=8, learning_rate=1e-3,
             reward_modulus=4)
N = 200_000
TINY = float(np.finfo(np.float32).tiny)


def _np(tree):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flatten(tree).items()}


def _close(got, want, label):
    g, w = _np(got), _np(jax.device_get(want))
    assert g.keys() == w.keys(), label
    for k, a in g.items():
        np.testing.assert_allclose(a, w[k], **TOL, err_msg=f"{label} {k}")


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 11])
def test_gumbel_within_two_ulps_of_jax(seed):
    """200k draws: the uniforms are jax's bit for bit; torch's float32 log
    is within an ulp of XLA's, so each draw is within 2 ulps of
    max(|g|, 1) (measured: 2 at most, and at most 9.6e-7)."""
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (N,)))
    got = rng.gumbel(rng.PRNGKey(seed), (N,)).numpy()
    u = rng.uniform(rng.PRNGKey(seed), (N,), TINY, 1.0).numpy()
    np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (N,), minval=TINY, maxval=1.0)))
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert float((np.abs(got - want) / ulp).max()) <= 2.0
    assert got.dtype == np.float32


@pytest.mark.parametrize("seed", [7, 11])
def test_categorical_matches_jax(seed):
    """1000 distributions over 200 classes (200k draws): the same classes
    wherever the reference's top-2 score margin exceeds the draws' error,
    which is every row here."""
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                          (1000, 200))) * 2.0
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    scores = np.asarray(jax.random.gumbel(key, logits.shape)) + logits
    top2 = np.sort(scores, axis=-1)[:, -2:]
    assert float((top2[:, 1] - top2[:, 0]).min()) > 1e-5
    got = rng.categorical(rng.PRNGKey(seed), torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_synthetic_reward_matches_reference():
    toks = np.random.default_rng(0).integers(0, 50, (6, 12)).astype(np.int32)
    want = np.asarray(jreward(jnp.asarray(toks), 4, 7, 1))
    got = synthetic_reward(torch.from_numpy(toks), 4, 7, 1)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The reference's actor, replayed to read its sampling margins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jdecode():
    """The reference's decode step jitted once per config in this module
    (each cycle's margins replay it)."""
    built = {}

    def get(jc):
        if jc not in built:
            built[jc] = jax.jit(functools.partial(JT.decode_step, jc, JEC))
        return built[jc]
    return get


def _margins(dec, jc, al, params, step):
    """The reference actor's smallest top-2 margin of log(probs + 1e-9)
    + gumbel over the sampled tokens of cycle ``step`` from ``params``
    (``dec``: its jitted decode step), and its sequences."""
    W, L = al.n_streams, al.prompt_len + al.gen_len
    key = jax.random.fold_in(jax.random.PRNGKey(3), step)
    kp, kg, _ = jax.random.split(key, 3)
    prompts = jax.random.randint(kp, (W, al.prompt_len), 0, jc.vocab)
    cache = JT.init_cache(jc, JEC, W, L)
    for t in range(al.prompt_len):
        logits, cache = dec(params, cache, prompts[:, t:t + 1])
    logits = logits[:, 0]
    worst, toks = np.inf, []
    for k in jax.random.split(kg, al.gen_len):
        probs = jax.nn.softmax(logits[:, : jc.vocab] / al.temperature, -1)
        lp = jnp.log(probs + 1e-9)
        scores = np.asarray(lp + jax.random.gumbel(k, lp.shape))
        top2 = np.sort(scores, axis=-1)[:, -2:]
        worst = min(worst, float((top2[:, 1] - top2[:, 0]).min()))
        tok = jax.random.categorical(k, lp, axis=-1)
        new, cache = dec(params, cache, tok[:, None])
        logits = new[:, 0]
        toks.append(tok)
    return worst, np.asarray(jnp.concatenate([prompts, jnp.stack(toks, 1)],
                                             1))


# ---------------------------------------------------------------------------
# Fused actor-learner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["starcoder2-3b", "xlstm-125m"])
def test_fused_actor_learner_matches_reference(arch, jdecode):
    jc, tc_ = jreduced(arch), reduced_config(arch)
    jal, al = JALConfig(**SMALL), ALConfig(**SMALL)
    jinit, jcycle = jmake(jc, JEC, jal)
    init, cycle = make_actor_learner(tc_, EC, al)
    jcarry = jinit(jax.random.PRNGKey(0))
    carry = al_carry_from_jax(jax.device_get(jcarry))
    # the port's own init draws the same parameters (to the normal
    # draw's few ulps), in float32
    own = flatten(init(rng.PRNGKey(0)).params)
    for k, v in flatten(carry.params).items():
        assert own[k].dtype == torch.float32
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7)
    jcycle = jax.jit(jcycle)
    for c in range(3):
        margin, want_seqs = _margins(jdecode(jc), jc, jal, jcarry.params, c)
        assert margin > MARGIN, (c, margin)
        jcarry, jm = jcycle(jcarry)
        carry, m = cycle(carry)
        cur = (c * al.n_streams) % al.replay_capacity
        np.testing.assert_array_equal(
            carry.seqs[cur: cur + al.n_streams].numpy(), want_seqs)
        np.testing.assert_array_equal(carry.seqs.numpy(),
                                      np.asarray(jcarry.seqs))
        for name in ("cursor", "size", "step"):
            got, want = getattr(carry, name), getattr(jcarry, name)
            assert got.dtype == torch.int32 and int(got) == int(want), name
        assert float(m["reward"]) == float(jm["reward"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(carry.rewards.numpy(),
                                   np.asarray(jcarry.rewards), **TOL)
    _close(carry.params, jcarry.params, f"{arch} params")
    _close(carry.opt_state["m"], jcarry.opt_state["m"], f"{arch} m")
    _close(carry.opt_state["v"], jcarry.opt_state["v"], f"{arch} v")
    assert int(carry.opt_state["step"]) == int(jcarry.opt_state["step"]) == 9


def test_actor_uses_target_params_only():
    """Generation within a cycle must not depend on the learner's
    updates: the Concurrent-Training decoupling."""
    cfg = reduced_config("xlstm-125m")
    outs = {}
    for lr in (0.0, 5e-2):
        al = ALConfig(n_streams=4, prompt_len=4, gen_len=6,
                      replay_capacity=32, updates_per_cycle=2, minibatch=4,
                      learning_rate=lr)
        init, cycle = make_actor_learner(cfg, EC, al)
        carry, _ = cycle(init(rng.PRNGKey(0)))
        outs[lr] = carry.seqs[:4]
    assert torch.equal(outs[0.0], outs[5e-2])


# ---------------------------------------------------------------------------
# Disaggregated actor-learner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_dist", [False, True])
def test_disaggregated_matches_reference(per_dist, jdecode):
    """3 cycles on the CPU against the reference with one CPU device for
    both device sets; with ``prioritized`` and ``distributional_adv`` off
    and on (the segment-tree and C51 projection plain versions)."""
    arch = "xlstm-125m"
    jc, tc_ = jreduced(arch), reduced_config(arch)
    kw = dict(SMALL, prioritized=per_dist, distributional_adv=per_dist)
    jal, al = JALConfig(**kw), ALConfig(**kw)
    devs = np.array(jax.devices()[:1])
    jd = JDisagg(jc, JEC, jal, actor_devices=devs, learner_devices=devs)
    d = DisaggregatedActorLearner(tc_, EC, al)
    disaggregated_from_jax(d, *jax.device_get(
        (jd.params, jd.opt_state, jd.seqs, jd.advs)), jd.cursor, jd.size,
        jd.step)
    for c in range(3):
        margin, want_seqs = _margins(jdecode(jc), jc, jal, jd.params, c)
        assert margin > MARGIN, (c, margin)
        jm, m = jd.cycle(), d.cycle()
        assert (d.cursor, d.size, d.step) == (jd.cursor, jd.size, jd.step)
        cur = (c * al.n_streams) % al.replay_capacity
        np.testing.assert_array_equal(
            d.seqs[cur: cur + al.n_streams].numpy(), want_seqs)
        np.testing.assert_array_equal(d.seqs.numpy(), np.asarray(jd.seqs))
        assert d.seqs.dtype == torch.int32
        assert m["reward"] == jm["reward"]
        np.testing.assert_allclose(m["loss"], jm["loss"], **TOL)
        np.testing.assert_allclose(d.advs.numpy(), np.asarray(jd.advs),
                                   **TOL)
    assert jm["loss"] != 0.0
    _close(d.params, jd.params, "params")
    _close(d.opt_state["m"], jd.opt_state["m"], "m")
    _close(d.opt_state["v"], jd.opt_state["v"], "v")
    assert int(d.opt_state["step"]) == int(jd.opt_state["step"]) == 6


def test_disaggregated_kernels_on_the_learner_path(monkeypatch):
    """The learner builds one sum tree and one projection per call and
    draws one descent per update; the actor none of them."""
    from repro_torch.kernels import ops as kops
    calls = {"tree_build": 0, "categorical_projection": 0,
             "segment_tree_sample": 0}
    import repro_torch.core.replay as replay
    for name, mod in (("tree_build", kops),
                      ("categorical_projection", kops),
                      ("segment_tree_sample", replay.kops)):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    al = ALConfig(**dict(SMALL, prioritized=True, distributional_adv=True))
    d = DisaggregatedActorLearner(reduced_config("xlstm-125m"), EC, al)
    d.cycle()
    assert calls == dict.fromkeys(calls, 0)     # the learner skipped
    d.cycle()
    assert calls == {"tree_build": 1, "categorical_projection": 1,
                     "segment_tree_sample": al.updates_per_cycle}


def test_al_config_fields_match_reference():
    assert dataclasses.asdict(ALConfig()) == dataclasses.asdict(JALConfig())
