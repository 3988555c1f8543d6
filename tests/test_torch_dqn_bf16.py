"""The port's DQN path in bfloat16 against the JAX package's, on the CPU.

Parameters come from the reference's init through ``repro_torch.convert``
(they stay float32 in both packages: the compute dtype applies at use),
frames and batches are made with numpy from a seed.

Tolerances. The two packages round to bfloat16 at different places (XLA
keeps excess precision inside a fusion, torch rounds after every op), so
each layer's output may differ by up to one bfloat16 step, 2⁻⁸ of its
magnitude, and the difference carries into every later layer. A forward
through ``depth`` rounded layers (each conv, the trunk's linear, the
head, the dueling combination) is therefore held to ``depth x 2⁻⁸`` of
the reference's largest magnitude, and so are the loss and the
per-sample priority signal. A gradient runs the layers backwards too
(``2 x depth x 2⁻⁸``), and a bias's gradient is a sum over every
position and sample whose terms cancel: two bfloat16 sums of them can
differ by as much as either differs from the float32 sum. So each
gradient leaf is held to the reference's own bfloat16-to-float32
distance for that leaf plus ``2 x depth x 2⁻⁸`` of its largest
magnitude. That bound cannot tell a float32 computation from a bfloat16
one, so the forward test also checks the dtype that each conv and
linear runs in. An optimizer step moves each element by about lr
whatever its gradient's rounding, so an updated parameter is held to
``2 lr`` per update beside the float32 tests' 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_trainer as jbuild
from repro.api.spec import AlgoSpec as JAlgo
from repro.api.spec import ExperimentSpec as JSpec
from repro.api.spec import ScheduleSpec as JSched
from repro.config import DQNConfig as JDQNConfig
from repro.config import ExecConfig as JExec
from repro.configs import dqn_nature as jcfg
from repro.core import dqn as jdqn
from repro.models import nature_cnn as jnet
from repro.optim import centered_rmsprop as jax_rmsprop
from repro_torch.api.spec import AlgoSpec, ExperimentSpec, ScheduleSpec
from repro_torch.api.trainers import build_trainer
from repro_torch.config import DQNConfig, ExecConfig
from repro_torch.configs import dqn_nature as tcfg
from repro_torch.convert import carry_from_jax, opt_state_from_jax, \
    params_from_jax
from repro_torch.core import dqn as tdqn
from repro_torch.models import nature_cnn as tnet
from repro_torch.optim.rmsprop import centered_rmsprop
from torch_presets import _leaves

JEC = JExec(compute_dtype="bfloat16")
TEC = ExecConfig(compute_dtype="bfloat16")
STEP = 2.0 ** -8            # one bfloat16 step, relative to the value
A = 3
PRESETS = sorted(tcfg.VARIANTS)
GEOMETRY = {"tiny": (10, 8), "nature": (84, 2)}     # frame size, batch
LR = 2.5e-4


def _depth(cfg) -> int:
    """Layers whose outputs are rounded to bfloat16 on the way to Q."""
    return len(cfg.convs) + 2 + int(cfg.dueling)


def _configs(variant: str, geometry: str):
    jv, tv = jcfg.get_variant(variant), tcfg.get_variant(variant)
    size = GEOMETRY[geometry][0]
    jc = jcfg.cnn_config_for(jv, jcfg.cnn_geometry(geometry, size, A))
    tc = tcfg.cnn_config_for(tv, tcfg.cnn_geometry(geometry, size, A))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jv, tv, jc, tc


def _frames(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, cfg.frame_size, cfg.frame_size, cfg.frame_stack),
        dtype=np.uint8)


def _keys(noisy: bool, seed: int = 5):
    if not noisy:
        return None, None
    jk = jax.random.PRNGKey(seed)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _close(got, want, bound, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound * scale, f"{what}: {err:.3e} > {bound:.3e} x " \
        f"{scale:.3e}"


@pytest.fixture(scope="module")
def jitted():
    """The reference's bf16 forward passes, jitted once per config."""
    cache = {}

    def get(kind, jc):
        key = (kind, jc)
        if key not in cache:
            fn = jnet.q_forward if kind == "q" else jnet.q_logits
            cache[key] = jax.jit(lambda p, o, k: fn(p, o, jc, JEC,
                                                    noise_key=k))
        return cache[key]
    return get


@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
@pytest.mark.parametrize("variant", PRESETS)
def test_q_forward_and_logits_bf16(variant, geometry, jitted, monkeypatch):
    jv, tv, jc, tc = _configs(variant, geometry)
    jp = jnet.q_init(jc, A, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    frames = _frames(tc, GEOMETRY[geometry][1], 1)
    jk, tk = _keys(tv.noisy)
    bound = _depth(tc) * STEP
    seen = []
    conv, affine = tnet.F.conv2d, tnet._affine
    monkeypatch.setattr(tnet.F, "conv2d", lambda x, w, **kw: seen.append(
        ("conv", x.dtype, w.dtype)) or conv(x, w, **kw))
    monkeypatch.setattr(tnet, "_affine", lambda *a: seen.append(
        ("linear", a[2].dtype, affine(*a).dtype)) or affine(*a))
    got = tnet.q_forward(tp, torch.from_numpy(frames), tc, TEC, noise_key=tk)
    monkeypatch.undo()
    assert got.dtype == torch.float32
    assert len(seen) == (0 if tc.vector_dim else len(tc.convs)) + 2 + \
        int(tc.dueling)
    assert {d for _, *ds in seen for d in ds} == {torch.bfloat16}, seen
    want = jitted("q", jc)(jp, jnp.asarray(frames), jk)
    _close(got.numpy(), want, bound, "q")
    if tc.num_atoms > 1:
        got = tnet.q_logits(tp, torch.from_numpy(frames), tc, TEC,
                            noise_key=tk)
        assert got.dtype == torch.float32
        want = jitted("logits", jc)(jp, jnp.asarray(frames), jk)
        _close(got.numpy(), want, bound, "logits")
    # parameters stay float32 and the float32 path is untouched by ec
    assert all(v.dtype == torch.float32 for v in tp.values())
    f32 = tnet.q_forward(tp, torch.from_numpy(frames), tc, noise_key=tk)
    assert torch.equal(f32, tnet.q_forward(
        tp, torch.from_numpy(frames), tc, ExecConfig(compute_dtype="float32"),
        noise_key=tk))


@pytest.mark.parametrize("variant", ["rainbow", "dueling", "noisy"])
def test_population_forward_bf16(variant):
    """R = 2 replicas as one grouped convolution and batched products in
    bf16, against the reference's forward under ``jax.vmap``."""
    jv, tv, jc, tc = _configs(variant, "tiny")
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jp = jax.vmap(lambda k: jnet.q_init(jc, A, k))(keys)
    tp = params_from_jax(jax.device_get(jp))
    frames = np.stack([_frames(tc, 8, 1), _frames(tc, 8, 2)])
    jk = jax.random.split(jax.random.PRNGKey(5), 2) if tv.noisy else None
    tk = (torch.from_numpy(np.asarray(jk).astype(np.int64)) if tv.noisy
          else None)
    got = tnet.q_forward(tp, torch.from_numpy(frames), tc, TEC, noise_key=tk)
    want = jax.jit(jax.vmap(lambda p, o, k: jnet.q_forward(
        p, o, jc, JEC, noise_key=k), in_axes=(0, 0, 0 if tv.noisy else None)))(
        jp, jnp.asarray(frames), jk)
    assert got.shape == (2, 8, A)
    for r in range(2):
        _close(got[r].numpy(), np.asarray(want)[r], _depth(tc) * STEP,
               f"replica {r}")


def _batch(cfg, n, seed, weights):
    r = np.random.default_rng(seed)
    b = {"obs": _frames(cfg, n, seed), "next_obs": _frames(cfg, n, seed + 1),
         "action": r.integers(0, A, size=n).astype(np.int32),
         "reward": r.choice(np.float32([0.0, 1.0, 1.9]), size=n),
         "done": r.random(n) < 0.25}
    if weights:
        b["weight"] = r.uniform(0.2, 1.0, size=n).astype(np.float32)
    return b


def _heads(jc, tc, jec, tec):
    """Both packages' q_forward and q_logits with a trailing noise key."""
    def j(fn):
        return lambda p, o, k=None: fn(p, o, jc, jec, noise_key=k)

    def t(fn):
        return lambda p, o, k=None: fn(p, o, tc, tec, noise_key=k)
    return (j(jnet.q_forward), j(jnet.q_logits), t(tnet.q_forward),
            t(tnet.q_logits))


@pytest.mark.parametrize("variant", ["dqn", "rainbow"])
def test_one_update_bf16(variant, geometry="nature"):
    """The loss, the gradients and one centered-RMSProp step in bf16, at
    the full Nature width (84x84x4)."""
    jv, tv, jc, tc = _configs(variant, geometry)
    jp = jnet.q_init(jc, A, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    nb = _batch(tc, 8, 7, weights=jv.prioritized)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jk, tk = _keys(tv.noisy, 11)
    depth = _depth(tc)

    def losses(jec, tec):
        jqf, jql, tqf, tql = _heads(jc, tc, jec, tec)
        if jv.distributional:
            return (lambda p: jdqn.c51_loss_variant(p, jp, jb, jql, 0.9, jv,
                                                    jk, "ref"),
                    lambda p: tdqn.c51_loss_variant(p, tp, tb, tql, 0.9, tv,
                                                    tk))
        return (lambda p: jdqn.q_loss_variant(p, jp, jb, jqf, 0.9, jv, jk),
                lambda p: tdqn.q_loss_variant(p, tp, tb, tqf, 0.9, tv, tk))

    def jgrad(jloss):
        return jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    jloss, tloss = losses(JEC, TEC)
    (jl, jtd), jg = jgrad(jloss)
    _, jg32 = jgrad(losses(None, None)[0])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl, ttd = tloss(leaves)
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    _close(float(tl.detach()), float(jl), depth * STEP, "loss")
    _close(ttd.numpy(), jtd, depth * STEP, "priority signal")
    for k in jg:
        assert tg[k].dtype == torch.float32, k
        want, scale = np.asarray(jg[k]), np.abs(np.asarray(jg[k])).max()
        noise = np.abs(want - np.asarray(jg32[k])).max()
        err = np.abs(tg[k].numpy() - want).max()
        assert err <= noise + 2 * depth * STEP * scale, (k, err, noise, scale)
    # one step through the update function each package's trainer builds
    jopt, topt = jax_rmsprop(LR), centered_rmsprop(LR)
    jos = jax.tree.map(lambda x: x + 1e-4, jopt.init(jp))
    tos = opt_state_from_jax(jax.device_get(jos))
    jqf, jql, tqf, tql = _heads(jc, tc, JEC, TEC)
    jupd = jax.jit(jdqn.make_update_fn(jqf, jopt, JDQNConfig(discount=0.9,
                                                             variant=jv),
                                       jv, q_logits=jql,
                                       kernel_backend="ref"))
    tupd = tdqn.make_update_fn(tqf, topt, DQNConfig(discount=0.9, variant=tv),
                               tv, q_logits=tql)
    jp2, _, jl2, _ = jupd(jp, jp, jos, jb, jk)
    tp2, _, tl2, _ = tupd(tp, tp, tos, tb, tk)
    _close(float(tl2), float(jl2), depth * STEP, "update loss")
    for k in jp2:
        assert tp2[k].dtype == torch.float32, k
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                   atol=2 * LR + 1e-5, rtol=1e-5, err_msg=k)


def test_one_cycle_bf16_on_catch(variant="rainbow"):
    """One concurrent rainbow cycle in bf16 on catch (W=4, C=32, AdamW;
    both DQN kernels' plain versions, the dueling, noisy and C51 heads)
    from the reference's carry. In the first cycle ε is near 1, so few actions
    are greedy and a bf16 near-tie has few chances to flip one: the
    integer leaves (the replay's actions, rewards and positions, the
    environments, the keys) are compared exactly, and they agree here. A
    float leaf is held as a gradient is (its bf16-to-float32 distance in
    the reference's own cycle plus ``2 x depth x 2⁻⁸`` of its largest
    magnitude), and a parameter also to ``2 lr`` per update."""
    torch.set_num_threads(1)
    sched = dict(cycles=1, cycle_steps=32, prepopulate=64)
    algo = dict(minibatch_size=8, replay_capacity=256, optimizer="adamw")
    top = dict(env="catch", mode="concurrent", envs=4, obs_mode="pixels",
               frame_size=10, net="tiny")

    def jcycle(ec, j0=None):
        jt = jbuild(JSpec(variant=jcfg.get_variant(variant),
                          schedule=JSched(**sched), algo=JAlgo(**algo),
                          exec=ec, **top))
        j0 = jt.init_carry() if j0 is None else j0
        return jax.device_get((j0,) + tuple(jt.cycle(j0)))

    j0, j1, jm = jcycle(JEC)
    _, j32, _ = jcycle(JExec(compute_dtype="float32"), j0)
    spec = ExperimentSpec(variant=tcfg.get_variant(variant),
                          schedule=ScheduleSpec(**sched),
                          algo=AlgoSpec(**algo), exec=TEC, **top)
    tt = build_trainer(spec, device="cpu")
    t1, tm = tt.cycle(carry_from_jax(j0))
    depth = _depth(tt._c.ncfg)
    updates = sched["cycle_steps"] // spec.algo.train_period
    _close(float(tm["loss"][0]), float(jm["loss"][0]), depth * STEP, "loss")
    for k in ("reward", "episodes"):
        assert float(tm[k][0]) == float(jm[k][0]), k
    got, want, w32 = (dict(_leaves(c)) for c in (t1, j1, j32))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = got[path].numpy(), np.asarray(w)
        assert g.shape == w.shape, path
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)
            continue
        noise = np.abs(w - np.asarray(w32[path])).max()
        bound = noise + 2 * depth * STEP * np.abs(w).max()
        if path.startswith(".params."):
            bound = max(bound, 2 * 1e-3 * updates)     # AdamW's lr 1e-3
        assert np.abs(g - w).max() <= bound, path
