"""The port's mixture-of-experts MLP against the JAX reference, on the CPU.

The reference runs its plain XLA path in float32 and its parameters cross
to the port through ``convert.tree_from_jax``; inputs come from a numpy
seed. Routes (``top_e``) must be equal, and every routing asserts first
that the k-th router probability exceeds the (k+1)-th by ``MARGIN``, so
that the equality means something (``torch.topk`` and ``lax.top_k`` may
order near-ties differently). The two packages' router probabilities
differ by at most 6.9e-7 in a reduced model's forward (both MoE archs,
float32), so a margin of 1e-5 leaves each a 7x reserve. MoE outputs and logits are held to atol = rtol = 1e-4, the
auxiliary loss to 1e-5 relative; train steps to the tolerances of
``tests/test_torch_lm_train.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ExecConfig as JExec
from repro.config import TrainConfig as JTrain
from repro.configs import reduced_config as jreduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import moe as JM
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch import rng
from repro_torch.config import ExecConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.convert import tree_from_jax
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim.base import flatten
from repro_torch.optim.schedule import warmup_cosine
from test_torch_lm_train import _close_by_leaf, _params_close

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-5
MOE = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")
JEC = JExec(compute_dtype="float32")
EC = ExecConfig(compute_dtype="float32")


def _configs(arch, **moe):
    jc, tc = jreduced(arch), reduced_config(arch)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _margin(x32: np.ndarray, w: np.ndarray, k: int) -> float:
    """The smallest gap between the k-th and (k+1)-th router probability
    over the rows of x32 (float64)."""
    logits = x32.astype(np.float64) @ w.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((p[:, k - 1] - p[:, k]).min()) if p.shape[1] > k else 1.0


@pytest.fixture
def margins(monkeypatch):
    """Every routing's margin, recorded on the port's side (the two
    packages' router inputs agree to ~1e-6)."""
    seen = []
    router = M._router

    def recording(x32, w, m):
        seen.append(_margin(x32.detach().numpy(), w.detach().numpy(),
                            m.top_k))
        return router(x32, w, m)
    monkeypatch.setattr(M, "_router", recording)
    return seen


def _moe_case(jc, seed, B=2, S=16):
    p = jax.device_get(JP.init_tree(JM.moe_param_spec(jc),
                                    jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    return p, x


def _check_moe(jc, tc, impl, p, x, margins):
    jy, jaux = JM.moe_ffn(p, jnp.asarray(x), jc, JExec(moe_impl=impl))
    ty, taux = M.moe_ffn(tree_from_jax(p), torch.from_numpy(x), tc,
                         ExecConfig(moe_impl=impl))
    assert margins and min(margins) > MARGIN, min(margins)
    xt = x.reshape(-1, x.shape[-1])
    _, je, _ = JM._router(jnp.asarray(xt), jnp.asarray(p["router"]), jc.moe)
    _, te, _ = M._router(torch.from_numpy(xt),
                         torch.from_numpy(p["router"]), tc.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    return ty, np.asarray(jy)


@pytest.mark.parametrize("impl", ["scatter", "dense"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, impl, margins):
    jc, tc = _configs(arch)
    p, x = _moe_case(jc, 0)
    _check_moe(jc, tc, impl, p, x, margins)


def test_capacity_drops_match_reference(margins):
    """capacity_factor 0.25 (cap 8 for 64 assignments a row over 4
    experts): assignments past the capacity are dropped in both packages,
    and the output parts from the dense oracle."""
    jc, tc = _configs("granite-moe-1b-a400m", capacity_factor=0.25)
    p, x = _moe_case(jc, 1, S=32)
    ty, _ = _check_moe(jc, tc, "scatter", p, x, margins)
    dense, _ = M.moe_ffn(tree_from_jax(p), torch.from_numpy(x), tc,
                         ExecConfig(moe_impl="dense"))
    assert float((ty - dense).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", ["scatter", "dense"])
def test_padded_experts_match_reference(impl, margins):
    """Reduced qwen with two pad experts (the full model pads 60 to 64):
    the pad experts have weights and buffers and never a token."""
    jc, tc = _configs("qwen2-moe-a2.7b", pad_to=6)
    assert M.padded_experts(tc.moe) == 6 and tc.moe.n_experts == 4
    p, x = _moe_case(jc, 2)
    assert p["w_gate"].shape[0] == 6 and p["router"].shape[1] == 4
    _check_moe(jc, tc, impl, p, x, margins)


def test_one_hot_and_gather_dispatch_agree_and_expert_parallel_is_scatter():
    """The one-hot products a gradient takes give the gather's values bit
    for bit; ``expert_parallel`` without a mesh is the scatter path."""
    cfg = reduced_config("qwen2-moe-a2.7b")
    params = T.init_params(cfg, rng.PRNGKey(5), EC,
                           param_dtype=torch.float32)
    p = T._layer(params["layers"], 0)["b0_attn"]["mlp"]
    x = torch.randn(3, 20, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        gathered, aux = M.moe_ffn(p, x, cfg, EC)
        ep, ep_aux = M.moe_ffn(p, x, cfg,
                               ExecConfig(compute_dtype="float32",
                                          moe_impl="expert_parallel"))
    hot, hot_aux = M.moe_ffn(p, x.requires_grad_(), cfg, EC)
    assert hot.requires_grad
    assert torch.equal(gathered, hot.detach()) and torch.equal(aux, hot_aux)
    assert torch.equal(gathered, ep) and torch.equal(aux, ep_aux)


def test_bf16_model_routes_with_its_float32_router(margins):
    """A bfloat16 model stores its drawn leaves in bf16 but the router in
    float32, and routes as the reference does (which reads the router in
    float32 whatever the compute dtype)."""
    jc, tc = _configs("granite-moe-1b-a400m")
    ec = ExecConfig()                                   # bfloat16
    jp = jax.device_get(JT.init_params(jc, jax.random.PRNGKey(4), JExec()))
    tp = T.init_params(tc, rng.PRNGKey(4), ec)
    jmlp = jax.tree.map(lambda a: a[0], jp["layers"]["b0_attn"]["mlp"])
    tmlp = T._layer(tp["layers"], 0)["b0_attn"]["mlp"]
    assert tmlp["router"].dtype == torch.float32
    assert tmlp["w_gate"].dtype == torch.bfloat16
    np.testing.assert_allclose(tmlp["router"].numpy(), jmlp["router"],
                               rtol=1e-5, atol=1e-7)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ty, taux = M.moe_ffn(tmlp, xb, tc, ec)
    jy, jaux = JM.moe_ffn(jmlp, jnp.asarray(x, jnp.bfloat16), jc, JExec())
    assert min(margins) > MARGIN, min(margins)
    x32 = xb.to(torch.float32).reshape(-1, jc.d_model)
    _, je, _ = JM._router(jnp.asarray(x32.numpy()), jnp.asarray(
        jmlp["router"]), jc.moe)
    _, te, _ = M._router(x32, tmlp["router"], tc.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch, margins):
    """Fused prefill (logits, aux and cache), then 8 greedy decode
    steps, at the configs' own capacity (the prefill drops where the
    capacity says)."""
    jc, tc = _configs(arch)
    B, S, steps = 2, 12, 8
    jp = JT.init_params(jc, jax.random.PRNGKey(0), JEC)
    tp = tree_from_jax(jax.device_get(jp))
    tokens = np.random.default_rng(1).integers(0, jc.vocab, size=(B, S),
                                               dtype=np.int32)
    jl, jaux, jcache = jax.jit(functools.partial(
        JT.forward, jc, JEC, collect_cache_len=S + steps))(
            jp, jnp.asarray(tokens))
    tl, taux, tcache = T.forward(tc, EC, tp, torch.from_numpy(tokens),
                                 collect_cache_len=S + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jdec = jax.jit(functools.partial(JT.decode_step, jc, JEC))
    jlast = np.asarray(jl)[:, -1, : jc.vocab]
    for _ in range(steps):
        top = np.sort(jlast, axis=-1)[:, -2:]
        assert (top[:, 1] - top[:, 0] > 1e-3).all(), top
        nxt = np.argmax(jlast, axis=-1).astype(np.int32)[:, None]
        jl, jcache = jdec(jp, jcache, jnp.asarray(nxt))
        tl, tcache = T.decode_step(tc, EC, tp, tcache, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jlast = np.asarray(jl)[:, -1, : jc.vocab]
        np.testing.assert_array_equal(
            torch.argmax(tl[:, -1, : tc.vocab], dim=-1).numpy(),
            np.argmax(jlast, axis=-1))
    assert len(margins) == 2 * (1 + steps) and min(margins) > MARGIN, \
        min(margins)
    jcache = jax.device_get(jcache)
    for (path, a), (_, b) in zip(
            _flat({k: v for k, v in tcache.items() if k != "ring"}),
            _flat({k: v for k, v in jcache.items() if k != "ring"})):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=str(path), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_reference(arch, margins):
    """2 steps from the reference's state of each step: loss and ce (and
    so the auxiliary loss) to 1e-4, AdamW's moments (the router's
    gradient among them, not zero) to 1e-4 of each leaf's largest,
    parameters as tests/test_torch_lm_train.py holds them."""
    jc, tc = _configs(arch)
    train = dict(learning_rate=3e-3, warmup_steps=10, remat=False)
    jstep, jopt = jmake_train_step(jc, JEC, JTrain(**train))
    jstep = jax.jit(jstep)
    step, _ = make_train_step(tc, EC, TrainConfig(**train))
    jp = JT.init_params(jc, jax.random.PRNGKey(0), JEC)
    jst = jopt.init(jp)
    data, jdata = SyntheticLM(tc.vocab, 32, 2), JSyntheticLM(jc.vocab, 32, 2)
    lr = warmup_cosine(3e-3, 10, 10_000)
    for i in range(2):
        p, st = (tree_from_jax(jax.device_get(t)) for t in (jp, jst))
        st["step"] = st["step"].to(torch.int32)
        jp, jst, jm = jstep(jp, jst, jdata.batch(jnp.int32(i)))
        p, st, m = step(p, st, data.batch(i))
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                       err_msg=f"{arch} step {i} {k}")
        assert float(m["loss"]) > float(m["ce"])            # aux > 0
        router = st["m"]["layers"]["b0_attn"]["mlp"]["router"]
        assert float(router.abs().max()) > 0
        _close_by_leaf(st["m"], jst["m"], f"{arch} step {i} adam m")
        _close_by_leaf(st["v"], jst["v"], f"{arch} step {i} adam v")
        amplified = _params_close(p, jp, float(lr(torch.tensor(i + 1))),
                                  f"{arch} step {i} params")
        total = sum(t.numel() for t in flatten(p).values())
        assert amplified <= 1e-3 * total, (amplified, total)
    assert min(margins) > MARGIN, min(margins)
