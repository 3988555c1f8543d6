"""The port's recurrent blocks and architectures against the JAX
reference, on the CPU.

Mamba2 (``models/ssm.py``), mLSTM and sLSTM (``models/xlstm.py``) and the
two architectures built of them, zamba2-2.7b (5 Mamba2 blocks and one
shared attention block per superblock) and xlstm-125m (mLSTM + sLSTM),
reduced to 2 superblocks and d_model 128. The reference runs its plain
XLA path (``use_pallas=False``: ``ssd_chunked``, the chunked mLSTM, the
sLSTM step scan) in float32; the port runs its ops' plain versions.
Parameters and caches cross through ``repro_torch.convert.tree_from_jax``
and inputs are made with numpy from a seed. Outputs, states and logits
are held to atol = rtol = 1e-4 (the chunked and sequential forms sum in
other orders); greedy tokens must be equal, with the reference's top-2
logit margin checked to exceed that tolerance. Through a whole stack of
random-weight blocks the SSM states grow to a few hundred and float32
rounding grows with them, so there each cache tensor is held to
rtol = 1e-4 and an atol of 1e-4 times its largest magnitude.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ExecConfig as JExec
from repro.configs import reduced_config as jreduced
from repro.models import params as JP
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.models import xlstm as JXL
from repro_torch import rng
from repro_torch.config import ExecConfig
from repro_torch.configs import reduced_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as XL

TOL = dict(atol=1e-4, rtol=1e-4)
JEC = JExec(compute_dtype="float32")
EC = ExecConfig(compute_dtype="float32")
ARCHS = ("zamba2-2.7b", "xlstm-125m")


def _configs(arch, **xlstm):
    jc, tc = jreduced(arch), reduced_config(arch)
    if xlstm:
        jc = dataclasses.replace(jc, xlstm=dataclasses.replace(jc.xlstm,
                                                               **xlstm))
        tc = dataclasses.replace(tc, xlstm=dataclasses.replace(tc.xlstm,
                                                               **xlstm))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _assert_tree(got, want, tol=TOL, scaled: bool = False):
    """Every tensor of ``got`` against ``want``; ``scaled``: atol is
    tol's atol times the tensor's largest magnitude (at least 1)."""
    g, w = list(_flat(got)), list(_flat(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        atol = tol["atol"] * (max(float(np.abs(b).max()), 1.0)
                              if scaled and b.size else 1.0)
        np.testing.assert_allclose(a, b, err_msg=str(path), atol=atol,
                                   rtol=tol["rtol"])


def _block_params(spec, seed):
    """The reference's init of one block, with its constant leaves (biases,
    gains, A_log, dt_bias, D) redrawn from numpy so that they matter; as
    (numpy tree for jax, torch tree)."""
    jp = jax.device_get(JP.init_tree(spec, jax.random.PRNGKey(seed)))
    r = np.random.default_rng(seed)
    for name, leaf in spec.items():
        if leaf.init != "normal":
            jp[name] = (0.5 * r.standard_normal(leaf.shape)).astype(np.float32)
    return jp, tree_from_jax(jp)


def _x(seed, *shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture(scope="module")
def jref():
    """The reference's functions, each jitted once in this module (its
    eager calls compile every primitive on its own), and its key-0
    parameters drawn once per arch (eagerly, as before: a jitted draw
    may differ in the last bits)."""
    built = {}

    def jit(fn, *static):
        if (fn, static) not in built:
            built[fn, static] = jax.jit(fn, static_argnames=static)
        return built[fn, static]

    def params(jc):
        if ("params", jc) not in built:
            built["params", jc] = JT.init_params(jc, jax.random.PRNGKey(0),
                                                 JEC)
        return built["params", jc]

    def decode(jc, ring):
        step = jit(JT.decode_step, "cfg", "ec", "ring")
        return lambda p, c, t: step(cfg=jc, ec=JEC, params=p, cache=c,
                                    tokens=t, ring=ring)

    return types.SimpleNamespace(jit=jit, params=params, decode=decode)


@pytest.mark.parametrize("S", [32, 12])        # two chunks of 16; S < chunk
def test_mamba2_forward_matches_ssd_chunked(S, jref):
    jc, tc = _configs("zamba2-2.7b")
    jp, tp = _block_params(JSSM.mamba2_param_spec(jc), 1)
    jx, tx = _x(2, 2, S, jc.d_model)
    jy, jh = jref.jit(JSSM.mamba2_forward, "cfg", "ec")(jp, jx, cfg=jc,
                                                      ec=JEC)
    ty, th = SSM.mamba2_forward(tp, tx, tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_mamba2_decode_step_matches_reference(jref):
    jc, tc = _configs("zamba2-2.7b")
    jp, tp = _block_params(JSSM.mamba2_param_spec(jc), 3)
    d_inner, H, P, N = SSM.ssm_dims(tc)
    r = np.random.default_rng(4)
    cache = {"state": r.standard_normal((2, H, P, N)).astype(np.float32),
             "conv": r.standard_normal((2, tc.ssm.conv_width - 1,
                                        d_inner + 2 * N)).astype(np.float32)}
    jx, tx = _x(5, 2, 1, jc.d_model)
    jy, jcache = jref.jit(JSSM.mamba2_decode_step, "cfg", "ec")(
        jp, jx, jax.tree.map(jnp.asarray, cache), cfg=jc, ec=JEC)
    tcache = tree_from_jax(cache)
    ty, new = SSM.mamba2_decode_step(tp, tx, tcache, tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_tree(new, jax.device_get(jcache))
    # the cache passed in is left as it was
    _assert_tree(tcache, cache, dict(atol=0, rtol=0))


def _mlstm_state(seed, tc, B):
    d_inner, H, P = XL.mlstm_dims(tc)
    r = np.random.default_rng(seed)
    return (0.1 * r.standard_normal((B, H, P, P)).astype(np.float32),
            r.standard_normal((B, H, P)).astype(np.float32),
            r.standard_normal((B, H)).astype(np.float32))


@pytest.mark.parametrize("S,chunk,chunked", [
    (32, 8, True),      # four chunks
    (12, 64, True),     # S below the chunk: L = S
    (20, 8, True),      # S no multiple of the chunk: the step recurrence
    (16, 8, False)])    # the step recurrence, asked for
@pytest.mark.parametrize("warm", [False, True])
def test_mlstm_forward_matches_reference(S, chunk, chunked, warm, jref):
    jc, tc = _configs("xlstm-125m", chunk=chunk)
    jp, tp = _block_params(JXL.mlstm_param_spec(jc), 6)
    jx, tx = _x(7, 2, S, jc.d_model)
    st = _mlstm_state(8, tc, 2) if warm else None
    jy, jst = jref.jit(JXL.mlstm_forward, "cfg", "ec", "chunked")(
        jp, jx, cfg=jc, ec=JEC, state=None if st is None else
        tuple(map(jnp.asarray, st)), chunked=chunked)
    ty, tst = XL.mlstm_forward(tp, tx, tc, state=None if st is None else
                               tree_from_jax(st), chunked=chunked)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_tree(tst, jax.device_get(jst))


def test_mlstm_decode_step_matches_reference(jref):
    jc, tc = _configs("xlstm-125m")
    jp, tp = _block_params(JXL.mlstm_param_spec(jc), 9)
    d_inner, _, _ = XL.mlstm_dims(tc)
    conv = np.random.default_rng(10).standard_normal(
        (2, tc.xlstm.conv_width - 1, d_inner)).astype(np.float32)
    cache = {"state": _mlstm_state(11, tc, 2), "conv": conv}
    jx, tx = _x(12, 2, 1, jc.d_model)
    jy, jcache = jref.jit(JXL.mlstm_decode_step, "cfg", "ec")(
        jp, jx, jax.tree.map(jnp.asarray, cache), cfg=jc, ec=JEC)
    ty, new = XL.mlstm_decode_step(tp, tx, tree_from_jax(cache), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_tree(new, jax.device_get(jcache))


def _slstm_state(seed, tc, B):
    r = np.random.default_rng(seed)
    f = lambda: r.standard_normal((B, tc.d_model)).astype(np.float32)  # noqa: E731
    return (f(), 1.0 + np.abs(f()), np.tanh(f()), f())


@pytest.mark.parametrize("S", [32, 21])         # 21: no multiple of 16
@pytest.mark.parametrize("warm", [False, True])
def test_slstm_forward_matches_reference(S, warm, jref):
    jc, tc = _configs("xlstm-125m")
    jp, tp = _block_params(JXL.slstm_param_spec(jc), 13)
    jx, tx = _x(14, 2, S, jc.d_model)
    st = _slstm_state(15, tc, 2) if warm else None
    jy, jst = jref.jit(JXL.slstm_forward, "cfg", "ec")(
        jp, jx, cfg=jc, ec=JEC, state=None if st is None
        else tuple(map(jnp.asarray, st)))
    ty, tst = XL.slstm_forward(tp, tx, tc, state=None if st is None else
                               tree_from_jax(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_tree(tst, jax.device_get(jst))


def test_slstm_decode_step_matches_reference(jref):
    jc, tc = _configs("xlstm-125m")
    jp, tp = _block_params(JXL.slstm_param_spec(jc), 16)
    st = _slstm_state(17, tc, 2)
    jx, tx = _x(18, 2, 1, jc.d_model)
    jy, jst = jref.jit(JXL.slstm_decode_step, "cfg", "ec")(
        jp, jx, tuple(map(jnp.asarray, st)), cfg=jc, ec=JEC)
    ty, tst = XL.slstm_decode_step(tp, tx, tree_from_jax(st), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_tree(tst, jax.device_get(jst))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_and_keeps_r_float32(arch):
    """The reference's init, leaf for leaf; in bf16 every drawn leaf is
    stored in bf16 except the sLSTM's R, which the reference reads in
    float32."""
    jc, tc = _configs(arch)
    jp = jax.device_get(JT.init_params(jc, jax.random.PRNGKey(3), JEC))
    tp = T.init_params(tc, rng.PRNGKey(3), EC)
    bf16 = T.init_params(tc, rng.PRNGKey(3), ExecConfig())
    _assert_tree(tp, jp, dict(rtol=1e-5, atol=1e-7))
    spec = dict(_flat(T.model_param_spec(tc)))
    for (path, a), (_, b) in zip(_flat(tp), _flat(bf16)):
        drawn = spec[path].init in ("normal", "embed") and path[-1] != "r"
        want = a.to(torch.bfloat16) if drawn else a
        assert b.dtype == want.dtype and torch.equal(b, want), path
    if arch == "xlstm-125m":
        assert bf16["layers"]["b1_slstm"]["r"].dtype == torch.float32
    else:
        assert "shared_attn" in bf16 and "b5_attn" not in bf16["layers"]


def _margin_ok(logits):
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return bool(((top[..., 1] - top[..., 0]) >
                 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top[..., 1]))).all())


@pytest.mark.parametrize("arch,ring", [("zamba2-2.7b", False),
                                       ("zamba2-2.7b", True),
                                       ("xlstm-125m", False)])
def test_prefill_and_decode_match_reference(arch, ring, jref):
    """Fused prefill (logits and every cache: the shared attention
    block's KV cache in each superblock, the SSM states and conv windows,
    the mLSTM and sLSTM state tuples), then 6 greedy decode steps; the
    ring case prefills token by token into a 16-slot window and wraps."""
    jc, tc = _configs(arch)
    B, S, steps, window = 2, 32, 6, 16
    jp = jref.params(jc)
    tp = tree_from_jax(jax.device_get(jp))
    tokens = np.random.default_rng(1).integers(0, jc.vocab, size=(B, S),
                                               dtype=np.int32)
    jdec = jref.decode(jc, ring)
    if ring:
        jcache = JT.init_cache(jc, JEC, B, window, ring=True)
        tcache = T.init_cache(tc, EC, B, window, ring=True, device="cpu")
        for i in range(S):
            jl, jcache = jdec(jp, jcache, jnp.asarray(tokens[:, i:i + 1]))
            tl, tcache = T.decode_step(tc, EC, tp, tcache,
                                       torch.from_numpy(tokens[:, i:i + 1]),
                                       ring=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    else:
        jl, _, jcache = jref.jit(JT.forward, "cfg", "ec",
                                 "collect_cache_len")(
            cfg=jc, ec=JEC, params=jp, tokens=jnp.asarray(tokens),
            collect_cache_len=S + steps)
        tl, aux, tcache = T.forward(tc, EC, tp, torch.from_numpy(tokens),
                                    collect_cache_len=S + steps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert float(aux) == 0.0 and int(tcache["pos"]) == S
    _assert_tree(tcache["layers"], jax.device_get(jcache["layers"]),
                 scaled=True)
    jlast = np.asarray(jl)[:, -1, : jc.vocab]
    for _ in range(steps):
        assert _margin_ok(jlast)
        nxt = np.argmax(jlast, axis=-1).astype(np.int32)[:, None]
        jl, jcache = jdec(jp, jcache, jnp.asarray(nxt))
        tl, tcache = T.decode_step(tc, EC, tp, tcache, torch.from_numpy(nxt),
                                   ring=ring)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jlast = np.asarray(jl)[:, -1, : jc.vocab]
        np.testing.assert_array_equal(
            torch.argmax(tl[:, -1, : tc.vocab], dim=-1).numpy(),
            np.argmax(jlast, axis=-1))
    assert int(tcache["pos"]) == int(jcache["pos"]) == S + steps
    _assert_tree(tcache["layers"], jax.device_get(jcache["layers"]),
                 scaled=True)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [32, 2])          # 2: fewer tokens than W - 1
def test_fused_prefill_equals_token_by_token(arch, S):
    """One fused forward builds the same cache, and the same next logits,
    as S decode steps from an empty cache (a prompt shorter than the
    conv window leaves the window's head zero, as the decode steps do)."""
    _, tc = _configs(arch)
    tp = T.init_params(tc, rng.PRNGKey(5), EC)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tc.vocab, size=(2, S + 4), dtype=np.int32))
    fl, _, fused = T.forward(tc, EC, tp, tokens[:, :S],
                             collect_cache_len=S + 4)
    steps = T.init_cache(tc, EC, 2, S + 4, device="cpu")
    for i in range(S):
        sl, steps = T.decode_step(tc, EC, tp, steps, tokens[:, i:i + 1])
    np.testing.assert_allclose(sl[:, 0].numpy(), fl[:, -1].numpy(), **TOL)
    _assert_tree(fused, steps, scaled=True)
    for i in range(S, S + 4):
        fl, fused = T.decode_step(tc, EC, tp, fused, tokens[:, i:i + 1])
        sl, steps = T.decode_step(tc, EC, tp, steps, tokens[:, i:i + 1])
        np.testing.assert_allclose(fl.numpy(), sl.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_tokens_match_reference(arch, capsys):
    """The port's serve launcher (reduced, float32, key 0) prints the
    reference launcher's greedy sample."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "16", "--gen",
            "6"]
    jserve.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("sample:")]
    res = serve.run(serve.parse_args(argv + ["--device", "cpu"]))
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("sample:")]
    assert got == want and len(got) == 1
    assert tuple(res["tokens"].shape) == (2, 6)
    assert _margin_ok(res["prefill_logits"].numpy())
