"""The port's cross-attention stack (CROSS_ATTN blocks, whisper's encoder
and learned positions, the VLM's tanh gate) against the JAX reference,
on the CPU.

The reference runs its plain XLA path in float32; parameters cross to
the port through ``convert.tree_from_jax`` and inputs come from a numpy
seed. Outputs, logits and caches (``k``, ``v``, ``ck``, ``cv``) are held
to atol = rtol = 1e-4 and greedy tokens must be equal, each step
asserting first that the reference's top-2 logit margin exceeds that
tolerance; train steps to the tolerances of
``tests/test_torch_lm_train.py``. The VLM's gate is drawn as zeros (the
released model's init), which would hide its cross-attention, so the
tests set it to nonzero values in both packages' parameters. Reduced
llama-3.2-vision is cut to one superblock (4 self + 1 cross) where the
reference's compile would dominate, and each JAX function is compiled
once per arch (module-scoped fixtures).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.config import ExecConfig as JExec
from repro.config import TrainConfig as JTrain
from repro.configs import reduced_config as jreduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import rng
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import ExecConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.convert import tree_from_jax
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.optim.base import flatten
from repro_torch.optim.schedule import warmup_cosine
from test_torch_lm_train import _close_by_leaf, _params_close

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("llama-3.2-vision-11b", "whisper-tiny")
JEC = JExec(compute_dtype="float32")
EC = ExecConfig(compute_dtype="float32")
B, S, STEPS, WINDOW = 2, 12, 8, 16


def _configs(arch):
    jc, tc = jreduced(arch), reduced_config(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    if arch == "llama-3.2-vision-11b":
        jc = dataclasses.replace(jc, n_superblocks=1)
        tc = dataclasses.replace(tc, n_superblocks=1)
    return jc, tc


def _gated(jp):
    """The VLM's gates set to nonzero values (tanh 0.46 and -0.76)."""
    layers = dict(jp["layers"])
    for name in layers:
        if "gate_x" in layers[name]:
            n = layers[name]["gate_x"].shape[0]
            gate = jnp.asarray(np.linspace(0.5, -1.0, n, dtype=np.float32)
                               .reshape(n, 1))
            layers[name] = dict(layers[name], gate_x=gate)
    return dict(jp, layers=layers)


def _memory(cfg, seed, batch=B):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.cross_memory_len, cfg.d_model))).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference config, port config, reference params, port
    params, the reference's jitted forward and decode steps)."""
    arch = request.param
    jc, tc = _configs(arch)
    jp = JT.init_params(jc, jax.random.PRNGKey(0), JEC)
    if jc.family == "vlm":
        jp = _gated(jp)
    tp = tree_from_jax(jax.device_get(jp))
    fns = {
        "forward": jax.jit(functools.partial(JT.forward, jc, JEC,
                                             collect_cache_len=S + STEPS)),
        "decode": jax.jit(functools.partial(JT.decode_step, jc, JEC)),
        "ring": jax.jit(functools.partial(JT.decode_step, jc, JEC,
                                          ring=True)),
        "cross": jax.jit(functools.partial(JT.prefill_cross_cache, jc, JEC)),
    }
    return arch, jc, tc, jp, tp, fns


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_cache(tcache, jcache):
    jcache = jax.device_get(jcache)
    got = dict(_flat({k: v for k, v in tcache.items() if k != "ring"}))
    want = dict(_flat({k: v for k, v in jcache.items() if k != "ring"}))
    assert got.keys() == want.keys()
    for path, a in got.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(want[path]),
                                   err_msg=str(path), **TOL)
    return got


def _margin_ok(logits):
    """The top-2 margin of every row exceeds the tolerance's reach."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return bool(((top[..., 1] - top[..., 0]) >
                 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top[..., 1]))).all())


@pytest.mark.parametrize("Sq,Sk,H,Hkv", [(12, 12, 4, 4), (7, 33, 4, 2),
                                         (1, 16, 6, 1)])
def test_bidirectional_attention_matches_reference(Sq, Sk, H, Hkv):
    r = np.random.default_rng(Sq + Sk)
    q = r.standard_normal((2, Sq, H, 32)).astype(np.float32)
    k, v = (r.standard_normal((2, Sk, Hkv, 32)).astype(np.float32)
            for _ in range(2))
    want = JA.bidirectional_attention(*map(jnp.asarray, (q, k, v)))
    got = A.bidirectional_attention(*map(torch.from_numpy, (q, k, v)))
    assert tuple(got.shape) == (2, Sq, H, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_encode_matches_reference():
    """Whisper's encoder: the frames plus its learned ``pos``, non-causal
    layers with no rotation, ``final_norm``."""
    jc, tc = _configs("whisper-tiny")
    jp = JT.init_params(jc, jax.random.PRNGKey(1), JEC)
    tp = tree_from_jax(jax.device_get(jp))
    frames = _memory(jc, 3)
    want = jax.jit(functools.partial(JT.encode, jc, JEC))(
        jp, jnp.asarray(frames))
    got = T.encode(tc, EC, tp, torch.from_numpy(frames))
    assert tuple(got.shape) == (B, jc.cross_memory_len, jc.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_cross_cache_matches_reference(model):
    arch, jc, tc, jp, tp, fns = model
    mem = _memory(jc, 4)
    jcache = fns["cross"](jp, JT.init_cache(jc, JEC, B, WINDOW),
                          jnp.asarray(mem))
    tcache = T.init_cache(tc, EC, B, WINDOW, device="cpu")
    out = T.prefill_cross_cache(tc, EC, tp, tcache, torch.from_numpy(mem))
    assert out is tcache
    got = _assert_cache(tcache, jcache)
    n_cross = sum(1 for path in got if path[-1] == "ck")
    assert n_cross == 1 and all(
        float(t.abs().max()) > 0 for path, t in got.items()
        if path[-1] in ("ck", "cv"))


@pytest.mark.parametrize("ring", [False, True])
def test_prefill_and_decode_match_reference(model, ring):
    """Fused prefill (logits and the cache: k, v, ck, cv), then 8 greedy
    decode steps; the ring case fills the cross cache through
    ``prefill_cross_cache`` and prefills token by token into a 16-slot
    window, which the decode steps wrap."""
    arch, jc, tc, jp, tp, fns = model
    mem = _memory(jc, 5)
    tokens = np.random.default_rng(2).integers(0, jc.vocab, size=(B, S),
                                               dtype=np.int32)
    jdec = fns["ring" if ring else "decode"]
    if ring:
        jcache = fns["cross"](jp, JT.init_cache(jc, JEC, B, WINDOW, True),
                              jnp.asarray(mem))
        tcache = T.prefill_cross_cache(
            tc, EC, tp, T.init_cache(tc, EC, B, WINDOW, True, device="cpu"),
            torch.from_numpy(mem))
        for i in range(S):
            jl, jcache = jdec(jp, jcache, jnp.asarray(tokens[:, i:i + 1]))
            tl, tcache = T.decode_step(tc, EC, tp, tcache,
                                       torch.from_numpy(tokens[:, i:i + 1]),
                                       ring=True)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    else:
        jl, jaux, jcache = fns["forward"](jp, jnp.asarray(tokens),
                                          jnp.asarray(mem))
        tl, aux, tcache = T.forward(tc, EC, tp, torch.from_numpy(tokens),
                                    torch.from_numpy(mem),
                                    collect_cache_len=S + STEPS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert float(aux) == float(jaux) == 0.0
        _assert_cache(tcache, jcache)
    jlast = np.asarray(jl)[:, -1, : jc.vocab]
    for _ in range(STEPS):
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
    assert int(tcache["pos"]) == int(jcache["pos"]) == S + STEPS
    _assert_cache(tcache, jcache)


def test_cross_attention_reaches_the_logits(model):
    """The memory moves the logits (through the gate, for the VLM), and
    whisper's decoder rotates nothing: its learned positions move them."""
    arch, jc, tc, jp, tp, _ = model
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, jc.vocab, size=(B, S), dtype=np.int32))
    a, _ = T.forward(tc, EC, tp, tokens, torch.from_numpy(_memory(tc, 8)))
    b, _ = T.forward(tc, EC, tp, tokens, torch.from_numpy(_memory(tc, 9)))
    assert float((a - b).abs().max()) > 1e-3
    if tc.pos_kind == "learned":
        assert not T._rotary(tc)
        moved = dict(tp, pos_embed=torch.roll(tp["pos_embed"], 1, 0))
        c, _ = T.forward(tc, EC, moved, tokens,
                         torch.from_numpy(_memory(tc, 8)))
        assert float((a - c).abs().max()) > 1e-3


def test_serve_launcher_tokens_match_reference(model, capsys):
    """The port's serve launcher (the reduced arch, float32, key 0 for
    weights, prompts and memory; a fused prefill) prints the reference
    launcher's greedy sample. (The ring path's tokens are held above, at
    one superblock.)"""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    args = ["--arch", model[0], "--batch", "2", "--prompt-len", "8",
            "--gen", "6"]
    jserve.main(args)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("sample:")]
    res = serve.run(serve.parse_args(args + ["--device", "cpu"]))
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("sample:")]
    assert got == want and len(got) == 1
    cfg = res["cfg"]
    assert tuple(res["memory"].shape) == (2, cfg.cross_memory_len,
                                          cfg.d_model)
    assert _margin_ok(res["prefill_logits"].numpy())


def test_train_step_matches_reference(model):
    """2 steps with step i's memory, each from the reference's state of
    that step: loss and ce to 1e-4, AdamW's moments to 1e-4 of each
    leaf's largest (the cross-attention's and, for whisper, the
    encoder's and the positions' gradients among them, not zero),
    parameters as tests/test_torch_lm_train.py holds them."""
    arch, jc, tc, jp, _, _ = model
    train = dict(learning_rate=3e-3, warmup_steps=10, remat=False)
    jstep, jopt = jmake_train_step(jc, JEC, JTrain(**train))
    jstep = jax.jit(jstep)
    step, _ = make_train_step(tc, EC, TrainConfig(**train))
    jst = jopt.init(jp)
    data, jdata = SyntheticLM(tc.vocab, 16, B), JSyntheticLM(jc.vocab, 16, B)
    lr = warmup_cosine(3e-3, 10, 10_000)
    for i in range(2):
        mem = _memory(jc, 10 + i)
        p, st = (tree_from_jax(jax.device_get(t)) for t in (jp, jst))
        st["step"] = st["step"].to(torch.int32)
        jp, jst, jm = jstep(jp, jst, dict(jdata.batch(jnp.int32(i)),
                                          memory=jnp.asarray(mem)))
        p, st, m = step(p, st, dict(data.batch(i),
                                    memory=torch.from_numpy(mem)))
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL,
                                       err_msg=f"{arch} step {i} {k}")
        moments = flatten(st["m"])
        for path, g in moments.items():
            if path[-1] in ("wk_x", "wv_x", "pos", "pos_embed", "gate_x"):
                assert float(g.abs().max()) > 0, path
        _close_by_leaf(st["m"], jst["m"], f"{arch} step {i} adam m")
        _close_by_leaf(st["v"], jst["v"], f"{arch} step {i} adam v")
        amplified = _params_close(p, jp, float(lr(torch.tensor(i + 1))),
                                  f"{arch} step {i} params")
        total = sum(t.numel() for t in flatten(p).values())
        assert amplified <= 1e-3 * total, (amplified, total)


def test_checkpoint_crosses_both_ways(model, tmp_path):
    """The new leaves (cross-attention, gate, encoder, positions) cross
    through the npz layout: the port's save restores into the
    reference's template and the reference's into the port's, equal."""
    arch, jc, tc, jp, _, _ = model
    tp = T.init_params(tc, rng.PRNGKey(11), EC, param_dtype=torch.float32)
    save_checkpoint(str(tmp_path / "port"), 1, {"params": tp})
    back = jrestore(str(tmp_path / "port"), 1, {"params": jp})["params"]
    want = dict(_flat(tp))
    for path, a in _flat(jax.device_get(back)):
        np.testing.assert_array_equal(np.asarray(a), want[path].numpy(),
                                      err_msg=str(path))
    jsave(str(tmp_path / "ref"), 2, {"params": jp})
    got = restore_checkpoint(str(tmp_path / "ref"), 2, {"params": tp})
    for (path, a), (_, b) in zip(_flat(got["params"]),
                                 _flat(jax.device_get(jp))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=str(path))
    names = {path[-1] for path in want}
    assert {"wq_x", "wk_x", "wv_x", "wo_x", "norm_x"} <= names
    assert ("gate_x" in names) == (jc.family == "vlm")
    assert ({"pos_embed", "pos"} <= names) == jc.is_encoder_decoder
