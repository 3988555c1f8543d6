"""The port's transformer serve path against the JAX reference, on the CPU.

The reference model runs its plain XLA path (``use_pallas=False``, as its
serve launcher does) in float32; its parameters and caches cross to the
port through ``repro_torch.convert.tree_from_jax``. Logits and caches are
held to atol = rtol = 1e-4 (the products and the softmax sum in another
order than XLA's); greedy tokens must be equal, and each step asserts
that the reference's top-2 logit margin exceeds that tolerance, so the
equality means something. Also here: the parameter specs and the init
against the reference's, the launcher, and the import guard.
"""

import ast
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ExecConfig as JExec
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models import params as JP
from repro.models import transformer as JT
from repro_torch import rng
from repro_torch.config import ExecConfig
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import params as P
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ("mistral-nemo-12b", "starcoder2-3b", "granite-3-8b", "granite-20b")
JEC = JExec(compute_dtype="float32")
EC = ExecConfig(compute_dtype="float32")


def _configs(name):
    """(reference config, port config) of a reduced arch; ``wide-heads``
    is reduced mistral-nemo with H * hd != d_model, as the full model has."""
    arch = "mistral-nemo-12b" if name == "wide-heads" else name
    jc, tc = jreduced(arch), reduced_config(arch)
    if name == "wide-heads":
        jc = dataclasses.replace(jc, head_dim=48, n_heads=4, n_kv_heads=2)
        tc = dataclasses.replace(tc, head_dim=48, n_heads=4, n_kv_heads=2)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@pytest.mark.parametrize("arch", DENSE + ("zamba2-2.7b", "xlstm-125m",
                                          "granite-moe-1b-a400m",
                                          "qwen2-moe-a2.7b",
                                          "llama-3.2-vision-11b",
                                          "whisper-tiny"))
def test_configs_and_param_specs_match_reference(arch):
    jc, tc = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jl = JP._leaves(JT.model_param_spec(jc, JExec()))
    tl = P._leaves(T.model_param_spec(tc, ExecConfig()))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert (a.shape, a.axes, a.init, a.fan_in, a.value) == \
            (b.shape, b.axes, b.init, b.fan_in, b.value), path
        assert b.dtype == torch.float32
    assert JP.param_count(JT.model_param_spec(jc, JExec())) == \
        P.param_count(T.model_param_spec(tc, ExecConfig()))
    # stored for serving: drawn leaves in bf16 but the sLSTM's R and the
    # MoE router, which stay float32
    served = P._leaves(P.drawn_in(T.model_param_spec(tc, ExecConfig()),
                                  torch.bfloat16, keep=T.F32_LEAVES))
    f32_drawn = {path[-1] for path, leaf in served if leaf.dtype ==
                 torch.float32 and leaf.init in ("normal", "embed")}
    assert f32_drawn == ({"router"} if tc.moe is not None else
                         {"r"} if arch == "xlstm-125m" else set())


def test_get_config_loads_every_arch():
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert cfg.arch_id == arch
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jget_config(arch))
    assert not hasattr(T, "NOT_PORTED") and not hasattr(T, "_check_ported")


def test_init_matches_reference_and_chunks_bitwise(monkeypatch):
    jc, tc = _configs("mistral-nemo-12b")
    jp = jax.device_get(JT.init_params(jc, jax.random.PRNGKey(3), JEC))
    tp = T.init_params(tc, rng.PRNGKey(3), EC)
    bf16 = T.init_params(tc, rng.PRNGKey(3), ExecConfig())
    monkeypatch.setattr(P, "DRAW_CHUNK", 1000)
    chunked = T.init_params(tc, rng.PRNGKey(3), EC)
    flat_j = {"/".join(p): v for p, v in _flat(jp)}
    flat_t = {"/".join(p): v for p, v in _flat(tp)}
    assert flat_j.keys() == flat_t.keys()
    for path, want in flat_j.items():
        got = flat_t[path]
        assert tuple(got.shape) == want.shape, path
        # normal agrees with jax's to a few ulps (rng.py)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7,
                                   err_msg=path)
    for (path, a), (_, b), (_, c) in zip(_flat(tp), _flat(chunked),
                                         _flat(bf16)):
        assert torch.equal(a, b), path
        # drawn leaves stored in the compute dtype; norm gains stay f32
        want = a if "norm" in path[-1] else a.to(torch.bfloat16)
        assert c.dtype == want.dtype and torch.equal(c, want), path


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("ring,pos", [(False, 5), (False, 40), (True, 37)])
def test_layer_helpers_match_reference(ring, pos):
    """apply_rope, repeat_kv and cache_update (full cache: the slot clamps
    to L - 1; ring: it wraps) against the reference's."""
    from repro.models import attention as JA
    from repro.models import layers as JL
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    r = np.random.default_rng(pos)
    x = r.standard_normal((2, 5, 4, 48)).astype(np.float32)
    positions = (np.arange(5, dtype=np.int32) + pos)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                     1e6).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                 1e6)), atol=1e-6, rtol=1e-6)
    kv = r.standard_normal((2, 5, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        A.repeat_kv(torch.from_numpy(kv), 4, 2).numpy(),
        np.asarray(JA.repeat_kv(jnp.asarray(kv), 4, 2)))
    kc, vc = (r.standard_normal((2, 2, 16, 8)).astype(np.float32)
              for _ in range(2))
    kn, vn = (r.standard_normal((2, 1, 2, 8)).astype(np.float32)
              for _ in range(2))
    jk, jv = JA.cache_update(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                             jnp.asarray(vn), jnp.int32(pos), ring)
    tk, tv = A.cache_update(torch.from_numpy(kc), torch.from_numpy(vc),
                            torch.from_numpy(kn), torch.from_numpy(vn),
                            torch.full((), pos, dtype=torch.int32), ring)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_prefill_step_matches_reference():
    from repro.launch.steps import make_prefill_step as jmake
    from repro_torch.launch.steps import make_prefill_step
    jc, tc = _configs("granite-3-8b")
    jp = JT.init_params(jc, jax.random.PRNGKey(0), JEC)
    tokens = np.random.default_rng(2).integers(0, jc.vocab, size=(2, 9),
                                               dtype=np.int32)
    want = jmake(jc, JEC)(jp, {"tokens": jnp.asarray(tokens)})
    got = make_prefill_step(tc, EC)(tree_from_jax(jax.device_get(jp)),
                                    {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (2, jc.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _margin_ok(logits):
    """The top-2 margin of every row exceeds the tolerance's reach."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return bool(((top[..., 1] - top[..., 0]) >
                 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top[..., 1]))).all())


def _assert_cache(tc, jcache):
    for (path, a), (_, b) in zip(_flat({k: v for k, v in tc.items()
                                        if k != "ring"}),
                                 _flat({k: v for k, v in jcache.items()
                                        if k != "ring"})):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(path),
                                   **TOL)


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "starcoder2-3b",
                                  "granite-3-8b", "wide-heads"])
@pytest.mark.parametrize("ring", [False, True])
def test_prefill_and_decode_match_reference(name, ring):
    """Fused prefill (logits and cache), then 8 greedy decode steps; the
    ring case prefills token by token into a 16-slot window and wraps."""
    jc, tc = _configs(name)
    B, S, steps, window = 2, 12, 8, 16
    jp = JT.init_params(jc, jax.random.PRNGKey(0), JEC)
    tp = tree_from_jax(jax.device_get(jp))
    tokens = np.random.default_rng(1).integers(0, jc.vocab, size=(B, S),
                                               dtype=np.int32)
    jdec = jax.jit(functools.partial(JT.decode_step, jc, JEC, ring=ring))
    if ring:
        jcache = JT.init_cache(jc, JEC, B, window, ring=True)
        tcache = T.init_cache(tc, EC, B, window, ring=True, device="cpu")
        for i in range(S):
            jl, jcache = jdec(jp, jcache, jnp.asarray(tokens[:, i:i + 1]))
            tl, tcache = T.decode_step(tc, EC, tp, tcache,
                                       torch.from_numpy(tokens[:, i:i + 1]),
                                       ring=True)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jlast = np.asarray(jl)[:, -1, : jc.vocab]
    else:
        jl, _, jcache = jax.jit(functools.partial(
            JT.forward, jc, JEC, collect_cache_len=S + steps))(
                jp, jnp.asarray(tokens))
        tl, aux, tcache = T.forward(tc, EC, tp, torch.from_numpy(tokens),
                                    collect_cache_len=S + steps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert float(aux) == 0.0 and int(tcache["pos"]) == S
        _assert_cache(tcache, jax.device_get(jcache))
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
    _assert_cache(tcache, jax.device_get(jcache))


def test_serve_steps_and_launcher_tokens_match_reference(capsys):
    """The port's serve launcher (reduced mistral-nemo, float32, key 0)
    prints the reference launcher's greedy sample."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    jserve.main(["--arch", "mistral-nemo-12b", "--batch", "2",
                 "--prompt-len", "8", "--gen", "6"])
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("sample:")]
    res = serve.run(serve.parse_args(
        ["--arch", "mistral-nemo-12b", "--batch", "2", "--prompt-len", "8",
         "--gen", "6", "--device", "cpu"]))
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("sample:")]
    assert got == want and len(got) == 1
    assert tuple(res["tokens"].shape) == (2, 6)
    assert res["tokens"].dtype == torch.int32
    assert _margin_ok(res["prefill_logits"].numpy())


def _launch(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mistral-nemo-12b", "--batch", "2", "--prompt-len", "8", "--gen",
         "4", *extra], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)


def test_launcher_runs_on_cpu_only_when_asked():
    ok = _launch("--device", "cpu")
    assert ok.returncode == 0, ok.stderr
    assert "generated shape: (2, 4)" in ok.stdout
    no_card = _launch()
    assert no_card.returncode != 0
    assert "torch.cuda.is_available() is False" in no_card.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in
                    (ROOT / "src" / "repro_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_import_guard(rel):
    """No module of the port, and not chip_smoke.py, imports jax, jaxlib
    or the reference package."""
    for name in _imports(ROOT / rel):
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name
