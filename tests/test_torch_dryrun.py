"""The cost counter, the kernels' shape-only branch and the dry run, on
the CPU.

The counter's rules on hand-made ops: a product's 2 x |result| x K, a
pointwise op's |result|, a reduction's |operand|, views free; on a fake
process group a product sharded N ways counts 1/N of its flops on each
device, a replicated one in full, and an all-reduce twice its bytes.
A reduced step (prefill, decode, train) counts exactly the same flops,
bytes and ops on real CPU tensors (the plain versions) and on fake ones
(the shape-only branches). Each kernel wrapper takes its shape-only
branch for fake tensors only: there it calls neither the plain version
nor the launch, and a real tensor never takes it. Last, the reference's
dry-run test as the port runs it (reduced granite-3-8b, a fake world of
8, mesh (2, 4)) in a subprocess: flops and collective bytes above zero,
and each device's argument bytes those of the JAX specs' shards.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.config import ExecConfig as JExec
from repro.config import TrainConfig as JTrain
from repro.configs import reduced_config as jreduced
from repro.launch import steps as JSt
from repro.sharding import rules as JR
from repro_torch import rng
from repro_torch.config import ExecConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import categorical_projection as cp
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import segment_tree as st
from repro_torch.kernels import slstm_scan as sl
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as A
from repro_torch.roofline.cost import CostCounter

EC = ExecConfig(compute_dtype="float32")


@pytest.fixture
def fake_world():
    """A ``fake`` process group of 8 ranks in this process, torn down
    after the test."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_world as make
    make(8)
    yield
    dist.destroy_process_group()


def test_counter_rules_on_plain_ops():
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    with CostCounter() as c:
        y = a @ b
        z = y + 1.0
        z.sum()
        y.t(), y.view(-1), y[:2]    # views: no kernel
    assert c.ops == {"aten.mm": 1, "aten.add": 1, "aten.sum": 1}
    assert c.flops == 2 * 4 * 16 * 8 + 64 + 64
    assert c.bytes == ((32 + 128 + 64) + (64 + 64) + (64 + 1)) * 4


def test_counter_counts_local_shards(fake_world):
    """Sharded N ways: 1/N of the product on each device (DTensor's
    global-shape propagation not counted); replicated: all of it; a
    partial sum made whole: one all-reduce, weighted 2x."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
    fm = FakeTensorMode()
    with fm:
        x, w = torch.empty(16, 32), torch.empty(32, 64)
        w_loc, x_loc = torch.empty(32, 8), torch.empty(16, 4)
        w_rows = torch.empty(4, 64)
    xd = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
    sharded = DTensor.from_local(w_loc, mesh, [Shard(1)], run_check=False)
    whole = DTensor.from_local(w, mesh, [Replicate()], run_check=False)
    full = 2 * 16 * 64 * 32
    for wd, want in ((sharded, full // 8), (whole, full)):
        with fm, CostCounter() as c:
            xd @ wd
        assert c.flops == want and c.ops == {"aten.mm": 1}
    xs = DTensor.from_local(x_loc, mesh, [Shard(1)], run_check=False)
    ws = DTensor.from_local(w_rows, mesh, [Shard(0)], run_check=False)
    with fm, CostCounter() as c:
        (xs @ ws).redistribute(mesh, [Replicate()])
    assert c.flops == 2 * 16 * 64 * 4
    assert c.collectives["all-reduce"] == 2 * 16 * 64 * 4
    assert c.ops["_c10d_functional.all_reduce"] == 1


def _fake_like(tree, fm):
    if isinstance(tree, dict):
        return {k: _fake_like(v, fm) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake_like(v, fm) for v in tree)
    with fm:
        return torch.empty(tree.shape, dtype=tree.dtype, device=tree.device)


def _count(fn, args, grad: bool) -> dict:
    with (torch.enable_grad() if grad else torch.no_grad()), \
            CostCounter() as c:
        fn(*args)
    return c.summary()


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen2-moe-a2.7b",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_step_counts_the_same_on_fake_and_real_tensors(arch):
    cfg = reduced_config(arch)
    params = T.init_params(cfg, rng.PRNGKey(0), EC)
    toks = rng.randint(rng.PRNGKey(1), (2, 16), 0, cfg.vocab)
    cache = T.init_cache(cfg, EC, 2, 24, device="cpu")
    cache["pos"].fill_(16)
    step, opt = make_train_step(cfg, EC, TrainConfig())
    p32 = T.init_params(cfg, rng.PRNGKey(0), EC, param_dtype=torch.float32)
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones(2, 16)}
    cases = [(make_prefill_step(cfg, EC), (params, {"tokens": toks}), False),
             (make_serve_step(cfg, EC), (params, cache, toks[:, :1]), False),
             (step, (p32, opt.init(p32), batch), True)]
    for fn, args, grad in cases:
        real = _count(fn, args, grad)
        fm = FakeTensorMode()
        fake_args = _fake_like(args, fm)
        with fm:
            fake = _count(fn, fake_args, grad)
        for key in ("flops", "bytes", "ops", "collectives"):
            assert real[key] == fake[key], (arch, key)
        assert real["flops"] > 0 and any(k.startswith("kernel.")
                                         for k in real["ops"])


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen2-moe-a2.7b",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_useful_flops_leave_out_lookups_and_stay_within_counted(arch):
    """A share of peak takes ``useful_flops``: ``model_flops`` less the
    embedding lookup, never above what the counter counts for the step
    (the reference's ``model_flops`` counts the lookup as a product)."""
    cfg = reduced_config(arch)
    params = T.init_params(cfg, rng.PRNGKey(0), EC)
    toks = rng.randint(rng.PRNGKey(1), (2, 16), 0, cfg.vocab)
    counted = _count(make_prefill_step(cfg, EC), (params, {"tokens": toks}),
                     False)["flops"]
    useful = A.useful_flops(cfg, 32, "infer")
    embed = T.padded_vocab(cfg) * cfg.d_model
    assert A.lookup_params(cfg) == embed
    assert useful == A.model_flops(cfg, 32, "infer")[0] - 2 * embed * 32
    assert 0 < useful <= counted
    assert A.useful_flops(cfg, 32, "train") == \
        A.model_flops(cfg, 32, "train")[0] - 6 * embed * 32


def test_lookup_params_keep_a_tied_table_and_take_position_tables():
    cfg = get_config("whisper-tiny")
    assert cfg.tie_embeddings
    assert A.lookup_params(cfg) == (cfg.learned_pos_len
                                    + cfg.cross_memory_len) * cfg.d_model


def _kernel_cases():
    """name -> (module, wrapper call, its plain version's name, its
    shape-only branch's name, its launch's name, input shapes and
    dtypes)."""
    f32, bf = torch.float32, torch.bfloat16
    return {
        "rmsnorm": (rn, lambda x, g: rn.rmsnorm(x, g, 1e-5), "rmsnorm_plain",
                    "_shape_only", "_launch",
                    [((3, 5, 16), bf), ((16,), f32)]),
        "flash": (fa, lambda q, k, v: fa.flash_attention(q, k, v),
                  "flash_attention_plain", "_shape_only", "_launch",
                  [((2, 8, 4, 16), bf), ((2, 8, 2, 16), bf),
                   ((2, 8, 2, 16), bf)]),
        "decode": (da, lambda q, k, v: da.decode_attention(q, k, v, 3),
                   "decode_attention_plain", "_shape_only", "_launch",
                   [((2, 1, 4, 16), bf), ((2, 2, 8, 16), bf),
                    ((2, 2, 8, 16), bf)]),
        "ssm": (ss, lambda *a: ss.ssm_scan(*a, chunk=4), "_plain_out",
                "_shape_only", "_launch",
                [((2, 8, 3, 4), f32), ((2, 8, 3), f32), ((3,), f32),
                 ((2, 8, 5), f32), ((2, 8, 5), f32)]),
        "slstm": (sl, lambda wx, R, b, *s: sl.slstm_scan(wx, R, b, s, 2),
                  "slstm_scan_plain", "_shape_only", "_launch",
                  [((2, 5, 32), f32), ((4, 2, 4, 4), f32), ((32,), f32)]
                  + [((2, 8), f32)] * 4),
        "segment_tree": (st, lambda t, x: st.segment_tree_sample(t, x),
                         "segment_tree_sample_plain", "_sample_shape_only",
                         "_launch_sample", [((16,), f32), ((5,), f32)]),
        "tree_build": (st, lambda p: st.tree_build(p), "tree_build_plain",
                       "_build_shape_only", "_launch_build", [((8,), f32)]),
        "projection": (cp, lambda p, r, d: cp.categorical_projection(
            p, r, d, v_min=-1.0, v_max=1.0, gamma_n=0.9),
            "categorical_projection_plain", "_shape_only", "_launch",
            [((4, 5), f32), ((4,), f32), ((4,), f32)]),
    }


def _raise(*a, **k):
    raise AssertionError("called")


@pytest.mark.parametrize("name", sorted(_kernel_cases()))
def test_shape_only_branch_is_for_fake_tensors_only(name, monkeypatch):
    mod, call, plain, shape_only, launch, shapes = _kernel_cases()[name]
    g = torch.Generator().manual_seed(0)
    real = [torch.rand(s, generator=g).to(dt) for s, dt in shapes]
    want = call(*real)
    # fake tensors: neither the plain version nor the launch runs, the
    # outputs have the real call's shapes and dtypes, and a counter
    # counts the kernel's work
    monkeypatch.setattr(mod, plain, _raise)
    monkeypatch.setattr(mod, launch, _raise)
    fm = FakeTensorMode()
    with fm, CostCounter() as c:
        got = call(*[fm.from_tensor(t) for t in real])
    flat = lambda o: list(o) if isinstance(o, (list, tuple)) else [o]
    outs = [t for o in flat(got) for t in flat(o)]
    wants = [t for o in flat(want) for t in flat(o)]
    assert [(t.shape, t.dtype) for t in outs] == [(t.shape, t.dtype)
                                                  for t in wants]
    assert sum(v for k, v in c.ops.items() if k.startswith("kernel.")) == 1
    assert c.flops > 0 and c.bytes > 0
    # a real tensor never takes the shape-only branch: on the CPU the
    # plain version, elsewhere (meta) the launch
    monkeypatch.undo()
    monkeypatch.setattr(mod, shape_only, _raise)
    again = call(*real)
    for a, b in zip([t for o in flat(again) for t in flat(o)], wants):
        assert torch.equal(a, b)
    launched = []
    monkeypatch.setattr(mod, launch,
                        lambda *a, **k: launched.append(1) or _raise())
    with pytest.raises(AssertionError):
        call(*[t.to("meta") for t in real])
    assert launched == [1]


DRYRUN_PROG = r"""
import json, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.config import ExecConfig, ShapeConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun as D
D.fake_world(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
rec = D.trace_step(reduced_config("granite-3-8b"),
                   ShapeConfig("t", 64, 4, "train"), mesh,
                   ExecConfig(remat=True), TrainConfig(), "cpu")
print(json.dumps(rec))
"""


def _jax_shard_bytes(tree, specs, axes) -> int:
    """Bytes of rank 0's shards of a JAX abstract tree under its specs."""
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda s: isinstance(
                                  s, jax.sharding.PartitionSpec))):
        n = 1
        for i, d in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            names = () if e is None else (e,) if isinstance(e, str) else e
            ways = math.prod(axes[a] for a in names)
            n *= -(-d // ways)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def test_reference_dryrun_reduced_granite_subprocess(monkeypatch):
    """The reference's dry-run test as the port runs it: reduced
    granite-3-8b's train step on a fake world of 8, mesh (2, 4)."""
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", DRYRUN_PROG],
                         capture_output=True, text=True, env=env,
                         cwd=os.getcwd(), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0   # model-parallel products
    assert rec["kernel_calls"]["flash_attention"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    # the JAX specs' shards of the same state and batch
    monkeypatch.setattr(JR, "NamedSharding", lambda mesh, spec: spec)

    class Mesh:
        shape = {"data": 2, "model": 4}
        axis_names = ("data", "model")
    jc, jec = jreduced("granite-3-8b"), JExec(remat=True)
    params, opt = JSt.abstract_train_state(jc, jec, JTrain())
    pspec = JR.param_shardings(jc, Mesh(), jec)
    rep = jax.sharding.PartitionSpec()
    ospec = {"m": pspec, "v": pspec, "step": rep}
    batch = {k: jax.ShapeDtypeStruct((4, 64), np.int32 if k != "mask"
                                     else np.float32)
             for k in ("tokens", "labels", "mask")}
    bspec = JR.input_shardings(jc, Mesh(), 4, False)
    want = (_jax_shard_bytes(params, pspec, Mesh.shape)
            + _jax_shard_bytes(opt, ospec, Mesh.shape)
            + _jax_shard_bytes(batch, bspec, Mesh.shape))
    assert rec["argument_bytes"] == want


def test_dqn_dryrun_cli_subprocess(tmp_path):
    """``--arch dqn`` on the CPU for the preset with all three DQN
    kernels: rainbow counts the descent, the tree build and the
    projection."""
    out = tmp_path / "dqn.json"
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "dqn",
         "--variant", "rainbow", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=os.getcwd(),
        timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    (r,) = json.loads(out.read_text())
    assert r["variant"] == "rainbow" and r["mesh"] == "1x1"
    assert set(r["kernel_calls"]) == {"segment_tree", "tree_build",
                                      "categorical_projection"}
    assert r["flops_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")


MISTRAL = "mistral-nemo-12b"


@pytest.fixture(scope="module")
def reference_mistral_records(tmp_path_factory):
    """The reference's ``python -m repro.launch.dryrun`` records of
    mistral's prefill_32k and decode_32k on 16x16, in a subprocess."""
    out = tmp_path_factory.mktemp("ref_dry") / "dry.json"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", MISTRAL,
         "--shape", "prefill_32k,decode_32k", "--mesh", "single", "--out",
         str(out)], capture_output=True, text=True, env=env, cwd=os.getcwd(),
        timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return {r["shape"]: r for r in json.loads(out.read_text())}


class _CloneShapes(CostCounter):
    """The counter, also recording the shape of each ``clone``'s input."""

    shapes: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is not NotImplemented and not self._suspended
                and func.__name__.startswith("clone")):
            _CloneShapes.shapes.append(tuple(args[0].shape))
        return out


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_flops_per_device_match_reference(shape, monkeypatch,
                                                 reference_mistral_records):
    """The port's per-device flops of mistral-nemo-12b on 16x16 against
    the reference's dry run of the same cell.

    Every query head computes on one ``model`` rank (2 of 32 each), a
    rank computes the K and V projections of only the KV head its query
    heads read (mistral's 8 KV heads do not divide the 16 ``model``
    ranks; K, V and the caches stay whole on each rank, the new rows
    gathered), and a decode step's products run on the flattened rows:
    no copy of a weight shard is left among its ops. One difference
    remains, counted here from the config rather than allowed for in a
    loose ratio: the reference's attention in the dry run is XLA's
    blocked einsum over every (query, key) pair, and the port's flash
    kernel counts the causal pairs only (prefill: 4.40e13 of the
    reference's 1.88e14).

    With it taken out the two agree within 3%: what is left is
    elementwise work counted op by op in eager torch and fused by XLA.
    The raw ratio is held to 0.7-0.8 for prefill (0.76: the masked pairs)
    and 0.9-1.1 for decode (0.99)."""
    import torch.distributed as dist
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.launch import dryrun as D
    _CloneShapes.shapes = []
    monkeypatch.setattr(D, "CostCounter", _CloneShapes)
    try:
        rec = D.lower_one(MISTRAL, shape, False, ExecConfig(remat=True),
                          TrainConfig(remat=True), "cpu")
    finally:
        dist.destroy_process_group()
    ref = reference_mistral_records[shape]
    cfg = get_config(MISTRAL)
    sc = INPUT_SHAPES[shape]
    b_loc = sc.global_batch // 16
    port = rec["flops_per_device"]
    lo, hi = (0.9, 1.1) if sc.kind == "decode" else (0.7, 0.8)
    assert lo <= port / ref["flops_per_device"] <= hi
    heads = cfg.n_heads // 16
    attn = 4 * cfg.resolved_head_dim * b_loc * heads * cfg.n_layers
    masked = (0 if sc.kind == "decode" else
              attn * (sc.seq_len ** 2 - sc.seq_len * (sc.seq_len + 1) // 2))
    assert abs((port + masked) / ref["flops_per_device"] - 1) <= 0.03
    assert rec["kernel_calls"] == {
        "decode_attention" if sc.kind == "decode" else "flash_attention":
        cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1}
    if sc.kind == "decode":
        smallest_weight = cfg.d_model * cfg.n_heads // 16 * \
            cfg.resolved_head_dim
        assert _CloneShapes.shapes
        assert max(math.prod(s) for s in _CloneShapes.shapes) < \
            smallest_weight, sorted(set(_CloneShapes.shapes))


@pytest.mark.parametrize("flags,chunked", [((), True),
                                           (("--mlstm-recurrent",), False)])
def test_dryrun_mlstm_recurrent_flag(flags, chunked, monkeypatch, tmp_path):
    """``--mlstm-recurrent`` reaches the step's ``ExecConfig`` as the
    reference's flag does (``mlstm_chunked=False``)."""
    from repro_torch.launch import dryrun as D
    seen = []
    monkeypatch.setattr(D, "lower_one", lambda arch, shape, mp, ec, tc, dev:
                        seen.append(ec) or {"trace_s": 0.0,
                                            "flops_per_device": 0.0,
                                            "bytes_per_device": 0.0,
                                            "collective_bytes_per_device":
                                            0.0, "dominant": "compute"})
    assert D.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                   "--mesh", "single", "--out", str(tmp_path / "d.json"),
                   *flags]) == 0
    assert [ec.mlstm_chunked for ec in seen] == [chunked]


@pytest.mark.parametrize("rank", [0, 3, 5])
def test_sharded_attention_reads_the_ranks_kv_head(rank):
    """8 query heads over 2 KV heads on a ``model`` axis of 8 (fake group,
    this process as ``rank``): in the attention block's body each rank
    computes its one query head against the one KV head that head reads
    (``transformer._kv_group``), on real CPU tensors, and its head of
    the output is the whole call's, in prefill and in decode."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ranks import Ranks
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    try:
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
        cfg = dataclasses.replace(reduced_config("mistral-nemo-12b"),
                                  n_heads=8, n_kv_heads=2)
        first, n = T._kv_group(1, cfg, Ranks(mesh, 0))
        assert (first, n) == (rank // 4, 1)
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 16, 8, 16, generator=g)
        k, v = (torch.randn(2, 16, 2, 16, generator=g) for _ in range(2))
        want = fa.flash_attention(q, k, v)
        got = fa.flash_attention(q[:, :, rank:rank + 1],
                                 k[:, :, first:first + n],
                                 v[:, :, first:first + n])
        torch.testing.assert_close(got, want[:, :, rank:rank + 1])
        # decode: q (B, 1, H, D) against (B, Hkv, L, D) caches
        kc, vc = k.transpose(1, 2), v.transpose(1, 2)
        want = da.decode_attention(q[:, :1], kc, vc, 12)
        got = da.decode_attention(q[:, :1, rank:rank + 1],
                                  kc.narrow(1, first, n),
                                  vc.narrow(1, first, n), 12)
        torch.testing.assert_close(got, want[:, :, rank:rank + 1])
    finally:
        dist.destroy_process_group()
