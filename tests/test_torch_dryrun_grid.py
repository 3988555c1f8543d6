"""The dry run over the reference's grid, on the CPU.

Each module whose records failed to trace under DTensor (the mLSTM's
``log_sigmoid`` and its 4 heads on 16 ranks, the Mamba2 block's 3-D
products, the cross-attention's batched products, the MoE slot table
built in place) has one record traced at full size on 16x16 in this
process and held to the reference's record of the same cell, which one
subprocess of ``python -m repro.launch.dryrun`` lowers. Then the K and V
projections over the rank's own KV heads, on the 8-rank fake world
(mesh (data 2, model 4)): a rank computes the columns of the one KV head
its query head reads, and the decode caches stay whole on each rank.
Last, the mLSTM's chunk loop counted on fake tensors from two chunks
(``route.steps``) against the whole loop, and ``--against``'s table.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.config import (INPUT_SHAPES, ExecConfig, ShapeConfig,
                                TrainConfig)
from repro_torch.configs import get_config, reduced_config
from repro_torch.roofline.analysis import masked_pairs
from repro_torch.roofline.cost import CostCounter

# (arch, shape) -> the ratio of the port's per-device flops, with the
# masked attention pairs the reference counts added back, to the
# reference's, as PERF.md attributes it; each is held within 3% of it
RECORDS = {
    ("xlstm-125m", "prefill_32k"): 1.0,
    ("xlstm-125m", "decode_32k"): 1.243,
    ("zamba2-2.7b", "prefill_32k"): 1.027,
    ("llama-3.2-vision-11b", "prefill_32k"): 0.990,
    ("granite-moe-1b-a400m", "decode_32k"): 0.999,
}
ARCHS = ("xlstm-125m", "zamba2-2.7b", "llama-3.2-vision-11b",
         "granite-moe-1b-a400m")
SHAPES = ("prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def reference_records(tmp_path_factory):
    """The reference's records of exactly ``RECORDS``, from one run of its
    dry-run CLI: the other cells of the (arch x shape) product are
    entered in its output file beforehand as done, so that it skips
    them."""
    out = tmp_path_factory.mktemp("ref_grid") / "dry.json"
    skip = [{"arch": a, "shape": s, "mesh": "16x16", "variant": "baseline"}
            for a in ARCHS for s in SHAPES if (a, s) not in RECORDS]
    out.write_text(json.dumps(skip))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch",
         ",".join(ARCHS), "--shape", ",".join(SHAPES), "--mesh", "single",
         "--out", str(out)], capture_output=True, text=True, env=env,
        cwd=os.getcwd(), timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    recs = {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())
            if "flops_per_device" in r}
    assert set(recs) == set(RECORDS)
    return recs


@pytest.mark.parametrize("arch,shape", sorted(RECORDS))
def test_record_traces_and_counts_what_the_reference_counts(
        arch, shape, reference_records):
    """The record traces on 16x16 (no failure) with the reference's
    default flags, and its per-device flops, the masked pairs added back,
    are within 3% of the attributed ratio to the reference's (PERF.md):

    * xlstm-125m prefill_32k 1.0: each rank runs the mLSTM recurrence of
      one head for a quarter of v's head dim (4 heads on 16 ranks);
    * xlstm-125m decode_32k 1.243: a port fault left open (ROADMAP
      queue 3): every rank runs the mLSTM step's state update for all 4
      heads, 1.54e8 flops over the reference's, whose ranks split
      each head's state;
    * zamba2-2.7b prefill_32k 1.027: each rank runs the Mamba2 block on
      its 5 heads; it also computes all of B and C (128 of in_proj's
      773 columns it multiplies), which the reference splits evenly;
    * llama-3.2-vision-11b prefill_32k 0.990 and granite-moe-1b-a400m
      decode_32k 0.999: elementwise work counted op by op here and
      fused by XLA.
    """
    import torch.distributed as dist
    from repro_torch.launch import dryrun as D
    try:
        rec = D.lower_one(arch, shape, False, ExecConfig(remat=True),
                          TrainConfig(remat=True), "cpu")
    finally:
        dist.destroy_process_group()
    assert "error" not in rec and rec["flops_per_device"] > 0
    ref = reference_records[(arch, shape)]["flops_per_device"]
    adjusted = (rec["flops_per_device"] + masked_pairs(
        get_config(arch), INPUT_SHAPES[shape], 16)) / ref
    assert abs(adjusted / RECORDS[(arch, shape)] - 1) <= 0.03, adjusted
    assert rec["kernel_calls"] and rec["dominant"] in (
        "compute", "memory", "collective")


@pytest.fixture
def world_of_8(request):
    """A ``fake`` process group of 8 ranks, this process as rank
    ``request.param`` (0 by default), torn down after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    rank = getattr(request, "param", 0)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    yield rank
    dist.destroy_process_group()


@pytest.mark.parametrize("world_of_8", [0, 3, 6], indirect=True)
def test_kv_projection_covers_the_ranks_kv_head(world_of_8):
    """4 query heads over 2 KV heads on a (data 2, model 4) mesh: model
    rank j holds query head j and computes only the columns of KV head
    j // 2 (real CPU tensors; no collective runs), its shard of a result
    that holds each KV head twice, sharded over ``model``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models import attention as A
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    j = world_of_8 % 4
    g = torch.Generator().manual_seed(0)
    d, hd = 16, 8
    x = torch.randn(2, 5, d, generator=g)
    w = torch.randn(d, 2 * hd, generator=g)
    wq = torch.randn(d, 4 * hd, generator=g)
    whole = [Replicate(), Replicate()]
    xd, wd = (DTensor.from_local(t, mesh, whole, run_check=False)
              for t in (x, w))
    wqd = DTensor.from_local(wq[:, j * hd:(j + 1) * hd], mesh,
                             [Replicate(), Shard(1)], run_check=False,
                             shape=wq.shape, stride=wq.stride())
    k = A.project_kv(xd, wd, 2, hd, wqd)
    assert k.shape == (2, 5, 4, hd)
    assert k.placements == (Replicate(), Shard(2))
    head = j // 2
    torch.testing.assert_close(
        k.to_local(), (x @ w[:, head * hd:(head + 1) * hd])[:, :, None])
    # plain tensors: the whole projection, as before
    torch.testing.assert_close(A.project_kv(x, w, 2, hd, wq),
                               (x @ w).reshape(2, 5, 2, hd))


class _Products(CostCounter):
    """The counter, also recording each product's (contracted, output
    columns) sizes."""

    seen: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is not NotImplemented and not self._suspended
                and func.__name__.split(".")[0] == "mm"):
            _Products.seen.append((args[0].shape[-1], args[1].shape[-1]))
        return out


def test_decode_step_projects_the_ranks_kv_head_and_keeps_caches_whole(
        world_of_8, monkeypatch):
    """Reduced starcoder2-3b (4 query heads, 2 KV heads of 32) decodes on
    fake tensors on a (data 2, model 4) mesh: each layer's K and V
    products have 32 output columns on a rank (one KV head), as its Q
    product has, and the caches it writes, with the new rows, hold both
    KV heads whole on every ``model`` rank."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    from repro_torch.launch import dryrun as D
    from repro_torch.models import attention as A
    cfg = reduced_config("starcoder2-3b")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == (4, 2, 32)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    writes = []
    write = A._sharded_cache_write

    def record(kc, vc, kn, vn, slot):
        writes.append((kc.placements, kc.to_local().shape, kn.placements,
                       kn.to_local().shape))
        return write(kc, vc, kn, vn, slot)

    monkeypatch.setattr(A, "_sharded_cache_write", record)
    monkeypatch.setattr(D, "CostCounter", _Products)
    _Products.seen = []
    rec = D.trace_step(cfg, ShapeConfig("d", 64, 4, "decode"), mesh,
                       ExecConfig(), TrainConfig(), "cpu")
    layers = cfg.n_layers
    d = cfg.d_model
    # Q, K and V: one head (32 columns) each; the MLP's gate and up and
    # the unembedding: 64 columns (a quarter of 256)
    assert _Products.seen.count((d, 32)) == 3 * layers
    assert _Products.seen.count((d, 64)) == 2 * layers + 1
    assert len(writes) == layers
    for cpl, cshape, npl, nshape in writes:
        assert cpl[1] == Replicate() and cshape[1] == cfg.n_kv_heads
        assert npl[1] == Replicate() and nshape[2] == cfg.n_kv_heads
    assert rec["collectives"].get("all-gather", 0) > 0


def _l_sharded_decode(rank: int, world: int, store_dir: str, out: str):
    """One rank of ``test_decode_over_l_shards_matches_whole_caches``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models import attention as A
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
        rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 1, 4, 8, generator=g)
        k, v = (torch.randn(2, 2, 16, 8, generator=g) for _ in range(2))
        rows = 16 // world
        kd, vd = (DTensor.from_local(t[:, :, rank * rows:(rank + 1) * rows],
                                     mesh, [Shard(2)], run_check=False,
                                     shape=t.shape, stride=t.stride())
                  for t in (k, v))
        qd = DTensor.from_local(q, mesh, [Replicate()], run_check=False)
        got = {}
        with CostCounter() as counter:
            for n in (3, 11, 16, 40):  # 40: a ring cache that has wrapped
                o = A.decode_attention(qd, kd, vd,
                                       torch.full((), n, dtype=torch.int32))
                got[n] = o.to_local()
        got["collectives"] = counter.collectives
        if rank == 0:
            torch.save(got, out)
    finally:
        dist.destroy_process_group()


def test_decode_over_l_shards_matches_whole_caches(tmp_path):
    """Decode attention on caches whose L positions are split over 2
    gloo ranks (``kv_seq_shard``) equals the kernel's plain version on
    the whole caches, for a valid prefix inside the first shard, across
    both, whole and wrapped, within 1e-6; no rank gathers the caches:
    the only collectives are all-reduces of a rank's (B, 1, H) weights
    and (B, 1, H, D) output, 3 a call."""
    import torch.multiprocessing as mp
    from repro_torch.kernels import ops
    out = str(tmp_path / "o.pt")
    mp.spawn(_l_sharded_decode, args=(2, str(tmp_path), out), nprocs=2)
    got = torch.load(out)
    colls = got.pop("collectives")
    assert colls["all-gather"] == 0
    # per call: max and sum of the weights (2 x 8 floats), the output sum
    # (64 floats); float32, an all-reduce weighted twice
    assert colls["all-reduce"] == 4 * 2 * 4 * (8 + 8 + 64)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 8, generator=g)
    k, v = (torch.randn(2, 2, 16, 8, generator=g) for _ in range(2))
    for n, o in got.items():
        torch.testing.assert_close(
            o, ops.decode_attention(q, k, v, n), atol=1e-6, rtol=1e-6)


def test_chunked_mlstm_prefill_counts_the_same_on_fake_and_real_tensors(
        monkeypatch):
    """A prefill of reduced xlstm-125m (one superblock, chunks of 16)
    over 4 chunks of its mLSTM. On fake tensors with no gradient the
    chunk loop runs two chunks and the counter counts the second twice
    more (``route.steps``): the flops, bytes, ops and collectives equal
    those of the whole loop on real CPU tensors, and the peak of live
    bytes that of the whole loop on fake tensors (run with the gradient
    mode on; no leaf records one). A real run's peak also holds the
    plain kernels' temporaries, which the shape-only branches do not
    make."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import rng
    from repro_torch.kernels import route
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    ec = ExecConfig(compute_dtype="float32")
    cfg = reduced_config("xlstm-125m")
    cfg = dataclasses.replace(cfg, n_superblocks=1,
                              xlstm=dataclasses.replace(cfg.xlstm, chunk=16))
    S = 4 * cfg.xlstm.chunk
    params = T.init_params(cfg, rng.PRNGKey(0), ec)
    toks = rng.randint(rng.PRNGKey(1), (2, S), 0, cfg.vocab)
    step = make_prefill_step(cfg, ec)
    fm = FakeTensorMode()
    ran = []
    steps = route.steps

    def spy(fn, carry, n):
        def counted(i, c):
            ran[-1] += 1
            return fn(i, c)
        return steps(counted, carry, n)

    monkeypatch.setattr(route, "steps", spy)

    def fake(t):
        if isinstance(t, dict):
            return {k: fake(v) for k, v in t.items()}
        with fm:
            return torch.empty(t.shape, dtype=t.dtype)

    counts = []
    for args, mode, grad in (
            ((params, {"tokens": toks}), contextlib.nullcontext(), False),
            ((fake(params), {"tokens": fake(toks)}), fm, False),
            ((fake(params), {"tokens": fake(toks)}), fm, True)):
        ran.append(0)
        with torch.set_grad_enabled(grad), mode, CostCounter() as c:
            step(*args)
        counts.append(c.summary())
    real, once, whole = counts
    assert ran == [4 * cfg.n_superblocks, 2 * cfg.n_superblocks,
                   4 * cfg.n_superblocks]
    for key in ("flops", "bytes", "ops", "collectives"):
        assert real[key] == once[key] == whole[key], key
    assert once["peak_bytes"] == whole["peak_bytes"]
    assert real["ops"]["aten.cummax"] == 4 * cfg.n_superblocks


def test_against_prints_each_record_beside_the_reference(tmp_path, capsys):
    """``--against``: one row per port record, with both per-device flops,
    their ratio and the ratio with the masked pairs added back
    (``dryrun.versus``, which ``chip_smoke.py`` holds the grid to), and a
    failed record's error."""
    from repro_torch.launch import dryrun as D
    m = "mistral-nemo-12b"
    port = [{"arch": m, "shape": "prefill_32k", "mesh": "16x16",
             "flops_per_device": 1.4e14, "collective_bytes_per_device": 3e9},
            {"arch": "xlstm-125m", "shape": "decode_32k", "mesh": "16x16",
             "error": "no strategy\ntraceback"}]
    ref = [{"arch": m, "shape": "prefill_32k", "mesh": "16x16",
            "flops_per_device": 1.88e14, "collective_bytes_per_device": 2e9},
           {"arch": "xlstm-125m", "shape": "decode_32k", "mesh": "16x16",
            "flops_per_device": 6.3e8, "collective_bytes_per_device": 1e6}]
    (tmp_path / "port.json").write_text(json.dumps(port))
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    assert D.main(["--out", str(tmp_path / "port.json"), "--against",
                   str(tmp_path / "ref.json")]) == 0
    rows = capsys.readouterr().out.splitlines()
    masked = masked_pairs(get_config(m), INPUT_SHAPES["prefill_32k"], 16)
    assert masked > 0
    assert rows[2] == (f"| {m} | prefill_32k | 16x16 | 1.4000e+14 "
                       f"| 1.8800e+14 | {1.4e14 / 1.88e14:.3f} "
                       f"| {(1.4e14 + masked) / 1.88e14:.3f} | 3.000e+09 "
                       f"| 2.000e+09 |")
    assert rows[3] == ("| xlstm-125m | decode_32k | 16x16 | fails: no "
                       "strategy | 6.3000e+08 | | | | |")
    assert D.versus(port[0], 1.88e14) == (
        1.4e14 / 1.88e14, (1.4e14 + masked) / 1.88e14)
