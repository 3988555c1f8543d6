"""The dry run over the reference's grid, on the CPU.

Records of each block kind (the mLSTM with its 4 heads on 16 ranks, the
Mamba2 block, cross-attention, the MoE), and the records whose per-rank
work ``sharding/partition.py`` repaired (the mLSTM decode step,
``--fsdp`` at batch 1 and in the MoE decode, ``--kv-seq-shard`` decode),
are traced at full size on 16x16 in this process and held to the
reference's record of the same cell and flags, which one subprocess of
the reference's dry run lowers. Then the K and V projections over the
rank's own KV heads, on the 8-rank fake world (mesh (data 2, model 4)):
a rank computes the columns of the one KV head its query head reads,
and the decode caches stay whole on each rank; decode attention over L
shards on 2 gloo ranks; the mLSTM's chunk loop counted on fake tensors
from two chunks (``route.steps``) against the whole loop, and
``--against``'s table.
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
# reference's, at the default flags, as PERF.md attributes it; each is
# held within 3% of it
RECORDS = {
    ("xlstm-125m", "prefill_32k"): 1.0,
    ("xlstm-125m", "decode_32k"): 0.985,
    ("zamba2-2.7b", "prefill_32k"): 1.027,
    ("llama-3.2-vision-11b", "prefill_32k"): 0.990,
    ("granite-moe-1b-a400m", "decode_32k"): 0.999,
}
# (flag, arch, shape) -> the same under that flag, for records whose
# per-rank work was repaired
FLAG_RECORDS = {
    ("fsdp", "mistral-nemo-12b", "long_500k"): 0.996,
    ("fsdp", "qwen2-moe-a2.7b", "decode_32k"): 0.999,
    ("kv_seq_shard", "mistral-nemo-12b", "decode_32k"): 0.949,
}

# the reference's dry run of the cells above in one subprocess
_REFERENCE = """
import json, sys
from repro.launch import dryrun as D
from repro.config import ExecConfig, TrainConfig
out = []
for arch, shape, flag in json.loads(sys.argv[1]):
    ec = ExecConfig(remat=True, **({flag: True} if flag else {}))
    rec = D.lower_one(arch, shape, False, ec, TrainConfig(remat=True))
    out.append([arch, shape, flag, rec["flops_per_device"]])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_records():
    """{(arch, shape, flag): the reference's per-device flops} of the
    cells of ``RECORDS`` (flag "") and ``FLAG_RECORDS``, from one
    subprocess that lowers each through the reference's dry run."""
    cells = [[a, s, ""] for a, s in RECORDS]
    cells += [[a, s, f] for f, a, s in FLAG_RECORDS]
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(cells)],
        capture_output=True, text=True, env=env, cwd=os.getcwd(),
        timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    recs = {(a, s, f): flops for a, s, f, flops in
            json.loads(res.stdout.strip().splitlines()[-1])}
    assert set(recs) == {tuple(c) for c in cells}
    return recs


def _held(arch, shape, flag, want, reference_records):
    """The record traced on 16x16 under ``flag`` and its per-device
    flops, the masked pairs added back (``dryrun.versus``), within 3% of
    ``want`` times the reference's; returns the record."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun as D
    ec = ExecConfig(remat=True, **({flag: True} if flag else {}))
    try:
        rec = D.lower_one(arch, shape, False, ec, TrainConfig(remat=True),
                          "cpu")
    finally:
        dist.destroy_process_group()
    assert "error" not in rec and rec["flops_per_device"] > 0
    _, adjusted = D.versus(rec, reference_records[(arch, shape, flag)], ec)
    assert abs(adjusted / want - 1) <= 0.03, adjusted
    assert rec["kernel_calls"] and rec["dominant"] in (
        "compute", "memory", "collective")
    return rec


@pytest.mark.parametrize("arch,shape", sorted(RECORDS))
def test_record_traces_and_counts_what_the_reference_counts(
        arch, shape, reference_records):
    """The record traces on 16x16 (no failure) with the reference's
    default flags, and its per-device flops, the masked pairs added back,
    are within 3% of the attributed ratio to the reference's (PERF.md):

    * xlstm-125m prefill_32k 1.0: each rank runs the mLSTM recurrence of
      one head for a quarter of v's head dim (4 heads on 16 ranks);
    * xlstm-125m decode_32k 0.985: each rank updates the k-side rows of
      every head's mLSTM state that the cache places on it, as the
      reference's ranks split each head's state (1.243 before, every
      rank updating all 4 heads);
    * zamba2-2.7b prefill_32k 1.027: each rank runs the Mamba2 block on
      its 5 heads; it also computes all of B and C (128 of in_proj's
      773 columns it multiplies), which the reference splits evenly;
    * llama-3.2-vision-11b prefill_32k 0.990 and granite-moe-1b-a400m
      decode_32k 0.999: elementwise work counted op by op here and
      fused by XLA.
    """
    _held(arch, shape, "", RECORDS[(arch, shape)], reference_records)


@pytest.mark.parametrize("flag,arch,shape", sorted(FLAG_RECORDS))
def test_repaired_record_counts_what_the_reference_counts(
        flag, arch, shape, reference_records):
    """Under ``--fsdp`` or ``--kv-seq-shard`` the record's per-device
    flops, the masked pairs added back, are within 3% of the attributed
    ratio to the reference's, and within 0.9-1.1 (the ratios in
    brackets were those of the per-op DTensor partition this replaced):

    * --fsdp mistral-nemo-12b long_500k 0.996 (1.365): at batch 1 the
      K/V projections split their contraction over ``data``, as the
      reference's do;
    * --fsdp qwen2-moe-a2.7b decode_32k 0.999 (1.640): the experts'
      output keeps its batch rows, so the next layers run the rank's 8
      rows (collective bytes 3.8e9 a device, the reference's 4.7e9;
      8.55e11 before);
    * --kv-seq-shard mistral-nemo-12b decode_32k 0.949 (1.045): no plain
      score pass, the kernel returns the log-sum-exp; the rest is the
      reference's elementwise cache write over its shard.
    """
    want = FLAG_RECORDS[(flag, arch, shape)]
    rec = _held(arch, shape, flag, want, reference_records)
    assert 0.9 <= want <= 1.1
    if flag == "fsdp" and arch == "qwen2-moe-a2.7b":
        # the experts' output keeps its batch rows: no activations of the
        # whole batch move
        assert rec["collective_bytes_per_device"] < 1e10


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
    """4 query heads over 2 KV heads on a (data 2, model 4) mesh: in the
    attention block's body (``transformer._qkv`` with the rank's
    ``Ranks``) model rank j holds query head j and computes only the
    columns of KV head j // 2 (real CPU tensors; no collective runs);
    gathered for the cache, each KV head once."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ranks import PLAIN, Ranks
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    j = world_of_8 % 4
    cfg = dataclasses.replace(reduced_config("starcoder2-3b"), d_model=16,
                              n_heads=4, n_kv_heads=2, head_dim=8)
    g = torch.Generator().manual_seed(0)
    d, hd = 16, 8
    x = torch.randn(2, 5, d, generator=g)
    bp = {"norm1": torch.ones(d), "wq": torch.randn(d, 4 * hd, generator=g),
          "wk": torch.randn(d, 2 * hd, generator=g),
          "wv": torch.randn(d, 2 * hd, generator=g)}
    local = dict(bp, wq=bp["wq"][:, j * hd:(j + 1) * hd])
    q, k, v = T._qkv(local, x, cfg, Ranks(mesh, 1))
    assert q.shape == k.shape == v.shape == (2, 5, 1, hd)
    head = j // 2
    h = T.rms_norm(x, bp["norm1"], cfg.norm_eps)
    torch.testing.assert_close(
        k, (h @ bp["wk"][:, head * hd:(head + 1) * hd])[:, :, None])
    # plain tensors: the whole projection, as before
    _, k, _ = T._qkv(bp, x, cfg, PLAIN)
    torch.testing.assert_close(k, (h @ bp["wk"]).reshape(2, 5, 2, hd))


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
    product has, and the caches each rank writes, with the new rows,
    hold both KV heads (the rank's batch row of each)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.models import attention as A
    cfg = reduced_config("starcoder2-3b")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == (4, 2, 32)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    writes = []
    write = A.cache_write

    def record(kc, vc, kn, vn, slot):
        writes.append((tuple(kc.shape), tuple(kn.shape)))
        return write(kc, vc, kn, vn, slot)

    monkeypatch.setattr(A, "cache_write", record)
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
    for cshape, nshape in writes:
        assert cshape[:2] == (2, cfg.n_kv_heads)
        assert nshape[:3] == (2, 1, cfg.n_kv_heads)
    assert rec["collectives"].get("all-gather", 0) > 0


def _l_sharded_decode(rank: int, world: int, store_dir: str, out: str):
    """One rank of ``test_decode_over_l_shards_matches_whole_caches``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import attention as A
    from repro_torch.sharding.ranks import Ranks
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
        rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 1, 4, 8, generator=g)
        k, v = (torch.randn(2, 2, 16, 8, generator=g) for _ in range(2))
        rows = 16 // world
        kl, vl = (t[:, :, rank * rows:(rank + 1) * rows] for t in (k, v))
        got = {}
        with CostCounter() as counter:
            for n in (3, 11, 16, 40):  # 40: a ring cache that has wrapped
                got[n] = A.decode_attention(
                    q, kl, vl, torch.full((), n, dtype=torch.int32),
                    Ranks(mesh), (0,), 16)
        got["collectives"] = counter.collectives
        got["ops"] = dict(counter.ops)
        if rank == 0:
            torch.save(got, out)
    finally:
        dist.destroy_process_group()


def test_decode_over_l_shards_matches_whole_caches(tmp_path):
    """Decode attention on caches whose L positions are split over 2
    gloo ranks (``kv_seq_shard``, the attention block's body) equals the
    kernel's plain version on the whole caches, for a valid prefix inside
    the first shard, across both, whole and wrapped, within 1e-6; no
    rank gathers the caches: the only collectives are all-reduces of a
    rank's (B, 1, H) weights and (B, 1, H, D) output, 3 a call, and the
    log-sum-exp comes from the kernel call (no plain score product)."""
    import torch.multiprocessing as mp
    from repro_torch.kernels import ops
    out = str(tmp_path / "o.pt")
    mp.spawn(_l_sharded_decode, args=(2, str(tmp_path), out), nprocs=2)
    got = torch.load(out)
    colls = got.pop("collectives")
    counted = got.pop("ops")
    assert colls["all-gather"] == 0
    # per call: max and sum of the weights (2 x 8 floats), the output sum
    # (64 floats); float32, an all-reduce weighted twice
    assert colls["all-reduce"] == 4 * 2 * 4 * (8 + 8 + 64)
    assert counted["kernel.decode_attention"] == 4
    assert not any(k.split(".")[-1] in ("bmm", "mm", "einsum")
                   for k in counted)
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
