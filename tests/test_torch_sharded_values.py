"""The model's DTensor paths run for real, on 4 gloo ranks, against the
single-process port.

The dry run counts the sharded step on fake tensors; this runs it on
real CPU tensors over a spawned 4-rank ``gloo`` world, meshes (data 1,
model 4) and (data 2, model 2). The parameters, tokens and caches are
placed by the port's rules (``sharding/rules.py``), each rank holding its
own shard. Each arch's reduced config, in float64, goes through the
prefill step's forward, each block's prefill cache entry (the state the
mLSTM and Mamba2 blocks hand to decode), a decode step from a
prefilled cache and one training loss with its gradient. The logits,
the entries, the loss, the caches written and every parameter's
gradient, gathered whole, are held to the same calls on plain tensors
in one process, within 1e-5 (of the leaf's largest magnitude for a
gradient).

The configs reach each block's per-rank split (``sharding/
partition.py``): the mLSTM's heads split over ranks by their v columns
in the chunked form (2 heads on 4 ``model`` ranks) and its state
gathered whole for the cache, its decode step on the k-side rows of the
state the cache splits, the Mamba2 block on its heads, the MoE's router
per batch shard and its experts per model rank, the K and V of the
rank's own KV head (2 KV heads on 4 ``model`` ranks), and the MLPs'
columns. On mesh (2, 2) also under ``--fsdp`` (the weights' embed axis
over ``data``, gathered for the rank's batch rows) for starcoder2 and
granite-moe, and under ``--kv-seq-shard`` (the caches' L positions over
``model``, the decode step's attention combined by the kernel's
log-sum-exp) for starcoder2 and xlstm.
"""

import dataclasses
import os

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import rng
from repro_torch.config import ExecConfig
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as T
from repro_torch.models.layers import rope_tables, softmax_cross_entropy
from repro_torch.optim.base import flatten, value_and_grad
from repro_torch.sharding import partition as PT

MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
ARCHS = ("xlstm-125m", "zamba2-2.7b", "granite-moe-1b-a400m",
         "starcoder2-3b")
# (flag, arch) run on mesh 2x2 besides the default flags
FLAGGED = (("fsdp", "starcoder2-3b"), ("fsdp", "granite-moe-1b-a400m"),
           ("kv_seq_shard", "starcoder2-3b"), ("kv_seq_shard", "xlstm-125m"))
# float64: a one-ulp change of the reduced zamba2's float32 parameters
# moves its logits by ~3e-4, which would hide a fault of that size
EC = ExecConfig(compute_dtype="float64")
B, S, CACHE = 2, 16, 24


def _config(arch):
    """The reduced config with one superblock and chunks of 8 (2 of S)."""
    cfg = dataclasses.replace(reduced_config(arch), n_superblocks=1)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=8))
    if cfg.xlstm is not None:
        # 2 heads on 4 model ranks: each rank one head's half of v's
        # columns, as 4 heads on 16 ranks at full size
        cfg = dataclasses.replace(
            cfg, n_heads=2, n_kv_heads=2,
            xlstm=dataclasses.replace(cfg.xlstm, chunk=8))
    return cfg


def _inputs(cfg):
    toks = rng.randint(rng.PRNGKey(1), (B, S + 1), 0, cfg.vocab)
    return {"tokens": toks[:, :S], "labels": toks[:, 1:],
            "mask": torch.ones(B, S), "next": toks[:, S:]}


def _loss(cfg):
    def loss_fn(params, batch):
        logits, aux = T.forward(cfg, EC, params, batch["tokens"])
        ce = softmax_cross_entropy(logits, batch["labels"], cfg.vocab,
                                   batch["mask"])
        return ce + aux, ce
    return loss_fn


def _run(cfg, params, inputs, cache, whole):
    """The prefill's logits and each block's cache entry, the loss and
    its gradient, and a decode step's logits and the caches it writes;
    ``whole`` makes a result a plain tensor."""
    with torch.no_grad():
        logits, _ = T.forward(cfg, EC, params, inputs["tokens"])
        out = {"prefill": whole(logits),
               "entries": _entries(cfg, params, inputs["tokens"], whole)}
    (loss, _), grads = value_and_grad(
        _loss(cfg), params, {k: inputs[k] for k in ("tokens", "labels",
                                                     "mask")}, has_aux=True)
    out["loss"] = whole(loss)
    out["grads"] = {k: whole(g) for k, g in flatten(grads).items()}
    with torch.no_grad():
        logits, cache = T.decode_step(cfg, EC, params, cache, inputs["next"])
    out["decode"] = whole(logits)
    out["cache"] = {k: whole(t) for k, t in _leaves(cache["layers"])}
    return out


def _entries(cfg, params, tokens, whole):
    """What each block of the superblock gives the decode cache in the
    fused prefill (``T._apply_block``'s entry: the K/V whole, the
    recurrent state, the conv's last inputs), on the embedded tokens."""
    x = PT.embed(params["embed"], tokens, EC.cdtype)
    rope = None
    if T._rotary(cfg):
        rope = rope_tables(torch.arange(S, dtype=torch.int32),
                           cfg.resolved_head_dim, cfg.rope_theta)
    lp = T._layer(params["layers"], 0)
    out = {}
    for j, kind in enumerate(cfg.superblock):
        name = f"b{j}_{kind}"
        bp = params["shared_attn"] if T._shared(cfg, kind) else lp[name]
        x, _, entry = T._apply_block(kind, bp, x, rope, None, cfg, EC,
                                     collect=True)
        out.update({name + k: whole(t) for k, t in _leaves(entry)})
    return out


def _leaves(tree, path=""):
    """(path, tensor) of each leaf of nested dicts and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _plain(cfg):
    params = T.init_params(cfg, rng.PRNGKey(0), EC,
                           param_dtype=torch.float64)
    inputs = _inputs(cfg)
    with torch.no_grad():
        _, _, cache = T.forward(cfg, EC, params, inputs["tokens"],
                                collect_cache_len=CACHE)
    return params, inputs, cache


def _tree(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def _rank(rank, world, store_dir, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.compat import use_mesh
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.partition import cache_placements
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
        rank=rank, world_size=world)
    try:
        got = {}
        for name, shape in MESHES.items():
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            axes = R.mesh_axes(mesh)

            def place(t, spec):
                pl = R.placements(spec, mesh)
                local, offset = R.local_offset(t.shape, mesh, pl)
                idx = tuple(slice(o, o + n) for o, n in zip(offset, local))
                return DTensor.from_local(t[idx].clone(), mesh, pl,
                                          run_check=False, shape=t.shape,
                                          stride=t.stride())

            def whole(t):
                return (t.full_tensor() if isinstance(t, DTensor)
                        else t).detach()

            runs = [(arch, "") for arch in ARCHS]
            if name == "2x2":
                runs += [(arch, flag) for flag, arch in FLAGGED]
            for arch, flag in runs:
                cfg = _config(arch)
                ec = dataclasses.replace(EC, **{flag: True} if flag else {})
                params, inputs, cache = _plain(cfg)
                ispecs = R.input_placements(axes, B, False)
                ispecs["next"] = ispecs["tokens"]
                dparams = _tree(place, params,
                                R.param_placements(cfg, axes, ec))
                dinputs = {k: place(v, ispecs[k]) for k, v in inputs.items()}
                dcache = _tree(place, cache,
                               cache_placements(cfg, axes, ec, B, cache))
                with use_mesh(mesh), implicit_replication():
                    got[name, arch, flag] = _run(cfg, dparams, dinputs,
                                                 dcache, whole)
        if rank == 0:
            torch.save(got, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{(mesh name, arch): the results gathered whole}, from one spawned
    4-rank world that builds both meshes."""
    d = tmp_path_factory.mktemp("gloo")
    out = str(d / "out.pt")
    mp.spawn(_rank, args=(4, str(d), out), nprocs=4)
    return torch.load(out)


@pytest.fixture(scope="module")
def plain():
    """{arch: the results on plain tensors}."""
    out = {}
    for arch in ARCHS:
        cfg = _config(arch)
        out[arch] = _run(cfg, *_plain(cfg), lambda t: t.detach())
    return out


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    err = float((got.to(want.dtype) - want).abs().max()) if want.numel() \
        else 0.0
    assert got.shape == want.shape, what
    assert err <= 1e-5 * max(scale, 1.0), (what, err, scale)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_single_process_port(arch, mesh, sharded,
                                                      plain):
    _matches(sharded[mesh, arch, ""], plain[arch], (mesh, arch))


@pytest.mark.parametrize("flag,arch", FLAGGED)
def test_sharded_step_under_a_flag_matches_the_single_process_port(
        flag, arch, sharded, plain):
    """``--fsdp`` and ``--kv-seq-shard`` on mesh (2, 2): the same step,
    the same bound (the plain step does not read either flag)."""
    _matches(sharded["2x2", arch, flag], plain[arch], ("2x2", arch, flag))


def _matches(got, want, what):
    mesh, arch = what[:2]
    for key in ("prefill", "loss", "decode"):
        _close(got[key], want[key], (mesh, arch, key))
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        g = got["grads"][k]
        scale = max(float(w.abs().max()), 1e-30)
        assert g.shape == w.shape, (mesh, arch, k)
        assert float((g - w).abs().max()) <= 1e-5 * scale, (mesh, arch, k)
    for k, w in want["cache"].items():
        _close(got["cache"][k], w, (mesh, arch, "cache", k))
    assert set(got["entries"]) == set(want["entries"])
    for k, w in want["entries"].items():
        _close(got["entries"][k], w, (mesh, arch, "entry", k))
