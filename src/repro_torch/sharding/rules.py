"""Logical-axis -> mesh-axis sharding rules, per (architecture, mesh):
the port of ``repro.sharding.rules``.

Every parameter leaf carries logical axis names (``models/params.py``);
this module decides which map onto the ``model`` / ``data`` / ``pod``
mesh axes, respecting divisibility (a dimension that does not divide is
replicated: granite-20b's single KV head, whisper's 6 heads, qwen2-moe's
60 experts on a 16-way model axis).

Baseline scheme: vocab/mlp/heads/experts -> model; batch -> (pod, data);
the rest replicated. ``fsdp``: embed-axis parameters also shard over
``data``. ``kv_seq_shard``: decode caches shard their sequence dim over
``model`` and attention heads stay replicated.

The rules take a mesh's axes as a mapping of names to sizes
(``mesh_axes`` reads them off a ``DeviceMesh``), so they need no process
group. A spec is a tuple with one entry per tensor dim: None
(replicated), a mesh-axis name, or a tuple of names (sharded over their
product, the first name major), as a ``PartitionSpec`` holds them.
``placements`` turns a spec into the DTensor placements on a mesh.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.config import ExecConfig, ModelConfig
from repro_torch.models import params as PM
from repro_torch.models.layers import round_up
from repro_torch.models.moe import padded_experts
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.xlstm import mlstm_dims

Axes = Mapping[str, int]
Spec = Tuple[object, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """A ``DeviceMesh``'s axis names and sizes, in mesh-dim order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(axes: Axes, name: str) -> int:
    return axes.get(name, 1)


def logical_rules(cfg: ModelConfig, axes: Axes,
                  ec: ExecConfig) -> Dict[str, Optional[str]]:
    m = _axis_size(axes, "model")
    d = _axis_size(axes, "data")
    vpad = round_up(cfg.vocab, ec.vocab_pad)

    def fits(n: int) -> bool:
        return m > 1 and n % m == 0

    rules: Dict[str, Optional[str]] = {
        "vocab": "model" if fits(vpad) else None,
        "mlp": "model" if (cfg.d_ff and fits(_shared_mlp_width(cfg))) else None,
        "heads_flat": "model" if fits(cfg.n_heads) else None,
        "kv_flat": "model" if fits(cfg.n_kv_heads) else None,
        "embed": None,
        "pos": None,
        "conv": None,
    }
    if ec.kv_seq_shard:
        # the model axis works on the cache sequence dim, so attention
        # heads stay replicated (sharded q heads against L-sharded caches
        # would gather the whole cache every layer)
        rules["heads_flat"] = None
        rules["kv_flat"] = None
    if cfg.moe is not None:
        rules["experts_logits"] = None        # router output dim
        if ec.moe_impl == "expert_parallel" and fits(padded_experts(cfg.moe)):
            # the padded expert stacks shard; each expert's mlp dim stays
            # with its owner rank
            rules["experts"] = "model"
            rules["expert_mlp"] = None
        elif fits(cfg.moe.n_experts):
            rules["experts"] = "model"
            rules["expert_mlp"] = None
        else:
            rules["experts"] = None
            rules["expert_mlp"] = "model" if fits(cfg.d_ff) else None
    if cfg.ssm is not None:
        d_inner, H, _, N = ssm_dims(cfg)
        rules["ssm_inner"] = "model" if fits(d_inner) else None
        rules["ssm_conv"] = "model" if fits(d_inner + 2 * N) else None
        rules["ssm_heads"] = "model" if fits(H) else None
    if cfg.xlstm is not None:
        d_inner = mlstm_dims(cfg)[0]
        rules["ssm_inner"] = "model" if fits(d_inner) else None
        rules["conv"] = None
        rules["heads"] = "model" if fits(cfg.n_heads) else None
        rules["head_dim"] = None
    if ec.fsdp and d > 1 and cfg.d_model % d == 0:
        rules["embed"] = "data"
    return rules


def _shared_mlp_width(cfg: ModelConfig) -> int:
    if cfg.moe is not None and cfg.moe.n_shared_experts:
        return cfg.d_ff * cfg.moe.n_shared_experts
    if cfg.xlstm is not None:
        return int(cfg.d_model * cfg.xlstm.proj_factor_slstm)
    return cfg.d_ff


def batch_axes(axes: Axes, global_batch: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of (pod, data) whose product divides the batch."""
    chosen = []
    prod = 1
    for a in ("pod", "data"):
        if a in axes and global_batch % (prod * axes[a]) == 0:
            chosen.append(a)
            prod *= axes[a]
    return tuple(chosen) if chosen else None


def param_placements(cfg: ModelConfig, axes: Axes, ec: ExecConfig):
    """The spec tree matching ``model_param_spec(cfg, ec)``."""
    from repro_torch.models.transformer import model_param_spec
    return PM.partition_tree(model_param_spec(cfg, ec),
                             logical_rules(cfg, axes, ec))


def input_placements(axes: Axes, global_batch: int,
                     with_memory: bool) -> Dict[str, Spec]:
    b = batch_axes(axes, global_batch)
    out: Dict[str, Spec] = {"tokens": (b, None), "labels": (b, None),
                            "mask": (b, None)}
    if with_memory:
        out["memory"] = (b, None, None)
    return out


def cache_placements(cfg: ModelConfig, axes: Axes, ec: ExecConfig,
                     global_batch: int, cache_tree):
    """A decode cache's specs: the batch dim over (pod, data); head-like
    dims over model where they divide; under ``kv_seq_shard`` a KV
    cache's L dim over model. Layer entries are (n_superblocks, batch,
    ...); scalars are replicated."""
    m = _axis_size(axes, "model")
    b = batch_axes(axes, global_batch)
    kv_ok = m > 1 and cfg.n_kv_heads % m == 0

    def spec_for(leaf: torch.Tensor) -> Spec:
        shp = tuple(leaf.shape)
        if len(shp) == 0 or shp[0] != cfg.n_superblocks:
            return ()
        rest = shp[1:]
        if len(rest) == 4 and rest[1] == cfg.n_kv_heads:     # (B, Hkv, L, hd)
            if ec.kv_seq_shard and m > 1 and rest[2] % m == 0:
                return (None, b, None, "model", None)
            return (None, b, "model" if kv_ok else None, None, None)
        heads = (ssm_dims(cfg)[1] if cfg.ssm is not None
                 else cfg.n_heads if cfg.xlstm is not None else None)
        if (heads is not None and len(rest) >= 2 and rest[1] == heads
                and heads % m == 0 and m > 1):
            return (None, b, "model", *([None] * (len(rest) - 2)))
        return (None, b, *([None] * (len(rest) - 1)))

    return _tree_map(spec_for, cache_tree)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def _tree_map2(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and the tensor tree it
    describes."""
    if isinstance(tree, torch.Tensor):
        return fn(specs, tree)
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, specs[k], v) for k, v in tree.items()}
    return type(tree)(_tree_map2(fn, s, v) for s, v in zip(specs, tree))


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on
    each mesh dim that a tensor dim's entry names, ``Replicate()`` on the
    rest. A dim sharded over several mesh axes (``(("pod", "data"),
    None)``) is ``Shard(0)`` on each; DTensor splits such a dim over its
    mesh dims in mesh order, the first major, which is the spec's order
    when the names come in mesh order (the only order this accepts)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        group = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in group if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {dim} are not in "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_offset(shape, mesh, placements) -> Tuple[Tuple[int, ...],
                                                   Tuple[int, ...]]:
    """(shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed by ``placements`` on ``mesh``; also inside
    ``FakeTensorMode`` (the mesh's coordinates are real tensors)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        local, offset = compute_local_shape_and_global_offset(
            shape, mesh, placements)
    return tuple(local), tuple(offset)
