"""The port's sharding rules, abstract trees, input specs and
``model_flops`` against the JAX package, on the CPU; and DTensor
placements, and a checkpoint restored onto a mesh, on a process group of
this process.

The rules take axis names and sizes, so the JAX side runs on the
reference's own stand-in mesh (``shape`` and ``axis_names``) and its
``NamedSharding`` is patched to hand back the bare spec: nothing in the
JAX package changes. Specs compare after one normalisation: a dim's
entry becomes the tuple of its mesh axes (``"model"`` and
``("model",)`` alike, None as ``()``). Rules, specs, trees and
``model_flops`` are exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.config import ExecConfig as JExec
from repro.config import INPUT_SHAPES as JSHAPES
from repro.config import TrainConfig as JTrain
from repro.configs import ARCH_IDS as JARCHS
from repro.configs import get_config as jget
from repro.launch import specs as JS
from repro.launch import steps as JSt
from repro.models import params as JP
from repro.models import transformer as JT
from repro.roofline import analysis as JA
from repro.sharding import rules as JR
from repro_torch.config import ExecConfig, INPUT_SHAPES, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import specs as S
from repro_torch.launch import steps as St
from repro_torch.models import params as PM
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as A
from repro_torch.sharding import rules as R

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}, "1x1": {"data": 1, "model": 1}}
VARIANTS = {"baseline": {}, "fsdp": {"fsdp": True},
            "expert_parallel": {"moe_impl": "expert_parallel"},
            "kv_seq_shard": {"kv_seq_shard": True}}


class FakeMesh:
    """The reference's stand-in mesh (tests/test_sharding.py)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _norm(spec):
    out = []
    for e in spec:
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def _jspecs(tree):
    """A JAX tree of PartitionSpecs as {path: normalised spec}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): _norm(tuple(s)) for p, s in leaves}


def _specs(tree, prefix=""):
    """The port's tree of spec tuples as {path: normalised spec}, with
    the JAX key strings."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs(v, f"{prefix}['{k}']"))
        return out
    return {prefix: _norm(tree)}


def _leaves(tree, prefix=""):
    """{JAX-style path: (shape, dtype name)} of a port tree of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _jleaves(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(np.dtype(x.dtype)))
            for p, x in leaves}


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's NamedSharding handing back its spec."""
    monkeypatch.setattr(JR, "NamedSharding", lambda mesh, spec: spec)


def test_arch_lists_match():
    assert list(ARCH_IDS) == list(JARCHS)


@pytest.mark.parametrize("arch", JARCHS)
def test_rules_and_param_specs_match_reference(arch, bare_specs):
    for mesh, axes in MESHES.items():
        for name, kw in VARIANTS.items():
            jec, ec = JExec(**kw), ExecConfig(**kw)
            want = JR.logical_rules(jget(arch), FakeMesh(**axes), jec)
            assert R.logical_rules(get_config(arch), axes, ec) == want, (
                mesh, name)
            jtree = JP.partition_tree(JT.model_param_spec(jget(arch), jec),
                                      want)
            got = R.param_placements(get_config(arch), axes, ec)
            assert _specs(got) == _jspecs(jtree), (mesh, name)


def test_batch_axes_reference_cases(bare_specs):
    pod = {"pod": 2, "data": 16, "model": 16}
    assert R.batch_axes(pod, 256) == ("pod", "data")
    assert R.batch_axes(pod, 16) == ("pod",)
    assert R.batch_axes(pod, 1) is None
    assert R.batch_axes({"data": 16, "model": 16}, 128) == ("data",)
    for axes in MESHES.values():
        for b in (1, 2, 4, 8, 16, 32, 128, 256, 3):
            assert R.batch_axes(axes, b) == JR.batch_axes(FakeMesh(**axes),
                                                          b)
            got = R.input_placements(axes, b, True)
            want = JR.input_shardings(None, FakeMesh(**axes), b, True)
            assert {k: _norm(v) for k, v in got.items()} == {
                k: _norm(tuple(v)) for k, v in want.items()}


@pytest.mark.parametrize("arch", JARCHS)
def test_abstract_trees_and_cache_specs_match_reference(arch, bare_specs):
    """Parameters, train state and every shape's inputs (caches
    included) at full size: paths, shapes and dtypes; the caches' specs
    on every mesh and variant; model_flops."""
    jc, c = jget(arch), get_config(arch)
    jec, ec = JExec(), ExecConfig()
    assert _leaves(T.abstract_params(c, ec)) == _jleaves(
        JT.abstract_params(jc, jec))
    params, opt = St.abstract_train_state(c, ec, TrainConfig())
    jparams, jopt = JSt.abstract_train_state(jc, jec, JTrain())
    assert _leaves(params) == _jleaves(jparams)
    assert _leaves(opt) == _jleaves(jopt)
    assert params["embed"].device.type == "meta"
    for shape in JSHAPES:
        got, want = S.input_specs(c, ec, shape), JS.input_specs(jc, jec, shape)
        assert _leaves(got) == _jleaves(want), shape
        assert S.decode_cache_len(c, INPUT_SHAPES[shape]) == \
            JS.decode_cache_len(jc, JSHAPES[shape])
        if "cache" not in got:
            continue
        B = JSHAPES[shape].global_batch
        for mesh, axes in MESHES.items():
            for name, kw in VARIANTS.items():
                jspec = JR.cache_shardings(jc, FakeMesh(**axes), JExec(**kw),
                                           B, want["cache"])
                spec = R.cache_placements(c, axes, ExecConfig(**kw), B,
                                          got["cache"])
                assert _specs_any(spec) == _jspecs(jspec), (shape, mesh,
                                                            name)
    for kind in ("train", "infer"):
        assert A.model_flops(c, 4096, kind) == JA.model_flops(jc, 4096, kind)


def _specs_any(tree, prefix=""):
    """``_specs`` over dicts and tuples (a cache's sLSTM state)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs_any(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_specs_any(v, f"{prefix}[{i}]"))
        return out
    return {prefix: _norm(tree)}


def test_lm_batch_specs_and_tree_bytes():
    from repro.data.synthetic import lm_batch_specs as jspecs
    from repro_torch.data.synthetic import lm_batch_specs
    assert _leaves(lm_batch_specs(1000, 64, 8)) == _jleaves(
        jspecs(1000, 64, 8))
    c = get_config("granite-3-8b")
    assert PM.tree_bytes(T.abstract_params(c)) == JP.tree_bytes(
        JT.abstract_params(jget("granite-3-8b")))


@pytest.fixture
def fake_world():
    """A ``fake`` process group of 512 ranks in this process, torn down
    after the test."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_world as make
    make(512)
    yield
    dist.destroy_process_group()


def test_placements_order_is_major_to_minor(fake_world):
    """A dim sharded over (pod, data) is Shard(0) on both mesh dims and
    splits pod-major, as a PartitionSpec does; a spec naming them out of
    the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    pl = R.placements((("pod", "data"), None, "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert R.placements((None, None), mesh) == (Replicate(),) * 3
    # rank (pod p, data d, model m) holds rows (p * 16 + d) * 2 ... of 64
    coords = mesh.get_coordinate()
    shape, offset = local((64, 3, 32), mesh, pl)
    assert shape == (2, 3, 2)
    assert offset == ((coords[0] * 16 + coords[1]) * 2, 0, coords[2] * 2)
    with pytest.raises(ValueError):
        R.placements((("data", "pod"), None), mesh)


def test_restore_places_leaves_on_the_template_mesh(tmp_path, fake_world):
    """A checkpoint written whole restores with ``placements`` as
    DTensors on the template's mesh, each rank's shard the slice of the
    saved array (here rank 0 of the fake world)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.checkpoint.ckpt import (restore_latest,
                                             save_checkpoint)
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(device_type="cpu")
    tree = {"w": torch.arange(64 * 6, dtype=torch.float32).reshape(64, 6),
            "b": torch.arange(5, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 3, tree)
    template = {k: DTensor.from_local(
        torch.empty(v.shape, dtype=v.dtype), mesh, [Replicate()] * 2,
        run_check=False) for k, v in tree.items()}
    placements = {"w": (Shard(0), Shard(1)), "b": (Replicate(), Replicate())}
    step, got, skipped = restore_latest(str(tmp_path), template,
                                        placements=placements)
    assert step == 3 and not skipped
    assert got["w"].placements == (Shard(0), Shard(1))
    assert torch.equal(got["w"].to_local(), tree["w"][:4, :1])
    assert torch.equal(got["b"].to_local(), tree["b"])
    assert os.path.exists(tmp_path / "step_00000003.npz")
