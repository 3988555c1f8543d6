"""The expert-parallel MoE against the JAX package and the port's scatter
path, on the CPU.

The reference's setup (``tests/test_perf_variants.py``): reduced
qwen2-moe at capacity 8.0. Ranks are simulated in one process (R = 1,
2, 4: each rank's ``expert_parallel_local`` on its slice of the expert
stacks, the parts summed as the all-reduce sums them) and run for real
in a spawned 2-rank gloo world (``moe_ffn`` under ``use_mesh`` of a
(data 1, model 2) mesh). y is held within 1e-4 of the JAX package's
dense oracle (the reference's bound) and to the scatter path: bitwise at
R = 1, and at R > 1 to 1e-6 (a token whose experts sit on two ranks
adds its parts in another order). The gradients of sum(y^2) + aux, x's
and the router's included, are held to the scatter path's to 1e-5 of
each leaf's largest magnitude.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.config import ExecConfig as JExec
from repro.configs import reduced_config as jreduced
from repro.models import moe as JM
from repro_torch.config import ExecConfig
from repro_torch.configs import reduced_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import moe as M

B, S = 4, 16


def _setup():
    jc = jreduced("qwen2-moe-a2.7b")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=8.0))
    c = reduced_config("qwen2-moe-a2.7b")
    c = dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=8.0))
    from repro.models import params as JP
    jp = JP.init_tree(JM.moe_param_spec(jc), jax.random.PRNGKey(0))
    x = np.random.default_rng(1).normal(size=(B, S, c.d_model)).astype(
        np.float32)
    return jc, c, jp, x


def _shared(p, x):
    xt = x.reshape(-1, x.shape[-1])
    g, u = xt @ p["shared_gate"], xt @ p["shared_up"]
    return (torch.nn.functional.silu(g) * u) @ p["shared_down"]


def _simulated(p, x, m, R):
    """The R ranks' parts summed, with the shared experts, and rank 0's
    auxiliary loss (the others' carry no gradient)."""
    el = M.padded_experts(m) // R
    parts, aux = [], None
    for r in range(R):
        ex = {k: p[k][r * el:(r + 1) * el] for k in ("w_gate", "w_up",
                                                     "w_down")}
        y, a = M.expert_parallel_local(x, p["router"], ex, r, m)
        parts.append(y)
        aux = a if r == 0 else aux
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    return (y + _shared(p, x)).reshape(x.shape), aux


def _grads(fn, p, x):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    xx = x.detach().clone().requires_grad_()
    y, aux = fn(leaves, xx)
    loss = (y ** 2).sum() + aux
    return y.detach(), aux.detach(), torch.autograd.grad(
        loss, [xx] + [leaves[k] for k in sorted(leaves)])


def _close_grads(got, want):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * max(scale, 1e-30)


@pytest.mark.parametrize("R", [1, 2, 4])
def test_simulated_ranks_match_dense_and_scatter(R):
    jc, c, jp, x = _setup()
    p = tree_from_jax(jp)
    xt = torch.from_numpy(x)
    jy, _ = JM.moe_ffn(jp, x, jc, JExec(moe_impl="dense"))
    scatter = lambda q, xx: M.moe_ffn(q, xx, c, ExecConfig(
        compute_dtype="float32"))
    ys, auxs, gs = _grads(scatter, p, xt)
    ye, auxe, ge = _grads(lambda q, xx: _simulated(q, xx, c.moe, R), p, xt)
    np.testing.assert_allclose(ye.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=0)
    if R == 1:
        assert torch.equal(ye, ys)
    else:
        torch.testing.assert_close(ye, ys, atol=1e-6, rtol=1e-6)
    assert torch.equal(auxe, auxs)
    _close_grads(ge, gs)


def test_no_mesh_or_indivisible_model_axis_takes_the_scatter_path():
    """The reference's ``ep_ok``: expert parallel only on a mesh with a
    ``model`` axis that divides the padded expert count."""
    m = reduced_config("qwen2-moe-a2.7b").moe
    E = M.padded_experts(m)

    class Mesh:
        def __init__(self, **axes):
            self.mesh_dim_names = tuple(axes)
            self._axes = axes

        def __getitem__(self, name):
            n = self._axes[name]
            return type("Sub", (), {"size": lambda s: n})()
    assert not M._ep_ok(None, m)
    assert not M._ep_ok(Mesh(data=2), m)
    assert M._ep_ok(Mesh(data=1, model=E), m)
    assert not M._ep_ok(Mesh(data=1, model=E + 1), m)


def _gloo_rank(rank, world, path, out):
    import torch.distributed as dist
    from repro_torch.compat import use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world)
    try:
        jc, c, jp, x = _setup()
        p, xt = tree_from_jax(jp), torch.from_numpy(x)
        mesh = make_host_mesh(model=world)
        ep = ExecConfig(compute_dtype="float32", moe_impl="expert_parallel")

        def run(q, xx):
            with use_mesh(mesh):
                return M.moe_ffn(q, xx, c, ep)
        got = _grads(run, p, xt)
        if rank == 0:
            torch.save(got, out)
    finally:
        dist.destroy_process_group()


def test_two_rank_gloo_world(tmp_path):
    jc, c, jp, x = _setup()
    out = str(tmp_path / "out.pt")
    mp.spawn(_gloo_rank, args=(2, str(tmp_path / "store"), out), nprocs=2,
             join=True)
    ye, auxe, ge = torch.load(out)
    p, xt = tree_from_jax(jp), torch.from_numpy(x)
    ys, auxs, gs = _grads(lambda q, xx: M.moe_ffn(
        q, xx, c, ExecConfig(compute_dtype="float32")), p, xt)
    jy, _ = JM.moe_ffn(jp, x, jc, JExec(moe_impl="dense"))
    np.testing.assert_allclose(ye.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(ye, ys, atol=1e-6, rtol=1e-6)
    assert torch.equal(auxe, auxs)
    _close_grads(ge, gs)
