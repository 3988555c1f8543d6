"""The route of one kernel call: by the tensors it is given.

* a fake tensor (``FakeTensorMode``: the dry run) takes the kernel's
  shape-only branch, which returns empty outputs of the kernel's shapes
  and dtypes and computes nothing: what ``register_fake`` is to a
  ``torch.library.custom_op``. A real tensor never takes it;
* a CPU tensor runs the plain version;
* any other tensor launches the kernel (which raises off the card).

Under a ``roofline.cost.CostCounter`` the call reports the kernel's
analytic flops and bytes (its ``work`` function: the formulas of
PERF.md's bound column) and the counter skips the ops the call runs
inside, so the three routes count the same. A call that records a
gradient goes through ``PlainRecompute`` off the CPU, and on every
device under a counter, whose backward then reports the kernel's
backward (``kernels/recompute.py``).

A call on DTensors (``sharded``) runs the wrapper on each rank's local
shards through ``local_map``, sharded along the dims the kernel computes
independently (batch rows, heads); an input sharded any other way, or a
partial sum, is redistributed first, and the counter sees those
collectives.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.recompute import PlainRecompute, needs_grad
from repro_torch.roofline import cost

__all__ = ["call", "is_fake", "is_sharded", "sharded"]

Work = Tuple[float, float]


def is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(t)


def is_sharded(*tensors) -> bool:
    """Whether any of ``tensors`` is a DTensor."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return False
    return any(isinstance(t, DTensor) for t in tensors)


def call(name: str, work: Callable[[], Work], launch: Callable,
         plain: Callable, shape_only: Callable, kwargs: Dict,
         *inputs: torch.Tensor, differentiable: bool = True):
    """Run ``launch``, ``plain`` or ``shape_only`` on ``inputs`` (with
    ``kwargs``) by the route the module docstring gives; ``work()`` is
    the call's (flops, bytes). The three return the same structure: one
    tensor or a tuple of them. A kernel that is not ``differentiable``
    (decode attention, the DQN kernels) never takes the recompute
    route: only its plain version on the CPU records a gradient."""
    first = inputs[0]
    if is_fake(first):
        fwd = shape_only
    elif first.device.type == "cpu":
        fwd = plain
    else:
        fwd = launch
    grad = differentiable and needs_grad(*inputs)
    counter = cost.active()
    named, quiet = None, contextlib.nullcontext()
    if counter is not None:
        flops, nbytes = work()
        counter.kernel(name, flops, nbytes)
        named, quiet = (name, flops), counter.suspended()
        if fwd is plain:
            # the kernel's layout (the plain version may return a view),
            # and a gradient through PlainRecompute, which counts it
            fwd = _dense(plain)
    with quiet:
        if grad and fwd is not plain:
            return _one(PlainRecompute.apply(named, fwd, plain, kwargs,
                                             *inputs))
        return fwd(*inputs, **kwargs)


def _dense(fn: Callable) -> Callable:
    """``fn`` with its outputs made contiguous, as a kernel writes them."""
    def dense(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return out.contiguous()
        return tuple(o.contiguous() for o in out)
    return dense


def _one(outs: tuple):
    """A Function's outputs as the kernel returns them: one tensor, or
    the tuple of several."""
    return outs[0] if len(outs) == 1 else outs


def sharded(fn: Callable, labels: Sequence[Optional[Tuple]],
            out_labels, *args):
    """``fn(*args)`` on each rank's local shards. ``labels[i]`` names
    each dim of the i-th argument (None for a non-tensor argument); a
    dim whose name is None must be whole on every rank, and dims that
    share a name are sharded together. ``out_labels`` names the dims of
    the output, or is a tuple of such names for a tuple of outputs.
    The placements follow the first argument's: a mesh dim on which it
    is sharded along a named dim shards every argument and output along
    that name, if each such dim divides by the ways it is split;
    otherwise everything is whole on that mesh dim.

    A dim named ``"kv"`` holds the key/value heads of grouped-query
    attention, each serving a group of the ``"h"`` (query) heads. It
    follows ``"h"``: sharded the same ways where it divides by them;
    where the ways are a multiple of it instead, each rank's query heads
    all fall in one group, so that argument stays whole and ``fn`` gets
    the rank's one KV head (its gradient a partial sum over the ranks
    that share the head)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lead = args[0]
    mesh = lead.device_mesh
    chosen, ways = [], {}
    for i, p in enumerate(lead.placements):
        name = labels[0][p.dim] if isinstance(p, Shard) else None
        n = ways.get(name, 1) * mesh.size(i)
        ok = name is not None and all(
            lab is None or name not in lab or a.shape[lab.index(name)] % n == 0
            for a, lab in zip(args, labels))
        if ok and name == "h":
            ok = all(lab is None or "kv" not in lab
                     or n % a.shape[lab.index("kv")] == 0
                     or a.shape[lab.index("kv")] % n == 0
                     for a, lab in zip(args, labels))
        if ok:
            ways[name] = n
        chosen.append(name if ok else None)
    # the "kv" dims that divide by the query heads' ways shard with them;
    # the others stay whole and are narrowed to the rank's KV head
    n_h = ways.get("h", 1)
    narrow = {j for j, (a, lab) in enumerate(zip(args, labels))
              if lab is not None and "kv" in lab
              and a.shape[lab.index("kv")] % n_h}

    def placements(lab, j=None):
        return [Shard(lab.index(n)) if n is not None and n in lab
                else Shard(lab.index("kv"))
                if n == "h" and "kv" in lab and j not in narrow
                else Replicate() for n in chosen]

    in_pl = tuple(placements(lab, j) if lab is not None else None
                  for j, lab in enumerate(labels))
    if out_labels and isinstance(out_labels[0], tuple):
        out_pl = tuple(placements(lab) for lab in out_labels)
    else:
        out_pl = placements(out_labels)
    # plain tensors among the arguments are whole on every rank
    args = tuple(DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
                 if isinstance(a, torch.Tensor)
                 and not isinstance(a, DTensor) and lab is not None else a
                 for a, lab in zip(args, labels))
    local, grad_pl = fn, None
    if narrow:
        coord = mesh.get_coordinate()
        rank = 0                       # this rank's index among the h ways
        for i, n in enumerate(chosen):
            if n == "h":
                rank = rank * mesh.size(i) + coord[i]
        grad_pl = tuple(
            None if lab is None else
            [Partial() if j in narrow and n == "h" else p
             for n, p in zip(chosen, in_pl[j])]
            for j, lab in enumerate(labels))

        def local(*xs):
            xs = list(xs)
            for j in narrow:
                dim = labels[j].index("kv")
                head = rank * xs[j].shape[dim] // n_h
                xs[j] = xs[j].narrow(dim, head, 1)
            return fn(*xs)
    return local_map(local, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
