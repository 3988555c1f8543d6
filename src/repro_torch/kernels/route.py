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

No DTensor reaches a kernel: ``sharding/partition.py`` runs each block
on a rank's local shards.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.recompute import PlainRecompute, needs_grad
from repro_torch.roofline import cost

__all__ = ["call", "is_fake", "is_sharded", "steps"]

Work = Tuple[float, float]


def is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(t)


@functools.lru_cache(maxsize=1)
def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return None
    return DTensor


def is_sharded(*tensors) -> bool:
    """Whether any of ``tensors`` is a DTensor."""
    dtensor = _dtensor_type()
    return dtensor is not None and any(isinstance(t, dtensor)
                                       for t in tensors)


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


def steps(step: Callable, carry, n: int):
    """``([y_0, ..., y_{n-1}], carry)`` of ``y_i, carry = step(i, carry)``
    for i < n, a loop whose steps run the same ops on the same shapes
    (the chunks of a scan). On fake tensors with no gradient under the
    cost counter (the dry run's prefill), steps 0 and 1 run and the
    counter counts step 1 n - 2 more times, the outputs y that those
    steps would keep alive included (``CostCounter.repeat``); their y
    are step 1's. The counts then equal the whole loop's."""
    counter = cost.active()
    once = (counter is not None and n > 2 and not torch.is_grad_enabled()
            and any(is_fake(t) for t in cost._tensors(carry)))
    ys = []
    for i in range(2 if once else n):
        mark = counter.mark() if once and i == 1 else None
        y, carry = step(i, carry)
        ys.append(y)
    if once:
        counter.repeat(mark, n - 2, kept=ys[-1])
        ys += ys[-1:] * (n - 2)
    return ys, carry
