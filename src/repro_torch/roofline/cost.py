"""A per-device cost counter: the counterpart of ``repro.roofline.hlo_cost``.

The reference walks a compiled SPMD module's HLO text; here the program
is eager PyTorch, so ``CostCounter`` is a ``TorchDispatchMode`` that
sees every aten op a rank runs and counts, per device:

* flops: a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``convolution`` and its backward) costs 2 x |result| x the contracted
  dims; an elementwise op (aten's ``pointwise`` tag) |result|, but for
  a copy (``clone``, ``copy_``), which computes nothing, as the
  reference's walker counts XLA's copies; a reduction |operand|;
* bytes: the operands plus the results of every op that runs a kernel
  (eager torch runs one per op: the walker's "top-level op"); views,
  aliases and allocations move nothing;
* collective bytes: the result of each collective, all-reduce weighted
  2x (a ring's reduce-scatter and all-gather), by the reference's names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``);
* the peak of the bytes that the counted ops' results hold alive
  (``peak_bytes``), which the dry run adds to the arguments' bytes.

**Local shards.** A DTensor op is left to DTensor (the mode returns
``NotImplemented`` for it), which runs it on the local shards, and the
mode counts those local ops and the collectives DTensor issues to
redistribute. DTensor's sharding propagation also runs each op once at
its global shape on fake tensors to learn the output's shape; those ops
are not counted. So a product sharded N ways counts 1/N of its global
flops on each device, and replicated work counts in full.

**Kernels.** The port's kernels launch through ``ctypes``, which no
dispatch mode sees. Each kernel wrapper reports its analytic flops and
bytes (``kernel``; the formulas of PERF.md's bound column) and the mode
ignores the aten ops the wrapper runs inside (``suspended``): the plain
version's on a CPU tensor, the launch's bookkeeping on a card tensor,
the shape-only branch on a fake tensor. A step therefore counts the same
on each of the three.

Enter the mode inside ``FakeTensorMode`` (``with fake_mode, counter:``)
so that it sees each op before the fake mode computes its shape.
"""

from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

__all__ = ["CostCounter", "active", "kernel", "quiet", "COLLECTIVES"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLL_FACTOR = {"all-reduce": 2.0}
# collective op names (functional and in-place c10d) -> the reference's kind
_COLL_KIND = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced":
    "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution",
             "convolution_backward"}
# pointwise-tagged ops that only move data
_COPIES = {"clone", "copy", "copy_"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "logsumexp", "var", "var_mean", "std", "std_mean", "norm",
    "linalg_vector_norm", "any", "all", "cumsum", "cumprod", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "topk", "sort", "nll_loss_forward", "nll_loss_backward",
}
# ops that run no kernel: views and aliases are caught by ``is_view``
_NO_KERNEL = {"detach", "alias", "empty", "empty_strided", "empty_like",
              "new_empty", "new_empty_strided", "lift_fresh", "device",
              "_local_scalar_dense", "wait_tensor", "set_", "resize_",
              "_unsafe_view", "unsqueeze_", "squeeze_", "as_strided_",
              "t_", "transpose_"}


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _held(t: torch.Tensor) -> int:
    """The bytes a result holds alive: its storage's."""
    return t.untyped_storage().nbytes() if t.layout == torch.strided \
        else _nbytes(t)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _product_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addbmm"):
        return 2.0 * out.numel() * args[1].shape[-1] + out.numel()
    if name == "convolution":
        # weight (C_out, C_in / groups, *kernel)
        return 2.0 * out.numel() * _numel(args[1].shape[1:])
    # convolution_backward(grad_out, input, weight, ..., groups, mask):
    # each of grad_input and grad_weight costs one forward product
    grad_out, weight, mask = args[0], args[2], args[-1]
    fwd = 2.0 * grad_out.numel() * _numel(weight.shape[1:])
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


class CostCounter(TorchDispatchMode):
    """Counts the flops, bytes, collectives and ops a rank runs while the
    mode is active (the module docstring). ``ops`` counts each aten op and
    each kernel call (``kernel.<name>``) by name."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
        self.ops: Dict[str, int] = collections.Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._suspended = 0
        self._patched = None

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {k: v for k, v in self.collectives.items()
                                if v},
                "collective_bytes": self.collective_bytes,
                "ops": dict(self.ops), "peak_bytes": self.peak_bytes}

    @contextlib.contextmanager
    def suspended(self) -> Iterator[None]:
        """Count none of the ops run inside (results still take memory)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def mark(self) -> tuple:
        """What the counter holds now, for ``repeat``; from here the
        peak is that of the ops that follow (``repeat`` restores it)."""
        held = (self.flops, self.bytes, dict(self.collectives),
                collections.Counter(self.ops), self.peak_bytes)
        self.peak_bytes = self.live_bytes
        return held

    def repeat(self, mark: tuple, times: int, kept=()) -> None:
        """Count what was counted since ``mark`` ``times`` more times: a
        loop whose steps run the same ops on the same shapes, run once
        from the mark. ``kept``, the tensors that step leaves alive, is
        held ``times`` more times, as the skipped steps' would be: on
        top of the step's own peak, and until they are freed."""
        flops, nbytes, colls, ops, peak = mark
        self.flops += times * (self.flops - flops)
        self.bytes += times * (self.bytes - nbytes)
        for k in self.collectives:
            self.collectives[k] += times * (self.collectives[k] - colls[k])
        for k, v in list(self.ops.items()):
            self.ops[k] += times * (v - ops.get(k, 0))
        extra = {id(t): (t, times * _held(t)) for t in _tensors(kept)}
        more = sum(n for _, n in extra.values())
        self.peak_bytes = max(peak, self.peak_bytes + more)
        self.live_bytes += more
        for t, n in extra.values():
            weakref.finalize(t, self._release, n)

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel (or its stand-in), counted by
        its analytic work."""
        if self._suspended:
            return
        self.flops += flops
        self.bytes += nbytes
        self.ops[f"kernel.{name}"] += 1

    def __enter__(self):
        self._patch_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch_propagation()

    def _patch_propagation(self) -> None:
        """Suspend counting around DTensor's global-shape propagation."""
        try:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
        except ImportError:           # no distributed build: no DTensor
            return
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(prop, op_schema):
            with counter.suspended():
                return orig(prop, op_schema)

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._patched = (ShardingPropagator, orig)

    def _unpatch_propagation(self) -> None:
        if self._patched is not None:
            cls, orig = self._patched
            cls._propagate_tensor_meta_non_cached = orig
            self._patched = None

    def _track(self, out) -> None:
        for t in _tensors(out):
            n = _held(t)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            kind = _COLL_KIND.get(name)
            if kind is not None and not self._suspended:
                moved = sum(_nbytes(t) for t in _tensors(out))
                self.collectives[kind] += moved * _COLL_FACTOR.get(kind, 1.0)
                self.ops[f"{ns}.{name}"] += 1
            return out
        if func.is_view or name in _NO_KERNEL or ns == "prim":
            return out
        self._track(out)
        if self._suspended:
            return out
        self.ops[f"{ns}.{name}"] += 1
        outs = list(_tensors(out))
        self.bytes += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                       + sum(_nbytes(t) for t in outs))
        if name in _PRODUCTS:
            self.flops += _product_flops(name, args, outs[0])
        elif name in _REDUCTIONS:
            self.flops += max((t.numel() for t in _tensors(args)), default=0)
        elif (torch.Tag.pointwise in func.tags and outs
              and name not in _COPIES):
            self.flops += outs[0].numel()
        return out


def _is_dtensor_type(t) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return False
    return issubclass(t, DTensor)


def active() -> Optional[CostCounter]:
    """The innermost ``CostCounter`` on this thread's dispatch-mode stack
    (the autograd engine's threads inherit the stack), else None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def kernel(name: str, flops: float, nbytes: float) -> None:
    """Report one kernel call to the active counter, if any."""
    counter = active()
    if counter is not None:
        counter.kernel(name, flops, nbytes)


@contextlib.contextmanager
def quiet() -> Iterator[None]:
    """Suspend the active counter, if any, inside the ``with`` block."""
    counter = active()
    if counter is None:
        yield
        return
    with counter.suspended():
        yield
