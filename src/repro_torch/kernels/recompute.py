"""A kernel's gradient by recomputing its plain version.

The reference's kernel ops (``repro.kernels.ops``: flash attention, the
SSD scan, RMSNorm) carry a ``custom_vjp`` whose backward differentiates
the plain version (``kernels/ref.py``) on the saved inputs; the reference
has no backward kernel. ``PlainRecompute`` is that rule in PyTorch: its
forward launches the kernel, its backward runs the plain version on the
saved inputs under ``torch.enable_grad()`` and returns
``torch.autograd.grad`` of it against the incoming cotangents. So the
input gradients are bitwise those of autograd through the plain version
at the same inputs and cotangents, and the backward launches no kernel.

A kernel wrapper takes this route for a CUDA tensor when grad mode is on
and an input requires grad (``needs_grad``); otherwise it launches the
kernel directly, and a CPU tensor runs the plain version, which autograd
already differentiates. Under a ``roofline.cost.CostCounter`` every
device takes it (``kernels/route.py``): the backward then reports the
kernel's ``<name>_backward`` to the counter, twice the forward's flops
and the bytes of the inputs, the cotangents and the input gradients,
and recomputes the plain version with the counter suspended; on fake
tensors it returns empty gradients and computes nothing.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.roofline import cost

__all__ = ["PlainRecompute", "needs_grad"]


def _tuple(out) -> Tuple[torch.Tensor, ...]:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call on these inputs must record a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


class PlainRecompute(torch.autograd.Function):
    """``apply(named, launch, plain, kwargs, *inputs)`` -> a tuple of
    outputs: ``launch(*inputs, **kwargs)`` and ``plain(*inputs,
    **kwargs)`` return the same output tensor, or the same tuple of them;
    ``kwargs`` holds the non-differentiable arguments (flags, sizes) and
    gets no gradient, nor do ``launch`` and ``plain``. ``named`` is the
    kernel's (name, forward flops) where a cost counter is active at the
    forward, else None. Outputs that receive no cotangent are left out of
    the recomputed product."""

    @staticmethod
    def forward(ctx, named: Optional[Tuple[str, float]], launch: Callable,
                plain: Callable, kwargs: Dict,
                *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        ctx.named, ctx.plain, ctx.kwargs = named, plain, kwargs
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return _tuple(launch(*inputs, **kwargs))

    @staticmethod
    def backward(ctx, *cotangents):
        from torch._subclasses.fake_tensor import is_fake
        needs = ctx.needs_input_grad[4:]
        saved = ctx.saved_tensors
        counter = cost.active() if ctx.named is not None else None
        quiet = contextlib.nullcontext()
        if counter is not None:
            name, flops = ctx.named
            counter.kernel(f"{name}_backward", 2 * flops,
                           _nbytes(saved) + _nbytes(cotangents)
                           + _nbytes(t for t, n in zip(saved, needs) if n))
            quiet = counter.suspended()
        with quiet:
            if saved and is_fake(saved[0]):
                grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                         if n else None for t, n in zip(saved, needs)]
            else:
                grads = PlainRecompute.grads(ctx, needs, cotangents)
                if counter is not None:
                    # the layout the counter's bytes assume downstream
                    grads = [None if g is None else g.contiguous()
                             for g in grads]
        return (None, None, None, None, *grads)

    @staticmethod
    def grads(ctx, needs: Sequence[bool], cotangents) -> list:
        """The input gradients: autograd of the plain version on the
        saved inputs against ``cotangents``, None where ``needs`` is
        False."""
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            outs = _tuple(ctx.plain(*leaves, **ctx.kwargs))
            pairs = [(o, g) for o, g in zip(outs, cotangents)
                     if g is not None and o.requires_grad]
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True) if pairs and wanted else ())
        return [next(grads, None) if need else None for need in needs]
