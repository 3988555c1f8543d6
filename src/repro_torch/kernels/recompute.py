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
already differentiates.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

__all__ = ["PlainRecompute", "needs_grad"]


def _tuple(out) -> Tuple[torch.Tensor, ...]:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call on these inputs must record a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class PlainRecompute(torch.autograd.Function):
    """``apply(launch, plain, kwargs, *inputs)`` -> a tuple of outputs:
    ``launch(*inputs, **kwargs)`` and ``plain(*inputs, **kwargs)`` return
    the same output tensor, or the same tuple of them; ``kwargs`` holds
    the non-differentiable arguments (flags, sizes) and gets no gradient,
    nor do ``launch`` and ``plain``. Outputs that receive no cotangent
    are left out of the recomputed product."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, kwargs: Dict,
                *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return _tuple(launch(*inputs, **kwargs))

    @staticmethod
    def backward(ctx, *cotangents):
        needs: Sequence[bool] = ctx.needs_input_grad[3:]
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
        return (None, None, None,
                *[next(grads, None) if need else None for need in needs])
