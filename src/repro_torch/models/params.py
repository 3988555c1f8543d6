"""Parameter specs: a model declares its parameters as a nested dict of
:class:`Leaf` (shape, logical axes, initializer). ``init_tree``
materializes them, ``abstract_tree`` gives tensors on the ``meta``
device (the dry run's stand-ins: no memory) and ``partition_tree`` each
leaf's sharding spec through logical-axis rules. The port of ``repro.models.params``; the draws go
through :mod:`repro_torch.rng`, so an init matches the reference's to
float rounding (``normal`` is exact to a few ulps).

A leaf is drawn in chunks of at most ``DRAW_CHUNK`` elements, each cast
straight into the leaf's dtype: a full-size leaf (mistral-nemo-12b's
stacked MLP weights hold 2.9 G elements) would otherwise need tens of GB
of int64 temporaries. The chunks offset the threefry counters, so a
chunked draw equals the whole one bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng

Tree = Any
DRAW_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | embed | const
    dtype: Any = torch.float32
    fan_in: Optional[int] = None
    value: float = 0.0         # fill value when init == "const"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _leaves(spec: Tree, prefix=()) -> list:
    out = []
    if isinstance(spec, Leaf):
        out.append((prefix, spec))
    elif isinstance(spec, dict):
        for k in sorted(spec):
            out.extend(_leaves(spec[k], prefix + (k,)))
    else:
        raise TypeError(f"bad spec node at {prefix}: {type(spec)}")
    return out


def _build(spec: Tree, fn: Callable[[Tuple[str, ...], Leaf], Any],
           prefix=()) -> Tree:
    if isinstance(spec, Leaf):
        return fn(prefix, spec)
    return {k: _build(v, fn, prefix + (k,)) for k, v in spec.items()}


def _scale(leaf: Leaf) -> float:
    """The normal draw's scale, rounded to float32 as jax applies it."""
    if leaf.init == "embed":
        return float(np.float32(0.02))
    fan_in = leaf.fan_in
    if fan_in is None:
        # contract over all but the last axis by convention
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 \
            else leaf.shape[0]
        # the stacked layer axis does not count toward fan-in
        if leaf.axes and leaf.axes[0] == "layers" and len(leaf.shape) > 2:
            fan_in = int(np.prod(leaf.shape[1:-1]))
    return float(np.float32(1.0 / np.sqrt(max(fan_in, 1))))


def _init_leaf(key: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    dev = key.device
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=dev)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=dev)
    if leaf.init == "const":
        return torch.full(leaf.shape, leaf.value, dtype=leaf.dtype, device=dev)
    scale = _scale(leaf)
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
    flat = out.view(-1)
    n = flat.numel()
    for start in range(0, n, DRAW_CHUNK):
        stop = min(start + DRAW_CHUNK, n)
        flat[start:stop] = (scale * rng.normal(key, (stop - start,),
                                               offset=start)).to(leaf.dtype)
    return out


def init_tree(spec: Tree, key: torch.Tensor) -> Tree:
    """Materialize a spec: one key per leaf, split in sorted-path order as
    the reference does; the tree keeps the spec's nesting."""
    leaves = _leaves(spec)
    keys = rng.split(key, max(len(leaves), 1))
    keymap = {path: keys[i] for i, (path, _) in enumerate(leaves)}
    return _build(spec, lambda path, leaf: _init_leaf(keymap[path], leaf))


def stacked(spec: Tree, n: int) -> Tree:
    """Add a leading 'layers' scan dimension of size n to every leaf."""
    def add(_, leaf: Leaf) -> Leaf:
        return Leaf((n,) + leaf.shape, ("layers",) + leaf.axes,
                    init=leaf.init, dtype=leaf.dtype, fan_in=leaf.fan_in,
                    value=leaf.value)
    return _build(spec, add)


def param_count(spec: Tree) -> int:
    return sum(int(np.prod(leaf.shape)) for _, leaf in _leaves(spec))


def drawn_in(spec: Tree, dtype, keep: Tuple[str, ...] = ()) -> Tree:
    """The spec with every drawn leaf (init ``normal`` or ``embed``)
    stored in ``dtype``; constant leaves (norm gains) and the leaves
    named in ``keep`` keep theirs."""
    return _build(spec, lambda path, leaf: dataclasses.replace(
        leaf, dtype=dtype) if leaf.init in ("normal", "embed")
        and path[-1] not in keep else leaf)


def abstract_tree(spec: Tree) -> Tree:
    """The spec as tensors on the ``meta`` device in each leaf's dtype."""
    return _build(spec, lambda _, leaf: torch.empty(
        leaf.shape, dtype=leaf.dtype, device="meta"))


def partition_tree(spec: Tree, rules: Dict[str, Optional[str]]) -> Tree:
    """Map each leaf's logical axes through ``rules`` to a spec: a tuple
    with, per dim, the mesh-axis name it shards over or None (the
    reference's ``PartitionSpec`` in plain Python). A logical axis absent
    from ``rules`` is replicated; ``rules`` holds divisibility already
    (``sharding/rules.py``)."""
    return _build(spec, lambda _, leaf: tuple(
        rules.get(ax) if ax is not None else None for ax in leaf.axes))


def tree_bytes(tree: Tree) -> int:
    """Bytes of every tensor leaf of a nested dict, list or tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
