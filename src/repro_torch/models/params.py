"""Parameter specs: a model declares its parameters as a dict of
:class:`Leaf` (shape, logical axes, initializer) and ``init_tree``
materializes them. The port of ``repro.models.params``; the draws go
through :mod:`repro_torch.rng`, so an init matches the reference's to
float rounding (``normal`` is exact to a few ulps)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng

Tree = Any


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | const
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


def _init_leaf(key: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    dev = key.device
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=dev)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=dev)
    if leaf.init == "const":
        return torch.full(leaf.shape, leaf.value, dtype=leaf.dtype, device=dev)
    fan_in = leaf.fan_in
    if fan_in is None:
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 \
            else leaf.shape[0]
    scale = float(np.float32(1.0 / np.sqrt(max(fan_in, 1))))
    return (scale * rng.normal(key, leaf.shape)).to(leaf.dtype)


def init_tree(spec: Dict[str, Leaf], key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Materialize a flat spec: one key per leaf, split in sorted-name
    order as the reference does."""
    leaves = _leaves(spec)
    keys = rng.split(key, max(len(leaves), 1))
    return {path[-1]: _init_leaf(keys[i], leaf)
            for i, (path, leaf) in enumerate(leaves)}
