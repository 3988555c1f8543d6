"""Where the body of one block call runs: the rank's place on the mesh,
and the collectives the body issues between its products.

``sharding/partition.py`` runs each block's body on the local shards of
a rank through one ``local_map``; the body takes a ``Ranks`` and does
its products and collectives through it. On plain tensors (one device)
the body gets ``PLAIN``, whose collectives are the identity and whose
products are ``layers.linear``: the single-device path, op for op.

Inside a body every rank computes its own part of the block's output
(a shard, or a partial sum over the ranks), so a gradient that reaches
a tensor inside it is the rank's part of that tensor's gradient. The
collectives' backwards follow that: an all-gather's is a reduce-scatter
(funcol's autograd all-gather), an all-reduce's an all-reduce.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.models.layers import linear


class _AllReduce(torch.autograd.Function):
    """The sum over a process group; its backward sums the ranks' parts
    of the gradient the same way (the module docstring)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol
        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(g, "sum", ctx.group)), None


class Ranks:
    """A rank of ``mesh``: ``model`` is the mesh dim whose ranks split a
    block's work (heads, columns, experts, cache positions), None where
    no dim does; ``split`` the mesh dims over which the rows of a
    weight's ``embed`` axis are split while x is not (``--fsdp`` at a
    batch that does not divide: the contraction is split there)."""

    def __init__(self, mesh=None, model: Optional[int] = None,
                 split: Sequence[int] = ()):
        self.mesh, self.model, self.split = mesh, model, tuple(split)

    def rank(self, dims: Sequence[int]) -> int:
        """This rank's index among the ranks of ``dims``, the first major:
        its shard of a dim DTensor splits over them."""
        coord = self.mesh.get_coordinate()
        rank = 0
        for i in dims:
            rank = rank * self.mesh.size(i) + coord[i]
        return rank

    @property
    def n_model(self) -> int:
        return 1 if self.model is None else self.mesh.size(self.model)

    @property
    def model_rank(self) -> int:
        return 0 if self.model is None else self.rank([self.model])

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' shards of ``t`` side by side along ``dim``."""
        if self.model is None:
            return t
        from torch.distributed import _functional_collectives as funcol
        gather = getattr(funcol, "all_gather_single_autograd", None) or \
            funcol.all_gather_tensor_autograd     # the name before 2.13
        return gather(t.contiguous(), dim % t.dim(), (self.mesh, self.model))

    def reduce(self, t: torch.Tensor, dims: Optional[Sequence[int]] = None
               ) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``dims`` (the model dim by
        default)."""
        dims = ([] if self.model is None else [self.model]) if dims is None \
            else dims
        for i in dims:
            t = _AllReduce.apply(t, (self.mesh, i))
        return t

    def contract(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., d) by w (d_local, n): where w holds the rank's rows of d
        over ``split``, x's columns of them, summed over those ranks."""
        if not self.split:
            return linear(x, w)
        n = w.shape[0]
        x = x.narrow(-1, self.rank(self.split) * n, n)
        return self.reduce(linear(x, w), self.split)

    def contract_batched(self, x: torch.Tensor, w: torch.Tensor
                         ) -> torch.Tensor:
        """``contract`` for a batch of products: x (E, rows, d) by w (E,
        d_local, n)."""
        if not self.split:
            return torch.bmm(x, w)
        n = w.shape[1]
        x = x.narrow(-1, self.rank(self.split) * n, n)
        return self.reduce(torch.bmm(x, w), self.split)


PLAIN = Ranks()
