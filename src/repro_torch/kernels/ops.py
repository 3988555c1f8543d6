"""The kernel ops of the DQN path, by the names ``repro.kernels.ops``
gives them.

There is one route per device and no backend switch: a CUDA tensor goes
through the op's hand-written kernel (or the call raises), a CPU tensor
through its plain PyTorch version.
"""

from repro_torch.kernels.categorical_projection import (  # noqa: F401
    categorical_projection, support)
from repro_torch.kernels.segment_tree import (  # noqa: F401
    next_pow2, segment_tree_sample, tree_build)

__all__ = ["segment_tree_sample", "categorical_projection", "support",
           "tree_build", "next_pow2"]
