"""The port's kernel ops, by the names ``repro.kernels.ops`` gives them.

There is one route per device and no backend switch: a CUDA tensor goes
through the op's hand-written kernel (or the call raises), a CPU tensor
through its plain PyTorch version. The attention and scan ops take the
model's layouts, as the reference's ops do.
"""

from repro_torch.kernels.categorical_projection import (  # noqa: F401
    categorical_projection, support)
from repro_torch.kernels.decode_attention import decode_attention  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401
from repro_torch.kernels.segment_tree import (  # noqa: F401
    next_pow2, segment_tree_sample, tree_build)
from repro_torch.kernels.slstm_scan import slstm_scan  # noqa: F401
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: F401

__all__ = ["segment_tree_sample", "categorical_projection", "support",
           "tree_build", "next_pow2", "rmsnorm", "flash_attention",
           "decode_attention", "ssm_scan", "slstm_scan"]
