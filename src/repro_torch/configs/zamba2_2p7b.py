"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64. Mamba2 backbone with shared attention blocks.
[arXiv:2411.15242]

Superblock approximation: the released model interleaves one (shared)
attention block per six blocks; we scan 9 superblocks of
(5 x Mamba2 + 1 x attention) = 54 layers, matching depth and the
mamba:attention ratio. Attention blocks carry the d_ff=10240 MLP; Mamba2
blocks are MLP-free (per the Mamba2 design).
"""

from repro_torch.config import ATTN, MAMBA2, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    citation="arXiv:2411.15242",
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    superblock=(MAMBA2, MAMBA2, MAMBA2, MAMBA2, MAMBA2, ATTN),
    n_superblocks=9,
    ssm=SSMConfig(state_dim=64, expand=2, head_dim=64, conv_width=4, chunk=128),
    max_context=4096,
    shared_attention=True,   # Zamba's single shared attention block

)
