"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, RoPE. [arXiv:2402.19173]
"""

from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-3b",
    family="dense",
    citation="arXiv:2402.19173",
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    superblock=(ATTN,),
    n_superblocks=30,
    rope_theta=999_999.0,
    max_context=16_384,
    sliding_window=4096,
)
