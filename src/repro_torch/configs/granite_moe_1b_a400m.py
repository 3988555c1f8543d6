"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
(per expert) vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""

from repro_torch.config import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    superblock=(ATTN,),
    n_superblocks=24,
    moe=MoEConfig(n_experts=32, top_k=8),
    tie_embeddings=True,
    max_context=4096,
)
