"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base (family card)]
"""

from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-8b",
    family="dense",
    citation="hf:ibm-granite/granite-3.0-2b-base",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    superblock=(ATTN,),
    n_superblocks=40,
    tie_embeddings=True,
    max_context=4096,
    sliding_window=4096,
)
