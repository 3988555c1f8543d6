"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k context, head_dim=128.
[hf:mistralai/Mistral-Nemo-Base-2407]
"""

from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-nemo-12b",
    family="dense",
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,           # Nemo uses head_dim 128 (n_heads*head_dim != d_model)
    d_ff=14336,
    vocab=131072,
    superblock=(ATTN,),
    n_superblocks=40,
    rope_theta=1_000_000.0,
    max_context=131_072,
    sliding_window=4096,    # long_500k sub-quadratic decode variant
)
