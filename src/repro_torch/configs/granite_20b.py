"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-style code model. [arXiv:2405.04324]

kv=1 (multi-query attention): the single KV head cannot be sharded over
the 16-way model axis — KV projections and cache are replicated over
"model" while Q heads shard 48/16=3 per device (see sharding rules).
"""

from repro_torch.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-20b",
    family="dense",
    citation="arXiv:2405.04324",
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    superblock=(ATTN,),
    n_superblocks=52,
    max_context=8192,
    sliding_window=4096,
)
