"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
(per routed expert) vocab=151936, MoE: 4 shared + 60 routed experts top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B]
"""

from repro_torch.config import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    superblock=(ATTN,),
    n_superblocks=24,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4, pad_to=64),
    max_context=32_768,
    sliding_window=4096,
)
