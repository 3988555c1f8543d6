"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

Backbone only, per assignment: the vision tower (ViT) + projector is a
STUB — ``input_specs()`` supplies precomputed patch embeddings of shape
(batch, vision_tokens, d_model). The released model inserts a
cross-attention layer every 5th block; we scan 8 superblocks of
(4 x self-attn + 1 x cross-attn) = 40 layers.
"""

from repro_torch.config import ATTN, CROSS_ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    superblock=(ATTN, ATTN, ATTN, ATTN, CROSS_ATTN),
    n_superblocks=8,
    vision_tokens=1601,      # one tile of 1601 patch tokens (stubbed tower)
    rope_theta=500_000.0,
    max_context=131_072,
    sliding_window=4096,
)
