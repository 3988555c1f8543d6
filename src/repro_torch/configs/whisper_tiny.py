"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865,
encoder-decoder with conv frontend (STUB). [arXiv:2212.04356]

Per assignment the mel-spectrogram + conv feature extractor is a stub:
``input_specs()`` provides precomputed frame embeddings of shape
(batch, encoder_seq, d_model); the 2x-striding conv yields
encoder_seq//2 = 1500 encoder positions. We implement the 4-layer
non-causal encoder and the 4-layer decoder (self-attn + cross-attn).
"""

from repro_torch.config import CROSS_ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    citation="arXiv:2212.04356",
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    superblock=(CROSS_ATTN,),   # every decoder layer: self-attn + cross-attn
    n_superblocks=4,
    n_encoder_layers=4,
    encoder_seq=3000,           # mel frames; conv stub downsamples 2x -> 1500
    tie_embeddings=True,
    max_context=448,
    sliding_window=448,
    mlp_kind="gelu",
    pos_kind="learned",
    learned_pos_len=32_768,  # sized to the assigned decode workloads; the
                             # released model uses 448 (noted in DESIGN.md)
)
