"""Configuration dataclasses (the port's copy of the parts of
``repro.config`` that the DQN trainer and the LLM serve path read).

``VariantConfig``, ``DQNConfig``, the block kinds, ``MoEConfig``,
``SSMConfig``, ``XLSTMConfig`` and ``ModelConfig`` carry the same fields,
defaults, properties and validation as the reference, so a config
compares field for field. ``ExecConfig`` keeps every field so that an
``ExperimentSpec`` JSON parses unchanged; of its knobs the port reads
``compute_dtype``, ``vocab_pad``, ``mlstm_chunked``, ``moe_impl``,
``fsdp`` and ``kv_seq_shard`` (the last three in the sharding rules and
the expert-parallel MoE). ``ShapeConfig``, the four input shapes and
``MeshConfig`` are the reference's, for the dry run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ExecConfig", "VariantConfig", "DQNConfig", "ATTN", "CROSS_ATTN",
           "MAMBA2", "MLSTM", "SLSTM", "BLOCK_KINDS", "MoEConfig",
           "SSMConfig", "XLSTMConfig", "ModelConfig", "ShapeConfig",
           "INPUT_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K", "MeshConfig"]


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution-strategy knobs, orthogonal to the architecture."""

    use_pallas: bool = False
    interpret: bool = False
    kernel_backend: str = "auto"
    compute_dtype: str = "bfloat16"
    remat: bool = False
    block_q: int = 512
    vocab_pad: int = 256
    moe_impl: str = "scatter"
    fsdp: bool = False
    kv_seq_shard: bool = False
    slstm_unroll: int = 1
    mlstm_chunked: bool = True
    decode_grouped: bool = True

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / step configuration for the LLM training path."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True            # activation checkpointing per superblock
    microbatch: int = 0           # 0 = no gradient accumulation


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    """Off-policy DQN variant family: double Q-learning, dueling heads,
    proportional prioritized replay, n-step returns, C51 and NoisyNet,
    each independently toggleable (docs/variants.md is the matrix)."""

    name: str = "dqn"
    double: bool = False
    dueling: bool = False
    prioritized: bool = False
    n_step: int = 1
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    per_beta_anneal_steps: int = 1_000_000
    per_eps: float = 1e-3
    distributional: bool = False
    num_atoms: int = 51
    v_min: float = -10.0
    v_max: float = 10.0
    noisy: bool = False
    noisy_sigma0: float = 0.5

    def validate(self) -> None:
        assert self.n_step >= 1, self.n_step
        assert 0.0 <= self.per_alpha <= 1.0, self.per_alpha
        assert 0.0 <= self.per_beta0 <= 1.0, self.per_beta0
        assert self.num_atoms >= 1, self.num_atoms
        assert self.v_max >= self.v_min, (self.v_min, self.v_max)
        if self.distributional:
            assert self.num_atoms >= 2, "C51 needs a non-degenerate support"
        assert self.noisy_sigma0 >= 0.0, self.noisy_sigma0


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Paper hyperparameters (Mnih et al. 2015 / Table 5 of the paper)."""

    minibatch_size: int = 32
    replay_capacity: int = 1_000_000
    target_update_period: int = 10_000   # C
    train_period: int = 4                # F
    discount: float = 0.99
    prepopulate: int = 50_000            # N
    learning_rate: float = 2.5e-4
    rmsprop_decay: float = 0.95
    rmsprop_eps: float = 0.01
    rmsprop_centered: bool = True
    eps_start: float = 1.0
    eps_end: float = 0.1
    eps_anneal_steps: int = 1_000_000
    eval_eps: float = 0.05
    n_envs: int = 8                      # W sampler streams
    frame_stack: int = 4
    concurrent: bool = True
    synchronized: bool = True
    variant: VariantConfig = VariantConfig()

    @property
    def updates_per_cycle(self) -> int:
        return self.target_update_period // self.train_period  # C / F


# ---------------------------------------------------------------------------
# Block kinds understood by the transformer stack
# ---------------------------------------------------------------------------
ATTN = "attn"            # causal self-attention (GQA) + MLP
CROSS_ATTN = "cross_attn"  # causal self-attn + cross-attn to memory + MLP
MAMBA2 = "mamba2"        # Mamba2 SSM block (no separate MLP)
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block
BLOCK_KINDS = (ATTN, CROSS_ATTN, MAMBA2, MLSTM, SLSTM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts MLP configuration."""

    n_experts: int
    top_k: int
    n_shared_experts: int = 0   # always-active experts (qwen2-moe style)
    # expert weight stacks padded to this count (dead weight); 0 = none
    pad_to: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style state-space block configuration."""

    state_dim: int = 64          # N: per-channel state size
    expand: int = 2              # inner dim = expand * d_model
    head_dim: int = 64           # channels per SSM head
    conv_width: int = 4          # depthwise conv kernel size
    chunk: int = 128             # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block configuration (arXiv:2405.04517)."""

    expand: int = 2              # mLSTM inner expansion
    conv_width: int = 4
    proj_factor_slstm: float = 4.0 / 3.0  # sLSTM post-FFN factor
    chunk: int = 64              # chunkwise-parallel mLSTM block length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A full architecture description."""

    arch_id: str
    family: str                  # dense | moe | hybrid | vlm | ssm | audio
    citation: str

    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # layer stack: superblock repeated n_superblocks times
    superblock: Tuple[str, ...]
    n_superblocks: int

    head_dim: Optional[int] = None       # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # encoder-decoder (whisper): a non-causal encoder stack feeding
    # cross-attention in the decoder superblocks.
    n_encoder_layers: int = 0
    encoder_seq: int = 0          # fixed encoder context (audio frames)

    # VLM: cross-attention memory provided by the (stubbed) vision tower.
    vision_tokens: int = 0        # patch-embedding sequence length

    # long-context decode: sliding-window KV ring buffer length
    sliding_window: int = 4096

    # max positional extent advertised by the config (informational)
    max_context: int = 131_072

    mlp_kind: str = "swiglu"      # swiglu | gelu (whisper)
    pos_kind: str = "rope"        # rope | learned (whisper)
    learned_pos_len: int = 0      # table size when pos_kind == "learned"
    # zamba2-style weight sharing: one attention block's parameters reused
    # by every ATTN slot in the stack (cache stays per-invocation)
    shared_attention: bool = False

    @property
    def n_layers(self) -> int:
        return len(self.superblock) * self.n_superblocks

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def has_cross_attention(self) -> bool:
        return CROSS_ATTN in self.superblock

    @property
    def cross_memory_len(self) -> int:
        if self.is_encoder_decoder:
            # conv frontend downsamples 2x in whisper
            return self.encoder_seq // 2
        return self.vision_tokens

    @property
    def attention_free(self) -> bool:
        return not any(k in (ATTN, CROSS_ATTN) for k in self.superblock)

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "hybrid", "vlm", "ssm", "audio"), self.family
        assert all(k in BLOCK_KINDS for k in self.superblock), self.superblock
        assert self.n_heads % self.n_kv_heads == 0
        if self.moe is not None:
            assert self.moe.top_k <= self.moe.n_experts
        if MAMBA2 in self.superblock:
            assert self.ssm is not None
        if MLSTM in self.superblock or SLSTM in self.superblock:
            assert self.xlstm is not None
        if CROSS_ATTN in self.superblock:
            assert self.cross_memory_len > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Production mesh description."""

    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")
