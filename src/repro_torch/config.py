"""Configuration dataclasses of the DQN path (the port's copy of the
fields of ``repro.config`` that the concurrent trainer reads).

``VariantConfig`` and ``DQNConfig`` carry the same fields, defaults and
validation as the reference. ``ExecConfig`` keeps every field so that an
``ExperimentSpec`` JSON parses unchanged; of its knobs the DQN path reads
only ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ExecConfig", "VariantConfig", "DQNConfig"]


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
