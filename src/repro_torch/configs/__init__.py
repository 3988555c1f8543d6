"""Architecture registry: the port's copy of ``repro.configs``.

Every architecture the reference knows has an id in ``ARCH_IDS``, and
``configs/<module>.py`` defines ``CONFIG: ModelConfig`` for each, copied
from the reference: dense, mixture-of-experts, hybrid (zamba2's Mamba2
with shared attention), recurrent (xlstm's mLSTM and sLSTM), the VLM
and whisper. The DQN network lives in ``configs/dqn_nature.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

_ARCH_MODULES = {
    "mistral-nemo-12b": "mistral_nemo_12b",
    "zamba2-2.7b": "zamba2_2p7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama-3.2-vision-11b": "llama_3p2_vision_11b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "xlstm-125m": "xlstm_125m",
    "granite-20b": "granite_20b",
    "granite-3-8b": "granite_3_8b",
    "whisper-tiny": "whisper_tiny",
    "starcoder2-3b": "starcoder2_3b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch_id: str) -> ModelConfig:
    """Return the full-size ModelConfig for an assigned architecture."""
    if arch_id not in _cache:
        if arch_id not in _ARCH_MODULES:
            raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
        mod = importlib.import_module(
            f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
        cfg: ModelConfig = mod.CONFIG
        cfg.validate()
        _cache[arch_id] = cfg
    return _cache[arch_id]


def reduced_config(arch_id: str) -> ModelConfig:
    """CPU-smoke-testable variant of the same family: <=2 superblocks,
    d_model<=512, <=4 experts, tiny vocab. Shapes shrink; structure stays."""
    cfg = get_config(arch_id)
    d_model = min(cfg.d_model, 128)
    head_dim = 32
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=min(4, moe.n_experts), top_k=min(2, moe.top_k),
            n_shared_experts=min(1, moe.n_shared_experts), pad_to=0)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, state_dim=16, head_dim=16, chunk=16)
    return dataclasses.replace(
        cfg,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab=256,
        n_superblocks=min(2, cfg.n_superblocks),
        n_encoder_layers=min(2, cfg.n_encoder_layers),
        encoder_seq=min(64, cfg.encoder_seq) if cfg.encoder_seq else 0,
        vision_tokens=min(16, cfg.vision_tokens) if cfg.vision_tokens else 0,
        sliding_window=64,
        moe=moe,
        ssm=ssm,
    )
