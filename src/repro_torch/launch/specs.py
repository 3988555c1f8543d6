"""Stand-ins for every model input on the ``meta`` device: the dry run's
"no allocation" contract, the port of ``repro.launch.specs``. One
function per workload kind, shaped as the real pipeline produces them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import (ExecConfig, INPUT_SHAPES, ModelConfig,
                                ShapeConfig)
from repro_torch.launch.steps import abstract_cache


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def needs_memory(cfg: ModelConfig) -> bool:
    return cfg.has_cross_attention


def memory_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The stubbed modality frontend's output: patch embeddings (VLM) or
    mel-frame embeddings before the encoder (audio)."""
    m = cfg.cross_memory_len if cfg.is_encoder_decoder else cfg.vision_tokens
    return _meta((batch, m, cfg.d_model), torch.float32)


def train_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32),
             "mask": _meta((B, S), torch.float32)}
    if needs_memory(cfg):
        specs["memory"] = memory_spec(cfg, B)
    return specs


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, S), torch.int32)}
    if needs_memory(cfg):
        specs["memory"] = memory_spec(cfg, B)
    return specs


def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """decode_32k keeps the full 32k KV cache; long_500k uses the
    sliding-window ring buffer (SSM/xLSTM blocks have O(1) state
    either way)."""
    if shape.seq_len > 100_000:
        return cfg.sliding_window
    return shape.seq_len


def decode_is_ring(shape: ShapeConfig) -> bool:
    return shape.seq_len > 100_000


def serve_specs(cfg: ModelConfig, ec: ExecConfig,
                shape: ShapeConfig) -> Dict[str, Any]:
    B = shape.global_batch
    cache = abstract_cache(cfg, ec, B, decode_cache_len(cfg, shape),
                           decode_is_ring(shape))
    return {"cache": cache, "tokens": _meta((B, 1), torch.int32)}


def input_specs(cfg: ModelConfig, ec: ExecConfig,
                shape_name: str) -> Dict[str, Any]:
    return shape_specs(cfg, ec, INPUT_SHAPES[shape_name])


def shape_specs(cfg: ModelConfig, ec: ExecConfig,
                shape: ShapeConfig) -> Dict[str, Any]:
    """``input_specs`` for a ``ShapeConfig`` of any size."""
    if shape.kind == "train":
        return train_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return serve_specs(cfg, ec, shape)
