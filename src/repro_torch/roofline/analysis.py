"""Roofline terms from the cost counter: the port of
``repro.roofline.analysis``.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM5, 700 W), from NVIDIA's
data sheet, dense rates without sparsity: 989.4 TFLOP/s bf16 on the
tensor cores, 66.9 TFLOP/s float32 outside them, 3.35 TB/s of HBM3.
Collectives: NVLink gives 450 GB/s per direction between the 8 cards of
a node; across nodes each card has one 400 Gb/s NIC, 50 GB/s. The
production meshes (16x16 and 2x16x16) span 32 and 64 nodes, so their
collective term takes the NIC's figure. A card set below 700 W runs
slower than these rates.

The counter (``roofline.cost.CostCounter``) counts per device, so

  compute term    = flops_per_device / peak_flops
  memory term     = bytes_per_device / hbm_bw
  collective term = collective_bytes_per_device / coll_bw

a first-order model, good enough to name the dominant term and to track
it across changes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

HW = {
    "name": "NVIDIA H100 80GB HBM3 (SXM5, 700 W)",
    "peak_flops": 989.4e12,     # bf16 dense FLOP/s per card
    "peak_flops_f32": 66.9e12,  # float32 FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,          # bytes/s per card
    "nvlink_bw": 450e9,         # bytes/s per direction inside a node
    "coll_bw": 50e9,            # bytes/s per card across nodes (the NIC)
}


def collective_bytes(counter) -> Dict[str, float]:
    """Per-device collective traffic by kind (cost-weighted bytes), as
    the counter saw it."""
    return dict(counter.collectives)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes: float) -> Dict[str, float]:
    t_compute = flops_per_device / HW["peak_flops"]
    t_memory = bytes_per_device / HW["hbm_bw"]
    t_coll = coll_bytes / HW["coll_bw"]
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dominant}


def model_flops(cfg, tokens: int, kind: str,
                param_counts: Optional[Dict[str, int]] = None):
    """Useful model FLOPs: 6·N·D for training, 2·N·D for inference, with
    N = active parameters (MoE experts scaled by top_k/n_experts).
    Returns (flops, total parameters, active parameters)."""
    from repro_torch.models import params as PM
    from repro_torch.models.transformer import model_param_spec

    spec = model_param_spec(cfg)
    total = 0
    active = 0
    for _, leaf in PM._leaves(spec):
        n = 1
        for s in leaf.shape:
            n *= s
        total += n
        if "experts" in leaf.axes and cfg.moe is not None:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens, total, active


def lookup_params(cfg) -> int:
    """Parameters that a step only gathers rows of and never multiplies:
    the input embedding where it is not tied to the unembedding, and the
    learned position tables."""
    from repro_torch.models import params as PM
    from repro_torch.models.transformer import model_param_spec

    n = 0
    for path, leaf in PM._leaves(model_param_spec(cfg)):
        if (path == ("embed",) and not cfg.tie_embeddings) \
                or leaf.axes[0] == "pos":
            n += math.prod(leaf.shape)
    return n


def useful_flops(cfg, tokens: int, kind: str) -> float:
    """The useful flops of a share of peak (``mfu``): ``model_flops``
    less its multiple of the lookup tables (``lookup_params``), which
    are gathered, not multiplied. ``model_flops`` keeps the reference's
    count, which takes them as products (mistral-nemo-12b's 8 x 1024
    prefill: 1.10e13 of 2.01e14), for the dry run's parity."""
    mult = 6.0 if kind == "train" else 2.0
    return model_flops(cfg, tokens, kind)[0] \
        - mult * lookup_params(cfg) * tokens


def mfu(useful_flops: float, seconds: float, cards: int = 1) -> float:
    """Model-FLOPs utilisation: useful flops (``useful_flops``) over what
    ``cards`` H100s could do at the bf16 peak in ``seconds``."""
    return useful_flops / (seconds * cards * HW["peak_flops"])


def masked_pairs(cfg, shape, data_ways: int, model_ways: int = 16,
                 heads_sharded: bool = True, remat: bool = True) -> float:
    """Flops a device's attention spends, in the reference's dry run, on
    the (query, key) pairs a causal mask drops: its attention is XLA's
    blocked einsum over every pair, where the port's flash kernel counts
    the kept pairs. For a ``ShapeConfig`` of a prefill or train step
    (decode has none) with the batch split ``data_ways`` and the heads
    ``model_ways`` (where they divide and ``heads_sharded``); a train
    step counts its attention 4 times with ``remat`` (the forward, the
    checkpointed forward again, a backward of twice the forward), else
    3."""
    from repro_torch.config import ATTN, CROSS_ATTN
    layers = cfg.n_superblocks * sum(k in (ATTN, CROSS_ATTN)
                                     for k in cfg.superblock)
    if shape.kind == "decode" or not layers:
        return 0.0
    heads = cfg.n_heads
    if heads_sharded and heads % model_ways == 0:
        heads //= model_ways
    batch = shape.global_batch
    if batch % data_ways == 0:
        batch //= data_ways
    S = shape.seq_len
    once = (4 * cfg.resolved_head_dim * batch * heads * layers
            * (S * S - S * (S + 1) // 2))
    return once * ((4 if remat else 3) if shape.kind == "train" else 1)
