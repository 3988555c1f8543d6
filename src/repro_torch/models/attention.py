"""GQA attention of the transformer stack: the port of
``repro.models.attention``.

Layouts: q (B, S, H, D); k/v (B, S, Hkv, D); caches (B, Hkv, L, D).

``causal_attention`` and ``decode_attention`` call the kernel ops
(flash attention and decode attention): on the card their kernels, on
the CPU their plain versions, which take the place of the reference's
dense and blocked XLA variants. ``bidirectional_attention`` (whisper's
encoder, cross-attention) is plain tensor ops on every device, as the
reference computes it outside any Pallas kernel. ``cache_update``
writes one step's K/V in place, at a slot computed on the device, so
the decode loop never waits for the card.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops, route


def repeat_kv(kv: torch.Tensor, n_heads: int, head_axis: int) -> torch.Tensor:
    n_kv = kv.shape[head_axis]
    if n_kv == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // n_kv, dim=head_axis)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention with GQA (kernel 3): q (B, S, H, D), k/v
    (B, S, Hkv, D) -> (B, S, H, D)."""
    return ops.flash_attention(q, k, v, causal=True, window=window)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention with GQA: q (B, Sq, H, D), k/v (B, Sk, Hkv,
    D) -> (B, Sq, H, D). The scores are taken in the inputs' type, then
    scaled and normalized in float32, and the probabilities cast back
    before the product with v, as the reference does."""
    H, D = q.shape[2], q.shape[3]
    k = repeat_kv(k, H, 2).transpose(1, 2)              # (B, H, Sk, D)
    v = repeat_kv(v, H, 2).transpose(1, 2)
    scores = torch.matmul(q.transpose(1, 2), k.transpose(2, 3))
    probs = torch.softmax(scores.to(torch.float32) * D ** -0.5, dim=-1)
    return torch.matmul(probs.to(q.dtype), v).transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, Hkv, L, D); cache_len: () int32 count
    of valid entries (kernel 4). A ring cache passes cache_len > L once
    it has wrapped: every slot < min(cache_len, L) is valid, and order is
    irrelevant to attention. Returns (B, 1, H, D)."""
    return ops.decode_attention(q, k_cache, v_cache, cache_len)


def cache_slot(pos: torch.Tensor, L: int, ring: bool) -> torch.Tensor:
    """The (1,) int64 cache slot of absolute position ``pos``, computed on
    pos's device: ``pos % L`` for a ring cache, ``min(pos, L - 1)``
    otherwise."""
    pos = pos.to(torch.int64).reshape(1)
    return torch.remainder(pos, L) if ring else torch.clamp(pos, max=L - 1)


@contextlib.contextmanager
def _one_writer_per_element():
    """Lift ``torch.use_deterministic_algorithms`` around a copy that
    writes each element once. A one-index ``index_copy_`` is deterministic
    by construction, but under the flag torch routes it on the card
    through a sort-based ``index_put_`` of about ten kernels, which the
    decode step would pay twice per layer."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor,
                slot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one step's K/V (B, 1, Hkv, D) at cache slot ``slot`` ((1,)
    int64 on the device), in place: one ``index_copy_`` kernel per cache,
    free of host syncs, and deterministic (one index, so one writer per
    element)."""
    if slot.numel() != 1:
        raise ValueError(f"one cache slot expected, got {tuple(slot.shape)}")
    if route.is_sharded(k_cache, v_cache, k_new, v_new, slot):
        return _sharded_cache_write(k_cache, v_cache, k_new, v_new, slot)
    with _one_writer_per_element():
        k_cache.index_copy_(2, slot, k_new.transpose(1, 2).to(k_cache.dtype))
        v_cache.index_copy_(2, slot, v_new.transpose(1, 2).to(v_cache.dtype))
    return k_cache, v_cache


def _sharded_cache_write(k_cache, v_cache, k_new, v_new, slot):
    """``cache_write`` on DTensor caches (the dry run): each rank writes
    its shard in place. The new K/V take the caches' batch and head
    sharding; where the caches' L dim is sharded (``kv_seq_shard``) a
    rank writes the slot only if its shard holds it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding.rules import local_offset
    mesh = k_cache.device_mesh
    cpl = list(k_cache.placements)
    npl = [Shard(0) if p == Shard(0) else Shard(2) if p == Shard(1)
           else Replicate() for p in cpl]
    whole = [Replicate()] * mesh.ndim
    local_len, offset = local_offset(k_cache.shape, mesh, cpl)
    split_l = local_len[2] != k_cache.shape[2]

    def write(kc, vc, kn, vn, s):
        if split_l:
            i = s - offset[2]
            held = (i >= 0) & (i < kc.shape[2])
            i = i.clamp(0, kc.shape[2] - 1)
            kn = torch.where(held, kn.transpose(1, 2).to(kc.dtype),
                             kc.index_select(2, i)).transpose(1, 2)
            vn = torch.where(held, vn.transpose(1, 2).to(vc.dtype),
                             vc.index_select(2, i)).transpose(1, 2)
            s = i
        return cache_write(kc, vc, kn, vn, s)

    if not isinstance(slot, DTensor):
        slot = DTensor.from_local(slot, mesh, whole, run_check=False)
    return local_map(write, out_placements=(cpl, cpl),
                     in_placements=(cpl, cpl, npl, npl, whole),
                     device_mesh=mesh, redistribute_inputs=True)(
        k_cache, v_cache, k_new, v_new, slot)


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, ring: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one step's K/V (B, 1, Hkv, D) at absolute position ``pos``
    (a device int32 scalar). Ring caches wrap modulo the window length.
    Unlike the reference, which returns new arrays, the caches are
    written in place and returned."""
    return cache_write(k_cache, v_cache, k_new, v_new,
                       cache_slot(pos, k_cache.shape[2], ring))
