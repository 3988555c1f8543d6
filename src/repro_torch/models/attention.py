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

Everything here runs on one rank's local tensors (``sharding/
partition.py`` places them). Under ``--kv-seq-shard`` a rank's caches
hold its shard of the L positions: ``decode_attention`` then combines
the ranks' outputs by the log-sum-exp the kernel returns, and
``cache_write_shard`` writes a slot only on the rank that holds it.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.ranks import PLAIN, Ranks


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
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     ranks: Ranks = PLAIN, l_dims=(),
                     L: int = 0) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, Hkv, L, D); cache_len: () int32 count
    of valid entries (kernel 4). A ring cache passes cache_len > L once
    it has wrapped: every slot < min(cache_len, L) is valid, and order is
    irrelevant to attention. Returns (B, 1, H, D).

    With ``l_dims`` the caches hold this rank's shard of ``L`` positions,
    split over those mesh dims of ``ranks`` (``kv_seq_shard``): the
    kernel runs over the valid positions of the shard and returns their
    log-sum-exp too, and the ranks' outputs are combined by their softmax
    weights in float32 by all-reduces over ``l_dims`` (the
    flash-decoding combine), so that no rank reads another's cache."""
    if not l_dims:
        return ops.decode_attention(q, k_cache, v_cache, cache_len)
    from torch.distributed import _functional_collectives as funcol
    Ll = k_cache.shape[2]
    start = ranks.rank(l_dims) * Ll
    n = torch.clamp(torch.clamp(cache_len, max=L) - start, min=0, max=Ll)
    o, lse = ops.decode_attention(q, k_cache, v_cache, n, return_lse=True)
    o = o.to(torch.float32)
    groups = [(ranks.mesh, i) for i in l_dims]
    top = lse
    for g in groups:
        top = funcol.wait_tensor(funcol.all_reduce(top, "max", g))
    w = torch.exp(lse - top)                        # 0 for an empty shard
    num = torch.where(w[..., None] > 0, o, 0.0) * w[..., None]
    for g in groups:
        num = funcol.wait_tensor(funcol.all_reduce(num, "sum", g))
        w = funcol.wait_tensor(funcol.all_reduce(w, "sum", g))
    return (num / w[..., None]).to(q.dtype)


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
    with _one_writer_per_element():
        k_cache.index_copy_(2, slot, k_new.transpose(1, 2).to(k_cache.dtype))
        v_cache.index_copy_(2, slot, v_new.transpose(1, 2).to(v_cache.dtype))
    return k_cache, v_cache


def cache_write_shard(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      slot: torch.Tensor, offset: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cache_write`` into caches that hold positions [offset, offset +
    L_local) of the whole cache (``kv_seq_shard``): the slot is written
    only where it falls in the shard (elsewhere its own rows are written
    back)."""
    i = slot - offset
    held = (i >= 0) & (i < k_cache.shape[2])
    i = i.clamp(0, k_cache.shape[2] - 1)
    k_new = torch.where(held, k_new.transpose(1, 2).to(k_cache.dtype),
                        k_cache.index_select(2, i)).transpose(1, 2)
    v_new = torch.where(held, v_new.transpose(1, 2).to(v_cache.dtype),
                        v_cache.index_select(2, i)).transpose(1, 2)
    return cache_write(k_cache, v_cache, k_new, v_new, i)


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
