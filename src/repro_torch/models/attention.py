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

``project_kv`` computes K or V. On DTensors whose query heads are
sharded over more ``model`` ways than there are KV heads, a rank
computes only the KV head its query heads read, and ``whole_kv`` gathers
the heads back for a cache.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops, route
from repro_torch.models.layers import linear, split_heads, whole_along


def repeat_kv(kv: torch.Tensor, n_heads: int, head_axis: int) -> torch.Tensor:
    n_kv = kv.shape[head_axis]
    if n_kv == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // n_kv, dim=head_axis)


def _head_dims(q_weight: torch.Tensor) -> list:
    """The mesh dims along which a DTensor query projection (d, H hd)
    shards its heads."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(q_weight, DTensor):
        return []
    return [i for i, p in enumerate(q_weight.placements) if p == Shard(1)]


def project_kv(x: torch.Tensor, w: torch.Tensor, n_kv: int, hd: int,
               q_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K or V heads of x (..., d) by w (d, n_kv hd), in x's type:
    (..., n_kv, hd).

    On DTensors whose query heads (``q_weight``'s columns) are sharded n
    ways, where n is a multiple of n_kv but not a divisor of it
    (mistral's 8 KV heads on 16 ``model`` ranks), w stays whole and each
    rank computes only the hd columns of the KV head its query heads
    read, as XLA's partitioner does. The result then holds n heads, each
    KV head repeated n / n_kv times and sharded n ways: the "kv" heads
    that GQA attention reads (``route.sharded``). ``whole_kv`` gives the
    n_kv heads back, whole on every rank."""
    dims = _head_dims(q_weight) if route.is_sharded(x, w) else []
    mesh = q_weight.device_mesh if dims else None
    n = math.prod(mesh.size(i) for i in dims) if dims else 1
    if n <= n_kv or n % n_kv:
        return split_heads(linear(x, w.to(x.dtype)), n_kv)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    whole = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, whole, run_check=False)
    # x keeps its batch sharding off the head dims; w is whole
    xpl = [p if i not in dims and p == Shard(0) else Replicate()
           for i, p in enumerate(x.placements)]
    ypl = [Shard(x.dim() - 1) if i in dims else p for i, p in enumerate(xpl)]
    # a rank's gradients are its part of the sum over the ranks that
    # share x or w
    xgrad = [Partial() if i in dims else p for i, p in enumerate(xpl)]
    wgrad = [Partial() if i in dims or p == Shard(0) else Replicate()
             for i, p in enumerate(xpl)]

    def local(xl, wl):
        head = route.mesh_rank(mesh, dims) * n_kv // n
        return linear(xl, wl.narrow(1, head * hd, hd).to(xl.dtype))

    y = local_map(local, out_placements=ypl, in_placements=(xpl, whole),
                  in_grad_placements=(xgrad, wgrad), device_mesh=mesh,
                  redistribute_inputs=True)(x, w)
    return y.reshape(*y.shape[:-1], n, hd)


def whole_kv(kv: torch.Tensor, n_kv: int) -> torch.Tensor:
    """``project_kv``'s heads (..., heads, hd) as the n_kv KV heads, whole
    on every rank: repeated heads are gathered (a collective the cost
    counter sees) and one of each kept. Anything else comes back as it
    is."""
    r = kv.shape[-2] // n_kv
    if r == 1:
        return kv
    return whole_along(kv, -2)[..., ::r, :]


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
    before the product with v, as the reference does. On DTensors each
    rank runs it on its batch rows and query heads (``route.sharded``)."""
    if route.is_sharded(q, k, v):
        lab, kv = ("b", None, "h", None), ("b", None, "kv", None)
        return route.sharded(bidirectional_attention, (lab, kv, kv), lab,
                             q, k, v)
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
    irrelevant to attention. Returns (B, 1, H, D). On caches whose L
    dim is sharded (``kv_seq_shard``), ``_decode_over_l_shards``."""
    dims = _l_dims(k_cache)
    if dims:
        return _decode_over_l_shards(q, k_cache, v_cache, cache_len, dims)
    return ops.decode_attention(q, k_cache, v_cache, cache_len)


def _l_dims(cache: torch.Tensor) -> list:
    """The mesh dims along which a DTensor cache (B, Hkv, L, D) shards
    its L dim."""
    if not route.is_sharded(cache):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(cache.placements) if p == Shard(2)]


def _decode_over_l_shards(q, k_cache, v_cache, cache_len, dims):
    """``decode_attention`` on caches whose L positions are split over the
    mesh dims ``dims``: each rank runs the kernel over the valid positions
    of its shard and takes the log-sum-exp of its scores in plain ops
    (the kernel returns none), and the ranks' outputs are combined by
    their softmax weights in float32, by all-reduces over ``dims`` (the
    flash-decoding combine). DTensor alone would gather the caches and
    attend over all L positions on every rank."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    L = k_cache.shape[2]
    whole = [Replicate()] * mesh.ndim
    qpl = [Shard(0) if p == Shard(0) else Replicate()
           for p in k_cache.placements]
    cpl = [Shard(0) if p == Shard(0) else Shard(2) if i in dims
           else Replicate() for i, p in enumerate(k_cache.placements)]
    if not isinstance(cache_len, torch.Tensor):
        cache_len = torch.full((), cache_len, dtype=torch.int32,
                               device=q.device)
    if not isinstance(q, DTensor):
        q = DTensor.from_local(q, mesh, whole, run_check=False)
    if not isinstance(cache_len, DTensor):
        cache_len = DTensor.from_local(cache_len, mesh, whole,
                                       run_check=False)
    groups = [(mesh, i) for i in dims]

    def local(ql, kl, vl, cl):
        B, _, H, D = ql.shape
        Hkv, Ll = kl.shape[1], kl.shape[2]
        start = route.mesh_rank(mesh, dims) * Ll
        n = torch.clamp(torch.clamp(cl, max=L) - start, min=0, max=Ll)
        o = ops.decode_attention(ql, kl, vl, n).to(torch.float32)
        s = torch.einsum("bkgd,bkld->bkgl", ql.reshape(B, Hkv, H // Hkv, D),
                         kl).to(torch.float32) * D ** -0.5
        s = torch.where(torch.arange(Ll, device=ql.device) < n, s,
                        float("-inf"))
        lse = torch.logsumexp(s, dim=-1).reshape(B, 1, H)
        top = lse
        for g in groups:
            top = funcol.wait_tensor(funcol.all_reduce(top, "max", g))
        w = torch.exp(lse - top)                  # 0 for an empty shard
        num = torch.where(w[..., None] > 0, o, 0.0) * w[..., None]
        for g in groups:
            num = funcol.wait_tensor(funcol.all_reduce(num, "sum", g))
            w = funcol.wait_tensor(funcol.all_reduce(w, "sum", g))
        return (num / w[..., None]).to(ql.dtype)

    return local_map(local, out_placements=qpl,
                     in_placements=(qpl, cpl, cpl, whole), device_mesh=mesh,
                     redistribute_inputs=True)(q, k_cache, v_cache,
                                               cache_len)


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
