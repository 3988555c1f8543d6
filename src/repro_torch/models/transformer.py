"""The composed model: the port of ``repro.models.transformer`` for
every architecture the reference supports: stacks of ATTN (GQA
self-attention + MLP), CROSS_ATTN (self-attention + cross-attention to a
memory + MLP), MAMBA2, MLSTM and SLSTM blocks, zamba2's shared attention
block, mixture-of-experts MLPs, learned positions and whisper's encoder.

A model is ``cfg.superblock`` repeated ``cfg.n_superblocks`` times. The
reference scans over stacked parameters; here a Python loop walks the
same stacked layout, so parameters and caches keep the reference's
paths and shapes and ``convert`` carries them across as they are:
``layers/b0_attn/*`` with a leading ``n_superblocks`` axis, linears as
(d_in, d_out), KV caches (n_sb, B, Hkv, L, hd), cross-attention caches
(n_sb, B, Hkv, M, hd), recurrent states (a tensor or a tuple of tensors)
and conv windows (n_sb, B, W - 1, C). A shared attention block has one
set of weights (``shared_attn``) and a KV cache per superblock.

Public API (as the reference's):
  model_param_spec(cfg, ec)                        -> param spec tree
  init_params(cfg, key, ec)                        -> params on key's device
  forward(cfg, ec, params, tokens, memory=None, collect_cache_len=None)
                                                   -> logits, aux[, cache]
  init_cache(cfg, ec, batch, cache_len, ring, device=...) -> decode cache
  decode_step(cfg, ec, params, cache, tokens, ring) -> logits, cache
  encode(cfg, ec, params, frames)                  -> memory (whisper)
  prefill_cross_cache(cfg, ec, params, cache, memory) -> cache

Drawn parameters (projections, MLP, embed, unembed) are stored in the
compute dtype: the reference stores them in float32 but reads them only
through ``.astype(cdtype)``, so the numbers are the same and a bfloat16
model takes half the memory. Constant leaves (norm gains, the SSM's
A_log, dt_bias and D, biases, the VLM's cross-attention gate), the
sLSTM's recurrent R and the MoE router, which the reference reads in
float32, stay float32. Training keeps every leaf in float32
(``init_params(..., param_dtype=torch.float32)``, the reference's
``TrainConfig.param_dtype``): the forward casts them on read, and
AdamW's small updates are not lost to bfloat16 rounding. A float32 draw
cast to bfloat16 is the bfloat16 leaf bit for bit.

A forward that records a gradient looks tokens (and learned positions)
up in their table by ``index_select``, whose backward (an ``index_add``)
is deterministic on the card under ``torch.use_deterministic_algorithms``;
without a gradient it gathers rows. ``ExecConfig.remat`` checkpoints
each superblock (``torch.utils.checkpoint``), as the reference checkpoints
its scanned body. Decode caches are updated in place.

Each block runs through ``sharding/partition.py``, which on DTensors
runs the block's body here on each rank's local shards (``ranks``: its
place on the mesh) and on plain tensors runs it once. So a body sees
local shapes: its query heads, KV heads, columns and experts are the
rank's (the weights' local widths say how many).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (ATTN, CROSS_ATTN, MAMBA2, MLSTM, SLSTM,
                                ExecConfig, ModelConfig)
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import params as P
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.layers import (gelu_mlp, linear, merge_heads,
                                       rms_norm, rope_tables, rotate,
                                       round_up, split_heads, swiglu)
from repro_torch.sharding import partition as PT
from repro_torch.sharding.ranks import PLAIN, Ranks

Tree = Any
DEFAULT_EXEC = ExecConfig()
ATTN_KINDS = (ATTN, CROSS_ATTN)
# drawn leaves that stay float32 (see the module docstring)
F32_LEAVES = XL.F32_LEAVES + ("router",)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _mlp_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.moe is not None:
        return M.moe_param_spec(cfg)
    if cfg.mlp_kind == "gelu":
        return {
            "w_up": P.Leaf((d, f), ("embed", "mlp"), fan_in=d),
            "b_up": P.Leaf((f,), ("mlp",), init="zeros"),
            "w_down": P.Leaf((f, d), ("mlp", "embed"), fan_in=f),
            "b_down": P.Leaf((d,), ("embed",), init="zeros"),
        }
    return {
        "w_gate": P.Leaf((d, f), ("embed", "mlp"), fan_in=d),
        "w_up": P.Leaf((d, f), ("embed", "mlp"), fan_in=d),
        "w_down": P.Leaf((f, d), ("mlp", "embed"), fan_in=f),
    }


def _attn_spec(cfg: ModelConfig, cross: bool = False) -> Dict[str, P.Leaf]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    spec = {
        "norm1": P.Leaf((d,), ("embed",), init="ones"),
        "wq": P.Leaf((d, H * hd), ("embed", "heads_flat"), fan_in=d),
        "wk": P.Leaf((d, Hkv * hd), ("embed", "kv_flat"), fan_in=d),
        "wv": P.Leaf((d, Hkv * hd), ("embed", "kv_flat"), fan_in=d),
        "wo": P.Leaf((H * hd, d), ("heads_flat", "embed"), fan_in=H * hd),
        "norm2": P.Leaf((d,), ("embed",), init="ones"),
        "mlp": _mlp_spec(cfg),
    }
    if cross:
        spec.update({
            "norm_x": P.Leaf((d,), ("embed",), init="ones"),
            "wq_x": P.Leaf((d, H * hd), ("embed", "heads_flat"), fan_in=d),
            "wk_x": P.Leaf((d, Hkv * hd), ("embed", "kv_flat"), fan_in=d),
            "wv_x": P.Leaf((d, Hkv * hd), ("embed", "kv_flat"), fan_in=d),
            "wo_x": P.Leaf((H * hd, d), ("heads_flat", "embed"),
                           fan_in=H * hd),
        })
        if cfg.family == "vlm":
            # llama-3.2-vision's tanh-gated cross-attention
            spec["gate_x"] = P.Leaf((1,), (None,), init="zeros")
    return spec


def _block_spec(cfg: ModelConfig, kind: str) -> Dict[str, P.Leaf]:
    if kind in ATTN_KINDS:
        return _attn_spec(cfg, cross=kind == CROSS_ATTN)
    if kind == MAMBA2:
        return SSM.mamba2_param_spec(cfg)
    if kind == MLSTM:
        return XL.mlstm_param_spec(cfg)
    if kind == SLSTM:
        return XL.slstm_param_spec(cfg)
    raise ValueError(kind)


def _shared(cfg: ModelConfig, kind: str) -> bool:
    """Whether the block slot reads the shared attention block."""
    return kind == ATTN and cfg.shared_attention


def _scanned_superblock_spec(cfg: ModelConfig) -> Dict[str, Tree]:
    """Per-superblock spec, excluding shared blocks."""
    return {f"b{i}_{kind}": _block_spec(cfg, kind)
            for i, kind in enumerate(cfg.superblock)
            if not _shared(cfg, kind)}


def _encoder_spec(cfg: ModelConfig) -> Dict[str, Tree]:
    """Whisper's encoder: attention layers as a self-attention block's
    but for ``wo``'s fan-in, which the reference declares as d_model,
    learned positions over the memory and a final norm."""
    d = cfg.d_model
    layer = _attn_spec(cfg)
    layer["wo"] = dataclasses.replace(layer["wo"], fan_in=d)
    return {
        "layers": P.stacked(layer, cfg.n_encoder_layers),
        "pos": P.Leaf((cfg.cross_memory_len, d), ("pos", "embed"),
                      init="embed"),
        "final_norm": P.Leaf((d,), ("embed",), init="ones"),
    }


def padded_vocab(cfg: ModelConfig, ec: ExecConfig = DEFAULT_EXEC) -> int:
    return round_up(cfg.vocab, ec.vocab_pad)


def model_param_spec(cfg: ModelConfig, ec: ExecConfig = DEFAULT_EXEC) -> Tree:
    """The reference's spec: the same paths, shapes, axes, initializers,
    fan-ins and (float32) dtypes."""
    d = cfg.d_model
    vpad = padded_vocab(cfg, ec)
    spec: Dict[str, Tree] = {
        "embed": P.Leaf((vpad, d), ("vocab", "embed"), init="embed"),
        "final_norm": P.Leaf((d,), ("embed",), init="ones"),
        "layers": P.stacked(_scanned_superblock_spec(cfg), cfg.n_superblocks),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = P.Leaf((d, vpad), ("embed", "vocab"), fan_in=d)
    if cfg.shared_attention:
        spec["shared_attn"] = _attn_spec(cfg)
    if cfg.pos_kind == "learned":
        spec["pos_embed"] = P.Leaf((cfg.learned_pos_len, d), ("pos", "embed"),
                                   init="embed")
    if cfg.is_encoder_decoder:
        spec["encoder"] = _encoder_spec(cfg)
    return spec


def init_params(cfg: ModelConfig, key: torch.Tensor,
                ec: ExecConfig = DEFAULT_EXEC,
                param_dtype: Optional[torch.dtype] = None) -> Tree:
    """The reference's init for ``key`` on key's device; drawn leaves are
    stored in ``param_dtype`` (float32 for training), by default in the
    compute dtype (see the module docstring)."""
    spec = P.drawn_in(model_param_spec(cfg, ec), param_dtype or ec.cdtype,
                      keep=F32_LEAVES)
    return P.init_tree(spec, key)


def abstract_params(cfg: ModelConfig, ec: ExecConfig = DEFAULT_EXEC) -> Tree:
    """The reference's parameter tree as ``meta`` tensors (its float32
    leaves): the dry run's parameters, no memory."""
    return P.abstract_tree(model_param_spec(cfg, ec))


# ---------------------------------------------------------------------------
# Blocks (full-sequence path)
# ---------------------------------------------------------------------------

def _layer(tree: Tree, i: int) -> Tree:
    """Superblock ``i``'s slice of a stacked tree (views, no copies)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    return {k: _layer(v, i) for k, v in tree.items()}


def _write(dst: Tree, src: Tree) -> None:
    """Copy a block's new recurrent state or conv window (a tensor, a
    tuple or a dict of them) into its cache slot, in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _write(d, s)
    else:
        for k in src:
            _write(dst[k], src[k])


def _ffn(bp, gamma: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
         ec: ExecConfig, ranks: Ranks = PLAIN, batch=()):
    """The MLP on rms_norm(x, gamma): (y, aux), a MoE MLP's auxiliary
    loss, 0.0 for the others. A GELU MLP's output bias is left to the
    caller (``partition.ffn`` adds it once the ranks' parts are summed)."""
    h = rms_norm(x, gamma, cfg.norm_eps)
    if cfg.moe is not None:
        return M.moe_ffn(bp, h, cfg, ec, ranks, batch)
    if cfg.mlp_kind == "gelu":
        return gelu_mlp(h, bp["w_up"], bp["b_up"], bp["w_down"], None,
                        ranks.contract), 0.0
    return swiglu(h, bp["w_gate"], bp["w_up"], bp["w_down"],
                  ranks.contract), 0.0


def _kv_group(n_q: int, cfg: ModelConfig, ranks: Ranks):
    """(first, count) of the KV heads that this rank's n_q query heads
    read, the query heads split over the model ranks."""
    G = cfg.n_heads // cfg.n_kv_heads
    first = ranks.model_rank * n_q
    if G % n_q == 0:
        return first // G, 1
    if n_q % G == 0:
        return first // G, n_q // G
    raise ValueError(f"{n_q} query heads a rank do not cover whole groups "
                     f"of {G}: {cfg.arch_id} on {ranks.n_model} model ranks")


def _kv_weight(w: torch.Tensor, n_q: int, cfg: ModelConfig,
               ranks: Ranks) -> torch.Tensor:
    """The K or V weight's columns for the KV heads that this rank's n_q
    query heads read: all of w's where it holds the rank's shard of the
    KV heads or the rank holds every query head, else those of the
    rank's group (more model ranks than KV heads: mistral's 8 on 16)."""
    hd = cfg.resolved_head_dim
    if n_q == cfg.n_heads or w.shape[1] != cfg.n_kv_heads * hd:
        return w
    first, n = _kv_group(n_q, cfg, ranks)
    return w.narrow(1, first * hd, n * hd)


def _whole_kv(t: torch.Tensor, n_q: int, cfg: ModelConfig,
              ranks: Ranks) -> torch.Tensor:
    """K or V (..., n, hd) of the rank's KV heads as all n_kv heads where
    ``_kv_weight`` took the rank's group (gathered over the model ranks,
    one copy of each head kept); else as it is."""
    if n_q == cfg.n_heads or t.shape[-2] * ranks.n_model == cfg.n_kv_heads:
        return t
    G = cfg.n_heads // cfg.n_kv_heads
    t = ranks.gather(t, -2)
    return t[..., :: G // n_q, :] if G % n_q == 0 else t


def _qkv(bp, x: torch.Tensor, cfg: ModelConfig, ranks: Ranks = PLAIN):
    hd = cfg.resolved_head_dim
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    n_q = bp["wq"].shape[1] // hd
    q = split_heads(ranks.contract(h, bp["wq"].to(h.dtype)), n_q)
    k, v = (split_heads(ranks.contract(h, w.to(h.dtype)), w.shape[1] // hd)
            for w in (_kv_weight(bp[n], n_q, cfg, ranks)
                      for n in ("wk", "wv")))
    return q, k, v


def _self_attention(bp, x: torch.Tensor, rope, cfg: ModelConfig,
                    causal: bool = True, window: Optional[int] = None,
                    collect: bool = False, ranks: Ranks = PLAIN,
                    cdtype=None):
    """The block's output; with ``collect`` also its K and V in the cache
    layout (B, Hkv, S, hd), in ``cdtype``, all KV heads of the rank's
    cache. ``rope``: the stack's ``rope_tables`` for x's positions, None
    where q and k are not rotated (learned positions, the encoder)."""
    q, k, v = _qkv(bp, x, cfg, ranks)
    if rope is not None:
        q = rotate(q, rope)
        k = rotate(k, rope)
    if causal:
        o = A.causal_attention(q, k, v, window=window)
    else:
        o = A.bidirectional_attention(q, k, v)
    o = merge_heads(o)
    out = linear(o, bp["wo"].to(o.dtype))
    if not collect:
        return out
    n_q = q.shape[2]
    return (out,) + tuple(_whole_kv(t, n_q, cfg, ranks).transpose(1, 2)
                          .to(cdtype) for t in (k, v))


def _cross_query(bp, x: torch.Tensor, cfg: ModelConfig,
                 ranks: Ranks = PLAIN) -> torch.Tensor:
    h = rms_norm(x, bp["norm_x"], cfg.norm_eps)
    return split_heads(ranks.contract(h, bp["wq_x"].to(h.dtype)),
                       bp["wq_x"].shape[1] // cfg.resolved_head_dim)


def _memory_kv(bp, memory: torch.Tensor, cfg: ModelConfig,
               ranks: Ranks = PLAIN):
    """A CROSS_ATTN block's K and V of the memory, (B, M, n, hd) each, the
    KV heads the rank's query heads read."""
    hd = cfg.resolved_head_dim
    n_q = bp["wq_x"].shape[1] // hd
    return tuple(split_heads(ranks.contract(memory, w.to(memory.dtype)),
                             w.shape[1] // hd)
                 for w in (_kv_weight(bp[n], n_q, cfg, ranks)
                           for n in ("wk_x", "wv_x")))


def _memory_entry(bp, memory: torch.Tensor, cfg: ModelConfig,
                  ranks: Ranks = PLAIN, cdtype=None):
    """The memory's K and V in the cache layout (B, Hkv, M, hd), all KV
    heads of the rank's cache."""
    n_q = bp["wq_x"].shape[1] // cfg.resolved_head_dim
    return tuple(_whole_kv(t, n_q, cfg, ranks).transpose(1, 2).to(cdtype)
                 for t in _memory_kv(bp, memory, cfg, ranks))


def _cross_out(bp, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The cross-attention's output projection, tanh-gated for the VLM."""
    o = merge_heads(o)
    o = linear(o, bp["wo_x"].to(o.dtype))
    if "gate_x" in bp:
        o = o * torch.tanh(bp["gate_x"].to(o.dtype))
    return o


def _cross_attention(bp, x: torch.Tensor, memory: torch.Tensor,
                     cfg: ModelConfig, ranks: Ranks = PLAIN,
                     collect: bool = False, cdtype=None):
    """The block's cross-attention to ``memory``; with ``collect`` also
    the memory's K/V in the cache layout, which the fused prefill keeps
    for the decode cache."""
    k, v = _memory_kv(bp, memory, cfg, ranks)
    o = A.bidirectional_attention(_cross_query(bp, x, cfg, ranks), k, v)
    out = _cross_out(bp, o, cfg)
    if not collect:
        return out
    n_q = bp["wq_x"].shape[1] // cfg.resolved_head_dim
    return (out,) + tuple(_whole_kv(t, n_q, cfg, ranks).transpose(1, 2)
                          .to(cdtype) for t in (k, v))


def _apply_block(kind: str, bp, x: torch.Tensor, rope, memory,
                 cfg: ModelConfig, ec: ExecConfig, collect: bool = False):
    """Full-sequence block application. Returns (x, aux, entry): ``aux``
    the block's auxiliary (MoE) loss, 0.0 where it has none; with
    ``collect``, ``entry`` holds what this block's decode cache needs:
    an attention block's K/V in the cache layout (B, Hkv, S, hd),
    unpadded, and a CROSS_ATTN block's memory K/V (B, Hkv, M, hd); a
    recurrent block's final state and the last min(S, W - 1) inputs of
    its conv (``_store`` writes it into the cache)."""
    entry = None
    if kind in ATTN_KINDS:
        h = PT.attention(bp, x, rope, cfg, collect=collect, cdtype=ec.cdtype)
        if collect:
            h, k, v = h
            entry = {"k": k, "v": v}
        x = x + h
        if kind == CROSS_ATTN:
            h = PT.cross_attention(bp, x, memory, cfg, collect=collect,
                                   cdtype=ec.cdtype)
            if collect:
                h, entry["ck"], entry["cv"] = h
            x = x + h
        h, aux = PT.ffn(bp["mlp"], bp["norm2"], x, cfg, ec)
        return x + h, aux, entry
    if kind == MAMBA2:
        out = PT.mamba2(bp, x, cfg, collect=collect)
    elif kind == MLSTM:
        out = PT.mlstm(bp, x, cfg, chunked=ec.mlstm_chunked,
                       collect=collect)
    elif kind == SLSTM:
        out = PT.slstm(bp, x, cfg, collect=collect)
    else:
        raise ValueError(kind)
    if not collect:
        return x + out, 0.0, None
    h, *rest = out
    if kind == SLSTM:
        entry = {"state": tuple(rest)}
    elif kind == MLSTM:
        entry = {"state": tuple(rest[:3]), "conv": rest[3]}
    else:
        entry = {"state": rest[0], "conv": rest[1]}
    return x + h, 0.0, entry


def _store(slot: Dict[str, Tree], entry: Dict[str, Tree]) -> None:
    """Write a block's prefill ``entry`` into its (zeroed) cache slot in
    place: K/V at the first S positions, a conv window's inputs at its
    end (zeros before them stand for the causal padding, where S <
    W - 1), the recurrent state and the memory's K/V whole."""
    for key, val in entry.items():
        dst = slot[key]
        if key in ("k", "v"):
            dst[:, :, : val.shape[2]] = val
        elif key == "conv":
            dst[:, dst.shape[1] - val.shape[1]:] = val
        else:
            _write(dst, val)


def _logits(cfg: ModelConfig, x: torch.Tensor, gamma: torch.Tensor,
            table: torch.Tensor, ranks: Ranks = PLAIN) -> torch.Tensor:
    """The final norm and the logits: ``table`` is the embedding (tied,
    read transposed) or the unembedding."""
    x = rms_norm(x, gamma, cfg.norm_eps)
    if cfg.tie_embeddings:
        return ranks.contract(x, table.to(x.dtype).t())
    return ranks.contract(x, table.to(x.dtype))


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Rows ``tokens`` of the embedding ``table`` in ``dtype``: a gather,
    by ``index_select`` where the table records a gradient (see the
    module docstring)."""
    rows = table.to(dtype)
    if not (torch.is_grad_enabled() and table.requires_grad):
        return rows[tokens.long()]
    ids = tokens.long()
    return rows.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, rows.shape[1])


def embed_rows(table: torch.Tensor, ids: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``embed_tokens`` on a shard of the table's rows: ``ids`` are
    offsets into the shard, and an id outside it gives a zero row."""
    held = ((ids >= 0) & (ids < table.shape[0]))[..., None]
    rows = embed_tokens(table, ids.clamp(0, table.shape[0] - 1), dtype)
    return rows * held.to(dtype)


def _superblock(x: torch.Tensor, aux, lp: Tree, shared: Optional[Tree], rope,
                memory, cfg: ModelConfig, ec: ExecConfig,
                cache_layers: Optional[Tree] = None, i: int = 0):
    """One superblock of the full-sequence path: (x, aux with each
    block's auxiliary loss added in order); with ``cache_layers``, each
    block's decode-cache entry is written into superblock ``i``'s
    slot."""
    for j, kind in enumerate(cfg.superblock):
        name = f"b{j}_{kind}"
        bp = shared if _shared(cfg, kind) else lp[name]
        x, a, e = _apply_block(kind, bp, x, rope, memory, cfg, ec,
                               collect=cache_layers is not None)
        aux = aux + a
        if cache_layers is not None:
            _store(_layer(cache_layers[name], i), e)
    return x, aux


def _rotary(cfg: ModelConfig) -> bool:
    """Whether attention rotates q and k (the reference: only under
    ``pos_kind == "rope"``)."""
    return cfg.pos_kind == "rope" and any(k in ATTN_KINDS
                                          for k in cfg.superblock)


def encode(cfg: ModelConfig, ec: ExecConfig, params: Tree,
           frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder. frames: (B, cross_memory_len, d) post-conv-stub
    embeddings, plus the encoder's learned positions, through non-causal
    self-attention layers (q and k not rotated) and ``final_norm``;
    returns the memory in the compute dtype."""
    enc = params["encoder"]
    x = frames.to(ec.cdtype) + enc["pos"].to(ec.cdtype)[None]
    for i in range(cfg.n_encoder_layers):
        lp = _layer(enc["layers"], i)
        x = x + PT.attention(lp, x, None, cfg, causal=False)
        h, _ = PT.ffn(lp["mlp"], lp["norm2"], x, cfg, ec)
        x = x + h
    return PT.norm(x, enc["final_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, ec: ExecConfig, params: Tree,
            tokens: torch.Tensor, memory: Optional[torch.Tensor] = None,
            collect_cache_len: Optional[int] = None):
    """Training / prefill forward. tokens: (B, S) integer.

    memory: (B, M, d) cross-attention memory: patch embeddings for the
    VLM, frame embeddings for whisper (encoded here). Returns (logits
    (B, S, vpad), aux_loss: the blocks' auxiliary losses summed and
    divided by the layer count, a float32 scalar); with
    ``collect_cache_len`` set, also returns a ready decode cache of that
    length (the fused prefill: one forward builds the KV caches, the
    memory's K/V, the recurrent states and the conv windows instead of
    S decode steps)."""
    B, S = tokens.shape
    dev = tokens.device
    x = PT.embed(params["embed"], tokens, ec.cdtype)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    if cfg.pos_kind == "learned":
        x = x + PT.embed(params["pos_embed"],
                         positions % cfg.learned_pos_len, ec.cdtype)
    rope = None
    if _rotary(cfg):
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    if cfg.is_encoder_decoder:
        if memory is None:
            raise ValueError(f"{cfg.arch_id} needs frame embeddings "
                             f"(memory)")
        memory = encode(cfg, ec, params, memory)
    if memory is not None:
        memory = memory.to(ec.cdtype)
    cache = None
    if collect_cache_len:
        if S > collect_cache_len:
            raise ValueError(f"prompt of {S} tokens exceeds the cache length "
                             f"{collect_cache_len}")
        cache = init_cache(cfg, ec, B, collect_cache_len, device=dev)
        cache["pos"].fill_(S)
    shared = params.get("shared_attn")
    remat = ec.remat and cache is None and torch.is_grad_enabled()
    aux = 0.0
    for i in range(cfg.n_superblocks):
        lp = _layer(params["layers"], i)
        if remat:
            x, aux = checkpoint(_superblock, x, aux, lp, shared, rope, memory,
                                cfg, ec, use_reentrant=False)
        else:
            x, aux = _superblock(x, aux, lp, shared, rope, memory, cfg, ec,
                                 None if cache is None else cache["layers"],
                                 i)
    logits = PT.unembed(params, x, cfg)
    if isinstance(aux, torch.Tensor):
        aux = aux / max(cfg.n_layers, 1)
    else:                       # no block with an auxiliary loss
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cache is not None:
        return logits, aux, cache
    return logits, aux


# ---------------------------------------------------------------------------
# Decode path (serve_step)
# ---------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, ec: ExecConfig, kind: str, batch: int,
                 cache_len: int, device) -> Tree:
    if kind in ATTN_KINDS:
        hd = cfg.resolved_head_dim
        shape = (batch, cfg.n_kv_heads, cache_len, hd)
        c = {"k": torch.zeros(shape, dtype=ec.cdtype, device=device),
             "v": torch.zeros(shape, dtype=ec.cdtype, device=device)}
        if kind == CROSS_ATTN:
            shape = (batch, cfg.n_kv_heads, cfg.cross_memory_len, hd)
            c["ck"] = torch.zeros(shape, dtype=ec.cdtype, device=device)
            c["cv"] = torch.zeros(shape, dtype=ec.cdtype, device=device)
        return c
    if kind == MAMBA2:
        return SSM.mamba2_init_cache(cfg, batch, ec.cdtype, device)
    if kind == MLSTM:
        return XL.mlstm_init_cache(cfg, batch, ec.cdtype, device)
    if kind == SLSTM:
        return {"state": XL.slstm_init_state(cfg, batch, device)}
    raise ValueError(kind)


def _stacked(tree: Tree, n: int) -> Tree:
    """Each tensor of ``tree`` repeated along a new leading axis of n."""
    if isinstance(tree, torch.Tensor):
        return tree.unsqueeze(0).repeat(n, *([1] * tree.dim()))
    if isinstance(tree, tuple):
        return tuple(_stacked(v, n) for v in tree)
    return {k: _stacked(v, n) for k, v in tree.items()}


def init_cache(cfg: ModelConfig, ec: ExecConfig, batch: int, cache_len: int,
               ring: bool = False, *, device) -> Tree:
    """Decode cache tree on ``device``, one cache per superblock slot by
    kind (a shared attention block gets a KV cache in every superblock;
    a CROSS_ATTN block also a zeroed cross cache of the memory's length,
    which ``prefill_cross_cache`` or the fused prefill fills).
    ``cache_len`` is the KV length (the window for ring caches).
    ``cache["pos"]`` counts tokens already consumed, as a device int32
    scalar."""
    layers = {f"b{i}_{kind}": _stacked(
        _block_cache(cfg, ec, kind, batch, cache_len, device),
        cfg.n_superblocks) for i, kind in enumerate(cfg.superblock)}
    return {"layers": layers,
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "ring": torch.full((), ring, dtype=torch.bool, device=device)}


def _attn_decode(bp, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, slot: torch.Tensor, cache_len,
                 rope, cfg: ModelConfig, ranks: Ranks = PLAIN,
                 l_dims=(), L: int = 0) -> torch.Tensor:
    """One token of a self-attention block against its KV cache, whose
    shard (the rank's KV heads, or its L positions over ``l_dims``,
    ``--kv-seq-shard``) the step's K/V are written into in place; the
    block's output."""
    q, k, v = _qkv(bp, x, cfg, ranks)
    if rope is not None:
        q = rotate(q, rope)
        k = rotate(k, rope)
    n_q = q.shape[2]
    kn, vn = (_whole_kv(t, n_q, cfg, ranks) for t in (k, v))
    if l_dims:
        kc, vc = A.cache_write_shard(k_cache, v_cache, kn, vn, slot,
                                     ranks.rank(l_dims) * k_cache.shape[2])
    else:
        kc, vc = A.cache_write(k_cache, v_cache, kn, vn, slot)
    if k.shape[2] < kc.shape[1]:
        first, n = _kv_group(n_q, cfg, ranks)
        kc, vc = kc.narrow(1, first, n), vc.narrow(1, first, n)
    o = A.decode_attention(q, kc, vc, cache_len, ranks, l_dims, L)
    o = merge_heads(o)
    return linear(o, bp["wo"].to(o.dtype))


def _cross_decode(bp, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  cross_len, cfg: ModelConfig, ranks: Ranks = PLAIN,
                  l_dims=(), M: int = 0) -> torch.Tensor:
    """One token of a CROSS_ATTN block's cross-attention against the
    cached memory K/V (the rank's shard of them)."""
    q = _cross_query(bp, x, cfg, ranks)
    n_q = q.shape[2]
    if n_q < cfg.n_heads and ck.shape[1] == cfg.n_kv_heads:
        first, n = _kv_group(n_q, cfg, ranks)
        ck, cv = ck.narrow(1, first, n), cv.narrow(1, first, n)
    o = A.decode_attention(q, ck, cv, cross_len, ranks, l_dims, M)
    return _cross_out(bp, o, cfg)


def _decode_block(kind: str, bp, cache_slice, x: torch.Tensor, at: Dict,
                  cfg: ModelConfig, ec: ExecConfig) -> torch.Tensor:
    """One-token block application against one superblock's cache slice
    (written in place); returns x. ``at`` holds what depends only on the
    position, which ``decode_step`` makes once for all layers: ``rope``
    (None without rotary positions), the cache ``slot``, ``cache_len``
    (pos + 1) and ``cross_len`` (the memory's length), each None where
    the stack has no use for it."""
    if kind in ATTN_KINDS:
        x = x + PT.attention_decode(bp, x, cache_slice, at, cfg)
        if kind == CROSS_ATTN:
            x = x + PT.cross_decode(bp, x, cache_slice, at, cfg)
        h, _ = PT.ffn(bp["mlp"], bp["norm2"], x, cfg, ec)
        return x + h
    if kind == MAMBA2:
        return x + PT.mamba2_decode(bp, x, cache_slice, cfg)
    if kind == MLSTM:
        return x + PT.mlstm_decode(bp, x, cache_slice, cfg)
    if kind == SLSTM:
        return x + PT.slstm_decode(bp, x, cache_slice, cfg)
    raise ValueError(kind)


def decode_step(cfg: ModelConfig, ec: ExecConfig, params: Tree, cache: Tree,
                tokens: torch.Tensor, ring: bool = False):
    """One decode step. tokens: (B, 1) integer. A CROSS_ATTN block's
    memory K/V must be in the cache (the fused prefill or
    ``prefill_cross_cache`` puts them there). Returns (logits (B, 1,
    vpad), cache) with the caches written in place and ``pos`` advanced
    on the device."""
    pos = cache["pos"]
    dev = pos.device
    x = PT.embed(params["embed"], tokens, ec.cdtype)
    if cfg.pos_kind == "learned":
        row = torch.remainder(pos.to(torch.int64), cfg.learned_pos_len)
        x = x + params["pos_embed"].index_select(0, row.reshape(1)).to(
            ec.cdtype)
    at = {"rope": None, "slot": None, "cache_len": pos + 1,
          "cross_len": None}
    attn = [f"b{j}_{kind}" for j, kind in enumerate(cfg.superblock)
            if kind in ATTN_KINDS]
    if attn:
        at["slot"] = A.cache_slot(pos, cache["layers"][attn[0]]["k"].shape[3],
                                  ring)
    if _rotary(cfg):
        at["rope"] = rope_tables(pos.reshape(1, 1).expand(x.shape[0], 1),
                                 cfg.resolved_head_dim, cfg.rope_theta)
    if cfg.has_cross_attention:
        at["cross_len"] = torch.full((), cfg.cross_memory_len,
                                     dtype=torch.int32, device=dev)
    shared = params.get("shared_attn")
    for i in range(cfg.n_superblocks):
        lp = _layer(params["layers"], i)
        cs = _layer(cache["layers"], i)
        for j, kind in enumerate(cfg.superblock):
            name = f"b{j}_{kind}"
            bp = shared if _shared(cfg, kind) else lp[name]
            x = _decode_block(kind, bp, cs[name], x, at, cfg, ec)
    logits = PT.unembed(params, x, cfg)
    return logits, {"layers": cache["layers"], "pos": at["cache_len"],
                    "ring": cache["ring"]}


def prefill_cross_cache(cfg: ModelConfig, ec: ExecConfig, params: Tree,
                        cache: Tree, memory: torch.Tensor) -> Tree:
    """Write every CROSS_ATTN slot's memory K/V, the constant part of the
    decode, into ``cache`` in place and return it; whisper's frames are
    encoded first. memory: (B, M, d)."""
    if cfg.is_encoder_decoder:
        memory = encode(cfg, ec, params, memory)
    memory = memory.to(ec.cdtype)
    for j, kind in enumerate(cfg.superblock):
        if kind != CROSS_ATTN:
            continue
        name = f"b{j}_{kind}"
        slot = cache["layers"][name]
        for i in range(cfg.n_superblocks):
            k, v = PT.memory_kv(_layer(params["layers"][name], i), memory,
                                cfg, memory.dtype)
            slot["ck"][i].copy_(k)
            slot["cv"][i].copy_(v)
    return cache
