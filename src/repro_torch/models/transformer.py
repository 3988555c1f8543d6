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
up in their table by a one-hot product (the same values: one term of
each sum is not zero), so that its backward is a product too and
deterministic on the card, not a scatter-add; without a gradient it
gathers rows. ``ExecConfig.remat`` checkpoints each superblock
(``torch.utils.checkpoint``), as the reference checkpoints its scanned
body. Decode caches are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (ATTN, CROSS_ATTN, MAMBA2, MLSTM, SLSTM,
                                ExecConfig, ModelConfig)
from repro_torch.kernels import route
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import params as P
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.layers import (gelu_mlp, linear, merge_heads,
                                       rms_norm, rope_tables, rotate,
                                       round_up, split_heads, swiglu)

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

def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return split_heads(x, n)


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


def _mlp(bp, x: torch.Tensor, cfg: ModelConfig, ec: ExecConfig):
    """(y, aux): a MoE MLP's auxiliary loss, 0.0 for the others."""
    if cfg.moe is not None:
        return M.moe_ffn(bp, x, cfg, ec)
    if cfg.mlp_kind == "gelu":
        return gelu_mlp(x, bp["w_up"], bp["b_up"], bp["w_down"],
                        bp["b_down"]), 0.0
    return swiglu(x, bp["w_gate"], bp["w_up"], bp["w_down"]), 0.0


def _qkv(bp, x: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    q = _heads(linear(h, bp["wq"].to(h.dtype)), cfg.n_heads, hd)
    k = A.project_kv(h, bp["wk"], cfg.n_kv_heads, hd, bp["wq"])
    v = A.project_kv(h, bp["wv"], cfg.n_kv_heads, hd, bp["wq"])
    return q, k, v


def _self_attention(bp, x: torch.Tensor, rope, cfg: ModelConfig,
                    causal: bool = True, window: Optional[int] = None,
                    return_kv: bool = False):
    """``rope``: the stack's ``rope_tables`` for x's positions, None where
    q and k are not rotated (learned positions, the encoder)."""
    q, k, v = _qkv(bp, x, cfg)
    if rope is not None:
        q = rotate(q, rope)
        k = rotate(k, rope)
    if causal:
        o = A.causal_attention(q, k, v, window=window)
    else:
        o = A.bidirectional_attention(q, k, v)
    o = merge_heads(o)
    out = linear(o, bp["wo"].to(o.dtype))
    if return_kv:
        return out, k, v
    return out


def _cross_query(bp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, bp["norm_x"], cfg.norm_eps)
    return _heads(linear(h, bp["wq_x"].to(h.dtype)), cfg.n_heads,
                  cfg.resolved_head_dim)


def _memory_kv(bp, memory: torch.Tensor, cfg: ModelConfig):
    """A CROSS_ATTN block's K and V of the memory, (B, M, Hkv, hd) each
    (``A.project_kv``'s heads on DTensors)."""
    hd = cfg.resolved_head_dim
    return tuple(A.project_kv(memory, bp[w], cfg.n_kv_heads, hd, bp["wq_x"])
                 for w in ("wk_x", "wv_x"))


def _cross_out(bp, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The cross-attention's output projection, tanh-gated for the VLM."""
    o = merge_heads(o)
    o = linear(o, bp["wo_x"].to(o.dtype))
    if "gate_x" in bp:
        o = o * torch.tanh(bp["gate_x"].to(o.dtype))
    return o


def _cross_attention(bp, x: torch.Tensor, memory: torch.Tensor,
                     cfg: ModelConfig):
    """(out, k, v): the block's cross-attention to ``memory`` and the
    memory's K/V, which the fused prefill keeps for the decode cache."""
    k, v = _memory_kv(bp, memory, cfg)
    o = A.bidirectional_attention(_cross_query(bp, x, cfg), k, v)
    return _cross_out(bp, o, cfg), k, v


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
        if collect:
            h, k, v = _self_attention(bp, x, rope, cfg, return_kv=True)
            k, v = (A.whole_kv(t, cfg.n_kv_heads) for t in (k, v))
            entry = {"k": k.transpose(1, 2).to(ec.cdtype),
                     "v": v.transpose(1, 2).to(ec.cdtype)}
            x = x + h
        else:
            x = x + _self_attention(bp, x, rope, cfg)
        if kind == CROSS_ATTN:
            h, mk, mv = _cross_attention(bp, x, memory, cfg)
            x = x + h
            if collect:
                mk, mv = (A.whole_kv(t, cfg.n_kv_heads) for t in (mk, mv))
                entry["ck"] = mk.transpose(1, 2).to(ec.cdtype)
                entry["cv"] = mv.transpose(1, 2).to(ec.cdtype)
        h, aux = _mlp(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps),
                      cfg, ec)
        return x + h, aux, entry
    if kind == MAMBA2:
        h, state, conv_in = SSM._forward(bp, x, cfg)
        w = cfg.ssm.conv_width
    elif kind == MLSTM:
        h, state, conv_in = XL._mlstm_forward(bp, x, cfg,
                                              chunked=ec.mlstm_chunked)
        w = cfg.xlstm.conv_width
    elif kind == SLSTM:
        h, state = XL.slstm_forward(bp, x, cfg)
        conv_in = None
    else:
        raise ValueError(kind)
    if collect:
        entry = {"state": state}
        if conv_in is not None:
            entry["conv"] = conv_in[:, -(w - 1):]
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


def _unembed(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return linear(x, params["embed"].to(x.dtype).t())
    return linear(x, params["unembed"].to(x.dtype))


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Rows ``tokens`` of the embedding ``table`` in ``dtype``: a gather,
    or, where the table records a gradient, a one-hot product (see the
    module docstring). On DTensors each rank looks its tokens up in its
    shard of the vocabulary (``_sharded_embed``)."""
    if route.is_sharded(table, tokens):
        return _sharded_embed(table, tokens, dtype)
    rows = table.to(dtype)
    if not (torch.is_grad_enabled() and table.requires_grad):
        return rows[tokens.long()]
    ids = torch.arange(rows.shape[0], device=tokens.device)
    return torch.matmul((tokens.long()[..., None] == ids).to(dtype), rows)


def _sharded_embed(table: torch.Tensor, tokens: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``embed_tokens`` on DTensors (the dry run), vocabulary-parallel:
    the table keeps its vocabulary sharding (its embed dim is gathered),
    the tokens their batch sharding; each rank gives the rows of the
    tokens in its vocabulary shard and zeros for the rest, and the
    output is their partial sum over the vocabulary's mesh dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding.rules import local_offset
    mesh = (table if isinstance(table, DTensor) else tokens).device_mesh
    whole = [Replicate()] * mesh.ndim
    if not isinstance(table, DTensor):
        table = DTensor.from_local(table, mesh, whole, run_check=False)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, whole, run_check=False)
    tpl = [p if p == Shard(0) else Replicate() for p in table.placements]
    kpl = [p if p == Shard(0) and t != Shard(0) else Replicate()
           for p, t in zip(tokens.placements, tpl)]
    opl = [Partial() if t == Shard(0) else p for p, t in zip(kpl, tpl)]
    # the table's gradient: a partial sum over the ranks of the tokens
    gpl = [Partial() if k == Shard(0) else t for t, k in zip(tpl, kpl)]
    _, offset = local_offset(table.shape, mesh, tpl)

    def lookup(tab, tok):
        idx = tok.long() - offset[0]
        if torch.is_grad_enabled() and tab.requires_grad:
            # an id outside the shard matches no column: a zero row
            return embed_tokens(tab, idx, dtype)
        held = ((idx >= 0) & (idx < tab.shape[0]))[..., None]
        return tab.to(dtype)[idx.clamp(0, tab.shape[0] - 1)] * held.to(dtype)

    return local_map(lookup, out_placements=opl, in_placements=(tpl, kpl),
                     in_grad_placements=(gpl, kpl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


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
        x = x + _self_attention(lp, x, None, cfg, causal=False)
        h, _ = _mlp(lp["mlp"], rms_norm(x, lp["norm2"], cfg.norm_eps), cfg,
                    ec)
        x = x + h
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


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
    x = embed_tokens(params["embed"], tokens, ec.cdtype)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    if cfg.pos_kind == "learned":
        x = x + embed_tokens(params["pos_embed"],
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
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, params, x)
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


def _decode_block(kind: str, bp, cache_slice, x: torch.Tensor, at: Dict,
                  cfg: ModelConfig, ec: ExecConfig) -> torch.Tensor:
    """One-token block application against one superblock's cache slice
    (written in place); returns x. ``at`` holds what depends only on the
    position, which ``decode_step`` makes once for all layers: ``rope``
    (None without rotary positions), the cache ``slot``, ``cache_len``
    (pos + 1) and ``cross_len`` (the memory's length), each None where
    the stack has no use for it."""
    if kind in ATTN_KINDS:
        q, k, v = _qkv(bp, x, cfg)
        if at["rope"] is not None:
            q = rotate(q, at["rope"])
            k = rotate(k, at["rope"])
        kc, vc = A.cache_write(cache_slice["k"], cache_slice["v"],
                               A.whole_kv(k, cfg.n_kv_heads),
                               A.whole_kv(v, cfg.n_kv_heads), at["slot"])
        o = A.decode_attention(q, kc, vc, at["cache_len"])
        o = merge_heads(o)
        x = x + linear(o, bp["wo"].to(o.dtype))
        if kind == CROSS_ATTN:
            o = A.decode_attention(_cross_query(bp, x, cfg),
                                   cache_slice["ck"], cache_slice["cv"],
                                   at["cross_len"])
            x = x + _cross_out(bp, o, cfg)
        h, _ = _mlp(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps), cfg,
                    ec)
        return x + h
    if kind == MAMBA2:
        h, new = SSM.mamba2_decode_step(bp, x, cache_slice, cfg)
    elif kind == MLSTM:
        h, new = XL.mlstm_decode_step(bp, x, cache_slice, cfg)
    elif kind == SLSTM:
        h, st = XL.slstm_decode_step(bp, x, cache_slice["state"], cfg)
        new = {"state": st}
    else:
        raise ValueError(kind)
    _write(cache_slice, new)
    return x + h


def decode_step(cfg: ModelConfig, ec: ExecConfig, params: Tree, cache: Tree,
                tokens: torch.Tensor, ring: bool = False):
    """One decode step. tokens: (B, 1) integer. A CROSS_ATTN block's
    memory K/V must be in the cache (the fused prefill or
    ``prefill_cross_cache`` puts them there). Returns (logits (B, 1,
    vpad), cache) with the caches written in place and ``pos`` advanced
    on the device."""
    pos = cache["pos"]
    dev = pos.device
    if route.is_sharded(params["embed"], tokens):
        x = _sharded_embed(params["embed"], tokens, ec.cdtype)
    else:
        x = params["embed"].to(ec.cdtype)[tokens.long()]
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
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, params, x)
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
            k, v = (A.whole_kv(t, cfg.n_kv_heads) for t in _memory_kv(
                _layer(params["layers"][name], i), memory, cfg))
            slot["ck"][i].copy_(k.transpose(1, 2))
            slot["cv"][i].copy_(v.transpose(1, 2))
    return cache
