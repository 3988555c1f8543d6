"""The composed model: the port of ``repro.models.transformer`` for
stacks of ATTN (GQA self-attention + MLP), MAMBA2, MLSTM and SLSTM
blocks, with zamba2's shared attention block: every dense, hybrid and
recurrent architecture the reference supports.

A model is ``cfg.superblock`` repeated ``cfg.n_superblocks`` times. The
reference scans over stacked parameters; here a Python loop walks the
same stacked layout, so parameters and caches keep the reference's
paths and shapes and ``convert`` carries them across as they are:
``layers/b0_attn/*`` with a leading ``n_superblocks`` axis, linears as
(d_in, d_out), KV caches (n_sb, B, Hkv, L, hd), recurrent states (a
tensor or a tuple of tensors) and conv windows (n_sb, B, W - 1, C). A
shared attention block has one set of weights (``shared_attn``) and a
KV cache per superblock.

Public API (as the reference's):
  model_param_spec(cfg, ec)                        -> param spec tree
  init_params(cfg, key, ec)                        -> params on key's device
  forward(cfg, ec, params, tokens, collect_cache_len=None)
                                                   -> logits, aux[, cache]
  init_cache(cfg, ec, batch, cache_len, ring, device=...) -> decode cache
  decode_step(cfg, ec, params, cache, tokens, ring) -> logits, cache

Drawn parameters (projections, MLP, embed, unembed) are stored in the
compute dtype: the reference stores them in float32 but reads them only
through ``.astype(cdtype)``, so the numbers are the same and a bfloat16
model takes half the memory. Constant leaves (norm gains, the SSM's
A_log, dt_bias and D, biases) and the sLSTM's recurrent R, which the
reference reads in float32, stay float32. Training keeps every leaf in
float32 (``init_params(..., param_dtype=torch.float32)``, the
reference's ``TrainConfig.param_dtype``): the forward casts them on
read, and AdamW's small updates are not lost to bfloat16 rounding. A
float32 draw cast to bfloat16 is the bfloat16 leaf bit for bit.

A forward that records a gradient looks tokens up in the embedding by a
one-hot product (the same values: one term of each sum is not zero), so
that its backward is a product too and deterministic on the card, not a
scatter-add; without a gradient it gathers rows. ``ExecConfig.remat``
checkpoints each superblock (``torch.utils.checkpoint``), as the
reference checkpoints its scanned body. CROSS_ATTN blocks, MoE MLPs,
learned positions and the encoder raise NotImplementedError naming
their ROADMAP.md item; decode caches are updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (ATTN, CROSS_ATTN, MAMBA2, MLSTM, SLSTM,
                                ExecConfig, ModelConfig)
from repro_torch.models import attention as A
from repro_torch.models import params as P
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.layers import (gelu_mlp, rms_norm, rope_tables,
                                       rotate, round_up, swiglu)

Tree = Any
DEFAULT_EXEC = ExecConfig()

# what the port does not run yet -> its ROADMAP.md queue 1 item
NOT_PORTED = {
    CROSS_ATTN: "item 13: cross-attention (VLM, whisper)",
    "moe": "item 13: mixture-of-experts MLPs",
    "learned": "item 13: cross-attention (VLM, whisper), with learned "
               "positions",
    "encoder": "item 13: cross-attention (VLM, whisper), with the encoder",
}


def _check_ported(cfg: ModelConfig) -> None:
    missing = [k for k in cfg.superblock if k in NOT_PORTED]
    if cfg.moe is not None:
        missing.append("moe")
    if cfg.pos_kind == "learned":
        missing.append("learned")
    if cfg.is_encoder_decoder:
        missing.append("encoder")
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: not ported yet: " + "; ".join(
                f"{m} (ROADMAP.md queue 1 {NOT_PORTED[m]})"
                for m in dict.fromkeys(missing)))


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _mlp_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    d, f = cfg.d_model, cfg.d_ff
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


def _attn_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "norm1": P.Leaf((d,), ("embed",), init="ones"),
        "wq": P.Leaf((d, H * hd), ("embed", "heads_flat"), fan_in=d),
        "wk": P.Leaf((d, Hkv * hd), ("embed", "kv_flat"), fan_in=d),
        "wv": P.Leaf((d, Hkv * hd), ("embed", "kv_flat"), fan_in=d),
        "wo": P.Leaf((H * hd, d), ("heads_flat", "embed"), fan_in=H * hd),
        "norm2": P.Leaf((d,), ("embed",), init="ones"),
        "mlp": _mlp_spec(cfg),
    }


def _block_spec(cfg: ModelConfig, kind: str) -> Dict[str, P.Leaf]:
    if kind == ATTN:
        return _attn_spec(cfg)
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


def padded_vocab(cfg: ModelConfig, ec: ExecConfig = DEFAULT_EXEC) -> int:
    return round_up(cfg.vocab, ec.vocab_pad)


def model_param_spec(cfg: ModelConfig, ec: ExecConfig = DEFAULT_EXEC) -> Tree:
    """The reference's spec: the same paths, shapes, axes, initializers,
    fan-ins and (float32) dtypes."""
    _check_ported(cfg)
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
    return spec


def init_params(cfg: ModelConfig, key: torch.Tensor,
                ec: ExecConfig = DEFAULT_EXEC,
                param_dtype: Optional[torch.dtype] = None) -> Tree:
    """The reference's init for ``key`` on key's device; drawn leaves are
    stored in ``param_dtype`` (float32 for training), by default in the
    compute dtype (see the module docstring)."""
    spec = P.drawn_in(model_param_spec(cfg, ec), param_dtype or ec.cdtype,
                      keep=XL.F32_LEAVES)
    return P.init_tree(spec, key)


# ---------------------------------------------------------------------------
# Blocks (full-sequence path)
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


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


def _mlp(bp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_kind == "gelu":
        return gelu_mlp(x, bp["w_up"], bp["b_up"], bp["w_down"], bp["b_down"])
    return swiglu(x, bp["w_gate"], bp["w_up"], bp["w_down"])


def _qkv(bp, x: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    q = _heads(torch.matmul(h, bp["wq"].to(h.dtype)), cfg.n_heads, hd)
    k = _heads(torch.matmul(h, bp["wk"].to(h.dtype)), cfg.n_kv_heads, hd)
    v = _heads(torch.matmul(h, bp["wv"].to(h.dtype)), cfg.n_kv_heads, hd)
    return q, k, v


def _self_attention(bp, x: torch.Tensor, rope, cfg: ModelConfig,
                    window: Optional[int] = None, return_kv: bool = False):
    """``rope``: the stack's ``rope_tables`` for x's positions."""
    q, k, v = _qkv(bp, x, cfg)
    q = rotate(q, rope)
    k = rotate(k, rope)
    o = A.causal_attention(q, k, v, window=window)
    o = o.reshape(*o.shape[:2], cfg.n_heads * cfg.resolved_head_dim)
    out = torch.matmul(o, bp["wo"].to(o.dtype))
    if return_kv:
        return out, k, v
    return out


def _apply_block(kind: str, bp, x: torch.Tensor, rope, cfg: ModelConfig,
                 ec: ExecConfig, collect: bool = False):
    """Full-sequence block application. Returns (x, entry); with
    ``collect``, ``entry`` holds what this block's decode cache needs:
    an ATTN block's K/V in the cache layout (B, Hkv, S, hd), unpadded; a
    recurrent block's final state and the last min(S, W - 1) inputs of
    its conv (``_store`` writes it into the cache). No block here adds
    an auxiliary loss."""
    entry = None
    if kind == ATTN:
        if collect:
            h, k, v = _self_attention(bp, x, rope, cfg, return_kv=True)
            entry = {"k": k.transpose(1, 2).to(ec.cdtype),
                     "v": v.transpose(1, 2).to(ec.cdtype)}
            x = x + h
        else:
            x = x + _self_attention(bp, x, rope, cfg)
        return x + _mlp(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps),
                        cfg), entry
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
    return x + h, entry


def _store(slot: Dict[str, Tree], entry: Dict[str, Tree]) -> None:
    """Write a block's prefill ``entry`` into its (zeroed) cache slot in
    place: K/V at the first S positions, a conv window's inputs at its
    end (zeros before them stand for the causal padding, where S <
    W - 1), the recurrent state whole."""
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
        return torch.matmul(x, params["embed"].to(x.dtype).t())
    return torch.matmul(x, params["unembed"].to(x.dtype))


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Rows ``tokens`` of the embedding ``table`` in ``dtype``: a gather,
    or, where the table records a gradient, a one-hot product (see the
    module docstring)."""
    rows = table.to(dtype)
    if not (torch.is_grad_enabled() and table.requires_grad):
        return rows[tokens.long()]
    ids = torch.arange(rows.shape[0], device=tokens.device)
    return torch.matmul((tokens.long()[..., None] == ids).to(dtype), rows)


def _superblock(x: torch.Tensor, lp: Tree, shared: Optional[Tree], rope,
                cfg: ModelConfig, ec: ExecConfig,
                cache_layers: Optional[Tree] = None, i: int = 0
                ) -> torch.Tensor:
    """One superblock of the full-sequence path; with ``cache_layers``,
    each block's decode-cache entry is written into superblock ``i``'s
    slot."""
    for j, kind in enumerate(cfg.superblock):
        name = f"b{j}_{kind}"
        bp = shared if _shared(cfg, kind) else lp[name]
        x, e = _apply_block(kind, bp, x, rope, cfg, ec,
                            collect=cache_layers is not None)
        if cache_layers is not None:
            _store(_layer(cache_layers[name], i), e)
    return x


def forward(cfg: ModelConfig, ec: ExecConfig, params: Tree,
            tokens: torch.Tensor, memory: Optional[torch.Tensor] = None,
            collect_cache_len: Optional[int] = None):
    """Training / prefill forward. tokens: (B, S) integer.

    Returns (logits (B, S, vpad), aux_loss scalar); with
    ``collect_cache_len`` set, also returns a ready decode cache of that
    length (the fused prefill: one forward builds the KV caches, the
    recurrent states and the conv windows instead of S decode steps).
    ``memory`` (cross-attention) is not ported."""
    _check_ported(cfg)
    if memory is not None:
        raise NotImplementedError(f"cross-attention memory: ROADMAP.md queue "
                                  f"1 {NOT_PORTED[CROSS_ATTN]}")
    B, S = tokens.shape
    dev = tokens.device
    x = embed_tokens(params["embed"], tokens, ec.cdtype)
    rope = None
    if ATTN in cfg.superblock:
        positions = torch.arange(S, dtype=torch.int32, device=dev)
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    cache = None
    if collect_cache_len:
        if S > collect_cache_len:
            raise ValueError(f"prompt of {S} tokens exceeds the cache length "
                             f"{collect_cache_len}")
        cache = init_cache(cfg, ec, B, collect_cache_len, device=dev)
        cache["pos"].fill_(S)
    shared = params.get("shared_attn")
    remat = ec.remat and cache is None and torch.is_grad_enabled()
    for i in range(cfg.n_superblocks):
        lp = _layer(params["layers"], i)
        if remat:
            x = checkpoint(_superblock, x, lp, shared, rope, cfg, ec,
                           use_reentrant=False)
        else:
            x = _superblock(x, lp, shared, rope, cfg, ec,
                            None if cache is None else cache["layers"], i)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, params, x)
    # the reference averages the blocks' auxiliary (MoE) losses: 0 here
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cache is not None:
        return logits, aux, cache
    return logits, aux


# ---------------------------------------------------------------------------
# Decode path (serve_step)
# ---------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, ec: ExecConfig, kind: str, batch: int,
                 cache_len: int, device) -> Tree:
    if kind == ATTN:
        shape = (batch, cfg.n_kv_heads, cache_len, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=ec.cdtype, device=device),
                "v": torch.zeros(shape, dtype=ec.cdtype, device=device)}
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
    kind (a shared attention block gets a KV cache in every superblock).
    ``cache_len`` is the KV length (the window for ring caches).
    ``cache["pos"]`` counts tokens already consumed, as a device int32
    scalar."""
    _check_ported(cfg)
    layers = {f"b{i}_{kind}": _stacked(
        _block_cache(cfg, ec, kind, batch, cache_len, device),
        cfg.n_superblocks) for i, kind in enumerate(cfg.superblock)}
    return {"layers": layers,
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "ring": torch.full((), ring, dtype=torch.bool, device=device)}


def _decode_block(kind: str, bp, cache_slice, x: torch.Tensor, rope,
                  slot: torch.Tensor, cache_len: torch.Tensor,
                  cfg: ModelConfig):
    """One-token block application against one superblock's cache slice
    (written in place); returns x. ``rope``, ``slot`` and ``cache_len``
    (pos + 1) depend only on the position, so ``decode_step`` makes them
    once for all layers (None where the stack has no attention)."""
    if kind == ATTN:
        q, k, v = _qkv(bp, x, cfg)
        q = rotate(q, rope)
        k = rotate(k, rope)
        kc, vc = A.cache_write(cache_slice["k"], cache_slice["v"], k, v,
                               slot)
        o = A.decode_attention(q, kc, vc, cache_len)
        o = o.reshape(*o.shape[:2], cfg.n_heads * cfg.resolved_head_dim)
        x = x + torch.matmul(o, bp["wo"].to(o.dtype))
        return x + _mlp(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps),
                        cfg)
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
    """One decode step. tokens: (B, 1) integer. Returns (logits (B, 1,
    vpad), cache) with the caches written in place and ``pos`` advanced
    on the device."""
    pos = cache["pos"]
    x = params["embed"].to(ec.cdtype)[tokens.long()]
    cache_len = pos + 1
    rope = slot = None
    attn = [f"b{j}_{kind}" for j, kind in enumerate(cfg.superblock)
            if kind == ATTN]
    if attn:
        L = cache["layers"][attn[0]]["k"].shape[3]
        rope = rope_tables(pos.reshape(1, 1).expand(x.shape[0], 1),
                           cfg.resolved_head_dim, cfg.rope_theta)
        slot = A.cache_slot(pos, L, ring)
    shared = params.get("shared_attn")
    for i in range(cfg.n_superblocks):
        lp = _layer(params["layers"], i)
        cs = _layer(cache["layers"], i)
        for j, kind in enumerate(cfg.superblock):
            name = f"b{j}_{kind}"
            bp = shared if _shared(cfg, kind) else lp[name]
            x = _decode_block(kind, bp, cs[name], x, rope, slot, cache_len,
                              cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, params, x)
    return logits, {"layers": cache["layers"], "pos": cache_len,
                    "ring": cache["ring"]}
