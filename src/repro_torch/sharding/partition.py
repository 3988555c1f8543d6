"""How each block of the LLM stack is split over a device mesh: one
``local_map`` per block call, with the rank's placements at its edges.

The parameters, tokens and caches come placed by ``sharding/rules.py``;
the residual stream x between blocks holds its batch rows on the ranks
of the batch dims (``pod``, ``data`` where they divide it) and is whole
on the rest. A block call runs its plain body (the model modules'
functions, on local shapes) on every rank through one ``local_map``:

* x enters whole but for its batch rows; a weight enters as placed,
  except that it is gathered over the batch dims (``--fsdp``'s embed
  axis: each rank multiplies its own rows by the whole weight);
* where the batch does not divide over a dim that splits a weight's
  embed rows (``--fsdp`` at batch 1), the weight stays split and the
  body splits the contraction there (``Ranks.contract``);
* over the ``model`` dim the body computes the rank's heads, columns,
  experts or cache positions, as the weights and caches are placed;
  the block's output is then the rank's partial sum, or its columns of
  the embed axis where the contraction was split;
* the output is summed and gathered back to x's placements at the
  block's edge, and a cache is written in place on each rank's shard.

Each input's gradient is its placement where that is a shard, and a
partial sum over every dim whose ranks split the block's work where it
is whole there (each rank's body reads it for its own part). On plain
tensors a block runs its body once, with ``ranks.PLAIN``: the single
device path, op for op.

The blocks: self-attention with its K/V and caches (prefill, decode,
``--kv-seq-shard`` decode), cross-attention, the MLP (dense or MoE),
Mamba2, the mLSTM, the sLSTM, the embedding, the final norm with the
unembedding, and a norm alone (whisper's encoder).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from repro_torch.config import ExecConfig, ModelConfig
from repro_torch.kernels.route import is_sharded
from repro_torch.sharding.ranks import PLAIN, Ranks

__all__ = ["attention", "attention_decode", "cross_attention",
           "cross_decode", "memory_kv", "ffn", "mamba2", "mamba2_decode",
           "mlstm", "mlstm_decode", "slstm", "slstm_decode", "embed",
           "unembed", "norm", "whole", "cache_placements"]


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _mesh(*tensors):
    dtensor = _dtensor()
    return next(t.device_mesh for t in tensors if isinstance(t, dtensor))


class _Layout:
    """One block call's mesh and the roles of its dims: ``batch`` the dims
    over which x holds its batch rows, ``model`` the ``model`` dim where it
    has more than one rank."""

    def __init__(self, x: torch.Tensor, *others):
        from torch.distributed.tensor import Shard
        self.mesh = _mesh(x, *others)
        self.n = self.mesh.ndim
        pl = getattr(x, "placements", ())
        self.batch = [i for i, p in enumerate(pl) if p == Shard(0)]
        self.rows = x.shape[0] if x.dim() else 1
        names = list(self.mesh.mesh_dim_names)
        i = names.index("model") if "model" in names else None
        self.model = i if i is not None and self.mesh.size(i) > 1 else None

    def x(self) -> list:
        """x's placements: its batch rows over the batch dims, whole on
        the rest."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(0) if i in self.batch else Replicate()
                for i in range(self.n)]

    def whole(self) -> list:
        from torch.distributed.tensor import Replicate
        return [Replicate()] * self.n

    def small(self, t) -> Optional[list]:
        """The placements of a tensor made from the position (rope tables,
        a cache slot, a count): its batch rows as x's where it has them,
        else whole; None passes None through."""
        if t is None:
            return None
        if t.dim() and self.batch and t.shape[0] == self.rows > 1:
            return self.x()
        return self.whole()

    def w(self, w, model: bool = True) -> Optional[list]:
        """A weight's placements in the body: as placed, gathered over the
        batch dims, and over the model dim unless ``model``; a vector (a
        norm's gain, a bias) whole but for its model shard."""
        from torch.distributed.tensor import Replicate
        if w is None:
            return None
        pl = getattr(w, "placements", None) or self.whole()
        return [p if i == self.model and model
                else Replicate() if i in self.batch or i == self.model
                or w.dim() == 1 else p for i, p in enumerate(pl)]

    def on_model(self, w, dim: int) -> bool:
        """Whether weight ``w`` is split along ``dim`` over the model
        dim."""
        from torch.distributed.tensor import Shard
        pl = getattr(w, "placements", None)
        return (self.model is not None and pl is not None
                and pl[self.model] == Shard(dim % w.dim()))

    def split(self, w, dim: int = 0) -> List[int]:
        """The dims, neither batch nor model, over which weight ``w``'s
        rows (its embed axis ``dim``) stay split: the contraction is
        split there."""
        from torch.distributed.tensor import Shard
        pl = getattr(w, "placements", ())
        return [i for i, p in enumerate(pl)
                if p == Shard(dim % w.dim()) and i not in self.batch
                and i != self.model]

    def out(self, ndim: int, partial: bool, split: Sequence[int] = (),
            model_dim: Optional[int] = None) -> list:
        """An output's placements: its batch rows over the batch dims, the
        rank's partial sum on the model dim (``partial``) or its shard
        along ``model_dim``, its columns (the last dim) over ``split``."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        pl = []
        for i in range(self.n):
            if i in self.batch:
                pl.append(Shard(0))
            elif i == self.model and partial:
                pl.append(Partial())
            elif i == self.model and model_dim is not None:
                pl.append(Shard(model_dim % ndim))
            elif i in split:
                pl.append(Shard(ndim - 1))
            else:
                pl.append(Replicate())
        return pl

    def block(self, body, args: Sequence, in_pl: Sequence, out_pl,
              model: bool, split: Sequence[int] = (), edge: bool = True):
        """``body(ranks, *local shards)`` of ``args`` placed by ``in_pl``
        (None: passed as it is), its outputs placed by ``out_pl``, the
        rank's ``ranks`` splitting the work over the model dim where
        ``model`` and the contraction over ``split``; gradients as the
        module docstring says. With ``edge`` the (first) output is summed
        and gathered back to x's placements."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        dtensor = _dtensor()
        ranks = Ranks(self.mesh, self.model if model else None, split)
        active = self.batch + ([self.model] if model else []) + list(split)
        grad = tuple(
            None if p is None else
            [q if isinstance(q, Shard) else Partial() if i in active
             else Replicate() for i, q in enumerate(p)] for p in in_pl)
        args = [dtensor.from_local(a, self.mesh, self.whole(),
                                   run_check=False)
                if p is not None and not isinstance(a, dtensor) else a
                for a, p in zip(args, in_pl)]
        res = local_map(lambda *a: body(ranks, *a), out_placements=out_pl,
                        in_placements=tuple(in_pl), in_grad_placements=grad,
                        device_mesh=self.mesh,
                        redistribute_inputs=True)(*args)
        if not edge:
            return res
        if isinstance(res, tuple):
            return (self.back(res[0]),) + tuple(res[1:])
        return self.back(res)

    def back(self, h):
        """A block's output summed and gathered to x's placements (the
        block's edge)."""
        return h.redistribute(self.mesh, self.x())


def cache_placements(cfg: ModelConfig, axes, ec: ExecConfig,
                     global_batch: int, cache_tree):
    """A decode cache's specs as the port's sharded decode holds them
    across steps: the rules' (``rules.cache_placements``, the reference's
    input specs), except that where the mLSTM's heads do not divide over
    ``model``, its state C and n split their k-side rows over it. The
    reference's decode step splits each head's state over k and keeps it
    so in the cache it returns (its HLO's output C is f32[.., 1, 96,
    384] a device at 16x16); the port's cache, updated in place, holds
    that split from the step before."""
    from repro_torch.models.xlstm import mlstm_dims
    from repro_torch.sharding import rules as R
    specs = R.cache_placements(cfg, axes, ec, global_batch, cache_tree)
    m = axes.get("model", 1)
    if cfg.xlstm is None or m < 2 or cfg.n_heads % m == 0:
        return specs
    H, Pd = cfg.n_heads, mlstm_dims(cfg)[2]
    if Pd % m:
        return specs

    def split(spec, leaf):
        shp = tuple(leaf.shape)
        if len(shp) in (4, 5) and shp[2] == H and shp[3] == Pd:
            return spec[:3] + ("model",) + spec[4:]
        return spec
    return R._tree_map2(split, specs, cache_tree)


def whole(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` whole along ``dim`` on every rank (the serve step's logits
    for the pick): a DTensor sharded along it is gathered there."""
    if not is_sharded(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim %= t.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

_ATTN = ("norm1", "wq", "wk", "wv", "wo")
_CROSS = ("norm_x", "wq_x", "wk_x", "wv_x", "wo_x", "gate_x")


def _rope(cos, sin):
    return None if cos is None else (cos, sin)


def _kv_entry(lay: _Layout, w) -> list:
    """The placements of a block's K or V in the cache layout (B, Hkv, S,
    hd): over the model dim its KV heads where ``w`` is split there,
    else whole (the body gathers them)."""
    return lay.out(4, False, model_dim=1 if lay.on_model(w, 1) else None)


def _l_dims(cache: torch.Tensor) -> tuple:
    """The mesh dims over which a (B, Hkv, L, hd) cache splits its L
    positions (``--kv-seq-shard``)."""
    from torch.distributed.tensor import Shard
    return tuple(i for i, p in enumerate(cache.placements) if p == Shard(2))


def attention(bp, x: torch.Tensor, rope, cfg: ModelConfig,
              causal: bool = True, window: Optional[int] = None,
              collect: bool = False, cdtype=None):
    """A self-attention block's output (to add to x) and, with
    ``collect``, its K and V in the cache layout (B, Hkv, S, hd), whole
    on each model rank: ``transformer._self_attention``."""
    from repro_torch.models import transformer as T
    ps = [bp[k] for k in _ATTN]
    cos, sin = rope if rope is not None else (None, None)

    def body(ranks, xl, *a):
        return T._self_attention(dict(zip(_ATTN, a)), xl, _rope(*a[5:]),
                                 cfg, causal, window, collect, ranks, cdtype)

    if not is_sharded(x, *ps):
        return body(PLAIN, x, *ps, cos, sin)
    lay = _Layout(x, *ps)
    model, split = lay.on_model(bp["wq"], 1), lay.split(bp["wq"])
    out = lay.out(x.dim(), model, split)
    return lay.block(body, [x, *ps, cos, sin],
                     [lay.x(), *(lay.w(p, model) for p in ps),
                      lay.small(cos), lay.small(sin)],
                     (out, _kv_entry(lay, bp["wk"]), _kv_entry(lay, bp["wv"]))
                     if collect else out, model, split)


def attention_decode(bp, x: torch.Tensor, cache, at, cfg: ModelConfig):
    """A self-attention block's one-token output (to add to x); the step's
    K/V are written into the cache slice in place: ``transformer.
    _attn_decode``."""
    from repro_torch.models import transformer as T
    ps = [bp[k] for k in _ATTN]
    cos, sin = at["rope"] if at["rope"] is not None else (None, None)
    small = [cos, sin, at["slot"], at["cache_len"]]
    kc, vc = cache["k"], cache["v"]
    L = kc.shape[2]

    def body(l_dims, ranks, xl, kcl, vcl, *a):
        return T._attn_decode(dict(zip(_ATTN, a)), xl, kcl, vcl, *a[7:],
                              _rope(*a[5:7]), cfg, ranks, l_dims, L)

    if not is_sharded(x, kc, vc, *ps):
        return body((), PLAIN, x, kc, vc, *ps, *small)
    lay = _Layout(x, kc, *ps)
    model, split = lay.on_model(bp["wq"], 1), lay.split(bp["wq"])
    cpl = list(kc.placements)
    return lay.block(functools.partial(body, _l_dims(kc)),
                     [x, kc, vc, *ps, *small],
                     [lay.x(), cpl, cpl, *(lay.w(p, model) for p in ps),
                      *(lay.small(t) for t in small)],
                     lay.out(x.dim(), model, split), model, split)


def cross_attention(bp, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig, collect: bool = False, cdtype=None):
    """A CROSS_ATTN block's cross-attention to ``memory`` (to add to x)
    and, with ``collect``, the memory's K and V in the cache layout:
    ``transformer._cross_attention``."""
    from repro_torch.models import transformer as T
    ps = [bp.get(k) for k in _CROSS]

    def body(ranks, xl, ml, *a):
        lp = {k: v for k, v in zip(_CROSS, a) if v is not None}
        return T._cross_attention(lp, xl, ml, cfg, ranks, collect, cdtype)

    if not is_sharded(x, memory, *ps):
        return body(PLAIN, x, memory, *ps)
    lay = _Layout(x, memory, *ps)
    model, split = lay.on_model(bp["wq_x"], 1), lay.split(bp["wq_x"])
    out = lay.out(x.dim(), model, split)
    return lay.block(body, [x, memory, *ps],
                     [lay.x(), lay.x(), *(lay.w(p, model) for p in ps)],
                     (out, _kv_entry(lay, bp["wk_x"]),
                      _kv_entry(lay, bp["wv_x"])) if collect else out,
                     model, split)


def memory_kv(bp, memory: torch.Tensor, cfg: ModelConfig, cdtype):
    """The memory's K and V of a CROSS_ATTN block in the cache layout (B,
    Hkv, M, hd), whole on each model rank (``prefill_cross_cache``)."""
    from repro_torch.models import transformer as T
    ps = [bp.get(k) for k in _CROSS]

    def body(ranks, ml, *a):
        lp = {k: v for k, v in zip(_CROSS, a) if v is not None}
        return T._memory_entry(lp, ml, cfg, ranks, cdtype)

    if not is_sharded(memory, *ps):
        return body(PLAIN, memory, *ps)
    lay = _Layout(memory, *ps)
    model, split = lay.on_model(bp["wq_x"], 1), lay.split(bp["wq_x"])
    return lay.block(body, [memory, *ps],
                     [lay.x(), *(lay.w(p, model) for p in ps)],
                     (_kv_entry(lay, bp["wk_x"]), _kv_entry(lay, bp["wv_x"])),
                     model, split, edge=False)


def cross_decode(bp, x: torch.Tensor, cache, at, cfg: ModelConfig):
    """A CROSS_ATTN block's one-token cross-attention against the cached
    memory K/V (to add to x): ``transformer._cross_decode``."""
    from repro_torch.models import transformer as T
    ps = [bp.get(k) for k in _CROSS]
    ck, cv, n = cache["ck"], cache["cv"], at["cross_len"]
    M = ck.shape[2]

    def body(l_dims, ranks, xl, ckl, cvl, nl, *a):
        lp = {k: v for k, v in zip(_CROSS, a) if v is not None}
        return T._cross_decode(lp, xl, ckl, cvl, nl, cfg, ranks, l_dims, M)

    if not is_sharded(x, ck, cv, *ps):
        return body((), PLAIN, x, ck, cv, n, *ps)
    lay = _Layout(x, ck, *ps)
    model, split = lay.on_model(bp["wq_x"], 1), lay.split(bp["wq_x"])
    cpl = list(ck.placements)
    return lay.block(functools.partial(body, _l_dims(ck)),
                     [x, ck, cv, n, *ps],
                     [lay.x(), cpl, cpl, lay.small(n),
                      *(lay.w(p, model) for p in ps)],
                     lay.out(x.dim(), model, split), model, split)


# ---------------------------------------------------------------------------
# MLP (dense or mixture-of-experts)
# ---------------------------------------------------------------------------

def ffn(bp, gamma: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
        ec: ExecConfig):
    """The MLP of an attention block on rms_norm(x, gamma): (output to add
    to x, auxiliary loss: the MoE's, 0.0 for the others); ``transformer.
    _ffn``. A MoE MLP under ``expert_parallel`` with a mesh that allows it
    keeps its own ``local_map`` (``moe._expert_parallel_moe``)."""
    from repro_torch.compat import current_mesh
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    if (cfg.moe is not None and ec.moe_impl == "expert_parallel"
            and M._ep_ok(current_mesh(), cfg.moe)):
        return M.moe_ffn(bp, norm(x, gamma, cfg.norm_eps), cfg, ec)
    names = sorted(bp)
    ps = [bp[k] for k in names]
    bias = bp.get("b_down")

    def body(batch, ranks, xl, g, *a):
        h, aux = T._ffn(dict(zip(names, a)), g, xl, cfg, ec, ranks, batch)
        return (h, aux) if cfg.moe is not None else h

    if not is_sharded(x, gamma, *ps):
        h = body((), PLAIN, x, gamma, *ps)
        h, aux = h if cfg.moe is not None else (h, 0.0)
    else:
        lay = _Layout(x, gamma, *ps)
        down = bp["w_down"]
        # the experts or each expert's MLP width, or the MLP width, split
        model = lay.on_model(down, 0) or (cfg.moe is not None
                                          and lay.on_model(down, 1))
        split = lay.split(bp["router" if cfg.moe is not None else "w_up"])
        out = lay.out(x.dim(), model, split)
        h = lay.block(functools.partial(body, lay.batch), [x, gamma, *ps],
                      [lay.x(), lay.w(gamma),
                       *(lay.w(p, model) for p in ps)],
                      (out, lay.whole()) if cfg.moe is not None else out,
                      model, split)
        h, aux = h if cfg.moe is not None else (h, 0.0)
    return (h if bias is None else h + bias.to(h.dtype)), aux


# ---------------------------------------------------------------------------
# Recurrent blocks
# ---------------------------------------------------------------------------

def _state_pl(lay: _Layout, t) -> list:
    return list(t.placements) if isinstance(t, _dtensor()) else lay.x()


def _recurrent(bp, names, x, body, model_of, collect, entries, whole=(),
               state=()):
    """A recurrent block's call: ``body(ranks, x, *state, *params)``; the
    model ranks split its work where ``model_of(lay)`` says, the weights
    in ``whole`` gathered over the model dim, the rest as placed; the
    ``state`` (a decode step's cache slices, written in place) as placed;
    with ``collect`` the outputs past the first placed by
    ``entries(lay, model)``."""
    ps = [bp[k] for k in names]
    if not is_sharded(x, *state, *ps):
        return body(PLAIN, x, *state, *ps)
    lay = _Layout(x, *ps)
    model = model_of(lay)
    split = lay.split(ps[0])
    out = lay.out(x.dim(), model, split)
    return lay.block(body, [x, *state, *ps],
                     [lay.x(), *(_state_pl(lay, t) for t in state),
                      *(lay.w(p, model and k not in whole)
                        for k, p in zip(names, ps))],
                     (out, *entries(lay, model)) if collect else out,
                     model, split)


def mamba2(bp, x: torch.Tensor, cfg: ModelConfig, collect: bool = False):
    """A Mamba2 block's output (to add to x) and, with ``collect``, its
    final state and the conv's last W - 1 inputs: ``ssm._forward``, the
    model ranks splitting the heads."""
    from repro_torch.models import ssm as SSM

    def body(ranks, xl, *ps):
        y, h, conv_in = SSM._forward(dict(zip(SSM.PARAMS, ps)), xl, cfg,
                                     ranks)
        return (y, h, SSM.conv_tail(conv_in, cfg, ranks)) if collect else y

    return _recurrent(
        bp, SSM.PARAMS, x, body, lambda lay: lay.on_model(bp["A_log"], 0),
        collect, lambda lay, model: (
            lay.out(4, False, model_dim=1 if model else None),
            lay.out(3, False)),
        whole=("in_proj", "conv_w", "conv_b", "norm"))


def mamba2_decode(bp, x: torch.Tensor, cache, cfg: ModelConfig):
    """A Mamba2 block's one-token output (to add to x); the state and conv
    window are written into the cache slice in place: ``ssm.
    decode_into`` (in_proj split by its columns)."""
    from repro_torch.models import ssm as SSM

    def body(ranks, xl, st, conv, *ps):
        return SSM.decode_into(dict(zip(SSM.PARAMS, ps)), xl, st, conv, cfg,
                               ranks)

    return _recurrent(bp, SSM.PARAMS, x, body,
                      lambda lay: lay.on_model(bp["A_log"], 0), False, None,
                      whole=("conv_w", "conv_b", "norm"),
                      state=(cache["state"], cache["conv"]))


def _mlstm_model(bp):
    return lambda lay: lay.on_model(bp["w_q"], 1)


def mlstm(bp, x: torch.Tensor, cfg: ModelConfig, chunked: bool = True,
          collect: bool = False):
    """An mLSTM block's output (to add to x) and, with ``collect``, its
    final state (C, n, m) and the conv's last W - 1 inputs, whole on
    each model rank: ``xlstm._mlstm_forward``."""
    from repro_torch.models import xlstm as XL

    def body(ranks, xl, *ps):
        y, state, xm = XL._mlstm_forward(dict(zip(XL.MLSTM_PARAMS, ps)), xl,
                                         cfg, chunked=chunked, ranks=ranks)
        if not collect:
            return y
        return (y, *XL.whole_state(state, cfg, ranks),
                xm[:, -(cfg.xlstm.conv_width - 1):])

    return _recurrent(bp, XL.MLSTM_PARAMS, x, body, _mlstm_model(bp),
                      collect, lambda lay, model: [
                          lay.out(n, False) for n in (4, 3, 2, 3)],
                      whole=("norm",))


def mlstm_decode(bp, x: torch.Tensor, cache, cfg: ModelConfig):
    """An mLSTM block's one-token output (to add to x); the state and conv
    window are written into the cache slice in place: ``xlstm.
    decode_into``. The state stays split as the cache places it."""
    from repro_torch.models import xlstm as XL

    def body(ranks, xl, C, n, m, conv, *ps):
        return XL.decode_into(dict(zip(XL.MLSTM_PARAMS, ps)), xl, (C, n, m),
                              conv, cfg, ranks)

    return _recurrent(bp, XL.MLSTM_PARAMS, x, body, _mlstm_model(bp), False,
                      None, whole=("norm",),
                      state=(*cache["state"], cache["conv"]))


def _slstm_model(bp):
    return lambda lay: lay.on_model(bp["ffn_down"], 0)


def slstm(bp, x: torch.Tensor, cfg: ModelConfig, collect: bool = False):
    """An sLSTM block's output (to add to x) and, with ``collect``, its
    final state: ``xlstm.slstm_forward``, the recurrence whole on every
    model rank and its FFN split by columns."""
    from repro_torch.models import xlstm as XL

    def body(ranks, xl, *ps):
        y, state = XL.slstm_forward(dict(zip(XL.SLSTM_PARAMS, ps)), xl, cfg,
                                    ranks=ranks)
        return (y, *state) if collect else y

    return _recurrent(bp, XL.SLSTM_PARAMS, x, body, _slstm_model(bp),
                      collect, lambda lay, model: [lay.out(2, False)] * 4,
                      whole=("r",))


def slstm_decode(bp, x: torch.Tensor, cache, cfg: ModelConfig):
    """An sLSTM block's one-token output (to add to x); the state is
    written into the cache slice in place."""
    from repro_torch.models import xlstm as XL

    def body(ranks, xl, *a):
        return XL.slstm_decode_into(dict(zip(XL.SLSTM_PARAMS, a[4:])), xl,
                                    a[:4], cfg, ranks)

    return _recurrent(bp, XL.SLSTM_PARAMS, x, body, _slstm_model(bp), False,
                      None, whole=("r",), state=tuple(cache["state"]))


# ---------------------------------------------------------------------------
# Embedding, unembedding, norm
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Rows ``tokens`` of ``table`` in ``dtype`` (``transformer.
    embed_tokens``); on DTensors vocabulary-parallel: each rank looks its
    tokens up in its shard of the vocabulary, zeros for the rest, and the
    rows are summed over the vocabulary's ranks at the edge. The table's
    embed dim is gathered over the batch dims, and stays split where the
    batch is not (its columns are gathered at the edge)."""
    from repro_torch.models import transformer as T
    if not is_sharded(table, tokens):
        return T.embed_tokens(table, tokens, dtype)
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.sharding.rules import local_offset
    lay = _Layout(tokens, table)
    pl = _state_pl(lay, table)
    vocab = [i for i, p in enumerate(pl) if p == Shard(0)]
    lay.batch = [i for i in lay.batch if i not in vocab]
    cols = [i for i, p in enumerate(pl) if p == Shard(1)
            and i not in lay.batch]
    tpl = [p if i in vocab + cols else q
           for i, (p, q) in enumerate(zip(pl, lay.whole()))]
    _, offset = local_offset(table.shape, lay.mesh, tpl)

    def lookup(ranks, tab, tok):
        return T.embed_rows(tab, tok.long() - offset[0], dtype)

    out = [Partial() if i in vocab else p
           for i, p in enumerate(lay.out(tokens.dim() + 1, False, cols))]
    # the vocabulary is split over the model dim: its ranks each give
    # their own rows
    return lay.block(lookup, [table, tokens], [tpl, lay.x()], out,
                     bool(vocab), cols)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The final norm and the logits over the padded vocabulary
    (``transformer._logits``), the vocabulary split as the table is."""
    from repro_torch.models import transformer as T
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    gamma = params["final_norm"]

    def body(ranks, xl, g, w):
        return T._logits(cfg, xl, g, w, ranks)

    if not is_sharded(x, gamma, table):
        return body(PLAIN, x, gamma, table)
    lay = _Layout(x, gamma, table)
    row = 1 if cfg.tie_embeddings else 0
    vocab = lay.on_model(table, 1 - row)
    split = lay.split(table, row)
    return lay.block(body, [x, gamma, table],
                     [lay.x(), lay.w(gamma), lay.w(table)],
                     lay.out(x.dim(), False, model_dim=-1 if vocab else None),
                     vocab, split, edge=False)


def norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """rms_norm(x, gamma) on each rank's rows."""
    from repro_torch.models.layers import rms_norm
    if not is_sharded(x, gamma):
        return rms_norm(x, gamma, eps)
    lay = _Layout(x, gamma)
    return lay.block(lambda ranks, xl, g: rms_norm(xl, g, eps), [x, gamma],
                     [lay.x(), lay.w(gamma)], lay.x(), False, edge=False)
