"""Mixture-of-experts MLP with top-k routing: the port of
``repro.models.moe``.

Dispatch (``ExecConfig.moe_impl``):

* ``scatter``: each batch row's tokens go into per-expert capacity
  buffers of ``cap`` slots, the experts run as one batched SwiGLU product
  over the expert axis, and the results come back weighted by the router.
  An assignment's slot is the exclusive count of earlier assignments to
  its expert in the row (its S·k assignments in token-major order);
  assignments at or past ``cap`` are dropped and add nothing (Switch /
  GShard semantics). ``cap`` counts the logical experts, the buffers the
  padded ones (qwen's 60 -> 64: the 4 pad experts get buffers and never a
  token).
* ``expert_parallel``: the reference's ``shard_map`` over the ``model``
  axis of the ambient mesh (``compat.use_mesh``), through ``local_map``:
  each rank holds E/model of the padded expert stacks, routes every
  token of its batch shard, keeps the assignments to its own experts
  (the rest go to a drop bucket, whose rows are zero and weight is 0),
  runs the scatter path's dispatch, experts and combine on them, and
  one all-reduce of y in the compute dtype over ``model`` sums the
  ranks' parts; ``aux`` is averaged over the batch axes. Taken exactly
  where the reference's ``ep_ok`` holds (a mesh with a ``model`` axis
  that divides the padded expert count), else the scatter path. The
  router and x are the same on every ``model`` rank, so their gradients
  are the ranks' partial sums, added once; the auxiliary loss carries a
  gradient from model rank 0 only.
* ``dense`` (the oracle): every expert computes every token; no drops.

The router reads its weight in float32 (``init_params`` keeps the leaf
in float32: a bfloat16 router would route on rounded logits). The
auxiliary loss is float32: Switch load balance plus the ST-MoE z-loss,
with exact expert counts.

Moving tokens into and out of the buffers is a gather: an index where
no gradient flows, and an ``index_select`` where one does, whose
backward (an ``index_add``) is deterministic on the card under
``torch.use_deterministic_algorithms``. The slot of every buffer entry
is found on the device, so serving never waits for the card.

On a mesh (``sharding/partition.py``) ``moe_ffn`` runs on a rank's
local shards: where the experts are split over the model ranks, each
rank dispatches only the assignments to its own experts, as
``expert_parallel_local`` does, and its output is its part of the sum
over the model ranks; where each expert's MLP width is split, each rank
runs every expert on its columns.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compat import current_mesh
from repro_torch.config import ExecConfig, ModelConfig, MoEConfig
from repro_torch.models import params as P
from repro_torch.sharding.ranks import PLAIN, Ranks


def padded_experts(m: MoEConfig) -> int:
    return max(m.pad_to, m.n_experts)


def moe_param_spec(cfg: ModelConfig) -> Dict[str, P.Leaf]:
    m = cfg.moe
    d, f = cfg.d_model, cfg.d_ff
    E = padded_experts(m)
    spec = {
        "router": P.Leaf((d, m.n_experts), ("embed", "experts_logits"),
                         fan_in=d),
        "w_gate": P.Leaf((E, d, f), ("experts", "embed", "expert_mlp"),
                         fan_in=d),
        "w_up": P.Leaf((E, d, f), ("experts", "embed", "expert_mlp"),
                       fan_in=d),
        "w_down": P.Leaf((E, f, d), ("experts", "expert_mlp", "embed"),
                         fan_in=f),
    }
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        spec["shared_gate"] = P.Leaf((d, fs), ("embed", "mlp"), fan_in=d)
        spec["shared_up"] = P.Leaf((d, fs), ("embed", "mlp"), fan_in=d)
        spec["shared_down"] = P.Leaf((fs, d), ("mlp", "embed"), fan_in=fs)
    return spec


def _router(x32: torch.Tensor, w: torch.Tensor, m: MoEConfig,
            ranks: Ranks = PLAIN, batch=()):
    """x32: (T, d) float32 -> top-k weights (T, k) float32, expert ids
    (T, k) int64 and the auxiliary loss. Its token means are averaged
    over the mesh dims ``batch`` of ``ranks``, whose ranks hold the
    batch's other tokens."""
    logits = ranks.contract(x32, w.to(torch.float32))       # (T, E_logical)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    T = x32.shape[0]
    ids = torch.arange(m.n_experts, device=x32.device)
    counts = (top_e.reshape(-1, 1) == ids).sum(0).to(torch.float32)
    f_e = counts / (T * m.top_k)
    p_e = torch.mean(probs, dim=0)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    for i in batch:
        f_e, p_e, z_loss = (_MeanOverRanks.apply(t, (ranks.mesh, i),
                                                 ranks.mesh.size(i))
                            for t in (f_e, p_e, z_loss))
    lb_loss = m.n_experts * torch.sum(f_e * p_e)
    aux = m.load_balance_loss * lb_loss + m.router_z_loss * z_loss
    return top_w, top_e, aux


def capacity(m: MoEConfig, S: int) -> int:
    """Slots per expert and batch row: the reference's formula, over the
    logical expert count, rounded up to a multiple of 8 (at least 8)."""
    cap = int(m.capacity_factor * S * m.top_k / m.n_experts)
    return max(8, (cap + 7) // 8 * 8)


def _routes(te: torch.Tensor, E: int, cap: int):
    """te: (B, S, k) expert ids -> (src, dst). ``src`` (B, E cap): the
    token (0..S-1) that fills each buffer slot (expert-major), S where
    the slot stays empty; ``dst`` (B, S k): the slot e cap + c each
    assignment reads its result from, E cap where it was dropped."""
    B, S, k = te.shape
    N = S * k
    e = te.reshape(B, N)
    hot = (e[..., None] == torch.arange(E, device=te.device)).to(torch.int32)
    pos = torch.cumsum(hot, dim=1) - hot                    # exclusive
    p = torch.gather(pos, 2, e[..., None])[..., 0]          # (B, N)
    keep = p < cap
    dst = torch.where(keep, e * cap + p, E * cap)
    # dropped assignments write past the slots, each to a column of its
    # own, so that no two writes meet
    col = torch.where(keep, dst, E * cap + torch.arange(N, device=te.device))
    tok = torch.arange(N, device=te.device) // k
    src = torch.full((B, E * cap + N), S, dtype=torch.int64, device=te.device)
    src.scatter_(1, col, tok.expand(B, N))
    return src[:, : E * cap], dst


def _pick(src: torch.Tensor, idx: torch.Tensor, grad: bool) -> torch.Tensor:
    """Rows ``idx`` (B, m) of ``src`` (B, n, d), a zero row where idx is
    n: an index, or ``index_select`` where a gradient flows (the module
    docstring)."""
    B, n, d = src.shape
    rows = torch.cat([src.reshape(B * n, d), src.new_zeros(1, d)])
    base = torch.arange(B, device=src.device)[:, None] * n
    flat = torch.where(idx < n, idx + base, B * n)
    if grad:
        return rows.index_select(0, flat.reshape(-1)).reshape(
            *flat.shape, d)
    return rows[flat]


def _experts_swiglu(p, buf: torch.Tensor,
                    ranks: Ranks = PLAIN) -> torch.Tensor:
    """buf: (E, rows, d) -> (E, rows, d); one batched SwiGLU product per
    expert over all its rows."""
    dt = buf.dtype
    g = ranks.contract_batched(buf, p["w_gate"].to(dt))
    u = ranks.contract_batched(buf, p["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, p["w_down"].to(dt))


def _scatter_moe(p, x: torch.Tensor, top_w: torch.Tensor,
                 top_e: torch.Tensor, m: MoEConfig, buckets: int = 0,
                 ranks: Ranks = PLAIN) -> torch.Tensor:
    """x: (B, S, d) -> (B S, d): dispatch into the capacity buffers, the
    experts, and the weighted combine. ``p`` holds E expert stacks; the
    ids run over ``buckets`` (E by default), and an id past E (the
    expert-parallel drop bucket) adds nothing."""
    B, S, d = x.shape
    k = m.top_k
    E = p["w_gate"].shape[0]
    buckets = buckets or E
    cap = capacity(m, S)
    src, dst = _routes(top_e.reshape(B, S, k), buckets, cap)
    if buckets > E:
        # the drop bucket's slots are never filled; its assignments read
        # the zero row, as a dropped one does
        src = src[:, : E * cap]
        dst = torch.where(dst < E * cap, dst, E * cap)
    grad = torch.is_grad_enabled() and (x.requires_grad or any(
        p[n].requires_grad for n in ("w_gate", "w_up", "w_down")))
    buf = _pick(x, src, grad)                               # (B, E cap, d)
    # (B, E, cap, d) -> (E, B cap, d): each expert's rows of every batch row
    buf = buf.reshape(B, E, cap, d).transpose(0, 1).reshape(E, B * cap, d)
    out = _experts_swiglu(p, buf, ranks)
    d = out.shape[-1]               # the rank's columns of d under a split
    out = out.reshape(E, B, cap, d).transpose(0, 1).reshape(B, E * cap, d)
    y = _pick(out, dst, grad)                               # (B, S k, d)
    # each token's k contributions, each product rounded to the compute
    # dtype, summed in k order
    y = y.reshape(B * S, k, d) * top_w.reshape(B * S, k, 1).to(out.dtype)
    acc = y[:, 0]
    for j in range(1, k):
        acc = acc + y[:, j]
    return acc


def _dense_moe(p, xt: torch.Tensor, top_w: torch.Tensor,
               top_e: torch.Tensor, m: MoEConfig, buckets: int = 0,
               ranks: Ranks = PLAIN) -> torch.Tensor:
    """The oracle: every expert on every token, weighted by the router.
    ``p`` holds E expert stacks; the ids run over ``buckets`` (E by
    default), and an id past E adds nothing."""
    dt = xt.dtype
    E = p["w_gate"].shape[0]
    if ranks.split:
        xe = xt.expand(E, *xt.shape)
        g = ranks.contract_batched(xe, p["w_gate"].to(dt))  # (E, T, f)
        u = ranks.contract_batched(xe, p["w_up"].to(dt))
    else:
        g = torch.matmul(xt, p["w_gate"].to(dt))            # (E, T, f)
        u = torch.matmul(xt, p["w_up"].to(dt))
    y_all = torch.matmul(F.silu(g) * u, p["w_down"].to(dt))  # (E, T, d)
    onehot = F.one_hot(top_e, buckets or E).to(dt)          # (T, k, E)
    if buckets > E:
        onehot = onehot[..., :E]
    w_e = torch.einsum("tk,tke->te", top_w.to(dt), onehot)
    return torch.einsum("te,etd->td", w_e, y_all)


def expert_parallel_local(x: torch.Tensor, router_w: torch.Tensor,
                          experts: Dict[str, torch.Tensor], rank: int,
                          m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``model`` rank's part (the reference's ``local_fn`` before its
    psum): x (B, S, d) of its batch shard, the router, and ``experts``,
    the rank's E_loc stacks (``w_gate``, ``w_up``, ``w_down``) of global
    ids rank E_loc ... Returns (its part of y (B S, d) in x's type, aux
    float32): the sum of the ranks' parts is the scatter path's y."""
    B, S, d = x.shape
    e_loc = experts["w_gate"].shape[0]
    top_w, top_e, aux = _router(x.reshape(B * S, d).to(torch.float32),
                                router_w, m)
    e_local = top_e - rank * e_loc
    mine = (e_local >= 0) & (e_local < e_loc)
    te = torch.where(mine, e_local, e_loc)              # e_loc: drop bucket
    tw = torch.where(mine, top_w, 0.0)
    y = _scatter_moe(experts, x, tw, te, m, buckets=e_loc + 1)
    return y.to(x.dtype), aux


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over a process group in the forward; the backward
    passes the cotangent through: the output is the same on every rank,
    so each rank's part has derivative 1, and the inputs' gradients are
    the ranks' partial sums, added where they are reduced."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverRanks(torch.autograd.Function):
    """All-reduce (mean) over a process group of n ranks; the backward
    gives each rank's part 1/n of the cotangent."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group, n: int) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol
        ctx.n = n
        return funcol.wait_tensor(funcol.all_reduce(t, "avg", group))

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _ep_ok(mesh, m: MoEConfig) -> bool:
    """The reference's ``ep_ok``: a mesh with a ``model`` axis that
    divides the padded expert count."""
    return (mesh is not None and "model" in (mesh.mesh_dim_names or ())
            and padded_experts(m) % mesh["model"].size() == 0)


def _expert_parallel_moe(p, x: torch.Tensor, m: MoEConfig, mesh):
    """``expert_parallel_local`` on every rank through ``local_map``: x
    (B, S, d) sharded over the batch axes present (pod, data) and whole
    on ``model``, the expert stacks sharded over ``model``, the router
    whole. Plain tensors count as whole on every rank (each process
    holds the full batch and parameters); y comes back as x came in."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = list(mesh.mesh_dim_names)
    B, S, d = x.shape
    bdims = [i for i, a in enumerate(names)
             if a in ("pod", "data") and mesh.size(i) > 1]
    ways = 1
    for i in bdims:
        ways *= mesh.size(i)
    if B % ways:
        bdims, ways = [], 1
    model = names.index("model")
    plain = not isinstance(x, DTensor)

    def pl(batch, on_model):
        # a batch axis that does not shard x holds the same work on each
        # of its ranks: whole there
        return [batch if i in bdims else on_model if i == model
                else Replicate() for i in range(mesh.ndim)]

    x_pl = pl(Shard(0), Replicate())
    w_pl = pl(Replicate(), Shard(0))
    whole = [Replicate()] * mesh.ndim
    ep_group = (mesh, model)
    b_groups = [(mesh, i) for i in bdims]

    def local_fn(xr, router_w, wg, wu, wd):
        rank = mesh.get_local_rank("model")
        y, aux = expert_parallel_local(
            xr, router_w, {"w_gate": wg, "w_up": wu, "w_down": wd}, rank, m)
        y = _SumOverRanks.apply(y, ep_group)
        for i, group in zip(bdims, b_groups):
            aux = _MeanOverRanks.apply(aux, group, mesh.size(i))
        if rank != 0:
            aux = aux.detach()          # the gradient through aux, once
        return y.reshape(xr.shape), aux

    args = [x, p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    args = [DTensor.from_local(a, mesh, whole, run_check=False)
            if not isinstance(a, DTensor) else a for a in args]
    y, aux = local_map(
        local_fn, out_placements=(x_pl, whole),
        in_placements=(x_pl, whole, w_pl, w_pl, w_pl),
        in_grad_placements=(pl(Shard(0), Partial()), pl(Partial(), Partial()),
                            pl(Partial(), Shard(0)), pl(Partial(), Shard(0)),
                            pl(Partial(), Shard(0))),
        device_mesh=mesh, redistribute_inputs=True)(*args)
    if plain:
        y, aux = y.to_local(), aux.to_local()
    return y, aux


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, ec: ExecConfig,
            ranks: Ranks = PLAIN, batch=()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss float32 scalar). The
    ``scatter`` path, ``dense`` where ``ec.moe_impl`` says so, and
    ``expert_parallel`` where it says so and the ambient mesh allows
    (the module docstring). On a rank (``ranks``, the batch's mesh dims
    ``batch``) y is its part of the sum over the model ranks, and aux
    carries a gradient from model rank 0 only."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    mesh = current_mesh() if ec.moe_impl == "expert_parallel" else None
    if _ep_ok(mesh, m):
        y, aux = _expert_parallel_moe(p, x, m, mesh)
        y = y.reshape(B * S, d)
    else:
        # a rank's means over the batch ranks (``_router``'s plain call
        # is the single device's)
        over = () if ranks is PLAIN else (ranks, batch)
        top_w, top_e, aux = _router(xt.to(torch.float32), p["router"], m,
                                    *over)
        if ranks.model_rank != 0:
            aux = aux.detach()          # the gradient through aux, once
        E, buckets = p["w_gate"].shape[0], 0
        if E < padded_experts(m):
            # this rank's experts of the model ranks' split: the others'
            # assignments go to a drop bucket, as in expert_parallel_local
            first = ranks.model_rank * E
            mine = (top_e >= first) & (top_e < first + E)
            top_e = torch.where(mine, top_e - first, E)
            top_w = torch.where(mine, top_w, 0.0)
            buckets = E + 1
        if ec.moe_impl == "dense":
            y = _dense_moe(p, xt, top_w, top_e, m, buckets, ranks)
        else:
            y = _scatter_moe(p, x, top_w, top_e, m, buckets, ranks)
    shared = m.n_shared_experts and (
        p["shared_down"].shape[0] < cfg.d_ff * m.n_shared_experts
        or ranks.model_rank == 0)
    if shared:
        dt = xt.dtype
        g = ranks.contract(xt, p["shared_gate"].to(dt))
        u = ranks.contract(xt, p["shared_up"].to(dt))
        y = y + torch.matmul(F.silu(g) * u, p["shared_down"].to(dt))
    return y.reshape(B, S, y.shape[-1]), aux
