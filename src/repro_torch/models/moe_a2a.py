"""Explicit-collective MoE dispatch (the Megatron-MoE / EP schedule,
``src/repro/models/moe_a2a.py``).

The reference writes this schedule by hand with ``jax.shard_map``; here
the same per-rank body runs on every rank of a ``torch.distributed``
device mesh, with each collective on the process group of its mesh axis
(``mesh.get_group(axis)``):

layout (the ``moe_ep``/``moe_a2a`` rule variant):
    tokens : batch sharded over the data axes, d_model full
    experts: sharded over the model axis  (E_loc = E / n_model)
    expert FFN dim (f): sharded over the data axes (f_loc = f / n_data)

per-rank schedule (all collectives explicit, all O(tokens), not O(weights)):
    1. route + pack LOCAL tokens into (E, cap_loc, d)      -- no communication
    2. slice my model-shard's experts  (E_loc, cap_loc, d) -- free
    3. all-gather over the f axis: every f-shard needs every token that
       hits its experts                          (E_loc, n_data*cap_loc, d)
    4. expert matmuls with local weight shards (d full, f_loc)
    5. reduce-scatter over the f axis: sum f-partials, keep my tokens' slice
                                                  (E_loc, cap_loc, d)
    6. unpack + weight locally, sum over the model axis: every expert shard
       contributes its experts' outputs to my tokens        (n_loc, d)

``x`` is this rank's batch shard and the parameters are plain tensors
holding the whole weight: the schedule takes this rank's shard of each as
a view, so the gradient of a weight is nonzero only on this rank's shard,
and the sum of the ranks' gradients is the whole gradient.  Or ``x`` and
the parameters are ``DTensor``s (the sharded dry run): they are
redistributed to the reference's ``shard_map`` layouts (x over the batch
axes, the router whole, gate/up (expert, -, f) and down (expert, f, -))
and the schedule runs on their local shards
(``parallel.sharding.local_apply``).

Differentiable end to end.  Each collective is an ``autograd.Function``
whose backward is its transpose: all-gather <-> reduce-scatter, and the
sum over the model axis, whose output every rank of the axis holds alike,
passes its gradient through unchanged (each rank back-propagates its own
copy of the loss, so summing the incoming gradients again, as
``torch.distributed.nn.functional.all_reduce`` does, would count it
``n_model`` times).
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..convert import torch_dtype
from ..parallel.sharding import (current_mesh, current_rules, local_apply,
                                 logical_to_spec)

__all__ = ["a2a_available", "moe_a2a", "call_count", "reset_call_count"]

_CALLS = [0]


def call_count() -> int:
    """How many times ``moe_a2a`` ran its schedule since the last reset."""
    return _CALLS[0]


def reset_call_count() -> None:
    _CALLS[0] = 0


def _axes(a: Any) -> Tuple[str, ...]:
    if a is None:
        return ()
    return (a,) if isinstance(a, str) else tuple(a)


def _axis_size(mesh, axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _group(mesh, axes):
    """The process group over ``axes`` of ``mesh``: one axis's own group;
    several axes (the batch axes of a multi-pod mesh) as one flattened
    mesh dimension."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _scatter0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


class _AllGather1(torch.autograd.Function):
    """All-gather along dim 1 (tiled); backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x.transpose(0, 1), group).transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g.transpose(0, 1), ctx.group).transpose(0, 1), None


class _ReduceScatter1(torch.autograd.Function):
    """Sum over the group and keep my slice of dim 1; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter0(x.transpose(0, 1), group).transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g.transpose(0, 1), ctx.group).transpose(0, 1), None


class _SumReplicated(torch.autograd.Function):
    """Sum over the group, every rank holding the result; backward: the
    gradient unchanged (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanReplicated(torch.autograd.Function):
    """Mean over the group, every rank holding it; backward: the gradient
    over the group size."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def a2a_available(cfg) -> bool:
    """True when the ambient mesh/rules support the explicit EP schedule."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return False
    e_ax = rules.lookup("expert")
    if isinstance(e_ax, tuple) or e_ax not in (mesh.mesh_dim_names or ()):
        return False
    n_model = _axis_size(mesh, e_ax)
    return cfg.n_experts % n_model == 0


def _shard(w: torch.Tensor, dim: int, idx: int, n: int) -> torch.Tensor:
    """Shard ``idx`` of ``n`` of ``w`` along ``dim`` (a view)."""
    if n == 1:
        return w
    size = w.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"into {n} shards")
    return w.narrow(dim, idx * (size // n), size // n)


def _coordinate(mesh, axes) -> int:
    """This rank's row-major index over ``axes`` of ``mesh``."""
    coord = mesh.get_coordinate()
    idx = 0
    for a in _axes(axes):
        i = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def moe_a2a(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``layers.moe`` under the explicit EP schedule: this
    rank's tokens ``x`` (B_loc, S, d) -> (out (B_loc, S, d), aux loss
    averaged over the batch axes)."""
    from torch.distributed.tensor import DTensor

    _CALLS[0] += 1
    if isinstance(x, DTensor):
        return local_apply(
            lambda *a: _schedule(cfg, *a, local=True),
            (x, p.router, p.gate, p.up, p.down),
            (("batch", None, None), (None, None), ("expert", None, "tensor"),
             ("expert", None, "tensor"), ("expert", "tensor", None)),
            (("batch", None, None), ()), summed=(0, 1))
    return _schedule(cfg, x, p.router, p.gate, p.up, p.down, local=False)


def _schedule(cfg, x, router, gate, up, down, local: bool):
    """The per-rank schedule; ``local``: the weights are this rank's
    shards already, else whole."""
    mesh, rules = current_mesh(), current_rules()
    e_ax = rules.lookup("expert")                       # e.g. "model"
    f_ax = _axes(logical_to_spec(("tensor",), mesh, rules)[0])  # e.g. data
    b_ax = _axes(logical_to_spec(("batch",), mesh, rules)[0])   # data axes
    n_model = _axis_size(mesh, e_ax)
    n_f = _axis_size(mesh, f_ax)
    j = _coordinate(mesh, e_ax)
    i_f = _coordinate(mesh, f_ax)

    bl, sl, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // n_model
    n = bl * sl
    cap = max(1, int(math.ceil(n * k * cfg.capacity_factor / e)))
    dt = torch_dtype(cfg.dtype)
    xf = x.reshape(n, d)

    # 1. local routing + pack (the math of layers.moe, all local)
    probs = torch.softmax(xf.float() @ router, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1, sorted=True)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    eid = topi.reshape(n * k)
    w = topw.reshape(n * k)
    tok = torch.arange(n * k, device=x.device) // k
    order = torch.argsort(eid, stable=True)
    eid_s, w_s, tok_s = eid[order], w[order], tok[order]
    counts = torch.zeros(e, dtype=eid.dtype, device=eid.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    offsets = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(n * k, device=x.device) - offsets[eid_s]
    in_cap = rank < cap
    rank_c = torch.where(in_cap, rank, cap)
    buf = torch.zeros((e, cap + 1, d), dtype=dt, device=x.device)
    buf = buf.index_put((eid_s, rank_c), xf[tok_s].to(dt))[:, :cap]

    # 2. my model-shard's experts
    buf_my = buf[j * e_loc:(j + 1) * e_loc]

    # 3. gather tokens across the f-shard axis (token traffic, not weights)
    f_group = _group(mesh, f_ax) if f_ax else None
    buf_g = _AllGather1.apply(buf_my, f_group) if f_group is not None else buf_my

    # 4. expert matmuls on local weight shards
    if not local:
        gate = _shard(_shard(gate, 0, j, n_model), 2, i_f, n_f)
        up = _shard(_shard(up, 0, j, n_model), 2, i_f, n_f)
        down = _shard(_shard(down, 0, j, n_model), 1, i_f, n_f)
    h = F.silu(torch.bmm(buf_g, gate)) * torch.bmm(buf_g, up)
    o_part = torch.bmm(h, down)                         # partial over f shards

    # 5. reduce f-partials, keep my tokens' slice
    o_my = (_ReduceScatter1.apply(o_part, f_group) if f_group is not None
            else o_part)                                # (e_loc, cap, d)

    # 6. unpack my experts' contributions to my tokens, sum over experts
    is_mine = (eid_s >= j * e_loc) & (eid_s < (j + 1) * e_loc)
    eid_rel = torch.clamp(eid_s - j * e_loc, 0, e_loc - 1)
    contrib = o_my[eid_rel, torch.clamp(rank_c, max=cap - 1)]
    wgt = (w_s * in_cap * is_mine).float()
    y = torch.zeros((n, d), dtype=torch.float32, device=x.device).index_add(
        0, tok_s, contrib.float() * wgt[:, None])
    y = _SumReplicated.apply(y.to(x.dtype), mesh.get_group(e_ax))

    # aux load-balance loss (global over experts; mean over token shards)
    comb = torch.sum(F.one_hot(topi, e).float() * topw[..., None], dim=1)
    density = torch.mean((comb > 0).float(), dim=0)
    aux = torch.sum(density * torch.mean(probs, dim=0)) * e
    if b_ax:
        aux = _MeanReplicated.apply(aux, _group(mesh, b_ax))
    return y.reshape(bl, sl, d), aux
