"""AdamW + LR schedule + gradient clipping as plain functions on tensors
(``src/repro/train/optim.py``).

``torch.optim.AdamW`` does not give the reference's numbers (it folds the
decay into the parameter before the step and takes the bias corrections in
float64), so the update is written out as the reference writes it: the
schedule and the bias corrections in float32, moments in
``cfg.state_dtype``, the arithmetic of each leaf in float32.

A parameter tree here is a flat mapping ``{port name: tensor}`` (an
``nn.Module`` is taken as its ``named_parameters()``); ``m`` and ``v`` use
the same names.  Two things follow the reference's *stacked* tree, not the
port's per-layer tensors (``layers.<i>.<name>`` is slice i of the
reference's ``layers/<name>``, see ``convert``):

* **weight decay** goes to a leaf whose reference array has rank >= 2
  (optim.py:90), so every per-layer leaf is decayed, the 1-D ones too
  (``ln1``, ``ln2``, ``A_log``, ``D``, ``dt_bias``, ``conv_b``, a norm's
  ``scale``), while the final ``ln_f`` is not;
* **the global norm** adds per-leaf float32 sums of squares in the
  reference's flatten order (sorted dict keys at every level), a stacked
  leaf's sum being the sum of its layers' sums.

The leaves may be ``DTensor``s (the sharded step): the global norm's sum
of squares is then reduced across ranks (``full_tensor``) and every
update is elementwise on each rank's shards.

``adamw_update`` updates the parameters and the moments in place and
returns them (the reference returns new trees; at full width a second copy
of the moments would not fit on the card).  On the card it runs the fused
kernels of ``kernels.adamw`` (``csrc/adamw.cu``): the norm in a reduction
over every gradient and a finish that adds the leaves in the reference's
order, then the update of every leaf in one pass, a few launches in all
and no host synchronisation; only the 0-d schedule (``cosine_lr``, the
bias corrections) stays as PyTorch operations.  ``DTensor`` leaves take
the kernels on their local shards, the norm's sums of squares reduced
across ranks by class of sharding as ``global_norm`` reduces them.  On
the CPU it runs ``adamw_update_plain``, the leaf-by-leaf loop, which is
also the kernels' plain version on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Tuple

import torch
from torch import nn

from ..convert import reference_leaf, torch_dtype
from ..kernels import adamw as fused

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "adamw_update_plain", "fused_launches", "cosine_lr", "global_norm", "clip_by_global_norm",
           "reference_key", "reference_order", "decays"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor           # 0-d int32
    m: Dict[str, torch.Tensor]   # first moment, params-shaped
    v: Dict[str, torch.Tensor]   # second moment, params-shaped


def _named(params: Any) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def reference_key(name: str) -> Tuple[Tuple[str, ...], bool]:
    """(the reference leaf's path, whether it is stacked over layers) of
    port parameter ``name``: ``layers.3.attn.wq`` -> (("layers", "attn",
    "wq"), True); ``dec.1.ln3.scale`` -> (("dec", "ln3", "scale"), True);
    ``shared.ln1.scale`` -> (("shared", "ln1", "scale"), False)."""
    path, layer = reference_leaf(name)
    return tuple(path.split(".")), layer is not None


def decays(name: str, t: torch.Tensor) -> bool:
    """The reference decays a leaf of rank >= 2; a stacked leaf has the
    port tensor's rank plus one."""
    return t.dim() + reference_key(name)[1] >= 2


def reference_order(names) -> List[List[str]]:
    """Port names grouped by reference leaf, the groups in the reference's
    flatten order, each group's layers in order."""
    groups: Dict[Tuple[str, ...], List[str]] = {}
    for n in names:
        groups.setdefault(reference_key(n)[0], []).append(n)
    layer = lambda n: reference_leaf(n)[1] or 0  # noqa: E731
    return [sorted(groups[k], key=layer) for k in sorted(groups)]


def adamw_init(params: Any, cfg: AdamWConfig) -> OptState:
    named = _named(params)
    dt = torch_dtype(cfg.state_dtype)
    dev = next(iter(named.values())).device
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m={n: zeros(p) for n, p in named.items()},
                    v={n: zeros(p) for n, p in named.items()})


def cosine_lr(cfg: AdamWConfig, step: Any) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    named = _named(tree)
    total: Any = 0
    for group in reference_order(named):
        leaf = None
        for n in group:
            sq = torch.sum(torch.square(named[n].detach().float()))
            leaf = sq if leaf is None else leaf + sq
        total = total + leaf
    if hasattr(total, "full_tensor"):  # DTensor leaves: reduce across ranks
        total = total.full_tensor()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(n: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    named = _named(tree)
    n = global_norm(named)
    scale = _clip_scale(n, max_norm)
    return {k: g * scale.to(g.dtype) for k, g in named.items()}, n


@torch.no_grad()
def adamw_update(params: Any, grads: Mapping[str, torch.Tensor],
                 state: OptState, cfg: AdamWConfig
                 ) -> Tuple[Dict[str, torch.Tensor], OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: the fused kernels where any parameter is
    on the card (they raise on a leaf elsewhere), ``adamw_update_plain``
    for parameters all on the CPU."""
    named = _named(params)
    if any(p.device.type == "cuda" for p in named.values()):
        return _fused_update(named, grads, state, cfg)
    return adamw_update_plain(named, grads, state, cfg)


def _schedule(cfg: AdamWConfig, state: OptState):
    """The step's 0-d float32 scalars: the step, lr and the bias corrections."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    return step, lr, bc1, bc2


@torch.no_grad()
def adamw_update_plain(params: Any, grads: Mapping[str, torch.Tensor],
                       state: OptState, cfg: AdamWConfig
                       ) -> Tuple[Dict[str, torch.Tensor], OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place, leaf by leaf.  Each leaf's gradient is
    cast to float32 on its own (after the norm), so no float32 copy of the
    whole gradient tree is made; the numbers are the reference's."""
    named = _named(params)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip else None
    step, lr, bc1, bc2 = _schedule(cfg, state)
    for name, p in named.items():
        g = grads[name].float()
        if scale is not None:
            g = g * scale
        m, v = state.m[name], state.v[name]
        mf = m.float()               # m itself when the state is float32
        mf.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        vf = v.float()
        vf.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        update = (mf / bc1).div_(torch.sqrt(vf / bc2).add_(cfg.eps))
        if decays(name, p):
            update.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - update.mul_(lr))
        if mf is not m:
            m.copy_(mf)
        if vf is not v:
            v.copy_(vf)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return named, OptState(step, state.m, state.v), metrics


_FUSED_DTYPES = (torch.float32, torch.bfloat16)


def _shard(name: str, p: torch.Tensor, g: torch.Tensor):
    """(p, g, the mesh, the mesh dimensions p is sharded over) of a leaf:
    a ``DTensor``'s gradient brought to its parameter's placements (a
    partial sum reduced), both as this rank's shards; a plain tensor as it
    is, with no mesh."""
    if not hasattr(p, "placements"):
        if hasattr(g, "placements"):
            raise ValueError(f"adamw: {name}: a DTensor gradient of a plain parameter")
        return p, g, None, ()
    if not hasattr(g, "placements"):
        raise ValueError(f"adamw: {name}: a plain gradient of a DTensor parameter")
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    dims = tuple(i for i, pl in enumerate(p.placements) if pl.is_shard())
    return p.to_local(), g.to_local(), p.device_mesh, dims


def _fused_update(named: Dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                  state: OptState, cfg: AdamWConfig):
    """``adamw_update`` through ``kernels.adamw`` on this rank's tensors.
    Raises on what the kernels do not take; nothing falls back to the loop."""
    names = list(named)
    ps, gs, ms, vs, cls = [], [], [], [], []
    classes: Dict[Any, int] = {}        # (mesh, sharded dims) -> class
    dev = next(p.device for p in named.values() if p.device.type == "cuda")
    for name in names:
        p, g, mesh, dims = _shard(name, named[name], grads[name])
        m, v = state.m[name], state.v[name]
        if mesh is not None:
            m, v = m.to_local(), v.to_local()
        if not g.is_contiguous():           # autograd may hand back a view
            g = g.contiguous()
        for what, t in (("parameter", p), ("gradient", g), ("m", m), ("v", v)):
            if t.device != dev or t.dtype not in _FUSED_DTYPES:
                raise ValueError(f"adamw: {name}: the {what} is {t.dtype} on "
                                 f"{t.device}; the kernel takes float32 or "
                                 f"bfloat16 on {dev}")
            if t.shape != p.shape or not t.is_contiguous():
                raise ValueError(f"adamw: {name}: the {what} of shape "
                                 f"{tuple(t.shape)} is not a contiguous "
                                 f"{tuple(p.shape)}")
        if m.dtype != v.dtype:
            raise ValueError(f"adamw: {name}: moments of {m.dtype} and {v.dtype}")
        ps.append(p)
        gs.append(g)
        ms.append(m)
        vs.append(v)
        cls.append(classes.setdefault((mesh, dims), len(classes)))
    sharded = (None, ()) not in classes
    if not sharded and len(classes) > 1:
        raise ValueError("adamw: DTensor leaves beside plain tensors")
    plan = _fused_plan(named, ps, [(p.dtype, g.dtype, m.dtype)
                                   for p, g, m in zip(ps, gs, ms)], cls, sharded)
    step, lr, bc1, bc2 = _schedule(cfg, state)
    clip = cfg.grad_clip or 0.0
    stats = fused.sumsq_and_finish(plan, gs, clip)
    if sharded:
        gnorm = torch.sqrt(_reduce_classes(stats, classes))
        scale = _clip_scale(gnorm, clip) if clip else None
    else:
        gnorm = stats[0]
        scale = stats[1] if clip else None
    hyper = fused.Hyper(cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
                        cfg.weight_decay)
    fused.update(plan, ps, gs, ms, vs, lr, bc1, bc2, scale, hyper)
    return named, OptState(step, state.m, state.v), {"lr": lr, "grad_norm": gnorm}


def _fused_plan(named: Dict[str, torch.Tensor], ps: List[torch.Tensor],
                dtypes: List[Tuple[torch.dtype, ...]], cls: List[int],
                sharded: bool):
    """The fused kernels' plan for leaves ``named`` whose shards ``ps`` and
    dtype triples are given, cached by all of them."""
    names = list(named)
    triples = tuple(tuple(str(d).removeprefix("torch.") for d in t) for t in dtypes)
    key = (tuple(names), tuple(p.numel() for p in ps), triples, tuple(cls), sharded)

    def leaves_groups():
        index = {n: i for i, n in enumerate(names)}
        leaves = [fused.Leaf(p.numel(), k, decays(n, named[n]), c)
                  for n, p, k, c in zip(names, ps, triples, cls)]
        groups = [[index[n] for n in grp] for grp in reference_order(names)]
        return leaves, groups, not sharded

    return fused.plan_cached(key, leaves_groups)


def fused_launches(params: Any, grad_dtype: Any = None,
                   state_dtype: str = "float32") -> Dict[str, int]:
    """Each fused kernel's launches in one ``adamw_update`` of plain-tensor
    ``params`` on the card, the gradients in ``grad_dtype`` (None: each
    parameter's own, as autograd gives them; the accumulator's dtype under
    accumulation)."""
    named = _named(params)
    ps = list(named.values())
    mdt = torch_dtype(state_dtype)
    dtypes = [(p.dtype, grad_dtype or p.dtype, mdt) for p in ps]
    return fused.launches(_fused_plan(named, ps, dtypes, [0] * len(ps), False))


def _reduce_classes(stats: torch.Tensor, classes: Dict[Any, int]) -> torch.Tensor:
    """The global sum of squares from each class's local sum: summed over
    the ranks of the mesh dimensions its leaves are sharded over (a
    partial sum there) and taken once over the others, as ``full_tensor``
    reduces ``global_norm``'s total; the classes added in order."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    total: Any = 0
    for (mesh, dims), c in classes.items():
        placements = [Partial() if d in dims else Replicate()
                      for d in range(mesh.ndim)]
        local = stats[2 + c].reshape(())
        total = total + DTensor.from_local(local, mesh, placements,
                                           run_check=False).full_tensor()
    return total
