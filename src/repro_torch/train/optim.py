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
of the moments would not fit on the card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Tuple

import torch
from torch import nn

from ..convert import reference_leaf, torch_dtype

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_lr", "global_norm", "clip_by_global_norm",
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
    """One AdamW step, in place.  Each leaf's gradient is cast to float32
    on its own (after the norm), so no float32 copy of the whole gradient
    tree is made; the numbers are the reference's."""
    named = _named(params)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip else None
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
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
