"""Abstract inputs and step builders for every (arch x shape) cell
(``src/repro/launch/specs.py``).

``input_specs(cfg, shape)`` returns the exact inputs the step function
takes as tensors on the ``meta`` device: shapes and dtypes, never
allocated (the reference's ``ShapeDtypeStruct``s from ``jax.eval_shape``).
The training state is ``trainer.init_state`` built on ``meta``, the
parameters ``fam.init(cfg, None, device="meta")``, the caches
``fam.init_cache`` on ``meta``.  ``make_cell`` packages (step fn, args,
per-argument placements) for the dry run: train shapes run
``make_train_step``; prefill shapes run ``prefill``; decode shapes run one
``decode_step`` (a single new token against a ``seq_len`` cache).

``place_args`` turns a cell's arguments, or concrete ones of the same
structure, into ``DTensor``s with the cell's placements.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import Shape
from ..convert import torch_dtype
from ..models.registry import get_family
from ..parallel.sharding import (DEFAULT_RULES, SERVE_RULES, ShardingRules,
                                 logical_to_spec, place, place_module,
                                 place_tree, placements, use_mesh)
from ..train.optim import AdamWConfig
from ..train.trainer import (TrainState, init_state, make_train_step,
                             place_state, state_specs)

__all__ = ["token_specs", "input_specs", "Cell", "make_cell", "place_args"]

META = torch.device("meta")


def _batch_axes(mesh, global_batch: int):
    """Batch logical axes: shard over (pod, data) when divisible, else
    replicate (long_500k has global_batch=1)."""
    n = 1
    names = tuple(mesh.mesh_dim_names or ())
    for i, a in enumerate(names):
        if a in ("pod", "data"):
            n *= mesh.size(i)
    return ("batch",) if global_batch % n == 0 else (None,)


def token_specs(cfg, shape: Shape) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if shape.kind == "train":
        specs["labels"] = torch.empty((b, s), dtype=torch.int32, device=META)
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        specs["vision_embeds"] = torch.empty((b, cfg.vision_tokens, cfg.d_model),
                                             dtype=dt, device=META)
    if cfg.family == "encdec":
        specs["frames"] = torch.empty((b, cfg.source_len, cfg.d_model),
                                      dtype=dt, device=META)
    return specs


def input_specs(cfg, shape: Shape) -> Dict[str, Any]:
    """All inputs of this cell's step function, on ``meta``."""
    fam = get_family(cfg)
    out: Dict[str, Any] = {"batch": token_specs(cfg, shape)}
    if shape.kind == "train":
        ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        out["state"] = init_state(None, cfg, ocfg, META)
    else:
        out["params"] = fam.init(cfg, None, META)
        max_len = shape.seq_len + (cfg.vision_tokens if cfg.family == "vlm" else 0)
        out["cache"] = fam.init_cache(cfg, shape.global_batch, max_len,
                                      device=META)
        if shape.kind == "decode":
            out["token"] = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                       device=META)
    return out


@dataclass
class Cell:
    """One traced unit: ``fn(*args)`` with each argument's logical specs
    (``PartitionSpec`` trees, ``specs``) and ``DTensor`` placements."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    placements: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...]
    specs: Tuple[Any, ...]


def _spec_tree(mesh, tree: Any, rules: ShardingRules) -> Any:
    """``tree_shardings``'s tree with ``PartitionSpec`` leaves."""
    if tree is None or (isinstance(tree, tuple) and not hasattr(tree, "_fields")
                        and all(e is None or isinstance(e, str) for e in tree)):
        return logical_to_spec(tree or (), mesh, rules)
    if isinstance(tree, dict):
        return {k: _spec_tree(mesh, v, rules) for k, v in tree.items()}
    return type(tree)(*(_spec_tree(mesh, v, rules) for v in tree))


def _placements(mesh, specs: Any) -> Any:
    if isinstance(specs, dict):
        return {k: _placements(mesh, v) for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(_placements(mesh, v) for v in specs))
    return placements(specs, mesh)


def make_cell(cfg, shape: Shape, mesh,
              rules: Optional[ShardingRules] = None,
              accum_steps: int = 1,
              compress_grads: bool = False) -> Cell:
    fam = get_family(cfg)
    specs = input_specs(cfg, shape)
    baxes = _batch_axes(mesh, shape.global_batch)
    if baxes == (None,) and rules is not None:
        rules = rules.with_(batch=None)       # replicate tiny batches everywhere
    elif baxes == (None,):
        rules = (DEFAULT_RULES if shape.kind == "train" else SERVE_RULES
                 ).with_(batch=None)

    def batch_specs(batch):
        return {k: logical_to_spec(baxes + (None,) * (v.dim() - 1), mesh,
                                   rules or DEFAULT_RULES)
                for k, v in batch.items()}

    def cell(fn, args, arg_specs, donate):
        return Cell(name=f"{cfg.name}:{shape.name}", fn=fn, args=args,
                    placements=tuple(_placements(mesh, s) for s in arg_specs),
                    donate_argnums=donate, specs=arg_specs)

    if shape.kind == "train":
        r = rules or DEFAULT_RULES
        step = make_train_step(cfg, accum_steps=accum_steps,
                               compress_grads=compress_grads)

        def fn(state, batch):
            with use_mesh(mesh, r):
                return step(state, batch)

        return cell(fn, (specs["state"], specs["batch"]),
                    (_spec_tree(mesh, state_specs(cfg), r),
                     batch_specs(specs["batch"])), (0,))

    r = rules or SERVE_RULES
    p_specs = _spec_tree(mesh, fam.param_specs(cfg), r)
    c_specs = _spec_tree(mesh, fam.cache_specs(cfg), r)

    if shape.kind == "prefill":
        def fn(params, batch, cache):
            with use_mesh(mesh, r), torch.no_grad():
                return fam.prefill(params, cfg, batch, cache)

        return cell(fn, (specs["params"], specs["batch"], specs["cache"]),
                    (p_specs, batch_specs(specs["batch"]), c_specs), (2,))

    # decode: one new token against a seq_len KV cache
    def fn(params, token, cache):
        with use_mesh(mesh, r), torch.no_grad():
            return fam.decode_step(params, cfg, token, cache)

    tok = logical_to_spec(baxes + (None,), mesh, r)
    return cell(fn, (specs["params"], specs["token"], specs["cache"]),
                (p_specs, tok, c_specs), (2,))


def place_args(cell: Cell, mesh, args: Optional[Tuple[Any, ...]] = None
               ) -> Tuple[Any, ...]:
    """``args`` (default: the cell's own), each tensor leaf a ``DTensor``
    with the cell's placements; a model's parameters (the parameters, or
    the training state's) are replaced in place."""
    def one(a, plc):
        if isinstance(a, torch.nn.Module):
            return place_module(a, plc, mesh)
        if isinstance(a, TrainState):
            return place_state(a, plc, mesh)
        if isinstance(a, torch.Tensor):
            return place(a, mesh, plc)
        return place_tree(a, plc, mesh)

    return tuple(one(a, p) for a, p in zip(args or cell.args, cell.placements))
