"""Logical-axis sharding: one model codebase, any mesh
(``src/repro/parallel/sharding.py``).

Model code annotates activations/params with *logical* axis names
("batch", "fsdp", "tensor", "expert", "seq").  A ``ShardingRules`` table maps
logical names to mesh axis names; ``use_mesh`` installs a mesh + rules
ambiently -- per thread, since the task threads of a workflow share the
process -- so the same model code runs unsharded on one device and sharded
on a ``torch.distributed`` device mesh.

Baseline rules (paper-faithful data/tensor layout):
    batch  -> (pod, data)     fsdp   -> (pod, data)
    tensor -> model           expert -> model        seq -> unsharded

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions (``launch/mesh.py``).  ``logical_to_spec`` gives the port's
``PartitionSpec``: one entry per *tensor* dimension, each ``None``, a mesh
axis name or a tuple of them, as JAX's ``PartitionSpec`` has.  DTensor
describes the same layout the other way round, one placement per *mesh*
dimension; ``placements`` converts.  A tensor dimension split over several
mesh axes is split in the mesh's order (row-major), as JAX splits it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "SERVE_RULES",
    "RULE_VARIANTS",
    "PartitionSpec",
    "use_mesh",
    "current_mesh",
    "current_rules",
    "constrain",
    "weight",
    "logical_to_spec",
    "placements",
    "mesh_sharding",
    "tree_shardings",
    "whole_along",
    "replicated",
    "place",
    "place_tree",
    "place_module",
    "axis_size",
    "axis_index",
    "axis_group",
    "fit",
    "partial_grads",
    "local_apply",
]

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (not split), a mesh axis
    name, or a tuple of mesh axis names (split over all of them).
    ``PartitionSpec()`` is replicated."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, MeshAxes], ...] = (
        ("batch", ("pod", "data")),
        ("fsdp", ("pod", "data")),
        ("tensor", "model"),
        ("expert", "model"),
        ("seq", None),
        ("kv", None),
        ("kvseq", None),
    )
    # FSDP weight gathering: when True, ``weight`` re-constrains each weight
    # to be replicated over the fsdp axes right before use, so the weight is
    # all-gathered instead of the partial-sum activations being all-reduced.
    weight_gather: bool = False

    def lookup(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def with_(self, weight_gather: Optional[bool] = None,
              **kw: MeshAxes) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        wg = self.weight_gather if weight_gather is None else weight_gather
        return ShardingRules(tuple(d.items()), weight_gather=wg)


DEFAULT_RULES = ShardingRules()

# Serving layout: KV caches are *sequence*-sharded over the model axis
# (context parallelism) -- kv-head counts (8) don't divide the 16-way model
# axis, cache length always does.  Weights keep the fsdp x tensor layout.
SERVE_RULES = DEFAULT_RULES.with_(kvseq="model")

# Named rule tables: model code never changes -- each variant is one swap of
# the logical->mesh mapping (+ weight gathering).
RULE_VARIANTS: Dict[str, ShardingRules] = {
    # paper-faithful baselines
    "baseline": DEFAULT_RULES,
    "serve_baseline": SERVE_RULES,
    # FSDP weight gathering: all-gather weights instead of all-reducing
    # partial-sum activations when contracting over the fsdp-sharded dim
    "wg": DEFAULT_RULES.with_(weight_gather=True),
    "serve_wg": SERVE_RULES.with_(weight_gather=True),
    # + sequence parallelism: residual-stream activations sharded over the
    # model axis between TP regions (all-reduce -> reduce-scatter+all-gather)
    "sp": DEFAULT_RULES.with_(weight_gather=True, seq="model"),
    # pure data parallelism over every rank (small models): no tensor axis;
    # params stay fully sharded (ZeRO-3) and are gathered per use
    "dp": DEFAULT_RULES.with_(
        weight_gather=True,
        batch=("pod", "data", "model"),
        fsdp=("pod", "data", "model"),
        tensor=None, expert=None),
    # decode with weights replicated over the data axis (TP only)
    "serve_repl": SERVE_RULES.with_(fsdp=None),
    # MoE expert parallelism: experts sharded over the model axis, the expert
    # FFN dim over data (so no contraction dim of the expert matmuls is
    # sharded), dense/attention weights TP'd over data -- the Megatron-MoE
    # layout.  Tokens move to experts instead of expert weights to tokens.
    "moe_ep": DEFAULT_RULES.with_(
        weight_gather=True, fsdp=None, tensor="data", expert="model"),
    # same layout, with the dispatch through the explicit expert-parallel
    # schedule (models/moe_a2a.py)
    "moe_a2a": DEFAULT_RULES.with_(
        weight_gather=True, fsdp=None, tensor="data", expert="model"),
}

_state = threading.local()


def _ctx() -> Tuple[Optional[Any], ShardingRules]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", DEFAULT_RULES)


@contextmanager
def use_mesh(mesh: Optional[Any], rules: ShardingRules = DEFAULT_RULES):
    """Install mesh+rules ambiently for the calling thread.  With a mesh,
    DTensor also takes a plain tensor met beside a ``DTensor`` (a mask, a
    position range the model builds) as replicated: every rank builds the
    same one (``implicit_replication``; DTensor's switch is per process)."""
    prev = _ctx()
    _state.mesh, _state.rules = mesh, rules
    try:
        if mesh is None or _implicit_replication_on():
            yield            # a nested use keeps the outer one's switch on
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _state.mesh, _state.rules = prev


def _implicit_replication_on() -> bool:
    from torch.distributed.tensor import DTensor

    return bool(DTensor._op_dispatcher._allow_implicit_replication)


def current_mesh() -> Optional[Any]:
    return _ctx()[0]


def current_rules() -> Optional[ShardingRules]:
    mesh, rules = _ctx()
    return rules if mesh is not None else None


def _axis_names(mesh: Any) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _filter_axes(mesh: Any, axes: MeshAxes) -> MeshAxes:
    """Drop mesh-axis names not present in this mesh (pod on single-pod)."""
    if axes is None:
        return None
    names = _axis_names(mesh)
    if isinstance(axes, str):
        return axes if axes in names else None
    kept = tuple(a for a in axes if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    mesh: Optional[Any] = None,
                    rules: Optional[ShardingRules] = None) -> PartitionSpec:
    m, r = _ctx()
    mesh = m if mesh is None else mesh
    rules = r if rules is None else rules
    parts = []
    used: set = set()
    for ax in logical_axes:
        mapped = rules.lookup(ax)
        if mesh is not None:
            mapped = _filter_axes(mesh, mapped)
        # an axis name may appear only once in a PartitionSpec
        if mapped is not None:
            flat = (mapped,) if isinstance(mapped, str) else mapped
            if any(a in used for a in flat):
                mapped = None
            else:
                used.update(flat)
        parts.append(mapped)
    return PartitionSpec(*parts)


def placements(spec: Sequence[MeshAxes], mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dimension that splits tensor dimension ``d``, ``Replicate()`` on
    the others.  A tensor dimension split over several mesh axes must name
    them in the mesh's order (DTensor splits in that order, row-major, as
    JAX does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        flat = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in flat]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes!r} of dimension {d} is not in "
                             f"the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _unit_dims_whole(plc: Sequence[Any], shape: Sequence[int]) -> Tuple[Any, ...]:
    """``plc`` with a split of a dimension of size 1 made ``Replicate``:
    the same layout (one rank holds the row either way on a mesh axis of
    size 1, the case it arises in: a batch of one on a (1, 1) mesh), which
    DTensor can flatten with the next dimension."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_shard() and shape[p.dim] == 1 else p
                 for p in plc)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """A ``DTensor`` redistributed to the spec's placements under the
    ambient mesh; anything else, or no mesh, is returned unchanged."""
    from torch.distributed.tensor import DTensor

    mesh, rules = _ctx()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = _unit_dims_whole(
        placements(logical_to_spec(logical_axes, mesh, rules), mesh), x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def weight(x: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Weight access point: under ``weight_gather`` rules, re-constrain the
    weight to be replicated over its fsdp axes (a weight all-gather whose
    gradient comes back as a reduce-scatter).  Otherwise identity."""
    mesh, rules = _ctx()
    if mesh is None or not rules.weight_gather:
        return x
    axes = tuple(None if a == "fsdp" else a for a in logical_axes)
    return constrain(x, axes)


def mesh_sharding(mesh: Any, logical_axes: Sequence[Optional[str]],
                  rules: ShardingRules = DEFAULT_RULES) -> Tuple[Any, ...]:
    """The placements of one tensor with ``logical_axes`` on ``mesh``."""
    return placements(logical_to_spec(logical_axes, mesh, rules), mesh)


def _is_spec_leaf(x: Any) -> bool:
    return x is None or (isinstance(x, tuple) and not hasattr(x, "_fields")
                         and all(e is None or isinstance(e, str) for e in x))


def tree_shardings(mesh: Any, logical_tree: Any,
                   rules: ShardingRules = DEFAULT_RULES) -> Any:
    """Map a tree (dicts, named tuples) of logical-axis tuples to
    placements.  A leaf is a tuple of logical axis names or None; ``()``
    and ``None`` are replicated."""
    if _is_spec_leaf(logical_tree):
        return mesh_sharding(mesh, logical_tree or (), rules)
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, v, rules) for k, v in logical_tree.items()}
    if hasattr(logical_tree, "_fields"):
        return type(logical_tree)(*(tree_shardings(mesh, v, rules)
                                    for v in logical_tree))
    raise TypeError(f"not a spec tree: {logical_tree!r}")


# ------------------------------------------------------------- placement
def whole_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A ``DTensor`` gathered along tensor dimension ``dim`` (its other
    splits kept); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_shard(dim) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_shard(dim) else p for p in x.placements))


def replicated(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """``x`` as a ``DTensor`` replicated on ``mesh`` (every rank holds the
    same ``x``); a ``DTensor`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def place(x: torch.Tensor, mesh: Any, plc: Sequence[Any]) -> torch.Tensor:
    """``x`` as a ``DTensor`` with placements ``plc`` on ``mesh``, this
    rank's shard cut from ``x`` itself (every rank holds the same ``x``: no
    collective) into storage of its own, so that no rank keeps the whole."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    plc = _unit_dims_whole(plc, x.shape)
    d = distribute_tensor(x.detach(), mesh, plc, src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh, plc,
                              run_check=False, shape=d.shape, stride=d.stride())


def place_tree(tree: Any, plc_tree: Any, mesh: Any) -> Any:
    """``place`` every tensor leaf of a tree (dicts, named tuples) with the
    placements at the same place of ``plc_tree`` (``tree_shardings``);
    other leaves are kept as they are."""
    if isinstance(tree, dict):
        return {k: place_tree(v, plc_tree[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(place_tree(v, p, mesh) for v, p in zip(tree, plc_tree)))
    if isinstance(tree, torch.Tensor):
        return place(tree, mesh, plc_tree)
    return tree


def place_module(model: torch.nn.Module, plc: Dict[str, Any], mesh: Any
                 ) -> torch.nn.Module:
    """Replace every parameter of ``model`` (in place) by its ``place``d
    ``DTensor``; ``plc`` maps parameter names to placements."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, torch.nn.Parameter(place(p, mesh, plc[name]),
                                              requires_grad=p.requires_grad))
    return model


# ------------------------------------------------- local (per-shard) code
def _mesh_axes(logical: Optional[str]) -> Tuple[str, ...]:
    mesh, rules = _ctx()
    if mesh is None:
        return ()
    a = _filter_axes(mesh, rules.lookup(logical))
    return () if a is None else ((a,) if isinstance(a, str) else tuple(a))


def axis_size(logical: Optional[str]) -> int:
    """How many ways the ambient rules split a dimension of ``logical``
    axis (1 without a mesh)."""
    mesh, _ = _ctx()
    n = 1
    for a in _mesh_axes(logical):
        n *= mesh.size(_axis_names(mesh).index(a))
    return n


def axis_index(logical: Optional[str]) -> int:
    """This rank's row-major index over the mesh axes of ``logical``."""
    mesh, _ = _ctx()
    idx = 0
    if mesh is None:
        return idx
    coord = mesh.get_coordinate()
    for a in _mesh_axes(logical):
        i = _axis_names(mesh).index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def axis_group(logical: Optional[str]) -> Any:
    """The process group over the mesh axes of ``logical`` (None when they
    are fewer than two ranks)."""
    mesh, _ = _ctx()
    axes = _mesh_axes(logical)
    if axis_size(logical) == 1:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def fit(logical_axes: Sequence[Optional[str]], shape: Sequence[int]
        ) -> Tuple[Optional[str], ...]:
    """``logical_axes`` with every axis dropped (replicated there) whose
    split does not divide its dimension of ``shape``, or whose mesh axes an
    earlier entry takes (``logical_to_spec`` drops it the same way): the
    layout of slices of it (a weight's rows) then matches."""
    spec = logical_to_spec(logical_axes)
    return tuple(a if a is None or (spec[d] is not None
                                    and shape[d] % axis_size(a) == 0) else None
                 for d, a in enumerate(logical_axes))


def partial_grads(plc: Sequence[Any]) -> Tuple[Any, ...]:
    """``plc`` with every ``Replicate`` made ``Partial``: the layout of the
    gradient of an input that every rank holds whole along those mesh
    dimensions but uses for its own part of the work (its batch shard, its
    heads), so that the ranks' gradients must be summed."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if p.is_replicate() else p for p in plc)


def local_apply(fn, args: Sequence[Any], in_axes: Sequence[Any],
                out_axes: Sequence[Any], summed: Sequence[int] = ()):
    """Run ``fn`` on each rank's shard: each ``DTensor`` argument is
    redistributed to its logical layout in ``in_axes`` and passed as its
    local tensor (``None`` in ``in_axes``: passed as it is), and each
    output is wrapped as a ``DTensor`` with its layout in ``out_axes``
    (evenly split; ``None``: returned as it is).  The gradient of an
    argument keeps its layout, but for the arguments at the positions
    ``summed``, which each rank uses for its own part of the work: their
    gradients are summed over the mesh dimensions they are whole on
    (``partial_grads``).  The reference's GSPMD
    partitions such code itself; DTensor has no strategy for some of its
    ops (an in-place write at a traced position, a sort), so the port
    says per op what each rank computes.  Without a mesh, or with no
    ``DTensor`` argument, it is ``fn(*args)``.  Differentiable."""
    from torch.distributed.tensor import DTensor

    mesh, rules = _ctx()
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    local = []
    for i, (a, ax) in enumerate(zip(args, in_axes)):
        if isinstance(a, DTensor) and ax is not None:
            want = _unit_dims_whole(
                placements(logical_to_spec(ax, mesh, rules), mesh), a.shape)
            if tuple(a.placements) != want:
                a = a.redistribute(mesh, want)
            a = a.to_local(grad_placements=partial_grads(want) if i in summed
                           else None)
        local.append(a)
    out = fn(*local)
    if out is None:
        return None
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    def wrap(o, ax):
        plc = placements(logical_to_spec(ax, mesh, rules), mesh)
        shape = list(o.shape)          # the global shape of an even split
        for i, p in enumerate(plc):
            if p.is_shard():
                shape[p.dim] *= mesh.size(i)
        return DTensor.from_local(o, mesh, _unit_dims_whole(plc, shape),
                                  run_check=False)

    wrapped = tuple(o if ax is None or not isinstance(o, torch.Tensor)
                    else wrap(o, ax) for o, ax in zip(outs, out_axes))
    return wrapped[0] if single else wrapped
