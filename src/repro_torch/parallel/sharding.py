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
    """Install mesh+rules ambiently for the calling thread."""
    prev = _ctx()
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


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


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """A ``DTensor`` redistributed to the spec's placements under the
    ambient mesh; anything else, or no mesh, is returned unchanged."""
    from torch.distributed.tensor import DTensor

    mesh, rules = _ctx()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements(logical_to_spec(logical_axes, mesh, rules), mesh)
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
