"""The port's parallel layer: logical-axis sharding rules over a
``torch.distributed`` device mesh (``src/repro/parallel``)."""

from .sharding import (
    ShardingRules,
    DEFAULT_RULES,
    SERVE_RULES,
    PartitionSpec,
    use_mesh,
    current_mesh,
    constrain,
    logical_to_spec,
    placements,
    mesh_sharding,
    tree_shardings,
)

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "SERVE_RULES",
    "PartitionSpec",
    "use_mesh",
    "current_mesh",
    "constrain",
    "logical_to_spec",
    "placements",
    "mesh_sharding",
    "tree_shardings",
]
