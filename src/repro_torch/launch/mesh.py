"""Device meshes over ``torch.distributed`` (``src/repro/launch/mesh.py``).

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") -- the
leading "pod" axis carries cross-pod data parallelism.

A mesh is a ``DeviceMesh`` of the ranks of the default process group, on
the card (``device_type="cuda"``, NCCL) unless the caller asks for
``"cpu"`` (gloo).  Building one never touches the network on its own:
with no process group initialised, ``make_host_mesh`` starts a group of
world size 1 over an in-process ``HashStore``; a larger world is set up by
its launcher (``torch.distributed.init_process_group`` with its own
address, world size and rank) before the mesh is made.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["make_production_mesh", "make_host_mesh"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _world(device_type: str) -> int:
    """The default group's world size, starting a world-size-1 group over a
    ``HashStore`` when there is none.  A ``"cuda"`` mesh needs a card
    whether or not a group is running, and a running group's backend must
    be the device type's (NCCL for ``"cuda"``, gloo for ``"cpu"``) or
    ``fake`` (the dry run's virtual ranks, ``launch/dryrun.py``)."""
    import torch.distributed as dist

    if device_type not in _BACKENDS:
        raise ValueError(f"device_type {device_type!r}: one of {sorted(_BACKENDS)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: ask for "
                           "device_type='cpu' to build a CPU mesh")
    if dist.is_initialized():
        backend = str(dist.get_backend())
        if backend != "fake" and _BACKENDS[device_type] not in backend:
            raise RuntimeError(
                f"a {device_type!r} mesh over a running {backend!r} group: "
                f"it needs {_BACKENDS[device_type]!r} (or the dry run's "
                f"'fake' group)")
        return dist.get_world_size()
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(_BACKENDS[device_type], store=dist.HashStore(),
                            rank=0, world_size=1)
    return dist.get_world_size()


def _mesh(device_type: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) pod mesh, or (2, 16, 16) with ``multi_pod``; raises when
    the default process group has fewer ranks than that."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh, have {have} (start "
            f"the process group with {n} ranks before building it)")
    _world(device_type)
    return _mesh(device_type, shape, axes)


def make_host_mesh(axes: Tuple[str, ...] = ("data",), device_type: str = "cuda",
                   shape: Optional[Tuple[int, ...]] = None):
    """A mesh over every rank of the default process group: all of them on
    the first axis, (world, 1, ...), or ``shape`` (whose product must be
    the world size)."""
    world = _world(device_type)
    shape = tuple(shape) if shape else (world,) + (1,) * (len(axes) - 1)
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {tuple(axes)} for "
                         f"{world} ranks")
    return _mesh(device_type, shape, tuple(axes))
