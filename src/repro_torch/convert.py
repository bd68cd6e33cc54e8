"""Conversions between numpy arrays and torch tensors, and the port's dtypes.

numpy has no bfloat16, and this package may not use ``ml_dtypes`` (the
machine with the GPU does not have it), so a bfloat16 tensor crosses to
the host as its 16-bit pattern: an ``int16`` array.  An array whose dtype
is *named* ``"bfloat16"`` (an ``ml_dtypes`` array, as the JAX package
produces) crosses the other way through the same 16-bit view.  Every other
dtype maps one to one.

``dtype_name`` is the one spelling of a dtype the port keys on (plan
cache, dataset checks); ``as_dtype`` is what a ``Dataset`` records: numpy's
dtype where numpy has one, else the torch dtype.

``params_from_reference`` loads the JAX package's parameter tree (as host
arrays) into the port's model of the same config, so both packages compute
the same function in the tests; ``params_to_reference`` is its inverse.
``train_state_from_reference``/``train_state_to_reference`` do the same
for a whole training state ``(params, OptState(step, m, v), rng)``, so a
checkpoint of either package's ``TrainState`` resumes in the other.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["dtype_name", "as_dtype", "host_dtype", "torch_dtype",
           "tensor_from_numpy", "numpy_from_tensor", "host_copy",
           "file_from_numpy", "params_from_reference", "params_to_reference",
           "train_state_from_reference", "train_state_to_reference"]

_BF16 = "bfloat16"


def dtype_name(dt: Any) -> str:
    """Canonical name of a dtype, array or tensor: ``"float32"``,
    ``"bfloat16"``, ``"int32"`` ...  numpy and torch spell every shared
    dtype the same way, so one name keys both."""
    if isinstance(dt, (torch.Tensor, np.ndarray)):
        dt = dt.dtype
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    if isinstance(dt, str) and dt == _BF16:
        return dt
    return np.dtype(dt).name


def as_dtype(dt: Any) -> Any:
    """The dtype a ``Dataset`` records: a ``np.dtype``, or
    ``torch.bfloat16`` for the one dtype numpy lacks.  Both carry
    ``.itemsize``."""
    name = dtype_name(dt)
    return torch.bfloat16 if name == _BF16 else np.dtype(name)


def host_dtype(dt: Any) -> np.dtype:
    """The numpy dtype of ``dt``'s host bytes (``int16`` for bfloat16)."""
    name = dtype_name(dt)
    return np.dtype(np.int16) if name == _BF16 else np.dtype(name)


def torch_dtype(dt: Any) -> torch.dtype:
    return getattr(torch, dtype_name(dt))


def tensor_from_numpy(a: Any, device: Any) -> torch.Tensor:
    """A tensor on ``device`` holding a copy of ``a``'s values (bfloat16
    arrays reinterpreted through their 16-bit pattern)."""
    a = np.array(a, order="C")  # own, writable, contiguous bytes
    if a.dtype.name == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """``t``'s values on the host; bfloat16 comes back as its int16 bit
    pattern.  A CPU tensor's array shares its memory, a CUDA tensor's is a
    copy -- use ``host_copy`` where a private buffer is required."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A private, C-contiguous host copy of ``t`` (one copy, from any
    device), bfloat16 as its int16 bit pattern."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", memory_format=torch.contiguous_format, copy=True).numpy()


def file_from_numpy(arrays: Mapping[str, Any], *, device: Any,
                    ownership: Optional[Mapping[str, Any]] = None,
                    filename: str = "data.h5"):
    """A port ``File`` whose datasets are device-resident copies of
    ``arrays`` (``{path: ndarray}``), adopted with ``copy=False``.
    ``ownership`` maps a path to its ``BlockOwnership``."""
    from .core.datamodel import File

    f = File(filename)
    owners: Dict[str, Any] = dict(ownership or {})
    for path, a in arrays.items():
        ds = f.create_dataset(path, data=tensor_from_numpy(a, device), copy=False)
        ds.ownership = owners.get(path)
    return f


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


# the reference's subtrees stacked along a leading layer axis: ``layers``
# (every decoder-only family), ``enc`` and ``dec`` (encdec).  Others, such
# as the hybrid's ``shared`` block, hold one weight set.
STACKED = ("layers", "enc", "dec")


def reference_leaf(name: str) -> Tuple[str, Optional[int]]:
    """(the reference leaf's dotted path, the layer index or None) of port
    parameter ``name``: ``dec.1.ln3.scale`` -> ("dec.ln3.scale", 1);
    ``shared.ln1.scale`` -> ("shared.ln1.scale", None)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKED and parts[1].isdigit():
        return ".".join([parts[0]] + parts[2:]), int(parts[1])
    return name, None


def _unstack(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's nested, layer-stacked tree as ``{port name: array}``:
    slice i of ``<stack>/<path>`` becomes ``<stack>.<i>.<path>`` for each
    stack in ``STACKED``."""
    arrays: Dict[str, Any] = {}
    for name, a in _flatten(tree):
        stack, _, rest = name.partition(".")
        if stack in STACKED and rest:
            for i in range(np.shape(a)[0]):
                arrays[f"{stack}.{i}.{rest}"] = a[i]
        else:
            arrays[name] = a
    return arrays


def _stack(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``{port name: tensor}`` as the reference's nested, layer-stacked tree
    of CPU tensors (the inverse of ``_unstack``)."""
    stacked: Dict[str, Dict[int, torch.Tensor]] = {}
    flat: Dict[str, torch.Tensor] = {}
    for name, t in named.items():
        key, layer = reference_leaf(name)
        t = t.detach().cpu()
        if layer is None:
            flat[name] = t
        else:
            stacked.setdefault(key, {})[layer] = t
    for name, by_layer in stacked.items():
        flat[name] = torch.stack([by_layer[i] for i in range(len(by_layer))])
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def params_to_reference(model: Any) -> Dict[str, Any]:
    """The reference's parameter tree of ``model``: nested dicts of CPU
    tensors, the layers stacked along a leading axis (``layers.<i>.<path>``
    back to slice i of ``layers/<path>``, and so for ``enc``/``dec``).
    ``numpy_from_tensor`` gives host arrays (bfloat16 as its bit
    pattern)."""
    return _stack(dict(model.named_parameters()))


def train_state_to_reference(state: Any) -> Any:
    """``TrainState(params, OptState(step, m, v), rng)`` in the reference's
    layout (the port's ``TrainState``/``OptState`` named tuples, whose
    checkpoint keys and tree structure are the reference's): parameters
    and moments as ``params_to_reference`` gives them, ``step`` a 0-d int32
    CPU tensor, ``rng`` a uint32[2] array."""
    from .train.optim import OptState
    from .train.trainer import TrainState

    model, opt, rng = state
    return TrainState(params=params_to_reference(model),
                      opt=OptState(step=opt.step.detach().cpu(),
                                   m=_stack(opt.m), v=_stack(opt.v)),
                      rng=np.asarray(rng, np.uint32))


def train_state_from_reference(cfg: Any, state: Any, device: Any = None) -> Any:
    """The port's ``TrainState`` on ``device`` from a training state in the
    reference's layout: the JAX package's ``TrainState`` as host arrays, or
    what ``load_pytree`` restores into ``train_state_to_reference``'s
    structure.  The moments keep their stored dtype."""
    from .train.optim import OptState
    from .train.trainer import TrainState

    params, (step, m, v), rng = state
    model = params_from_reference(cfg, params, device)
    dev = next(model.parameters()).device

    def moments(tree):
        return {n: _tensor(a, dev) for n, a in _unstack(tree).items()}

    return TrainState(
        params=model,
        opt=OptState(step=_tensor(step, dev).to(torch.int32),
                     m=moments(m), v=moments(v)),
        rng=np.asarray(rng, np.uint32))


def params_from_reference(cfg: Any, tree: Mapping[str, Any], device: Any = None):
    """The port's model of ``cfg`` on ``device`` holding the reference's
    parameters ``tree`` (nested dicts of host arrays, as
    ``jax.tree.map(np.asarray, get_family(cfg).init(key, cfg))`` gives).

    The reference stacks its layers along a leading axis; slice i of
    ``layers/<path>`` becomes parameter ``layers.<i>.<path>`` (and so for
    encdec's ``enc``/``dec``).  Layouts are
    the same in both packages, so every parameter is a copy; bfloat16
    crosses through its 16-bit view.  Raises on a missing or extra name, or
    on a shape or dtype that differs."""
    from .models.registry import get_family

    model = get_family(cfg).model(cfg, device)
    arrays = _unstack(tree)
    params = dict(model.named_parameters())
    if set(arrays) != set(params):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(params) - set(arrays))}, unexpected "
                       f"{sorted(set(arrays) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            t = _tensor(arrays[name], p.device)
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(t.shape)} "
                                 f"{t.dtype}, port {tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    return model


def _tensor(a: Any, device: Any) -> torch.Tensor:
    """``a`` (a host array or a CPU tensor) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device)
    return tensor_from_numpy(a, device)
