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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["dtype_name", "as_dtype", "host_dtype", "torch_dtype",
           "tensor_from_numpy", "numpy_from_tensor", "host_copy",
           "file_from_numpy"]

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
