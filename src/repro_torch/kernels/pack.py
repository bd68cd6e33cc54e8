"""CUDA block-gather (pack) kernels: build, binding and launch wrappers.

``csrc/pack.cu`` holds the two kernels that replace the Pallas
``pack_blocks`` / ``pack_cols`` of the JAX package (see the source's header
for what they compute, their bound and their design).  ``kernels.build``
compiles the source with ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/libpack-<hash>.so`` under the checkout (the hash covers
the source and the ``nvcc`` flags, so an edit to either rebuilds); this
module loads it with ``ctypes`` and launches it on PyTorch's current stream.

``check_args`` validates what the kernels cannot: a 2-D C-contiguous
source and tile offsets inside the source, checked on the host before they
are copied to the device (a CUDA load past the buffer is not clamped the
way a TPU DMA is).  ``kernels.ops`` calls it and dispatches on
``tensor.is_cuda``; the launchers here count every launch in
``build.launch_counts()`` so a run can show that its reshards went through
the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Any

import numpy as np
import torch

from . import build as _build

__all__ = ["check_args", "pack_blocks", "pack_cols"]

_lib: Any = None


def _library() -> Any:
    global _lib
    if _lib is None:
        lib = _build.load("pack")
        for fn in (lib.wlk_pack_rows, lib.wlk_pack_cols):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_args(src: torch.Tensor, tile_offsets: Any, tile: int,
               dim: int) -> np.ndarray:
    """Validate a pack call; returns the offsets as host ``np.int32``.

    ``src`` must be a 2-D C-contiguous tensor and ``tile_offsets`` a 1-D
    host integer array (as ``CompiledPlan.pack_tiles`` gives them) whose
    every entry names a tile of ``src`` along ``dim`` (``0 <= off <
    ceil(src.shape[dim] / tile)``; a ragged tail tile reads as zeros)."""
    if not isinstance(src, torch.Tensor):
        raise TypeError(f"pack source must be a torch.Tensor, got {type(src).__name__}")
    if src.dim() != 2:
        raise ValueError(f"pack source must be 2-D, got shape {tuple(src.shape)}")
    if not src.is_contiguous():
        raise ValueError(f"pack source must be C-contiguous, got strides {src.stride()}")
    if tile < 1:
        raise ValueError(f"tile extent must be >= 1, got {tile}")
    if isinstance(tile_offsets, torch.Tensor):
        raise TypeError("tile offsets must be a host integer array (numpy), "
                        "not a tensor")
    offs = np.asarray(tile_offsets)
    if offs.ndim != 1 or (offs.size and not np.issubdtype(offs.dtype, np.integer)):
        raise ValueError(f"tile offsets must be a 1-D integer array, got "
                         f"{offs.dtype} of shape {offs.shape}")
    n_tiles = -(-int(src.shape[dim]) // tile)
    if offs.size and (offs.min() < 0 or offs.max() >= n_tiles):
        raise ValueError(f"tile offsets must lie in [0, {n_tiles}) for a source "
                         f"of {src.shape[dim]} along dim {dim} in tiles of "
                         f"{tile}; got [{offs.min()}, {offs.max()}]")
    return offs.astype(np.int32, copy=False)


def _launch(name: str, fn_name: str, src: torch.Tensor, offs: np.ndarray,
            tile: int, out: torch.Tensor) -> torch.Tensor:
    if not src.is_cuda:
        raise ValueError(f"{name} launches on CUDA tensors only, got {src.device}")
    if len(offs) >= 2**31:
        raise ValueError(f"{name}: {len(offs)} tiles exceed the grid")
    if out.numel() == 0:
        return out
    # A copy from pageable host memory: PyTorch synchronises the current
    # stream for it, so every launch waits for the work queued before it.
    d_offs = torch.from_numpy(np.ascontiguousarray(offs)).to(src.device)
    fn = getattr(_library(), fn_name)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), out.data_ptr(), d_offs.data_ptr(),
                 src.shape[0], src.shape[1], tile, len(offs),
                 src.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _build.count(name)
    return out


def pack_blocks(src: torch.Tensor, offs: np.ndarray, tile_rows: int) -> torch.Tensor:
    """K1 on the card: ``out[t*tr:(t+1)*tr] = src[offs[t]*tr:(offs[t]+1)*tr]``
    for arguments ``check_args(src, offs, tile_rows, 0)`` accepted."""
    out = torch.empty((len(offs) * tile_rows, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    return _launch("pack_blocks", "wlk_pack_rows", src, offs, tile_rows, out)


def pack_cols(src: torch.Tensor, offs: np.ndarray, tile_cols: int) -> torch.Tensor:
    """K2 on the card: ``out[:, t*tc:(t+1)*tc] = src[:, offs[t]*tc:...]``
    for arguments ``check_args(src, offs, tile_cols, 1)`` accepted."""
    out = torch.empty((src.shape[0], len(offs) * tile_cols), dtype=src.dtype,
                      device=src.device)
    return _launch("pack_cols", "wlk_pack_cols", src, offs, tile_cols, out)
