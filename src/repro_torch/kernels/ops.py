"""Public pack wrappers: the CUDA kernels for CUDA tensors, their plain
versions (``ref``) for CPU tensors.

Both paths validate the same way (``pack.check_args``: 2-D, C-contiguous,
offsets inside the source), so a call that raises on the card raises on
the CPU too.  A CUDA tensor always launches the kernel; a build or launch
failure raises rather than falling back.
"""

from __future__ import annotations

import torch

from . import pack as _pack
from . import ref

__all__ = ["pack_blocks", "pack_cols"]


def _plain_device(src: torch.Tensor, name: str) -> None:
    if src.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {src.device}")


def pack_blocks(src: torch.Tensor, tile_offsets, tile_rows: int = 8) -> torch.Tensor:
    """Gather T row tiles of ``tile_rows`` rows into one contiguous buffer:
    ``out[t*tr:(t+1)*tr] = src[offs[t]*tr:(offs[t]+1)*tr]`` (the tail tile
    of a ragged source reads as zeros)."""
    offs = _pack.check_args(src, tile_offsets, tile_rows, 0)
    if src.is_cuda:
        return _pack.pack_blocks(src, offs, tile_rows)
    _plain_device(src, "pack_blocks")
    return ref.pack_blocks_ref(src, torch.from_numpy(offs), tile_rows)


def pack_cols(src: torch.Tensor, tile_offsets, tile_cols: int = 8) -> torch.Tensor:
    """Gather T column tiles of ``tile_cols`` columns:
    ``out[:, t*tc:(t+1)*tc] = src[:, offs[t]*tc:(offs[t]+1)*tc]`` (the tail
    tile of a ragged source reads as zeros)."""
    offs = _pack.check_args(src, tile_offsets, tile_cols, 1)
    if src.is_cuda:
        return _pack.pack_cols(src, offs, tile_cols)
    _plain_device(src, "pack_cols")
    return ref.pack_cols_ref(src, torch.from_numpy(offs), tile_cols)
