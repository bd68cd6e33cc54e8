"""Plain PyTorch versions of the pack kernels (the CPU path and the
oracle the CUDA kernels are held against on the card)."""

from __future__ import annotations

import torch

__all__ = ["pack_blocks_ref", "pack_cols_ref"]


def pack_blocks_ref(src: torch.Tensor, tile_offsets: torch.Tensor,
                    tile_rows: int = 8) -> torch.Tensor:
    """``out[t*tr:(t+1)*tr] = src[offs[t]*tr:(offs[t]+1)*tr]``, the rows
    zero-padded up to a tile multiple first."""
    r, c = src.shape
    pad = -r % tile_rows
    if pad:
        src = torch.cat([src, src.new_zeros((pad, c))], dim=0)
    offs = tile_offsets.to(device=src.device, dtype=torch.int64)
    return src.reshape(-1, tile_rows, c).index_select(0, offs).reshape(-1, c)


def pack_cols_ref(src: torch.Tensor, tile_offsets: torch.Tensor,
                  tile_cols: int = 8) -> torch.Tensor:
    """``out[:, t*tc:(t+1)*tc] = src[:, offs[t]*tc:(offs[t]+1)*tc]``, the
    columns zero-padded up to a tile multiple first."""
    r, c = src.shape
    pad = -c % tile_cols
    if pad:
        src = torch.cat([src, src.new_zeros((r, pad))], dim=1)
    offs = tile_offsets.to(device=src.device, dtype=torch.int64)
    return src.reshape(r, -1, tile_cols).index_select(1, offs).reshape(r, -1)
