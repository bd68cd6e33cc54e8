"""Public kernel wrappers: the CUDA kernels for CUDA tensors, their plain
versions (``ref``) for CPU tensors.

Both paths validate the same way (``pack.check_args``: 2-D, C-contiguous,
offsets inside the source; ``flash_attention.check_args``,
``ssd_scan.check_args``: shapes, dtypes, no input that requires grad), so a
call that raises on the card raises on the CPU too.  A CUDA tensor always
launches the kernel; a build or launch failure raises rather than falling
back, and a tensor on any other device raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as _fa
from . import pack as _pack
from . import ref
from . import ssd_scan as _ssd

__all__ = ["pack_blocks", "pack_cols", "flash_attention", "ssd_intra_chunk",
           "ssd_chunked_kernel"]


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, block_q: int = 256,
                    block_k: int = 512) -> torch.Tensor:
    """GQA attention forward: q (B,S,H,D); k/v (B,S,KV,D) -> (B,S,H,D) in
    q's dtype.  The counterpart of the reference's ``ops.flash_attention``
    (forward only).  ``block_q``/``block_k`` are the TPU kernel's VMEM
    tiling; they are accepted for the same signature and ignored."""
    del block_q, block_k
    _fa.check_args(q, k, v, window)
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal, window)
    _plain_device(q, "flash_attention")
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def ssd_intra_chunk(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD intra-chunk step: (y_diag (B,NC,q,H,P), states
    (B,NC,H,N,P)), float32 (see ``ref.ssd_intra_chunk_ref``)."""
    _ssd.check_args(x, dA, Bm, Cm)
    if x.is_cuda:
        return _ssd.ssd_intra_chunk(x, dA, Bm, Cm)
    _plain_device(x, "ssd_intra_chunk")
    return ref.ssd_intra_chunk_ref(x, dA, Bm, Cm)


def ssd_chunked_kernel(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, chunk: int = 256,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan with the intra-chunk step in the kernel: the
    counterpart of the reference's ``ops.ssd_chunked_pallas`` (ops.py:99,
    forward only).

    x (B,S,H,P) pre-multiplied by dt; dA (B,S,H); Bm/Cm (B,S,G,N).  Pads S
    to whole chunks, runs ``ssd_intra_chunk``, then the inter-chunk state
    recurrence and the off-diagonal term in torch (O(S N P), not O(S q)).
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) float32)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    r = h // g
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s

    def pad3(a):
        if not pad:
            return a
        return torch.cat([a, a.new_zeros((b, pad) + tuple(a.shape[2:]))], dim=1)

    xp = pad3(x).reshape(b, nc, q, h, p)
    dAp = pad3(dA).reshape(b, nc, q, h)
    Bp = pad3(Bm).reshape(b, nc, q, g, n)
    Cp = pad3(Cm).reshape(b, nc, q, g, n)

    y_diag, states = ssd_intra_chunk(xp, dAp, Bp, Cp)

    dA_cs = torch.cumsum(dAp.float(), dim=2)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                 # (b,nc,h)
    prev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
            if initial_state is None else initial_state.float())
    prevs = []
    for c in range(nc):                    # state entering each chunk
        prevs.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prevs_t = torch.stack(prevs, dim=1)                          # (b,nc,h,n,p)

    in_decay = torch.exp(dA_cs)                                  # (b,nc,q,h)
    Ch = Cp.float().repeat_interleave(r, dim=3) if g != h else Cp.float()
    y_off = torch.einsum("bcqhn,bchnp->bcqhp", Ch, prevs_t)
    y_off = y_off * in_decay[..., None]

    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y.to(x.dtype), prev
