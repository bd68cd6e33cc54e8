"""Public kernel wrappers: the CUDA kernels for CUDA tensors, their plain
versions (``ref``) for CPU tensors.

Both paths validate the same way (``pack.check_args``: 2-D, C-contiguous,
offsets inside the source; ``flash_attention.check_args``,
``ssd_scan.check_args``: shapes, dtypes, no input that requires grad), so a
call that raises on the card raises on the CPU too.  A CUDA tensor always
launches the kernel; a build or launch failure raises rather than falling
back, and a tensor on any other device raises.

``flash_attention`` (K3) and ``ssd_chunked_kernel`` (the scan around K4)
are differentiable, as the reference's ``ops.flash_attention`` and
``ops.ssd_chunked_pallas`` are: each is a ``torch.autograd.Function``
whose forward detaches its inputs and runs the kernel (or its plain
version on the CPU), and whose backward recomputes through the plain path
and differentiates that, as the reference's custom VJPs do (ops.py:27-57,
73-103; the JAX package has no backward kernel either).  K3's backward
recomputes ``models.layers.blockwise_attention`` with chunks of
``block_q``/``block_k``; K4's recomputes ``models.ssm.ssd_chunked``.  The
raw kernel entry points (``ssd_intra_chunk`` here, the launchers in
``flash_attention``/``ssd_scan``) keep refusing inputs that require grad.
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


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: int) -> torch.Tensor:
    _fa.check_args(q, k, v, window)
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal, window)
    _plain_device(q, "flash_attention")
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


class _FlashAttention(torch.autograd.Function):
    """K3 under autograd: the kernel's forward, a plain blockwise backward
    (the reference's ``_flash_fwd``/``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, block_q, block_k)
        return _flash_forward(q.detach(), k.detach(), v.detach(), causal,
                              window)

    @staticmethod
    def backward(ctx, g):
        from ..models.layers import blockwise_attention

        causal, window, block_q, block_k = ctx.args
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = blockwise_attention(*ins, causal=causal, window=window,
                                      q_chunk=block_q, k_chunk=block_k)
            dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, block_q: int = 256,
                    block_k: int = 512) -> torch.Tensor:
    """GQA attention: q (B,S,H,D); k/v (B,S,KV,D) -> (B,S,H,D) in q's
    dtype.  The counterpart of the reference's ``ops.flash_attention``,
    differentiable: ``block_q``/``block_k`` (the TPU kernel's VMEM tiles,
    not used by the forward) are the backward's recompute chunks."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, block_q, block_k)
    return _flash_forward(q, k, v, causal, window)


def ssd_intra_chunk(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD intra-chunk step: (y_diag (B,NC,q,H,P), states
    (B,NC,H,N,P)), float32 (see ``ref.ssd_intra_chunk_ref``)."""
    _ssd.check_args(x, dA, Bm, Cm)
    if x.is_cuda:
        return _ssd.ssd_intra_chunk(x, dA, Bm, Cm)
    _plain_device(x, "ssd_intra_chunk")
    return ref.ssd_intra_chunk_ref(x, dA, Bm, Cm)


def _ssd_scan(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, chunk: int,
              initial_state: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
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


class _SSDScan(torch.autograd.Function):
    """The scan around K4 under autograd: its forward, the plain
    ``ssd_chunked``'s backward (the reference's ``_ssd_fwd``/``_ssd_bwd``);
    ``initial_state`` gets a gradient only when one was passed."""

    @staticmethod
    def forward(ctx, x, dA, Bm, Cm, initial_state, chunk):
        ctx.chunk = chunk
        ctx.with_state = initial_state is not None
        ctx.save_for_backward(x, dA, Bm, Cm, initial_state)
        return _ssd_scan(x.detach(), dA.detach(), Bm.detach(), Cm.detach(),
                         chunk, None if initial_state is None
                         else initial_state.detach())

    @staticmethod
    def backward(ctx, gy, gfinal):
        from ..models.ssm import ssd_chunked

        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors
               if t is not None]
        with torch.enable_grad():
            y, final = ssd_chunked(*ins[:4], chunk=ctx.chunk,
                                   initial_state=ins[4] if ctx.with_state
                                   else None)
            grads = torch.autograd.grad((y, final), ins, (gy, gfinal))
        return (*grads[:4], grads[4] if ctx.with_state else None, None)


def ssd_chunked_kernel(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, chunk: int = 256,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan with the intra-chunk step in the kernel: the
    counterpart of the reference's ``ops.ssd_chunked_pallas`` (ops.py:99),
    differentiable.

    x (B,S,H,P) pre-multiplied by dt; dA (B,S,H); Bm/Cm (B,S,G,N).  Pads S
    to whole chunks, runs ``ssd_intra_chunk``, then the inter-chunk state
    recurrence and the off-diagonal term in torch (O(S N P), not O(S q)).
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) float32)."""
    ins = (x, dA, Bm, Cm) + (() if initial_state is None else (initial_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _SSDScan.apply(x, dA, Bm, Cm, initial_state, chunk)
    return _ssd_scan(x, dA, Bm, Cm, chunk, initial_state)
