"""Plain PyTorch versions of the port's kernels: the CPU path, and the
oracle every CUDA kernel is held against on the card."""

from __future__ import annotations

import math

import torch

__all__ = ["pack_blocks_ref", "pack_cols_ref", "flash_attention_ref",
           "ssd_intra_chunk_ref"]

NEG_INF = -1e30


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Scaled-dot-product attention with GQA broadcast, in float32 with the
    finite ``-1e30`` mask, rounded to ``q.dtype`` once.

    q (B, Sq, H, D); k/v (B, Sk, KV, D) with H = KV * rep; query i and key
    i share position i.  Head h reads kv head h // rep.  The same function
    as the reference's ``_sdpa`` (models/layers.py) with no query offset."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    qg = (q.float() / math.sqrt(d)).reshape(b, sq, kv, rep, d)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float())
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def ssd_intra_chunk_ref(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor):
    """The SSD intra-chunk step (einsum formulation), float32 out.

    x (B,NC,q,H,P); dA (B,NC,q,H); Bm/Cm (B,NC,q,G,N); head h reads group
    h // (H/G).  Per (batch, chunk, head): cs = cumsum(dA);
    L[i,j] = exp(cs_i - cs_j) for i >= j else 0; y = ((C B^T) * L) x;
    state = B^T (x * exp(cs_last - cs)).  Returns (y (B,NC,q,H,P),
    states (B,NC,H,N,P))."""
    b, nc, q, h, p = x.shape
    g, n = Bm.shape[3], Bm.shape[4]
    r = h // g
    xf, dAf, Bf, Cf = x.float(), dA.float(), Bm.float(), Cm.float()

    cs = torch.cumsum(dAf, dim=2)                              # (b,nc,q,h)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]         # (b,nc,i,j,h)
    ii = torch.arange(q, device=x.device)
    mask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    L = torch.where(mask, torch.exp(diff), 0.0)  # select: exp may be inf above

    scores = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)        # (b,nc,i,j,g)
    xg = xf.reshape(b, nc, q, g, r, p)
    Lg = L.reshape(b, nc, q, q, g, r)
    y = torch.einsum("bcijg,bcijgr,bcjgrp->bcigrp", scores, Lg, xg)
    y = y.reshape(b, nc, q, h, p)

    decay_last = torch.exp(cs[:, :, -1:, :] - cs)              # (b,nc,q,h)
    xwg = (xf * decay_last[..., None]).reshape(b, nc, q, g, r, p)
    st = torch.einsum("bcjgn,bcjgrp->bcgrnp", Bf, xwg).reshape(b, nc, h, n, p)
    return y, st
