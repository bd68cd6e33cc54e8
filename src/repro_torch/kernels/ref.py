"""Plain PyTorch versions of the port's kernels: the CPU path, and the
oracle every CUDA kernel is held against on the card."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["pack_blocks_ref", "pack_cols_ref", "flash_attention_ref",
           "flash_attention_tiles_ref", "ssd_intra_chunk_ref"]

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
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Scaled-dot-product attention with GQA broadcast, in float32 with the
    finite ``-1e30`` mask, rounded to ``q.dtype`` once.

    q (B, Sq, H, D); k/v (B, Sk, KV, D) with H = KV * rep; query i has
    position ``q_offset + i`` and key j position j.  Head h reads kv head
    h // rep.  The same function as the reference's ``_sdpa``
    (models/layers.py)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    qg = (q.float() / math.sqrt(d)).reshape(b, sq, kv, rep, d)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float())
    qpos = torch.arange(sq, device=q.device) + q_offset
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


def flash_attention_tiles_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0,
                              tiles: Optional[Tuple[int, int]] = None
                              ) -> torch.Tensor:
    """K3 in its CUDA kernels' order, at their tile sizes: the plain twin
    of ``flash_attention_ref`` that the kernels are held to tile by tile.

    ``tiles`` = (q rows, k rows), by default the kernel's for q's dtype
    (``flash_attention.BF16_TILES`` or ``F32_TILES``).  Per q tile, the k
    tiles ``flash_attention.k_tile_range`` runs, keys past Sk read as zeros:
    scores in float32 scaled by 1/sqrt(D) after the product, masked to the
    finite -1e30, an online softmax (running max, the correction of the
    earlier sum and accumulator), in bfloat16 the weights rounded to bf16
    once with the row sum adding the rounded weights, the division by
    max(l, 1e-30) and one rounding to q's dtype."""
    from . import flash_attention as fa

    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    bq, bk = tiles or (fa.BF16_TILES if q.dtype == torch.bfloat16
                       else fa.F32_TILES)
    nk = -(-sk // bk)
    qf = q.float().transpose(1, 2)                              # (b, h, sq, d)

    def keys(t):  # (b, h, nk * bk, d): kv head h // rep, zero rows past Sk
        t = t.float().transpose(1, 2).repeat_interleave(rep, dim=1)
        return torch.nn.functional.pad(t, (0, 0, 0, nk * bk - sk))

    kf, vf = keys(k), keys(v)
    out = torch.zeros_like(qf)
    for q0 in range(0, sq, bq):
        qt = qf[:, :, q0:q0 + bq]
        qpos = torch.arange(q0, q0 + qt.shape[2], device=q.device)[:, None]
        m = qt.new_full(qt.shape[:3], NEG_INF)
        l = qt.new_zeros(qt.shape[:3])
        acc = torch.zeros_like(qt)
        lo, hi = fa.k_tile_range(q0, bq, bk, sk, causal, window)
        for kt in range(lo, hi):
            ks = slice(kt * bk, (kt + 1) * bk)
            s = qt @ kf[:, :, ks].transpose(-1, -2) / math.sqrt(d)
            kpos = torch.arange(ks.start, ks.stop, device=q.device)[None, :]
            mask = kpos < sk
            if causal:
                mask = mask & (kpos <= qpos)
            if window:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            if q.dtype == torch.bfloat16:
                p = p.bfloat16().float()
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vf[:, :, ks]
            m = m_new
        out[:, :, q0:q0 + bq] = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


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
