"""Plain PyTorch versions of the port's kernels: the CPU path, and the
oracle every CUDA kernel is held against on the card."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["pack_blocks_ref", "pack_cols_ref", "flash_attention_ref",
           "flash_attention_tiles_ref", "ssd_intra_chunk_ref", "round_tf32",
           "split_tf32", "seq_cumsum", "ssd_intra_chunk_tiles_ref"]

NEG_INF = -1e30
LOG2E = 1.4426950408889634


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
                        q_offset: int = 0, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Scaled-dot-product attention with GQA broadcast, in float32 with the
    finite ``-1e30`` mask, rounded to ``q.dtype`` once.

    q (B, Sq, H, D); k/v (B, Sk, KV, D) with H = KV * rep; query i has
    position ``q_offset + i`` and key j position j.  Head h reads kv head
    h // rep.  q is scaled by ``scale`` in float32 before the product (by
    default divided by sqrt(D)).  The same function as the reference's
    ``_sdpa`` (models/layers.py)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    qs = q.float() / math.sqrt(d) if scale is None else q.float() * scale
    qg = qs.reshape(b, sq, kv, rep, d)
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
                              tiles: Optional[Tuple[int, int]] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """K3 in its CUDA kernels' order, at their tile sizes: the plain twin
    of ``flash_attention_ref`` that the kernels are held to tile by tile.

    ``tiles`` = (q rows, k rows), by default the kernel's for q's dtype and
    head dim (``flash_attention.bf16_tiles(D)`` or ``F32_TILES``).  Per q
    tile, the k tiles ``flash_attention.k_tile_range`` runs, keys past Sk
    read as zeros: scores in float32 scaled by ``scale`` (by default
    1/sqrt(D)) after the product, masked to the
    finite -1e30, an online softmax (running max, the correction of the
    earlier sum and accumulator), in bfloat16 the weights rounded to bf16
    once with the row sum adding the rounded weights, the division by
    max(l, 1e-30) and one rounding to q's dtype."""
    from . import flash_attention as fa

    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    bq, bk = tiles or (fa.bf16_tiles(d) if q.dtype == torch.bfloat16
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
            s = qt @ kf[:, :, ks].transpose(-1, -2)
            s = s / math.sqrt(d) if scale is None else s * scale
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


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to TF32, as ``cvt.rna.tf32.f32``: the low 13
    mantissa bits cleared, to nearest with ties away from zero (a carry may
    enter the exponent: the largest floats round to inf); NaN stays NaN."""
    a = a.float().contiguous()
    bits = (a.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isnan(a), a, bits.view(torch.float32))


def split_tf32(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3xTF32's split of float32 ``a``: (hi, lo) = (rna(a), rna(a - hi))."""
    hi = round_tf32(a)
    return hi, round_tf32(a.float() - hi)


def seq_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Inclusive sums along the last dimension, row after row in float32:
    K4's order, and ``torch.cumsum``'s along a chunk on the card (on the
    CPU ``torch.cumsum`` sums float32 in double)."""
    a = a.float()
    out = torch.empty_like(a)
    carry = a.new_zeros(a.shape[:-1])
    for k in range(a.shape[-1]):
        carry = carry + a[..., k]
        out[..., k] = carry
    return out


def ssd_intra_chunk_tiles_ref(x: torch.Tensor, dA: torch.Tensor,
                              Bm: torch.Tensor, Cm: torch.Tensor):
    """K4 in its CUDA kernel's order and arithmetic: the plain twin of
    ``ssd_intra_chunk_ref`` that the kernel is held to tile by tile.

    The cumulative sums by ``seq_cumsum``; every product on TF32 operands
    in float32 sums, hi hi' + lo hi' + hi lo' of ``split_tf32``'s parts.  Per 64-row tile i of y the j tiles 0 .. i in order,
    each adding ((C_i B_j^T) o L) x_j, L a select of exp(cs_i - cs_j); per
    j tile the states add B_j^T (w x_j), w = exp(cs_last - cs) (0 past q).
    L's exp is the kernel's ``__expf``: 2^(x log2 e), the product rounded
    to float32.
    Rows past q read as zeros.  Returns (y (B,NC,q,H,P), states
    (B,NC,H,N,P)), float32."""
    from .ssd_scan import TILE

    b, nc, q, h, p = x.shape
    r = h // Bm.shape[3]
    nt = -(-q // TILE)
    pad = nt * TILE - q

    def heads(t):  # (b, nc, h, nt * TILE, w): per head, zero rows past q
        t = t.float()
        if t.shape[3] != h:
            t = t.repeat_interleave(r, dim=3)
        return torch.nn.functional.pad(t.transpose(2, 3), (0, 0, 0, pad))

    def mm(a, b_):
        ah, al = split_tf32(a)
        bh, bl = split_tf32(b_)
        return ah @ bh + al @ bh + ah @ bl

    xh, Bh, Ch = heads(x), heads(Bm), heads(Cm)
    cs = seq_cumsum(dA.float().transpose(2, 3))                   # (b,nc,h,q)
    w = torch.exp(cs[..., -1:] - cs)
    cs = torch.nn.functional.pad(cs, (0, pad))
    wx = xh * torch.nn.functional.pad(w, (0, pad))[..., None]
    rows = torch.arange(nt * TILE, device=x.device)
    y = torch.zeros_like(xh)
    st = xh.new_zeros((b, nc, h, Bm.shape[4], p))
    for jt in range(nt):
        js = slice(jt * TILE, (jt + 1) * TILE)
        st = st + mm(Bh[..., js, :].transpose(-1, -2), wx[..., js, :])
    for it in range(nt):
        i_s = slice(it * TILE, (it + 1) * TILE)
        acc = torch.zeros_like(xh[..., i_s, :])
        for jt in range(it + 1):
            js = slice(jt * TILE, (jt + 1) * TILE)
            s = mm(Ch[..., i_s, :], Bh[..., js, :].transpose(-1, -2))
            keep = ((rows[i_s, None] >= rows[None, js])
                    & (rows[i_s, None] < q))
            arg = (cs[..., i_s, None] - cs[..., None, js]) * LOG2E
            sl = torch.where(keep, s * torch.exp2(arg), 0.0)
            acc = acc + mm(sl, xh[..., js, :])
        y[..., i_s, :] = acc
    return y[..., :q, :].transpose(2, 3).contiguous(), st
