"""Shared layers of the dense and ssm families: RMSNorm, RoPE, GQA attention
with a KV cache, SwiGLU, the embedding and its unembedding.

Parameters keep the reference's names, shapes and layouts
(``src/repro/models/layers.py``): ``wq`` is (d, H*hd) and is applied as
``x @ wq``, ``tok`` is (padded_vocab, d), a norm's ``scale`` is float32.  So
loading the reference's parameters is a copy (``convert.
params_from_reference``), never a transpose.  Each module allocates its
parameters uninitialised; ``reset_parameters(generator)`` draws them with
the reference's shapes and scales from an explicit ``torch.Generator`` on
the parameters' device (the values are the port's own: torch and JAX give
other numbers for one seed).

The reference's sharding hints (``constrain``/``weight``) are the identity
on one device and are left out.  Attention over a prompt or a training
sequence routes to the K3 kernel (``kernels.ops.flash_attention``, which
is differentiable) when ``cfg.use_flash`` is set, else to its plain version
``kernels.ref.flash_attention_ref`` (the reference's ``_sdpa``); decode
attends over the cache in torch, as the reference does.  The cache is
updated in place (the reference returns a new one): a slot's cache is
written once per token, never copied.

``blockwise_attention`` is the reference's pure-array flash attention
(online softmax over key chunks): the long-sequence path of ``attend`` and
the recompute of K3's backward.  ``cross_entropy`` and
``chunked_cross_entropy`` are the training losses; the chunked one never
holds more than one chunk's (B, chunk, vocab) logits, in the forward or,
through ``torch.utils.checkpoint``, in the backward.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..convert import torch_dtype
from ..kernels import ops as kops
from ..kernels import ref as kref

__all__ = ["rmsnorm", "RMSNorm", "rope_angles", "apply_rope",
           "blockwise_attention", "attend", "Attention", "SwiGLU", "Embed",
           "embed_lookup", "unembed", "cross_entropy", "chunked_cross_entropy",
           "remat", "normal_"]

Cache = Dict[str, torch.Tensor]


def normal_(p: torch.Tensor, std: float, generator: Optional[torch.Generator]
            ) -> None:
    """Fill ``p`` with N(0, std^2) drawn in float32, then rounded to its
    dtype (the reference draws in float32 and casts)."""
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ------------------------------------------------------------------ remat
_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn: Callable, *args):
    """``fn(*args)`` under the config's ``remat`` policy, the reference's
    ``jax.checkpoint`` around a layer (transformer.py:129-132): ``"full"``
    keeps only the layer's inputs and recomputes the rest in the backward;
    ``"dots"`` also keeps the matmul outputs (``checkpoint_dots``);
    ``"none"``, or no autograd, just calls ``fn``.  A policy never changes
    a value."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}: none, full or dots")


# ----------------------------------------------------------------- norms
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), torch.float32, device)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


# ----------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos/sin of shape (..., S, head_dim // 2)."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_chunk: int = 1024, k_chunk: int = 1024
                        ) -> torch.Tensor:
    """Flash attention in plain torch: an online softmax over key chunks
    for each query chunk, O(S * chunk) memory (layers.py:93-147).

    q (B, Sq, H, D); k/v (B, Sk, KV, D); query i and key i share position
    i.  Float32 inside, rounded to q's dtype once.  A key chunk that the
    causal or window mask hides from every row of a query chunk is skipped:
    the reference visits it, and it changes nothing there (its
    probabilities are exactly 0 once a row has seen a key, and a row's
    running sums are multiplied by exactly 0 when it sees its first), so
    the output is the same."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    qf = (q.float() * scale).reshape(b, sq, kv, rep, d)
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        qc = qf[:, q0:q1]                                # (b, cq, kv, rep, d)
        q_pos = torch.arange(q0, q1, device=q.device)
        acc = l = m = None
        for k0 in range(0, sk, k_chunk):
            k1 = min(k0 + k_chunk, sk)
            if causal and k0 > q1 - 1:
                break                                    # every key is ahead
            if window and k1 - 1 <= q0 - window:
                continue                                 # every key is stale
            k_pos = torch.arange(k0, k1, device=q.device)
            s = torch.einsum("bqkrd,bskd->bkrqs", qc, kf[:, k0:k1])
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > (q_pos[:, None] - window)
            s = torch.where(mask, s, kref.NEG_INF)
            if m is None:  # the reference's zero start, multiplied out
                m_new = s.amax(dim=-1)
                p = torch.exp(s - m_new[..., None])
                l_new = p.sum(dim=-1)
                acc_new = torch.einsum("bkrqs,bskd->bkrqd", p, vf[:, k0:k1])
            else:
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                l_new = l * corr + p.sum(dim=-1)
                acc_new = acc * corr[..., None] + torch.einsum(
                    "bkrqs,bskd->bkrqd", p, vf[:, k0:k1])
            acc, m, l = acc_new, m_new, l_new
        if acc is None:                                  # no key visible
            outs.append(qc.new_zeros((b, kv, rep, q1 - q0, d)))
        else:
            outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=3)                         # (b, kv, rep, sq, d)
    return out.reshape(b, h, sq, d).transpose(1, 2).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
           causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dispatch by size (layers.py:150-159): K3 under ``cfg.use_flash``
    (causal, S > 1), ``blockwise_attention`` beyond two ``attn_chunk``s,
    else the plain attention."""
    s = q.shape[1]
    if cfg.use_flash and causal and s > 1:
        return kops.flash_attention(q, k, v, causal=True, window=window)
    if s > 2 * cfg.attn_chunk:
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_chunk=cfg.attn_chunk,
                                   k_chunk=cfg.attn_chunk)
    return kref.flash_attention_ref(q, k, v, causal=causal, window=window)


class Attention(nn.Module):
    """GQA attention with RoPE and an optional KV cache.  The config passed
    to ``forward`` decides the path (``use_flash``, ``window``, RoPE), as the
    reference's functions take theirs."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.n_layers = cfg.n_layers
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        dt = torch_dtype(cfg.dtype)
        self.wq = _param((d, h * hd), dt, device)
        self.wk = _param((d, kv * hd), dt, device)
        self.wv = _param((d, kv * hd), dt, device)
        self.wo = _param((h * hd, d), dt, device)

    def reset_parameters(self, generator=None) -> None:
        s = 1.0 / math.sqrt(self.wq.shape[0])
        for w in (self.wq, self.wk, self.wv):
            normal_(w, s, generator)
        normal_(self.wo, s / math.sqrt(2 * self.n_layers), generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cfg,
                causal: bool = True, cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B, S, d); positions (B, S).  cache {"k", "v": (B, S_max, KV,
        hd), "len": 0-d int32}: a single token (S = 1) is written at
        ``len`` and attends over the cache; a prompt fills the cache from 0.
        Returns (out (B, S, d), the cache with its new ``len``)."""
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        q = (x @ self.wq).reshape(b, s, h, hd)
        k = (x @ self.wk).reshape(b, s, kv, hd)
        v = (x @ self.wv).reshape(b, s, kv, hd)
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        new_cache = None
        if cache is not None and s == 1:
            # decode: append at `len`, attend over the whole cache (masked)
            idx = cache["len"]
            ck, cv = cache["k"], cache["v"]
            at = idx.reshape(1).long()
            ck.index_copy_(1, at, k.to(ck.dtype))
            cv.index_copy_(1, at, v.to(cv.dtype))
            new_len = idx + s
            new_cache = {"k": ck, "v": cv, "len": new_len}
            kpos = torch.arange(ck.shape[1], device=x.device)
            valid = kpos < new_len
            if cfg.window:
                valid &= kpos > (new_len - 1 - cfg.window)
            qf = (q.float() / math.sqrt(hd)).reshape(b, s, kv, h // kv, hd)
            scores = torch.einsum("bqkrd,bskd->bkrqs", qf, ck.float())
            scores = torch.where(valid, scores, kref.NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            out = torch.einsum("bkrqs,bskd->bqkrd", probs, cv.float())
            out = out.reshape(b, s, h, hd).to(x.dtype)
        else:
            if cfg.use_flash and causal and s > 1:
                out = kops.flash_attention(q, k, v, causal=True,
                                           window=cfg.window)
            else:
                out = kref.flash_attention_ref(q, k, v, causal=causal,
                                               window=cfg.window)
            if cache is not None:  # prefill fills the cache
                ck, cv = cache["k"], cache["v"]
                ck[:, :s] = k.to(ck.dtype)
                cv[:, :s] = v.to(cv.dtype)
                new_cache = {"k": ck, "v": cv,
                             "len": torch.full_like(cache["len"], s)}
        out = out.reshape(b, s, h * hd)
        return out @ self.wo, new_cache


# ----------------------------------------------------------------- SwiGLU
class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, n_layers: int, dtype, device=None):
        super().__init__()
        self.n_layers = n_layers
        self.gate = _param((d, d_ff), dtype, device)
        self.up = _param((d, d_ff), dtype, device)
        self.down = _param((d_ff, d), dtype, device)

    def reset_parameters(self, generator=None) -> None:
        d, d_ff = self.gate.shape
        normal_(self.gate, 1.0 / math.sqrt(d), generator)
        normal_(self.up, 1.0 / math.sqrt(d), generator)
        normal_(self.down, 1.0 / math.sqrt(d_ff) / math.sqrt(2 * self.n_layers),
                generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.gate) * (x @ self.up)) @ self.down


# ------------------------------------------------------------- embeddings
class Embed(nn.Module):
    """``tok`` (padded_vocab, d) and, unless tied, ``out`` (d, padded_vocab);
    the pad rows are never indexed."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        v = cfg.padded_vocab
        self.tok = _param((v, cfg.d_model), dt, device)
        self.out = (None if cfg.tie_embeddings
                    else _param((cfg.d_model, v), dt, device))

    def reset_parameters(self, generator=None) -> None:
        normal_(self.tok, 0.02, generator)
        if self.out is not None:
            normal_(self.out, 0.02, generator)


def embed_lookup(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.tok[tokens]


def unembed(p: Embed, x: torch.Tensor) -> torch.Tensor:
    return x @ (p.out if p.out is not None else p.tok.T)


# ------------------------------------------------------------------ losses
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy, in float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def _chunk_loss(hc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    logits = (hc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum(lse - ll)


def chunked_cross_entropy(h: torch.Tensor, embed: Embed, labels: torch.Tensor,
                          chunk: int = 256) -> torch.Tensor:
    """Cross entropy without materialising (B, S, vocab) logits
    (layers.py:447-475): each sequence chunk computes its logits, reduces
    them to the sum of (lse - ll) and drops them; under autograd each
    chunk is a ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so the backward recomputes one chunk's logits at
    a time.  The last chunk may be short (the reference pads it and masks
    the padding out of the sum)."""
    w = embed.out if embed.out is not None else embed.tok.T
    b, s, _ = h.shape
    if s <= chunk:
        return cross_entropy(unembed(embed, h), labels)
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        hc, lc = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_loss, hc, lc, w, use_reentrant=False)
        else:
            part = _chunk_loss(hc, lc, w)
        total = total + part
    return total / (b * s)
