"""Shared layers of every model family: RMSNorm, RoPE, GQA attention with a
KV cache or cross-attention K/V, SwiGLU, the routed MoE, the embedding and
its unembedding.

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
written once per token, never copied.  Cross-attention (``xattn_kv``)
takes precomputed K/V: no ``wk``/``wv`` projection, no RoPE, no cache, and
always the plain attention.

``MoE`` holds the reference's expert weights (``router`` float32 (d, E),
``gate``/``up`` (E, d, f), ``down`` (E, f, d)); ``moe`` routes top-k with
the sorted, capacity-limited dispatch and ``moe_dense`` is the
every-token-through-every-expert oracle (layers.py:287-400).  The
reference's ``a2a`` dispatch needs a device mesh (``moe_a2a.
a2a_available``); on one device it falls through to sorted/dense, as the
reference does without a mesh.

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
           "blockwise_attention", "attend", "Attention", "SwiGLU", "MoE",
           "moe", "moe_dense", "Embed",
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
                causal: bool = True, cache: Optional[Cache] = None,
                xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B, S, d); positions (B, S).  cache {"k", "v": (B, S_max, KV,
        hd), "len": 0-d int32}: a single token (S = 1) is written at
        ``len`` and attends over the cache; a prompt fills the cache from 0.
        ``xattn_kv`` (k, v), each (B, S_src, KV, hd): cross-attention to
        them, without RoPE or cache, on the plain path (layers.py:201-214).
        Returns (out (B, S, d), the cache with its new ``len``)."""
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        q = (x @ self.wq).reshape(b, s, h, hd)
        if xattn_kv is not None:
            k, v = xattn_kv
        else:
            k = (x @ self.wk).reshape(b, s, kv, hd)
            v = (x @ self.wv).reshape(b, s, kv, hd)
            cos, sin = rope_angles(positions, hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

        new_cache = None
        if cache is not None and xattn_kv is None and s == 1:
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
            if cfg.use_flash and xattn_kv is None and causal and s > 1:
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


# -------------------------------------------------------------------- MoE
class MoE(nn.Module):
    """Routed experts: ``router`` (d, E) float32, ``gate``/``up`` (E, d, f)
    and ``down`` (E, f, d) in the config's dtype.  ``forward`` returns
    (out, aux loss) through ``moe``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.n_layers = cfg.n_layers
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_ffn
        dt = torch_dtype(cfg.dtype)
        self.router = _param((d, e), torch.float32, device)
        self.gate = _param((e, d, f), dt, device)
        self.up = _param((e, d, f), dt, device)
        self.down = _param((e, f, d), dt, device)

    def reset_parameters(self, generator=None) -> None:
        d, f = self.gate.shape[1], self.gate.shape[2]
        for w in (self.router, self.gate, self.up):
            normal_(w, 1.0 / math.sqrt(d), generator)
        normal_(self.down, 1.0 / math.sqrt(f) / math.sqrt(2 * self.n_layers),
                generator)

    def forward(self, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe(self, cfg, x)


def _route(p: MoE, cfg, xf: torch.Tensor):
    """Router probabilities (..., E) and the top-k weights (renormalised)
    and expert ids, float32.  ``torch.topk`` returns the k largest in
    descending order, as ``jax.lax.top_k`` does."""
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return probs, topw / topw.sum(dim=-1, keepdim=True), topi


def _combine(topw: torch.Tensor, topi: torch.Tensor, e: int) -> torch.Tensor:
    """Each token's weight per expert (..., E): the one-hot of its top-k
    ids weighted and summed over k."""
    return torch.sum(F.one_hot(topi, e).float() * topw[..., None], dim=-2)


def _aux_loss(probs: torch.Tensor, comb: torch.Tensor, e: int) -> torch.Tensor:
    """Load-balancing loss: E x sum over experts of (share of tokens routed
    there) x (mean router probability)."""
    dims = tuple(range(comb.dim() - 1))
    density = torch.mean((comb > 0).float(), dim=dims)
    mean_prob = torch.mean(probs, dim=tuple(range(probs.dim() - 1)))
    return torch.sum(density * mean_prob) * e


def moe_dense(p: MoE, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token through every expert, masked by its routing weights
    (layers.py:315-339): the oracle, and the path of tiny token counts.
    Returns (out (B, S, d) in x's dtype, aux loss)."""
    b, s, d = x.shape
    e, f = cfg.n_experts, p.gate.shape[2]
    probs, topw, topi = _route(p, cfg, x)
    comb = _combine(topw, topi, e)                               # (B,S,E)
    aux = _aux_loss(probs, comb, e)
    # (n, d) @ (E, d, f) broadcasts to (E, n, f): the expert weights are
    # read in place (an einsum would copy them into a (d, E*f) layout)
    xe = x.to(torch_dtype(cfg.dtype)).reshape(b * s, d)
    hg = torch.matmul(xe, p.gate)
    hu = torch.matmul(xe, p.up)
    h = F.silu(hg) * hu * comb.reshape(b * s, e).T.to(hg.dtype)[..., None]
    # E and F contracted at once, as the reference's "bsef,efd->bsd"
    out = h.permute(1, 0, 2).reshape(b * s, e * f) @ p.down.reshape(e * f, d)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe(p: MoE, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE with the sorted, capacity-limited dispatch
    (layers.py:348-400).  Returns (out (B, S, d) in x's dtype, aux loss).

    The n*k (token, expert) entries are sorted by expert with a stable sort
    (``jnp.argsort`` is stable, and the sort decides which tokens a full
    expert drops); each expert takes at most ``ceil(n*k*capacity_factor /
    E)`` in token order.  An entry past capacity is written to a spare row
    ``cap`` that is sliced away (the reference's scatter drops it), and its
    gather is clamped to row ``cap - 1`` and multiplied by 0, as the
    reference's clamped gather is.  Outputs are added per token in float32
    with ``index_add``.  ``moe_dispatch="dense"``, or n*k <= 4E, takes
    ``moe_dense``; ``"a2a"`` falls through here: its expert-parallel
    schedule needs a mesh (ROADMAP item 12)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    if cfg.moe_dispatch == "dense" or n * k <= 4 * e:
        return moe_dense(p, cfg, x)
    cap = max(1, int(math.ceil(n * k * cfg.capacity_factor / e)))
    dt = torch_dtype(cfg.dtype)

    xf = x.reshape(n, d)
    probs, topw, topi = _route(p, cfg, xf)                       # (n, E), (n, k)
    eid = topi.reshape(n * k)
    w = topw.reshape(n * k)
    tok = torch.arange(n * k, device=x.device) // k
    order = torch.argsort(eid, stable=True)
    eid_s, w_s, tok_s = eid[order], w[order], tok[order]

    counts = torch.bincount(eid, minlength=e)
    offsets = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(n * k, device=x.device) - offsets[eid_s]
    in_cap = rank < cap
    rank_c = torch.where(in_cap, rank, cap)

    xs = xf[tok_s].to(dt)
    buf = torch.zeros((e, cap + 1, d), dtype=dt, device=x.device)
    buf = buf.index_put((eid_s, rank_c), xs)[:, :cap]            # (E, cap, d)
    h = F.silu(torch.bmm(buf, p.gate)) * torch.bmm(buf, p.up)
    o = torch.bmm(h, p.down)                                     # (E, cap, d)

    gathered = o[eid_s, torch.clamp(rank_c, max=cap - 1)]
    contrib = gathered * (w_s * in_cap)[:, None].to(o.dtype)
    y = torch.zeros((n, d), dtype=torch.float32, device=x.device).index_add(
        0, tok_s, contrib.float())
    aux = _aux_loss(probs, _combine(topw, topi, e), e)
    return y.reshape(b, s, d).to(x.dtype), aux


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
