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

The reference's sharding hints stand where the reference has them:
``constrain`` pins an activation to a logical layout and ``weight`` marks
a weight's use (``parallel.sharding``).  Both are the identity for a plain
tensor or with no mesh, so a single-device run is unchanged; with the
parameters and inputs as ``DTensor``s on a mesh they redistribute, as
GSPMD does for the reference's.  Attention over a prompt or a training
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
``a2a`` dispatch runs the explicit expert-parallel schedule
(``moe_a2a.moe_a2a``) under a mesh whose rules allow it
(``moe_a2a.a2a_available``); without one it falls through to
sorted/dense, as the reference does.

The ``*_specs`` functions give each parameter's logical sharding axes
(``parallel.sharding``), keyed by parameter name as ``named_parameters``
names them; ``prefixed``/``stacked`` compose a family's ``param_specs``
from them.  ``stacked`` keys layer i's parameters ``<name>.<i>.<path>``,
where the reference's stacked leaf carries a leading ``None`` for its
layer axis.

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
from ..parallel.sharding import (axis_group, axis_index, axis_size, constrain,
                                 current_mesh, current_rules, local_apply,
                                 mesh_sharding, partial_grads, replicated,
                                 use_mesh, weight, whole_along)

__all__ = ["rmsnorm", "RMSNorm", "rope_angles", "apply_rope",
           "blockwise_attention", "attend", "Attention", "SwiGLU", "MoE",
           "moe", "moe_dense", "Embed",
           "embed_lookup", "unembed", "cross_entropy", "chunked_cross_entropy",
           "remat", "normal_", "norm_specs", "attention_specs",
           "swiglu_specs", "moe_specs", "embed_specs", "prefixed", "stacked",
           "TOKEN_AXES", "CACHE_AXES", "heads_axes", "attention_layout",
           "query_offset", "split_heads",
           "fill_rows", "write_at",
           "cache_softmax_av"]

Cache = Dict[str, torch.Tensor]
Specs = Dict[str, Tuple[Optional[str], ...]]


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


def _ambient(fn: Callable) -> Callable:
    """``fn`` with the calling thread's mesh and rules installed around it:
    a checkpoint recomputes ``fn`` in the backward, which the autograd
    engine runs on a thread of its own for CUDA tensors, where the ambient
    mesh (per thread) would be missing."""
    mesh = current_mesh()
    if mesh is None:
        return fn
    rules = current_rules()

    def run(*args):
        with use_mesh(mesh, rules):
            return fn(*args)

    return run


def remat(policy: str, fn: Callable, *args):
    """``fn(*args)`` under the config's ``remat`` policy, the reference's
    ``jax.checkpoint`` around a layer (transformer.py:129-132): ``"full"``
    keeps only the layer's inputs and recomputes the rest in the backward;
    ``"dots"`` also keeps the matmul outputs (``checkpoint_dots``);
    ``"none"``, or no autograd, just calls ``fn``.  A policy never changes
    a value."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    fn = _ambient(fn)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}: none, full or dots")


# ----------------------------------------------------------------- norms
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """A ``DTensor`` (B, S, d) split along its sequence (the ``sp`` rules'
    residual stream) comes out whole along it: the all-gather of sequence
    parallelism before the next matmul (DTensor cannot flatten a batch
    split and a sequence split into the rows of one matmul)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
    if hasattr(out, "placements") and out.dim() == 3:
        out = whole_along(out, 1)
    return out


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
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2).  Plain cos/sin
    beside a ``DTensor`` x become replicated ``DTensor``s: the backward
    multiplies by them, on a thread where DTensor takes no plain tensor."""
    if hasattr(x, "placements"):
        cos, sin = replicated(cos, x.device_mesh), replicated(sin, x.device_mesh)
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
                        q_chunk: int = 1024, k_chunk: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """Flash attention in plain torch: an online softmax over key chunks
    for each query chunk, O(S * chunk) memory (layers.py:93-147).

    q (B, Sq, H, D); k/v (B, Sk, KV, D); query i has position ``q_offset +
    i`` and key j position j.  Float32 inside, rounded to q's dtype once.  A key chunk that the
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
        q_pos = torch.arange(q0, q1, device=q.device) + q_offset
        acc = l = m = None
        for k0 in range(0, sk, k_chunk):
            k1 = min(k0 + k_chunk, sk)
            if causal and k0 > q1 - 1 + q_offset:
                break                                    # every key is ahead
            if window and k1 - 1 <= q0 + q_offset - window:
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
           causal: bool = True, window: int = 0, q_offset: int = 0
           ) -> torch.Tensor:
    """Dispatch by size (layers.py:150-159): K3 under ``cfg.use_flash``
    (causal, S > 1), ``blockwise_attention`` beyond two ``attn_chunk``s,
    else the plain attention.  ``q_offset``: the position of the first
    query (a rank's slice of the queries, ``attention_layout``)."""
    s = k.shape[1]
    if cfg.use_flash and causal and s > 1:
        return kops.flash_attention(q, k, v, causal=True, window=window)
    if s > 2 * cfg.attn_chunk:
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_chunk=cfg.attn_chunk,
                                   k_chunk=cfg.attn_chunk, q_offset=q_offset)
    return kref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)


# The layouts of attention's local code (``parallel.sharding.local_apply``):
# a token's q/k/v (B, S, heads, hd) split over the batch only, and one
# layer's KV cache (B, S_max, KV, hd) as ``cache_specs`` splits it.
TOKEN_AXES = ("batch", None, None, None)
CACHE_AXES = ("batch", "kvseq", "kv", None)


def heads_axes(cfg) -> Tuple[Optional[str], ...]:
    """The layout of q/k/v (B, S, heads, hd) for attention: the batch, and
    the heads over the tensor axes when they split both the query and the
    KV heads evenly (Megatron's layout), else whole."""
    n = axis_size("tensor")
    split = cfg.n_heads % n == 0 and cfg.n_kv_heads % n == 0
    return ("batch", None, "tensor" if split else None, None)


def attention_layout(cfg, s: int, flash: bool):
    """(q's layout, k/v's layout) for a prompt's attention on each rank's
    shard: the heads split (``heads_axes``) where they divide; else, on
    the plain path, the queries split along their length over the tensor
    axes, each rank holding every key (each attends its slice of the
    queries: the scores shrink by the split, as GSPMD's do with the heads
    split unevenly); else only the batch split."""
    ax = heads_axes(cfg)
    if ax[2] is None and not flash and s % axis_size("tensor") == 0:
        return ("batch", "tensor", None, None), ax
    return ax, ax


def query_offset(q: torch.Tensor, s: int) -> int:
    """The position of the first of a rank's queries (B, S_loc, ...) of
    ``s`` in all: its slice's start when ``attention_layout`` split them."""
    return axis_index("tensor") * q.shape[1] if q.shape[1] < s else 0


def split_heads(t: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd), on each rank's shard laid out as
    ``heads_axes`` splits the heads: DTensor splits no sharded dimension
    into two (in the forward, nor the merge's in the backward)."""
    ax = heads_axes(cfg)
    hd = cfg.resolved_head_dim
    return local_apply(lambda t: t.reshape(t.shape[0], t.shape[1], -1, hd),
                       (t,), (ax[:3],), (ax,))


def fill_rows(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, src0: int) -> None:
    """Write rows ``src0:`` of k/v (B, S, KV, hd) to rows 0.. of the cache
    ck/cv (B, S_max, KV, hd), as many as fit: this rank's rows of a cache
    split along its length over the ``kvseq`` axes (the whole of it on one
    device)."""
    s_loc = ck.shape[1]
    s0 = axis_index("kvseq") * s_loc
    n = max(0, min(k.shape[1] - src0 - s0, s_loc))
    if n:
        ck[:, :n] = k[:, src0 + s0:src0 + s0 + n].to(ck.dtype)
        cv[:, :n] = v[:, src0 + s0:src0 + s0 + n].to(cv.dtype)


def write_at(c: torch.Tensor, at: torch.Tensor, new: torch.Tensor) -> None:
    """``c[:, at] = new`` for a 0-d position ``at`` of the whole cache
    length, on this rank's rows of it (a rank whose rows do not hold
    ``at`` writes nothing).  No host read: the position stays on the
    device, as the reference's ``dynamic_update_slice`` keeps it."""
    s_loc = c.shape[1]
    if axis_size("kvseq") == 1:
        c.index_copy_(1, at.reshape(1).long(), new.to(c.dtype))
        return
    rel = at - axis_index("kvseq") * s_loc
    j = torch.clamp(rel, 0, s_loc - 1).reshape(1).long()
    keep = c.index_select(1, j)
    c.index_copy_(1, j, torch.where((rel >= 0) & (rel < s_loc),
                                    new.to(c.dtype), keep))


def cache_softmax_av(scores: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """softmax(scores) @ cv over the cache length, scores (B, KV, rep, Q,
    S_loc) float32, cv (B, S_loc, KV, hd) -> (B, Q, KV, rep, hd) float32.
    A cache split over the ``kvseq`` axes combines the ranks' partial
    maxima, sums and products with three all-reduces (flash-decoding)."""
    group = axis_group("kvseq")
    if group is None:
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bkrqs,bskd->bqkrd", probs, cv.float())
    from torch.distributed import _functional_collectives as fc

    m = fc.all_reduce(scores.amax(dim=-1, keepdim=True), "max", group)
    p = torch.exp(scores - m)
    total = fc.all_reduce(p.sum(dim=-1), "sum", group)
    acc = fc.all_reduce(torch.einsum("bkrqs,bskd->bkrqd", p, cv.float()),
                        "sum", group)
    return (acc / total[..., None]).permute(0, 3, 1, 2, 4)


def _decode_attend(q, k, v, ck, cv, idx, cfg) -> torch.Tensor:
    """One token per sequence: write k/v at ``idx`` and attend over the
    written cache rows (inside the window); this rank's rows of the cache."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    write_at(ck, idx, k)
    write_at(cv, idx, v)
    new_len = idx + s
    s_loc = ck.shape[1]
    kpos = axis_index("kvseq") * s_loc + torch.arange(s_loc, device=q.device)
    valid = kpos < new_len
    if cfg.window:
        valid &= kpos > (new_len - 1 - cfg.window)
    qf = (q.float() / math.sqrt(hd)).reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qf, ck.float())
    scores = torch.where(valid, scores, kref.NEG_INF)
    return cache_softmax_av(scores, cv).reshape(b, s, h * hd).to(q.dtype)


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
        s = x.shape[1]
        hd = cfg.resolved_head_dim
        q = split_heads(constrain(x @ weight(self.wq, ("fsdp", "tensor")),
                                  ("batch", None, "tensor")), cfg)
        if xattn_kv is not None:
            k, v = xattn_kv
        else:
            k = split_heads(constrain(x @ weight(self.wk, ("fsdp", "tensor")),
                                      ("batch", None, "tensor")), cfg)
            v = split_heads(constrain(x @ weight(self.wv, ("fsdp", "tensor")),
                                      ("batch", None, "tensor")), cfg)
            cos, sin = rope_angles(positions, hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

        new_cache = None
        if cache is not None and xattn_kv is None and s == 1:
            # decode: append at `len`, attend over the whole cache (masked)
            idx = cache["len"]
            ck, cv = cache["k"], cache["v"]
            out = local_apply(
                lambda q, k, v, ck, cv, idx: _decode_attend(q, k, v, ck, cv,
                                                            idx, cfg),
                (q, k, v, ck, cv, idx), (TOKEN_AXES,) * 3 + (CACHE_AXES,) * 2 + ((),),
                (TOKEN_AXES[:3],))
            new_cache = {"k": ck, "v": cv, "len": idx + s}
        else:
            flash = cfg.use_flash and xattn_kv is None and causal and s > 1
            q_ax, kv_ax = attention_layout(cfg, s, flash)

            def core(q, k, v):
                if flash:
                    o = kops.flash_attention(q, k, v, causal=True,
                                             window=cfg.window)
                else:
                    o = kref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=cfg.window,
                                                 q_offset=query_offset(q, s))
                return o.reshape(o.shape[0], o.shape[1], -1)

            out = constrain(local_apply(core, (q, k, v), (q_ax, kv_ax, kv_ax),
                                        (q_ax[:3],)), heads_axes(cfg)[:3])
            if cache is not None:  # prefill fills the cache
                ck, cv = cache["k"], cache["v"]
                local_apply(lambda k, v, ck, cv: fill_rows(ck, cv, k, v, 0),
                            (k, v, ck, cv), (TOKEN_AXES,) * 2 + (CACHE_AXES,) * 2, ())
                new_cache = {"k": ck, "v": cv,
                             "len": torch.full_like(cache["len"], s)}
        return constrain(out @ weight(self.wo, ("tensor", "fsdp")),
                         ("batch", "seq", "fsdp")), new_cache


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
        h = (F.silu(x @ weight(self.gate, ("fsdp", "tensor")))
             * (x @ weight(self.up, ("fsdp", "tensor"))))
        h = constrain(h, ("batch", None, "tensor"))
        return constrain(h @ weight(self.down, ("tensor", "fsdp")),
                         ("batch", "seq", "fsdp"))


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


def _router_probs(p: MoE, xf: torch.Tensor) -> torch.Tensor:
    return torch.softmax(xf.float() @ p.router, dim=-1)


def _top_k(probs: torch.Tensor, k: int):
    """The top-k weights (renormalised) and expert ids, float32.
    ``torch.topk`` returns the k largest in descending order, as
    ``jax.lax.top_k`` does."""
    topw, topi = torch.topk(probs, k, dim=-1, sorted=True)
    return topw / topw.sum(dim=-1, keepdim=True), topi


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

    def route(probs):  # the routing of every token, on every rank alike
        topw, topi = _top_k(probs, cfg.top_k)
        comb = _combine(topw, topi, e)                           # (B,S,E)
        return comb, _aux_loss(probs, comb, e)

    comb, aux = local_apply(route, (_router_probs(p, x),), ((None,) * 3,),
                            ((None,) * 3, ()))
    # (n, d) @ (E, d, f) broadcasts to (E, n, f): the expert weights are
    # read in place (an einsum would copy them into a (d, E*f) layout)
    xe = x.to(torch_dtype(cfg.dtype)).reshape(b * s, d)
    hg = torch.matmul(xe, weight(p.gate, ("expert", "fsdp", "tensor")))
    hu = torch.matmul(xe, weight(p.up, ("expert", "fsdp", "tensor")))
    h = F.silu(hg) * hu * comb.reshape(b * s, e).T.to(hg.dtype)[..., None]
    # E and F contracted at once, as the reference's "bsef,efd->bsd"; split
    # over the mesh, one product per expert, summed (DTensor cannot merge
    # two split dimensions into one contraction)
    down = weight(p.down, ("expert", "tensor", "fsdp"))
    if hasattr(h, "placements"):
        out = torch.bmm(h, down).sum(dim=0)
    else:
        out = h.permute(1, 0, 2).reshape(b * s, e * f) @ down.reshape(e * f, d)
    return constrain(out.reshape(b, s, d).to(x.dtype),
                     ("batch", "seq", "fsdp")), aux


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
    with ``index_add``.  ``moe_dispatch="a2a"`` takes the explicit
    expert-parallel schedule when the ambient mesh allows it
    (``moe_a2a``), and falls through here otherwise;
    ``moe_dispatch="dense"``, or n*k <= 4E, takes ``moe_dense``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    if cfg.moe_dispatch == "a2a":
        from .moe_a2a import a2a_available, moe_a2a

        if a2a_available(cfg):  # explicit EP schedule (mesh collectives)
            return moe_a2a(p, cfg, x)
    if cfg.moe_dispatch == "dense" or n * k <= 4 * e:
        return moe_dense(p, cfg, x)
    cap = max(1, int(math.ceil(n * k * cfg.capacity_factor / e)))
    dt = torch_dtype(cfg.dtype)

    xf = x.reshape(n, d)
    # the sort, the pack and the unpack see every token on every rank (the
    # global capacity decides which tokens an expert drops); the expert
    # matmuls run on each rank's experts
    buf, aux, *route = local_apply(
        lambda xf, probs: _sort_and_pack(xf, probs, cfg, cap, dt),
        (xf, _router_probs(p, xf)), ((None, None),) * 2,
        ((None,) * 3, (), None, None, None, None, None))
    buf = constrain(buf, ("expert", None, None))
    h = (F.silu(torch.bmm(buf, weight(p.gate, ("expert", "fsdp", "tensor"))))
         * torch.bmm(buf, weight(p.up, ("expert", "fsdp", "tensor"))))
    h = constrain(h, ("expert", None, "tensor"))
    o = torch.bmm(h, weight(p.down, ("expert", "tensor", "fsdp")))  # (E, cap, d)
    y = local_apply(lambda o: _unpack(o, *route, n, cap), (o,), ((None,) * 3,),
                    ((None, None),))
    return constrain(y.reshape(b, s, d).to(x.dtype),
                     ("batch", "seq", "fsdp")), aux


def _sort_and_pack(xf, probs, cfg, cap: int, dt):
    """Route the n tokens of ``xf`` (n, d), sort the n*k (token, expert)
    entries by expert (stable) and pack each expert's first ``cap`` into
    (E, cap, d).  Returns (the buffer, the aux loss, and the sorted
    entries' expert ids, weights, tokens, ranks and in-capacity flags)."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    topw, topi = _top_k(probs, k)                                # (n, k)
    eid = topi.reshape(n * k)
    w = topw.reshape(n * k)
    tok = torch.arange(n * k, device=xf.device) // k
    order = torch.argsort(eid, stable=True)
    eid_s, w_s, tok_s = eid[order], w[order], tok[order]

    # the reference's counts.at[eid].add(1): a fixed (E,) shape, which a
    # traced step needs (bincount's length depends on the data)
    counts = torch.zeros(e, dtype=eid.dtype, device=eid.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    offsets = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(n * k, device=xf.device) - offsets[eid_s]
    in_cap = rank < cap
    rank_c = torch.where(in_cap, rank, cap)

    xs = xf[tok_s].to(dt)
    buf = torch.zeros((e, cap + 1, d), dtype=dt, device=xf.device)
    buf = buf.index_put((eid_s, rank_c), xs)[:, :cap]            # (E, cap, d)
    aux = _aux_loss(probs, _combine(topw, topi, e), e)
    return buf, aux, eid_s, w_s, tok_s, rank_c, in_cap


def _unpack(o, eid_s, w_s, tok_s, rank_c, in_cap, n: int, cap: int):
    """Each token's sum of its experts' outputs ``o`` (E, cap, d), weighted,
    in float32: (n, d)."""
    gathered = o[eid_s, torch.clamp(rank_c, max=cap - 1)]
    contrib = gathered * (w_s * in_cap)[:, None].to(o.dtype)
    return torch.zeros((n, o.shape[2]), dtype=torch.float32,
                       device=o.device).index_add(0, tok_s, contrib.float())


# ------------------------------------------------------- sharding specs
def norm_specs() -> Specs:
    return {"scale": (None,)}


def attention_specs(cfg) -> Specs:
    return {"wq": ("fsdp", "tensor"), "wk": ("fsdp", "tensor"),
            "wv": ("fsdp", "tensor"), "wo": ("tensor", "fsdp")}


def swiglu_specs() -> Specs:
    return {"gate": ("fsdp", "tensor"), "up": ("fsdp", "tensor"),
            "down": ("tensor", "fsdp")}


def moe_specs() -> Specs:
    return {"router": (None, "tensor"), "gate": ("expert", "fsdp", "tensor"),
            "up": ("expert", "fsdp", "tensor"),
            "down": ("expert", "tensor", "fsdp")}


def embed_specs(cfg) -> Specs:
    p = {"tok": ("tensor", "fsdp")}
    if not cfg.tie_embeddings:
        p["out"] = ("fsdp", "tensor")
    return p


def prefixed(prefix: str, specs: Specs) -> Specs:
    """``specs`` of the submodule named ``prefix``."""
    return {f"{prefix}.{k}": v for k, v in specs.items()}


def stacked(name: str, n: int, specs: Specs) -> Specs:
    """``specs`` of each of the ``n`` layers of the ``nn.ModuleList``
    ``name``."""
    return {k: v for i in range(n) for k, v in prefixed(f"{name}.{i}", specs).items()}


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
    if hasattr(p.tok, "placements") and current_mesh() is not None:
        return constrain(_embed_vocab_parallel(p.tok, tokens),
                         ("batch", "seq", "fsdp"))
    return constrain(F.embedding(tokens, p.tok), ("batch", "seq", "fsdp"))


def _embed_vocab_parallel(tok: torch.Tensor, tokens: torch.Tensor
                          ) -> torch.Tensor:
    """The gather from a table split over its vocabulary (``DTensor``
    ``tok``), as GSPMD partitions the reference's ``take``: each rank looks
    up the tokens of its rows of the vocabulary (zero for the others), the
    table's model dimension gathered over the fsdp axes first, and the
    result is a partial sum over the tensor axes.  Each rank sees the
    tokens of its batch shard (the tokens gathered over the tensor axes,
    should they split the batch as well).  DTensor's own strategy for the
    gather (a masked partial) has no backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = current_mesh()
    t_plc = mesh_sharding(mesh, ("tensor", None), current_rules())
    vocab_dims = {i for i, q in enumerate(t_plc) if q.is_shard()}
    b_plc = mesh_sharding(mesh, ("batch",) + (None,) * (tokens.dim() - 1),
                          current_rules())
    ids_plc = tuple(Replicate() if i in vocab_dims else q
                    for i, q in enumerate(b_plc))
    t = tok.redistribute(mesh, t_plc).to_local(grad_placements=partial_grads(t_plc))
    ids = tokens.redistribute(mesh, ids_plc).to_local()
    v_loc = t.shape[0]
    v0 = axis_index("tensor") * v_loc
    inside = (ids >= v0) & (ids < v0 + v_loc)
    e = F.embedding(torch.where(inside, ids - v0, 0), t)
    e = e * inside[..., None].to(e.dtype)
    out_plc = tuple(Partial() if i in vocab_dims else
                    (Shard(0) if q.is_shard() else Replicate())
                    for i, q in enumerate(ids_plc))
    shape = tuple(tokens.shape) + (tok.shape[1],)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(e, mesh, out_plc, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _unembed_weight(p: Embed) -> torch.Tensor:
    return (weight(p.out, ("fsdp", "tensor")) if p.out is not None
            else weight(p.tok, ("tensor", "fsdp")).T)


def unembed(p: Embed, x: torch.Tensor) -> torch.Tensor:
    return constrain(x @ _unembed_weight(p), ("batch", None, "tensor"))


# ------------------------------------------------------------------ losses
def _label_logit(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit of its label.  Logits split over the vocabulary
    (a ``DTensor``): the sum of the logits masked to the label, which each
    rank takes on its slice of the vocabulary (DTensor's gather has no
    strategy for it); a plain tensor: a gather."""
    if hasattr(lf, "placements"):
        hit = labels.long()[..., None] == torch.arange(lf.shape[-1],
                                                       device=lf.device)
        return torch.sum(torch.where(hit, lf, 0.0), dim=-1)
    return torch.gather(lf, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy, in float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    return torch.mean(lse - _label_logit(lf, labels))


def _chunk_loss(hc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    logits = constrain(hc @ w, ("batch", None, "tensor")).float()
    lse = torch.logsumexp(logits, dim=-1)
    return torch.sum(lse - _label_logit(logits, lc))


def chunked_cross_entropy(h: torch.Tensor, embed: Embed, labels: torch.Tensor,
                          chunk: int = 256) -> torch.Tensor:
    """Cross entropy without materialising (B, S, vocab) logits
    (layers.py:447-475): each sequence chunk computes its logits, reduces
    them to the sum of (lse - ll) and drops them; under autograd each
    chunk is a ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so the backward recomputes one chunk's logits at
    a time.  The last chunk may be short (the reference pads it and masks
    the padding out of the sum)."""
    w = _unembed_weight(embed)
    b, s, _ = h.shape
    if s <= chunk:
        return cross_entropy(unembed(embed, h), labels)
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        hc, lc = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_ambient(_chunk_loss), hc, lc, w,
                              use_reentrant=False)
        else:
            part = _chunk_loss(hc, lc, w)
        total = total + part
    return total / (b * s)
