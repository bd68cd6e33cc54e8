"""Zamba2-style hybrid LM: a Mamba2 backbone with one *shared* attention +
MLP block applied after every ``attn_every`` layers (``src/repro/models/
hybrid.py``, arXiv:2411.15242).

The shared block's weights are one set reused at every application, but
each application (a *group*) carries its own KV state.  The reference
scans over groups, each scanning its Mamba layers; here both are Python
loops.  Parameter ``layers.<i>.{ln,mamba}`` is slice i of the reference's
stacked ``layers``; ``shared.{ln1,ln2,attn,ffn}`` is not stacked.

Attention over a prompt goes through ``layers.attend`` with the config's
sliding window (K3 under ``use_flash``, else blockwise beyond two
``attn_chunk``s, else the plain attention); the Mamba prefill reaches K4
through ``ssm.Mamba`` as the ssm family does.  Decode attends over a ring
of ``R = min(max_len, window)`` slots per group: cache ``attn`` holds
``k``/``v`` (groups, B, R, KV, hd), ``pos`` (groups, R) int32 and ``len``
(groups,) int32, written in place but for ``len``.

The ring's bookkeeping is the reference's, fault included: a prefill of
``s`` tokens leaves ``len = min(R, s)``, and ``decode_step`` takes that
``len`` as the next token's position, so after a prompt longer than the
ring the next token gets a wrong RoPE position and most of the window is
masked out (ROADMAP Queue 3).  The port reproduces the reference's result.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..convert import torch_dtype
from ..kernels import ref as kref
from ..parallel.sharding import axis_index, constrain, local_apply, weight
from . import layers as L
from . import ssm

__all__ = ["HybridLM", "init", "param_specs", "forward", "loss_fn",
           "init_cache", "cache_specs", "prefill", "decode_step"]

Cache = Dict[str, Dict[str, torch.Tensor]]


def _n_groups(cfg) -> int:
    k = cfg.attn_every or cfg.n_layers
    if cfg.n_layers % k:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {k}")
    return cfg.n_layers // k


class SharedBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``ffn``: one weight set for every group."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg, device)
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, cfg.n_layers,
                            torch_dtype(cfg.dtype), device)

    def forward(self, h, positions, cfg, cache=None):
        a, nc = _ring_attend(self.attn, cfg, self.ln1(h), positions, cache)
        h = h + constrain(a, ("batch", "seq", "fsdp"))
        return h + self.ffn(self.ln2(h)), nc


class HybridLM(nn.Module):
    """``embed``, ``layers`` (Mamba, an ``nn.ModuleList``), ``shared``,
    ``ln_f``; parameters allocated uninitialised (``init`` draws them)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"not a hybrid config: family {cfg.family!r}")
        _n_groups(cfg)
        self.embed = L.Embed(cfg, device)
        self.layers = nn.ModuleList(ssm.MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device)
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


def param_specs(cfg) -> L.Specs:
    """Each parameter's logical sharding axes, keyed by parameter name."""
    shared = {**L.prefixed("ln1", L.norm_specs()),
              **L.prefixed("ln2", L.norm_specs()),
              **L.prefixed("attn", L.attention_specs(cfg)),
              **L.prefixed("ffn", L.swiglu_specs())}
    return {**L.prefixed("embed", L.embed_specs(cfg)),
            **L.stacked("layers", cfg.n_layers, ssm.layer_specs(cfg)),
            **L.prefixed("shared", shared),
            **L.prefixed("ln_f", L.norm_specs())}


def init(cfg, generator: Optional[torch.Generator] = None,
         device=None) -> HybridLM:
    model = HybridLM(cfg, device)
    model.reset_parameters(generator)
    return model


# ------------------------------------------------------- shared attn (ring)
def _ring_attend(p: L.Attention, cfg, x: torch.Tensor, positions: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]]
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The shared block's attention (hybrid.py:69-124).  No cache: causal
    windowed attention over x.  A cache {"k", "v": (B, R, KV, hd), "pos":
    (R,), "len": 0-d}: a prompt is attended the same way and its last
    min(R, S) keys fill the ring from slot 0; one token is written at slot
    ``len % R`` and attends over the written slots inside its window."""
    s = x.shape[1]
    hd = cfg.resolved_head_dim
    q = L.split_heads(x @ weight(p.wq, ("fsdp", "tensor")), cfg)
    k = L.split_heads(x @ weight(p.wk, ("fsdp", "tensor")), cfg)
    v = L.split_heads(x @ weight(p.wv, ("fsdp", "tensor")), cfg)
    cos, sin = L.rope_angles(positions, hd, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)

    if cache is not None and s == 1:
        ck, cv, cpos, idx = cache["k"], cache["v"], cache["pos"], cache["len"]
        out = local_apply(
            lambda *a: _ring_decode(*a, cfg),
            (q, k, v, ck, cv, cpos, idx, positions),
            (L.TOKEN_AXES,) * 3 + (L.CACHE_AXES,) * 2 + ((None,), (), (None, None)),
            (L.TOKEN_AXES[:3],))
        return out @ p.wo, {"k": ck, "v": cv, "pos": cpos, "len": idx + 1}

    q_ax, kv_ax = L.attention_layout(cfg, s, cfg.use_flash and s > 1)

    def core(q, k, v):
        o = L.attend(q, k, v, cfg, causal=True, window=cfg.window,
                     q_offset=L.query_offset(q, s))
        return o.reshape(o.shape[0], o.shape[1], -1)

    out = constrain(local_apply(core, (q, k, v), (q_ax, kv_ax, kv_ax), (q_ax[:3],)),
                    L.heads_axes(cfg)[:3])
    out = out @ p.wo
    if cache is None:
        return out, None
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    take = min(ck.shape[1], s)

    def fill(k, v, ck, cv, cpos, positions):
        L.fill_rows(ck, cv, k, v, s - take)
        cpos[:take] = positions[0, s - take:].to(cpos.dtype)

    local_apply(fill, (k, v, ck, cv, cpos, positions),
                  (L.TOKEN_AXES,) * 2 + (L.CACHE_AXES,) * 2 + ((None,), (None, None)), ())
    return out, {"k": ck, "v": cv, "pos": cpos,
                 "len": torch.full_like(cache["len"], take)}


def _ring_decode(q, k, v, ck, cv, cpos, idx, positions, cfg) -> torch.Tensor:
    """One token per sequence: write k/v at ring slot ``idx % R`` and
    attend over the written slots inside the window; this rank's slots of
    the ring (all of them on one device).  ``cpos`` (R,) is whole on every
    rank."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    r = cpos.shape[0]
    slot = torch.remainder(idx, r)
    L.write_at(ck, slot, k)
    L.write_at(cv, slot, v)
    cpos.index_copy_(0, slot.reshape(1).long(), positions[0, :1].to(cpos.dtype))
    new_len = idx + 1
    s_loc = ck.shape[1]
    s0 = axis_index("kvseq") * s_loc
    written = (s0 + torch.arange(s_loc, device=q.device)) < torch.clamp(new_len, max=r)
    qpos = positions[0, 0]
    cp = cpos[s0:s0 + s_loc]
    in_window = (cp > qpos - (cfg.window or 10**9)) & (cp <= qpos)
    valid = written & in_window
    qf = (q.float() / math.sqrt(hd)).reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qf, ck.float())
    scores = torch.where(valid, scores, kref.NEG_INF)
    return L.cache_softmax_av(scores, cv).reshape(b, s, h * hd).to(q.dtype)


# ----------------------------------------------------------------- forward
def forward(model: HybridLM, cfg, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Cache] = None
            ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (hidden (B, S, d) after the final norm, the cache).  Under
    autograd only the Mamba layers run under the ``remat`` policy
    (hybrid.py:145-153); the shared block does not."""
    h = L.embed_lookup(model.embed, tokens)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device).expand(b, s)
    ng = _n_groups(cfg)
    per = cfg.n_layers // ng
    lens = []
    for g in range(ng):
        for i in range(g * per, (g + 1) * per):
            layer = model.layers[i]
            if cache is None:
                h = L.remat(cfg.remat, lambda x, f=layer: f(x, cfg)[0], h)
            else:
                h, _ = layer(h, cfg, {"conv": cache["mamba"]["conv"][i],
                                      "ssm": cache["mamba"]["ssm"][i]})
        ac = None
        if cache is not None:
            ac = {key: cache["attn"][key][g] for key in ("k", "v", "pos", "len")}
        h, nc = model.shared(h, positions, cfg, ac)
        if cache is not None:
            lens.append(nc["len"])
    new_cache = None
    if cache is not None:
        new_cache = {"mamba": cache["mamba"],
                     "attn": {**cache["attn"], "len": torch.stack(lens)}}
    return model.ln_f(h), new_cache


def loss_fn(model: HybridLM, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) -> the mean token cross entropy."""
    h, _ = forward(model, cfg, batch["tokens"])
    return L.chunked_cross_entropy(h, model.embed, batch["labels"],
                                   cfg.loss_chunk)


# ------------------------------------------------------------------- serve
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    ng = _n_groups(cfg)
    r = min(max_len, cfg.window) if cfg.window else max_len
    shape = (ng, batch, r, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "mamba": ssm.init_cache(cfg, batch, max_len, dtype, device),
        "attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device),
                 "pos": torch.zeros((ng, r), dtype=torch.int32, device=device),
                 "len": torch.zeros((ng,), dtype=torch.int32, device=device)},
    }


def cache_specs(cfg) -> Dict[str, Dict[str, tuple]]:
    """The cache's logical sharding axes, keyed as ``init_cache``'s dict."""
    kv = (None, "batch", "kvseq", "kv", None)
    return {"mamba": ssm.cache_specs(cfg),
            "attn": {"k": kv, "v": kv, "pos": (), "len": ()}}


def prefill(model: HybridLM, cfg, tokens: torch.Tensor, cache: Cache
            ) -> Tuple[torch.Tensor, Cache]:
    h, new_cache = forward(model, cfg, tokens, cache=cache)
    return L.unembed(model.embed, h[:, -1:]), new_cache


def decode_step(model: HybridLM, cfg, token: torch.Tensor, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
    """One token per sequence at position ``cache["attn"]["len"][0]`` (the
    reference's choice, hybrid.py:231-235)."""
    b = token.shape[0]
    pos = cache["attn"]["len"][0].reshape(1, 1).expand(b, 1)
    h, new_cache = forward(model, cfg, token, positions=pos, cache=cache)
    return L.unembed(model.embed, h), new_cache
