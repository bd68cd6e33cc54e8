"""Zamba2 in its published form (arXiv:2411.15242): Mamba-2 layers, and at
the configuration's ``hybrid_layers`` a call of one of ``shared_blocks``
shared attention + MLP blocks, taken in turn, whose result is added to the
hidden state before that layer's Mamba pre-norm.

Line numbers cite ``transformers`` 4.57.6, ``models/zamba2/
modeling_zamba2.py``.  With ``x0`` the embedding (l. 1287-1290) and ``h``
the hidden state, the call ``c`` of a hybrid layer (block ``c %
shared_blocks``, l. 1243-1245, 1413) computes

    u = RMSNorm_in([h, x0])                            l. 1016-1017 (2d wide)
    q, k, v = u Wq, u Wk, u Wv; RoPE on q and k        l. 420-438
    a = softmax(q k^T (hd/2)^-1/2, causal) v Wo        l. 355, 444-456
    a = RMSNorm_ff(a)                                  l. 1028 (no residual)
    [g, up] = a W_gate_up + (a A_c) B_c                l. 960-962 (adapter c)
    t = (GELU(g) * up) W_down W_linear,c               l. 964-967, 1158

and the layer then computes ``h + Mamba(RMSNorm(h + t))`` (l. 1078-1097):
``t`` enters the Mamba layer's input and never the residual.  A layer
without a call is ``h + Mamba(RMSNorm(h))``.  GELU is the exact (erf) one
(``hidden_act`` "gelu"); the attention has no adapters
(``use_shared_attention_adapter`` false); there are no biases.  The Mamba
mixer is ``ssm.Mamba``, whose gated norm groups by ``ssm_groups``
(Zamba2RMSNormGated, l. 60-78, group size d_inner / ngroups).  The mixer
follows the card's fast path (``mamba_chunk_scan_combined`` with no
``dt_limit``, l. 698-712), which does not clamp dt below; the CPU path of
``modeling_zamba2.py`` clamps it at ``time_step_min`` (l. 805).  Then
RMSNorm and the tied embedding's logits (l. 1392, 1530).

Parameters: ``embed``, ``layers`` (``ssm.MambaLayer`` each), ``blocks``
(one ``SharedBlock`` per shared block: a single leaf per weight, whose
gradient sums over the block's calls), ``calls`` (one ``Call`` per hybrid
layer: its adapter and linear), ``ln_f``.  Under autograd each layer, and
each call before it, runs under the config's ``remat`` policy.

Training only: serving the shared blocks needs a KV cache per call, which
this family does not have, so ``init_cache``, ``prefill`` and
``decode_step`` raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import torch_dtype
from . import layers as L
from . import ssm

__all__ = ["SharedBlock", "Call", "Zamba2LM", "init", "param_specs", "forward",
           "loss_fn", "init_cache", "cache_specs", "prefill", "decode_step"]


def _check(cfg) -> None:
    if cfg.family != "zamba2":
        raise ValueError(f"not a zamba2 config: family {cfg.family!r}")
    ids = cfg.hybrid_layers
    if not ids or cfg.shared_blocks < 1 or list(ids) != sorted(set(ids)) \
            or ids[-1] >= cfg.n_layers:
        raise ValueError(f"zamba2: hybrid_layers {ids} must be increasing layer "
                         f"ids below {cfg.n_layers}, with shared_blocks >= 1")
    if cfg.n_heads * cfg.resolved_head_dim != 2 * cfg.d_model:
        raise ValueError("zamba2: the shared attention's heads must span 2 d_model")


class SharedBlock(nn.Module):
    """Zamba2AttentionDecoderLayer's shared weights (l. 970-979):
    ``ln_in`` (input_layernorm, 2d), ``wq``/``wk``/``wv`` (2d, H hd), ``wo``
    (H hd, d), ``ln_ff`` (pre_ff_layernorm, d), ``gate_up`` (d, 2 d_ff),
    ``down`` (d_ff, d); applied as ``x @ w``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
        dt = torch_dtype(cfg.dtype)
        self.ln_in = L.RMSNorm(2 * d, cfg.norm_eps, device)
        self.wq = L._param((2 * d, cfg.n_heads * hd), dt, device)
        self.wk = L._param((2 * d, cfg.n_kv_heads * hd), dt, device)
        self.wv = L._param((2 * d, cfg.n_kv_heads * hd), dt, device)
        self.wo = L._param((cfg.n_heads * hd, d), dt, device)
        self.ln_ff = L.RMSNorm(d, cfg.norm_eps, device)
        self.gate_up = L._param((d, 2 * f), dt, device)
        self.down = L._param((f, d), dt, device)

    def reset_parameters(self, generator=None) -> None:
        for p in (self.wq, self.wk, self.wv, self.wo, self.gate_up, self.down):
            L.normal_(p, 0.02, generator)


class Call(nn.Module):
    """What one hybrid layer's call owns: the MLP's adapter ``adapter_in``
    (d, r) and ``adapter_out`` (r, 2 d_ff) (gate_up_proj_adapter_list,
    l. 944-953) and ``linear`` (d, d) (l. 1230)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, r = cfg.d_model, cfg.adapter_rank
        dt = torch_dtype(cfg.dtype)
        self.adapter_in = L._param((d, r), dt, device)
        self.adapter_out = L._param((r, 2 * cfg.d_ff), dt, device)
        self.linear = L._param((d, d), dt, device)

    def reset_parameters(self, generator=None) -> None:
        for p in (self.adapter_in, self.adapter_out, self.linear):
            L.normal_(p, 0.02, generator)


class Zamba2LM(nn.Module):
    """``embed`` (tied), ``layers``, ``blocks``, ``calls``, ``ln_f``;
    parameters allocated uninitialised (``init`` draws them)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check(cfg)
        self.embed = L.Embed(cfg, device)
        self.layers = nn.ModuleList(ssm.MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.blocks = nn.ModuleList(SharedBlock(cfg, device)
                                    for _ in range(cfg.shared_blocks))
        self.calls = nn.ModuleList(Call(cfg, device) for _ in cfg.hybrid_layers)
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


def init(cfg, generator: Optional[torch.Generator] = None,
         device=None) -> Zamba2LM:
    model = Zamba2LM(cfg, device)
    model.reset_parameters(generator)
    return model


def param_specs(cfg) -> L.Specs:
    """Each parameter's logical sharding axes, keyed by parameter name."""
    block = {**L.prefixed("ln_in", L.norm_specs()),
             "wq": ("fsdp", "tensor"), "wk": ("fsdp", "tensor"),
             "wv": ("fsdp", "tensor"), "wo": ("tensor", "fsdp"),
             **L.prefixed("ln_ff", L.norm_specs()),
             "gate_up": ("fsdp", "tensor"), "down": ("tensor", "fsdp")}
    call = {"adapter_in": ("fsdp", None), "adapter_out": (None, "tensor"),
            "linear": ("fsdp", None)}
    return {**L.prefixed("embed", L.embed_specs(cfg)),
            **L.stacked("layers", cfg.n_layers, ssm.layer_specs(cfg)),
            **L.stacked("blocks", cfg.shared_blocks, block),
            **L.stacked("calls", len(cfg.hybrid_layers), call),
            **L.prefixed("ln_f", L.norm_specs())}


# ----------------------------------------------------------------- forward
def _call(blk: SharedBlock, call: Call, cfg, h: torch.Tensor, x0: torch.Tensor,
          cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One call of a shared block: ``t`` (B, S, d) for the hybrid layer."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    u = blk.ln_in(torch.cat([h, x0], dim=-1))
    q = (u @ blk.wq).reshape(b, s, cfg.n_heads, hd)
    k = (u @ blk.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = (u @ blk.wv).reshape(b, s, cfg.n_kv_heads, hd)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    a = L.attend(q, k, v, cfg, causal=True, scale=(hd / 2) ** -0.5)
    a = blk.ln_ff(a.reshape(b, s, -1) @ blk.wo)
    gu = a @ blk.gate_up + (a @ call.adapter_in) @ call.adapter_out
    g, up = gu.chunk(2, dim=-1)
    return ((F.gelu(g) * up) @ blk.down) @ call.linear


def _mamba_after_call(layer: ssm.MambaLayer, cfg, h: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    o, _ = layer.mamba(layer.ln(h + t), cfg)
    return h + o


def forward(model: Zamba2LM, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The hidden state (B, S, d) after the final norm."""
    h = L.embed_lookup(model.embed, tokens)
    x0 = h
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device)
    cos, sin = L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    calls = {layer: c for c, layer in enumerate(cfg.hybrid_layers)}
    nb = len(model.blocks)
    for i, layer in enumerate(model.layers):
        if i not in calls:
            h = L.remat(cfg.remat, lambda x, f=layer: f(x, cfg)[0], h)
            continue
        c = calls[i]
        blk, call = model.blocks[c % nb], model.calls[c]
        # the block and call are bound now: remat calls them again later
        t = L.remat(cfg.remat, lambda x, x_0, b_=blk, c_=call: _call(
            b_, c_, cfg, x, x_0, cos, sin), h, x0)
        h = L.remat(cfg.remat,
                    lambda x, tt, f=layer: _mamba_after_call(f, cfg, x, tt), h, t)
    return model.ln_f(h)


def loss_fn(model: Zamba2LM, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) -> the mean token cross entropy."""
    h = forward(model, cfg, batch["tokens"])
    return L.chunked_cross_entropy(h, model.embed, batch["labels"],
                                   cfg.loss_chunk)


# ------------------------------------------------------------------- serve
def _no_serving(*_args, **_kwargs):
    raise NotImplementedError(
        "zamba2: the published form is trained only here; serving it needs a "
        "KV cache for each call of the shared blocks, which this family lacks")


init_cache = prefill = decode_step = _no_serving


def cache_specs(cfg) -> Dict[str, tuple]:
    return {}
