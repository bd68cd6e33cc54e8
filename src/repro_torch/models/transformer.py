"""Decoder-only transformer LM: the dense, MoE (with Arctic's dense
residual) and VLM (a precomputed vision-embedding prefix) families
(``src/repro/models/transformer.py``).

The reference stacks its layers along a leading axis and scans over them;
here they are an ``nn.ModuleList`` walked by a Python loop, and parameter
``layers.<i>.<name>`` is slice i of the reference's stacked ``layers/
<name>``.  The KV cache keeps the reference's stacked layout, (L, B, S_max,
KV, hd) for ``k`` and ``v`` and (L,) int32 for ``len``, and is updated in
place.

A MoE layer holds ``moe`` (``layers.MoE``) in place of ``ffn``, and
both when ``dense_residual`` is set (Arctic: the dense SwiGLU runs in
parallel on the same input); each layer returns its router's aux loss and
``forward`` sums them.  A VLM prepends ``prefix_embeds`` (B, V, d) to the
token embeddings: positions run over V + S, the cache holds V + S entries,
and the loss is taken on the text positions only.

Public surface (as the reference's): ``init``, ``param_specs``,
``forward``, ``loss_fn``, ``init_cache``, ``cache_specs``, ``prefill``,
``decode_step``.  Under autograd each layer
runs under the config's ``remat`` policy (``layers.remat``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..convert import torch_dtype
from . import layers as L

__all__ = ["Transformer", "init", "param_specs", "forward", "loss_fn",
           "init_cache", "cache_specs", "prefill", "decode_step"]

Cache = Dict[str, torch.Tensor]


class Layer(nn.Module):
    """``ln1``, ``ln2``, ``attn`` and ``ffn`` (dense, vlm), ``moe`` (moe), or
    both (moe with ``dense_residual``) (transformer.py:35-50)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg, device)
        is_moe = cfg.family == "moe"
        self.moe = L.MoE(cfg, device) if is_moe else None
        self.ffn = (L.SwiGLU(cfg.d_model, cfg.d_ff, cfg.n_layers,
                             torch_dtype(cfg.dtype), device)
                    if not is_moe or cfg.dense_residual else None)

    def forward(self, h, positions, cfg, cache=None, causal=True):
        """Returns (h, aux loss (0-d float32; None without a router), the
        layer's cache)."""
        a, new_cache = self.attn(self.ln1(h), positions, cfg, causal=causal,
                                 cache=cache)
        h = h + a
        x2 = self.ln2(h)
        if self.moe is None:
            return h + self.ffn(x2), None, new_cache
        mo, aux = self.moe(x2, cfg)
        h = h + mo
        if self.ffn is not None:  # arctic's dense residual, a parallel branch
            h = h + self.ffn(x2)
        return h, aux, new_cache


class Transformer(nn.Module):
    """``embed``, ``layers`` (an ``nn.ModuleList``), ``ln_f``; parameters
    allocated uninitialised (``init`` draws them).  The config passed to
    ``forward`` decides the path; the one given here only the shapes."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"not a transformer config: family {cfg.family!r}")
        self.embed = L.Embed(cfg, device)
        self.layers = nn.ModuleList(Layer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


def _layer_specs(cfg) -> L.Specs:
    p = {**L.prefixed("ln1", L.norm_specs()), **L.prefixed("ln2", L.norm_specs()),
         **L.prefixed("attn", L.attention_specs(cfg))}
    if cfg.family == "moe":
        p.update(L.prefixed("moe", L.moe_specs()))
        if cfg.dense_residual:
            p.update(L.prefixed("ffn", L.swiglu_specs()))
    else:
        p.update(L.prefixed("ffn", L.swiglu_specs()))
    return p


def param_specs(cfg) -> L.Specs:
    """Each parameter's logical sharding axes, keyed by parameter name."""
    return {**L.prefixed("embed", L.embed_specs(cfg)),
            **L.stacked("layers", cfg.n_layers, _layer_specs(cfg)),
            **L.prefixed("ln_f", L.norm_specs())}


def init(cfg, generator: Optional[torch.Generator] = None,
         device=None) -> Transformer:
    """A model of ``cfg`` on ``device`` with parameters drawn from
    ``generator`` at the reference's shapes and scales."""
    model = Transformer(cfg, device)
    model.reset_parameters(generator)
    return model


def forward(model: Transformer, cfg, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            cache: Optional[Cache] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Returns (hidden (B, V + S, d) after the final norm, the aux loss
    summed over layers, the cache with its new lengths).  ``prefix_embeds``
    (B, V, d) is prepended to the token embeddings (the VLM stub)."""
    h = L.embed_lookup(model.embed, tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device).expand(b, s)
    lens, auxs = [], []
    for i, layer in enumerate(model.layers):
        if cache is None:
            h, aux = L.remat(cfg.remat,
                             lambda x, f=layer: f(x, positions, cfg)[:2], h)
        else:
            lc = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"][i]}
            h, aux, nc = layer(h, positions, cfg, lc)
            lens.append(nc["len"])
        if aux is not None:
            auxs.append(aux)
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "len": torch.stack(lens)}
    aux = (torch.stack(auxs).sum() if auxs else
           torch.zeros((), dtype=torch.float32, device=h.device))
    return model.ln_f(h), aux, new_cache


def loss_fn(model: Transformer, cfg, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) [, vision_embeds (B, V, d)] ->
    the mean cross entropy over the text positions plus 0.01 x the aux
    loss (transformer.py:153-162)."""
    prefix = batch.get("vision_embeds")
    h, aux, _ = forward(model, cfg, batch["tokens"], prefix_embeds=prefix)
    if prefix is not None:
        h = h[:, prefix.shape[1]:]
    loss = L.chunked_cross_entropy(h, model.embed, batch["labels"],
                                   cfg.loss_chunk)
    return loss + 0.01 * aux


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    shape = (cfg.n_layers, batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((cfg.n_layers,), dtype=torch.int32, device=device)}


def cache_specs(cfg) -> Dict[str, tuple]:
    """The cache's logical sharding axes, keyed as ``init_cache``'s dict."""
    return {"k": (None, "batch", "kvseq", "kv", None),
            "v": (None, "batch", "kvseq", "kv", None),
            "len": ()}


def prefill(model: Transformer, cfg, tokens: torch.Tensor, cache: Cache,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prefix and the prompt, fill the cache, return last-token
    logits (B, 1, V)."""
    h, _, new_cache = forward(model, cfg, tokens, prefix_embeds=prefix_embeds,
                              cache=cache)
    return L.unembed(model.embed, h[:, -1:]), new_cache


def decode_step(model: Transformer, cfg, token: torch.Tensor, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
    """One token per sequence: token (B, 1) + cache -> (logits (B, 1, V),
    the cache)."""
    b = token.shape[0]
    pos = cache["len"][0].reshape(1, 1).expand(b, 1)
    h, _, new_cache = forward(model, cfg, token, positions=pos, cache=cache)
    return L.unembed(model.embed, h), new_cache
