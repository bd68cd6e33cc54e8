"""Decoder-only transformer LM, dense family (``src/repro/models/
transformer.py``).

The reference stacks its layers along a leading axis and scans over them;
here they are an ``nn.ModuleList`` walked by a Python loop, and parameter
``layers.<i>.<name>`` is slice i of the reference's stacked ``layers/
<name>``.  The KV cache keeps the reference's stacked layout, (L, B, S_max,
KV, hd) for ``k`` and ``v`` and (L,) int32 for ``len``, and is updated in
place.

Public surface (as the reference's): ``init``, ``forward``, ``loss_fn``,
``init_cache``, ``prefill``, ``decode_step``.  Under autograd each layer
runs under the config's ``remat`` policy (``layers.remat``).  MoE layers
and a vision prefix are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..convert import torch_dtype
from . import layers as L

__all__ = ["Transformer", "init", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step"]

Cache = Dict[str, torch.Tensor]


def check_config(cfg) -> None:
    """Raise for what the port's dense transformer does not have yet."""
    if cfg.family == "moe" or cfg.n_experts:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP Queue 1 item 9: "
            "layers.moe, moe_dense; item 10: moe_a2a)")
    if cfg.family == "vlm" or cfg.vision_tokens:
        raise NotImplementedError(
            "the vision-prefix (vlm) family is not ported yet "
            "(ROADMAP Queue 1 item 9)")
    if cfg.family != "dense":
        raise ValueError(f"not a dense config: family {cfg.family!r}")


class DenseLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg, device)
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, cfg.n_layers,
                            torch_dtype(cfg.dtype), device)

    def forward(self, h, positions, cfg, cache=None, causal=True):
        a, new_cache = self.attn(self.ln1(h), positions, cfg, causal=causal,
                                 cache=cache)
        h = h + a
        return h + self.ffn(self.ln2(h)), new_cache


class Transformer(nn.Module):
    """``embed``, ``layers`` (an ``nn.ModuleList``), ``ln_f``; parameters
    allocated uninitialised (``init`` draws them).  The config passed to
    ``forward`` decides the path; the one given here only the shapes."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_config(cfg)
        self.embed = L.Embed(cfg, device)
        self.layers = nn.ModuleList(DenseLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


def init(cfg, generator: Optional[torch.Generator] = None,
         device=None) -> Transformer:
    """A model of ``cfg`` on ``device`` with parameters drawn from
    ``generator`` at the reference's shapes and scales."""
    model = Transformer(cfg, device)
    model.reset_parameters(generator)
    return model


def forward(model: Transformer, cfg, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Cache] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Returns (hidden (B, S, d) after the final norm, aux loss (0 for the
    dense family), the cache with its new lengths)."""
    h = L.embed_lookup(model.embed, tokens)
    b, s, _ = h.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device).expand(b, s)
    lens = []
    for i, layer in enumerate(model.layers):
        if cache is None:
            h = L.remat(cfg.remat, lambda x, f=layer: f(x, positions, cfg)[0], h)
            continue
        lc = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"][i]}
        h, nc = layer(h, positions, cfg, lc)
        lens.append(nc["len"])
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "len": torch.stack(lens)}
    h = model.ln_f(h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device), new_cache


def loss_fn(model: Transformer, cfg, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) -> the mean token cross entropy
    plus 0.01 x the aux loss (transformer.py:153-161)."""
    if batch.get("vision_embeds") is not None:
        raise NotImplementedError("the vision prefix (vlm) is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    h, aux, _ = forward(model, cfg, batch["tokens"])
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


def prefill(model: Transformer, cfg, tokens: torch.Tensor, cache: Cache
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt, fill the cache, return last-token logits (B, 1, V)."""
    h, _, new_cache = forward(model, cfg, tokens, cache=cache)
    return L.unembed(model.embed, h[:, -1:]), new_cache


def decode_step(model: Transformer, cfg, token: torch.Tensor, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
    """One token per sequence: token (B, 1) + cache -> (logits (B, 1, V),
    the cache)."""
    b = token.shape[0]
    pos = cache["len"][0].reshape(1, 1).expand(b, 1)
    h, _, new_cache = forward(model, cfg, token, positions=pos, cache=cache)
    return L.unembed(model.embed, h), new_cache
