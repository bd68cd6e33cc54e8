"""Whisper-style encoder-decoder backbone (``src/repro/models/encdec.py``,
arXiv:2212.04356).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, source_len, d).  The encoder is a
non-causal transformer stack, so it never reaches K3; the decoder
interleaves causal self-attention (K3 under ``use_flash``),
cross-attention to the encoder output and a SwiGLU MLP.  Cross-attention
K/V are computed once per decoder layer from the encoder output
(``cross_kv``) and cached, so decode reads the source only through them.

Parameters ``enc.<i>.*`` and ``dec.<i>.*`` are slice i of the reference's
stacked ``enc``/``dec``; ``ln_enc``, ``ln_f`` and ``embed`` are not
stacked.  The cache is the reference's: self-attention ``k``/``v`` (L, B,
S_max, KV, hd) and ``len`` (L,), written in place, and ``xkv``
{"k", "v": (L, B, S_src, KV, hd)}.  As in the reference, the prompt in
``prefill`` attends to the cross K/V as computed, and decode to the copy
stored in the cache's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..convert import torch_dtype
from ..parallel.sharding import constrain, weight
from . import layers as L

__all__ = ["EncDec", "init", "param_specs", "encode", "cross_kv", "decode",
           "loss_fn", "init_cache", "cache_specs", "prefill", "decode_step"]

Cache = Dict[str, object]


class EncLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg, device)
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, cfg.n_layers,
                            torch_dtype(cfg.dtype), device)

    def forward(self, h, positions, cfg):
        a, _ = self.attn(self.ln1(h), positions, cfg, causal=False)
        h = h + a
        return h + self.ffn(self.ln2(h))


class DecLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln3 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg, device)
        self.xattn = L.Attention(cfg, device)
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, cfg.n_layers,
                            torch_dtype(cfg.dtype), device)

    def forward(self, h, positions, cfg, xk, xv, cache=None):
        """Self (causal, cached) + cross (to xk/xv) + MLP (encdec.py:111-119)."""
        a, nc = self.attn(self.ln1(h), positions, cfg, causal=True, cache=cache)
        h = h + a
        x, _ = self.xattn(self.ln2(h), positions, cfg, causal=False,
                          xattn_kv=(xk, xv))
        h = h + x
        return h + self.ffn(self.ln3(h)), nc


class EncDec(nn.Module):
    """``embed``, ``enc`` and ``dec`` (``nn.ModuleList``s), ``ln_enc``,
    ``ln_f``; parameters allocated uninitialised (``init`` draws them)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"not an encdec config: family {cfg.family!r}")
        self.embed = L.Embed(cfg, device)
        self.enc = nn.ModuleList(EncLayer(cfg, device)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, device)
                                 for _ in range(cfg.n_layers))
        self.ln_enc = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


def param_specs(cfg) -> L.Specs:
    """Each parameter's logical sharding axes, keyed by parameter name."""
    ln = L.norm_specs()
    enc = {**L.prefixed("ln1", ln), **L.prefixed("ln2", ln),
           **L.prefixed("attn", L.attention_specs(cfg)),
           **L.prefixed("ffn", L.swiglu_specs())}
    dec = {**L.prefixed("ln1", ln), **L.prefixed("ln2", ln),
           **L.prefixed("ln3", ln),
           **L.prefixed("attn", L.attention_specs(cfg)),
           **L.prefixed("xattn", L.attention_specs(cfg)),
           **L.prefixed("ffn", L.swiglu_specs())}
    return {**L.prefixed("embed", L.embed_specs(cfg)),
            **L.stacked("enc", cfg.enc_layers, enc),
            **L.stacked("dec", cfg.n_layers, dec),
            **L.prefixed("ln_enc", ln), **L.prefixed("ln_f", ln)}


def init(cfg, generator: Optional[torch.Generator] = None,
         device=None) -> EncDec:
    model = EncDec(cfg, device)
    model.reset_parameters(generator)
    return model


def _policy(cfg) -> str:
    """The reference checkpoints the whole block under ``full`` and
    ``dots`` alike (encdec.py:88-89, 133-134)."""
    return "full" if cfg.remat in ("full", "dots") else "none"


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


# ----------------------------------------------------------------- encoder
def encode(model: EncDec, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_src, d), the stub frontend's embeddings -> the encoder
    output (B, S_src, d) after ``ln_enc``.  Non-causal: plain attention."""
    b, s, _ = frames.shape
    positions = _positions(b, s, frames.device)
    h = constrain(frames.to(torch_dtype(cfg.dtype)), ("batch", None, "fsdp"))
    for layer in model.enc:
        h = L.remat(_policy(cfg), lambda x, f=layer: f(x, positions, cfg), h)
    return model.ln_enc(h)


def cross_kv(model: EncDec, cfg, enc_out: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """Each decoder layer's cross-attention K/V of the encoder output:
    {"k", "v": (L, B, S_src, KV, hd)}."""
    return {"k": torch.stack([
                L.split_heads(enc_out @ weight(l.xattn.wk, ("fsdp", "tensor")), cfg)
                for l in model.dec]),
            "v": torch.stack([
                L.split_heads(enc_out @ weight(l.xattn.wv, ("fsdp", "tensor")), cfg)
                for l in model.dec])}


# ----------------------------------------------------------------- decoder
def decode(model: EncDec, cfg, tokens: torch.Tensor,
           xkv: Dict[str, torch.Tensor],
           positions: Optional[torch.Tensor] = None,
           cache: Optional[Dict[str, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The decoder over ``tokens`` with cross K/V ``xkv``: (hidden after
    ``ln_f``, the self-attention cache {"k", "v", "len"} or None)."""
    h = L.embed_lookup(model.embed, tokens)
    b, s, _ = h.shape
    if positions is None:
        positions = _positions(b, s, h.device)
    lens = []
    for i, layer in enumerate(model.dec):
        xk, xv = xkv["k"][i], xkv["v"][i]
        if cache is None:
            h = L.remat(_policy(cfg), lambda x, f=layer, xk=xk, xv=xv:
                        f(x, positions, cfg, xk, xv)[0], h)
            continue
        lc = {"k": cache["k"][i], "v": cache["v"][i], "len": cache["len"][i]}
        h, nc = layer(h, positions, cfg, xk, xv, lc)
        lens.append(nc["len"])
    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "len": torch.stack(lens)}
    return model.ln_f(h), new_cache


# -------------------------------------------------------------------- train
def loss_fn(model: EncDec, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: frames (B, S_src, d), tokens (B, S), labels (B, S) -> the mean
    token cross entropy of the decoder."""
    xkv = cross_kv(model, cfg, encode(model, cfg, batch["frames"]))
    h, _ = decode(model, cfg, batch["tokens"], xkv)
    return L.chunked_cross_entropy(h, model.embed, batch["labels"],
                                   cfg.loss_chunk)


# -------------------------------------------------------------------- serve
def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    self_shape = (cfg.n_layers, batch, max_len, kvh, hd)
    cross_shape = (cfg.n_layers, batch, cfg.source_len, kvh, hd)
    return {
        "k": torch.zeros(self_shape, dtype=dtype, device=device),
        "v": torch.zeros(self_shape, dtype=dtype, device=device),
        "len": torch.zeros((cfg.n_layers,), dtype=torch.int32, device=device),
        "xkv": {"k": torch.zeros(cross_shape, dtype=dtype, device=device),
                "v": torch.zeros(cross_shape, dtype=dtype, device=device)},
    }


def cache_specs(cfg) -> Dict[str, object]:
    """The cache's logical sharding axes, keyed as ``init_cache``'s dict."""
    kv = (None, "batch", "kvseq", "kv", None)
    xkv = (None, "batch", None, "kv", None)
    return {"k": kv, "v": kv, "len": (), "xkv": {"k": xkv, "v": xkv}}


def prefill(model: EncDec, cfg, tokens: torch.Tensor, cache: Cache,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Encode the source, run the prompt through the decoder against its
    cross K/V, and cache those K/V in the cache's dtype (encdec.py:185-193).
    Returns (last-token logits (B, 1, V), the cache)."""
    xkv = cross_kv(model, cfg, encode(model, cfg, frames))
    sc = {"k": cache["k"], "v": cache["v"], "len": cache["len"]}
    h, new_sc = decode(model, cfg, tokens, xkv, cache=sc)
    dt = cache["k"].dtype
    new_cache = {**new_sc, "xkv": {key: t.to(dt) for key, t in xkv.items()}}
    return L.unembed(model.embed, h[:, -1:]), new_cache


def decode_step(model: EncDec, cfg, token: torch.Tensor, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
    b = token.shape[0]
    pos = cache["len"][0].reshape(1, 1).expand(b, 1)
    sc = {"k": cache["k"], "v": cache["v"], "len": cache["len"]}
    h, new_sc = decode(model, cfg, token, cache["xkv"], positions=pos, cache=sc)
    return L.unembed(model.embed, h), {**new_sc, "xkv": cache["xkv"]}
