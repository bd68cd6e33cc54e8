"""Family dispatch: one surface over the ported model families
(``src/repro/models/registry.py``).

``get_family(cfg)`` returns a ``Family`` with ``model(cfg, device)`` (the
module, parameters uninitialised), ``init(cfg, generator, device)``,
``param_specs(cfg)`` (each parameter's logical sharding axes),
``loss_fn(model, cfg, batch)``, ``init_cache(cfg, batch, max_len, dtype,
device)``, ``cache_specs(cfg)`` (the cache's logical axes, keyed as the
cache), ``prefill(model, cfg, batch, cache)`` and ``decode_step(model,
cfg, token, cache)``, so the trainer and the serving engine are
family-agnostic (the zamba2 family trains only: its serving functions
raise).  The vlm and encdec families take their stub frontends'
inputs through the batch: ``vision_embeds`` (B, V, d) and ``frames`` (B,
S_src, d).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from . import encdec, hybrid, ssm, transformer, zamba2

__all__ = ["Family", "get_family"]


@dataclass(frozen=True)
class Family:
    name: str
    model: Callable
    init: Callable
    param_specs: Callable
    loss_fn: Callable
    init_cache: Callable
    cache_specs: Callable
    prefill: Callable
    decode_step: Callable


def _tfm_prefill(model, cfg, batch, cache):
    return transformer.prefill(model, cfg, batch["tokens"], cache,
                               prefix_embeds=batch.get("vision_embeds"))


def _ssm_prefill(model, cfg, batch, cache):
    return ssm.prefill(model, cfg, batch["tokens"], cache)


def _hyb_prefill(model, cfg, batch, cache):
    return hybrid.prefill(model, cfg, batch["tokens"], cache)


def _enc_prefill(model, cfg, batch, cache):
    return encdec.prefill(model, cfg, batch["tokens"], cache,
                          frames=batch["frames"])


_FAMILIES: Dict[str, Family] = {
    fam: Family(fam, cls, mod.init, mod.param_specs, mod.loss_fn,
                mod.init_cache, mod.cache_specs, pre, mod.decode_step)
    for fam, mod, cls, pre in (
        ("dense", transformer, transformer.Transformer, _tfm_prefill),
        ("moe", transformer, transformer.Transformer, _tfm_prefill),
        ("vlm", transformer, transformer.Transformer, _tfm_prefill),
        ("ssm", ssm, ssm.MambaLM, _ssm_prefill),
        ("hybrid", hybrid, hybrid.HybridLM, _hyb_prefill),
        ("encdec", encdec, encdec.EncDec, _enc_prefill),
        ("zamba2", zamba2, zamba2.Zamba2LM, zamba2.prefill),
    )
}


def get_family(cfg) -> Family:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None
