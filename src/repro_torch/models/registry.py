"""Family dispatch: one surface over the ported model families
(``src/repro/models/registry.py``).

``get_family(cfg)`` returns a ``Family`` with ``model(cfg, device)`` (the
module, parameters uninitialised), ``init(cfg, generator, device)``,
``init_cache(cfg, batch, max_len, dtype, device)``, ``prefill(model, cfg,
batch, cache)`` and ``decode_step(model, cfg, token, cache)``, so the
serving engine is family-agnostic.  The dense and ssm families are ported;
the others raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from . import ssm, transformer

__all__ = ["Family", "get_family"]


@dataclass(frozen=True)
class Family:
    name: str
    model: Callable
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def _tfm_prefill(model, cfg, batch, cache):
    return transformer.prefill(model, cfg, batch["tokens"], cache)


def _ssm_prefill(model, cfg, batch, cache):
    return ssm.prefill(model, cfg, batch["tokens"], cache)


_FAMILIES: Dict[str, Family] = {
    "dense": Family("dense", transformer.Transformer, transformer.init,
                    transformer.init_cache, _tfm_prefill,
                    transformer.decode_step),
    "ssm": Family("ssm", ssm.MambaLM, ssm.init, ssm.init_cache, _ssm_prefill,
                  ssm.decode_step),
}

_NOT_YET = {
    "moe": "ROADMAP Queue 1 items 9-10 (layers.moe, moe_a2a)",
    "vlm": "ROADMAP Queue 1 item 9 (the vision prefix of transformer.forward)",
    "hybrid": "ROADMAP Queue 1 item 10 (models/hybrid.py, layers.attend/"
              "blockwise_attention)",
    "encdec": "ROADMAP Queue 1 item 10 (models/encdec.py)",
}


def get_family(cfg) -> Family:
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    if cfg.family in _NOT_YET:
        raise NotImplementedError(f"the {cfg.family} family is not ported yet: "
                                  f"{_NOT_YET[cfg.family]}")
    raise ValueError(f"unknown model family {cfg.family!r}")
