"""Assigned-architecture registry + the input-shape grid.

Every arch is selectable as ``--arch <id>`` (dashed id); each config module
defines ``CONFIG`` (the exact assigned config) and ``reduced()`` (same family
and code paths, tiny dimensions, for CPU smoke tests).

The shape grid is the assignment's: train_4k / prefill_32k / decode_32k /
long_500k.  ``shapes_for(cfg)`` filters out cells that are inapplicable to an
arch family (long_500k needs sub-quadratic attention; see DESIGN.md
§Arch-applicability).
"""

from __future__ import annotations

from dataclasses import dataclass
from importlib import import_module
from typing import Dict, List, Tuple

from ..models.config import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "SHAPES", "Shape", "shapes_for"]

ARCH_IDS: Tuple[str, ...] = (
    "arctic-480b",
    "phi3.5-moe-42b-a6.6b",
    "llama3.2-3b",
    "deepseek-coder-33b",
    "tinyllama-1.1b",
    "phi3-mini-3.8b",
    "mamba2-2.7b",
    "internvl2-76b",
    "zamba2-2.7b",
    "whisper-base",
)

_MODULES: Dict[str, str] = {
    "arctic-480b": "arctic_480b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama3.2-3b": "llama32_3b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi3-mini-3.8b": "phi3_mini",
    "mamba2-2.7b": "mamba2_2_7b",
    "internvl2-76b": "internvl2_76b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-base": "whisper_base",
    "zamba2-7b": "zamba2_7b",     # training only: not in the shape grid
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; choose from {list(_MODULES)}")
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced() if reduced else mod.CONFIG


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[Shape, ...] = (
    Shape("train_4k", 4_096, 256, "train"),
    Shape("prefill_32k", 32_768, 32, "prefill"),
    Shape("decode_32k", 32_768, 128, "decode"),
    Shape("long_500k", 524_288, 1, "decode"),
)


def shapes_for(cfg: ModelConfig) -> List[Shape]:
    """The applicable subset of the shape grid for this arch."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            continue  # full attention at 524k: skipped per assignment
        out.append(s)
    return out
