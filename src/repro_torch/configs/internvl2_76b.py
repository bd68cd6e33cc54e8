"""internvl2-76b [vlm] — InternViT + InternLM2 backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified]

The vision tower is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings (B, vision_tokens, d_model) prepended to the
text sequence.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    vision_tokens=256,
    remat="full",
    opt_state_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=256, vision_tokens=8, remat="none", dtype="float32",
        opt_state_dtype="float32",
    )
