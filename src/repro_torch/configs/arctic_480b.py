"""arctic-480b [moe] — 128 experts top-2 + dense residual per layer.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base; hf]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,          # dense FFN residual branch per layer
    remat="full",
    opt_state_dtype="bfloat16",   # ~480B params: Adam must fit 16 GB/chip HBM
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        moe_d_ff=96, vocab=256, n_experts=8, top_k=2, remat="none",
        dtype="float32", opt_state_dtype="float32",
    )
