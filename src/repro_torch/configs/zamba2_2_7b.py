"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

A simplified Zamba2-style hybrid, as the JAX package has it, not the
published form: one shared block at d_model with SwiGLU and a 4096
window, no concatenation with the embedding and no adapters.  The
published form is the ``zamba2`` family (``configs/zamba2_7b.py``).

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

The shared attention block is applied every ``attn_every`` Mamba layers with
a single reused weight set (Zamba2's parameter sharing).  At the long_500k
shape the shared block uses a sliding window (ring-buffer KV cache), so the
whole arch decodes with O(window + ssm_state) state — hence subquadratic.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    conv_width=4,
    ssd_chunk=256,
    attn_every=6,                 # 54 layers -> 9 shared-block applications
    window=4096,                  # sliding-window attention in shared blocks
    subquadratic=True,
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, attn_every=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=16, ssd_chunk=32,
        window=32, remat="none", dtype="float32",
    )
