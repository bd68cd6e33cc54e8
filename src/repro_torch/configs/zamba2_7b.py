"""zamba2-7b [zamba2] — Zamba2-7B-Instruct in its published form, the first
27 of its 81 layers (one of three 27-layer pipeline stages).

Published (``Zyphra/Zamba2-7B-Instruct``'s ``config.json``,
arXiv:2411.15242): hidden 3584, vocab 32000, context 4096; Mamba-2 layers
of 112 heads of 64, 2 groups, d_state 64, conv 4, chunk 256; at
``hybrid_layer_ids`` 6, 11, 17, 23, ... a call of one of two shared blocks
(``num_mem_blocks``), in turn: attention of 32 heads of 224 over [h, x0]
(7168 wide), RoPE, a GeGLU MLP of 14336 with a rank-128 adapter per call,
and a 3584 x 3584 linear per call.  Tied embeddings.

Cut: 27 layers, the hybrid layers among them 6, 11, 17 and 23 (blocks A,
B, A, B); every width as published.  Each pipeline stage of the
deployment holds both shared blocks, since every stage calls both.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="zamba2",
    n_layers=27,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=2,
    conv_width=4,
    ssd_chunk=256,
    hybrid_layers=(6, 11, 17, 23),
    shared_blocks=2,
    adapter_rank=128,
    rope_theta=10_000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    remat="full",
    use_flash=True,
)


def reduced() -> ModelConfig:
    """Two blocks, four calls, two groups, adapter rank 8, at CPU widths."""
    return CONFIG.replace(
        n_layers=6, hybrid_layers=(1, 2, 4, 5), d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=96, vocab=256, ssm_state=16,
        ssm_head_dim=16, ssd_chunk=32, adapter_rank=8, remat="none",
        dtype="float32", use_flash=False,
    )
