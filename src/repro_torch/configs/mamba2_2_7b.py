"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.

64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    conv_width=4,
    ssd_chunk=256,
    subquadratic=True,            # O(1)-state decode: runs long_500k
    remat="full",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16,
        ssd_chunk=32, remat="none", dtype="float32",
    )
