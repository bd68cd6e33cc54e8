"""whisper-base [audio] — encoder-decoder, conv frontend STUB.

6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865
[arXiv:2212.04356; unverified]

``input_specs()`` provides precomputed frame embeddings (B, 1500, d) for the
encoder; the decoder is the assigned 6-layer stack with self+cross attention.
long_500k is skipped (full attention, enc-dec).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,            # decoder layers
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    source_len=1500,
    remat="none",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, source_len=16, dtype="float32",
    )
