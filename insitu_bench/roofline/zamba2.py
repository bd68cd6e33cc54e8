"""The operations of the Zamba2 cell's training step and of its K3
launches, from shapes, beside ``roofline``'s peaks and K4 counts.

A shared block's call (``reference.zamba2.shared_call``): the q, k and v
projections from [h, x0] (2d wide), the causal attention over the
sequence (its scores and its weighted sum, each over the causal triangle),
the out-projection, the GeGLU MLP, the call's adapter and its linear.  The
Mamba layers are ``roofline.mamba2_forward_flops``'s, which also counts the
unembedding.  Elementwise work is not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

from insitu_bench import roofline


def attn_work(b: int, s: int, h: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of one causal bf16 K3 call over ``s`` tokens,
    ``h`` heads of ``d``: Q Kᵀ and P V over the causal triangle; q, k and v
    read once and o written once."""
    flops = 4 * b * h * d * s * (s + 1) / 2
    moved = 2 * 4 * b * s * h * d
    return flops, moved


def attn_bound_s(flops: float, moved: float, pk: Dict[str, float]) -> float:
    """K3's least time: the larger of its operations at the bf16 rate and
    its bytes at the memory bandwidth."""
    return max(flops / pk["bf16_flops"], moved / pk["bytes_per_s"])


def call_flops(w: Dict, batch: int, seq: int) -> float:
    """Operations of one call of a shared block over ``batch`` x ``seq``."""
    d, f, r = w["d_model"], w["d_ff"], w["adapter_rank"]
    qkv = w["heads"] * w["head_dim"]
    tokens = batch * seq
    proj = 2 * tokens * (3 * 2 * d * qkv + qkv * d + d * 2 * f + f * d
                         + r * (d + 2 * f) + d * d)
    attn, _ = attn_work(batch, seq, w["heads"], w["head_dim"])
    return proj + attn


def forward_flops(w: Dict, batch: int, seq: int, vocab: int) -> float:
    return (roofline.mamba2_forward_flops(w, batch, seq, vocab)
            + len(w["hybrid_layers"]) * call_flops(w, batch, seq))


def step_flops(w: Dict, batch: int, seq: int, vocab: int) -> float:
    """Model operations of one training step: the forward and a backward of
    twice its operations; the recompute of ``remat`` is not counted."""
    return 3 * forward_flops(w, batch, seq, vocab)
