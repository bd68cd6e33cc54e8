"""The yardstick of the roofline metrics: the card's published peaks and the
operations and bytes of each kernel and of a whole training step, computed
from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
card's full 700 W power limit (a card set below it runs slower, so every
share is stated with the card's limit beside it).  K4's rate is a third of
the TF32 tensor-core rate, TF32 being half the bf16 rate: 3xTF32, which
keeps the float32 contract, makes three TF32 products of each.

Byte counts read each input byte once and write each output byte once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bytes_per_s": 3.35e12, "bf16_flops": 989e12, "f32_flops": 67e12},
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``device_name`` (``torch.cuda.
    get_device_name()``), or ``None`` for a card the table lacks."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    return None


def ssd_work(b: int, nc: int, q: int, h: int, p: int, g: int, n: int
             ) -> Tuple[float, float]:
    """(operations, bytes) of one K4 call on chunked float32 inputs: x (b,
    nc, q, h, p), dA (b, nc, q, h), B and C (b, nc, q, g, n); it writes
    y_diag like x and the chunk states (b, nc, h, n, p).  The products
    C·Bᵀ over each group, (C·Bᵀ ∘ L)·x and the states Bᵀ·x, each over the
    causal triangle where it applies."""
    tri = q * (q + 1) / 2
    flops = 2 * b * nc * (g * tri * n + h * tri * p + h * q * n * p)
    moved = 4 * (2 * b * nc * q * h * p + b * nc * q * h + 2 * b * nc * q * g * n
                 + b * nc * h * n * p)
    return flops, moved


def ssd_bound_s(flops: float, moved: float, pk: Dict[str, float]) -> float:
    """K4's least time: the larger of its operations at the 3xTF32 rate and
    its bytes at the memory bandwidth."""
    return max(flops / (pk["bf16_flops"] / 2 / 3), moved / pk["bytes_per_s"])


def mamba2_forward_flops(w: Dict[str, int], batch: int, seq: int, vocab: int
                         ) -> float:
    """Operations of one forward pass of a Mamba-2 LM of widths ``w`` over
    ``batch`` x ``seq`` tokens, with logits over ``vocab`` ids: the in- and
    out-projections, the depthwise convolution, the SSD scan (its
    intra-chunk step, the chunk states and the states' contribution to each
    position) and the unembedding.  Elementwise work is not counted."""
    d, n_layer = w["d_model"], w["n_layer"]
    di = w["expand"] * d
    g, n, p, width = w["ngroups"], w["d_state"], w["headdim"], w["d_conv"]
    h = di // p
    q = w["chunk_size"]
    nc = -(-seq // q)
    tokens = batch * seq
    proj = 2 * tokens * (d * (2 * di + 2 * g * n + h) + di * d)
    conv = 2 * tokens * (di + 2 * g * n) * width
    intra, _ = ssd_work(batch, nc, q, h, p, g, n)    # with the chunk states
    inter = 2 * batch * nc * q * h * n * p           # C · state entering the chunk
    per_layer = proj + conv + intra + inter
    return n_layer * per_layer + 2 * tokens * d * vocab


def mamba2_step_flops(w: Dict[str, int], batch: int, seq: int, vocab: int) -> float:
    """Model operations of one training step: the forward and a backward of
    twice its operations; the recompute of ``remat`` is not counted."""
    return 3 * mamba2_forward_flops(w, batch, seq, vocab)
