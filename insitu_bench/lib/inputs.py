"""The inputs of every cell, made from ``--seed`` on the device and handed
alike to the program and to the plain reference: the Mamba-2 weights and
the token batches.

Every draw takes its own generator, seeded by ``derive(seed, *salt)``, so
the same seed gives the same inputs on the same device, whatever else a run
draws, and seeds beyond 32 bits are welcome.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Iterator, List, Tuple

import torch


def derive(seed: int, *salt: Any) -> int:
    """A 63-bit generator seed for ``(seed, *salt)``."""
    digest = hashlib.sha256(repr((int(seed),) + salt).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device: Any, seed: int, *salt: Any) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *salt))


# ------------------------------------------------------------------ mamba2
def padded_rows(vocab: int) -> int:
    """Rows of the embedding table as the port lays it out: the vocabulary
    padded to a multiple of 256."""
    return -(-vocab // 256) * 256


def mamba2_leaves(w: Dict[str, Any]) -> List[Tuple[str, tuple, str, str, float]]:
    """``(name, shape, dtype, init, std)`` of every parameter of a tied
    Mamba-2 LM of widths ``w`` (``d_model``, ``n_layer``, ``vocab``,
    ``d_state``, ``headdim``, ``expand``, ``ngroups``, ``d_conv``), named as
    the port names them.  ``init`` is ``normal`` (N(0, std^2) in bf16),
    ``one``, ``a_log`` or ``dt_bias`` (float32)."""
    d, n_layer = w["d_model"], w["n_layer"]
    di = w["expand"] * d
    g, n, hd, width = w["ngroups"], w["d_state"], w["headdim"], w["d_conv"]
    h = di // hd
    conv_dim = di + 2 * g * n
    out: List[Tuple[str, tuple, str, str, float]] = [
        ("embed.tok", (padded_rows(w["vocab"]), d), "bfloat16", "normal", 0.02)]
    for i in range(n_layer):
        p = f"layers.{i}."
        out += [
            (p + "ln.scale", (d,), "float32", "one", 0.0),
            (p + "mamba.in_proj", (d, 2 * di + 2 * g * n + h), "bfloat16",
             "normal", 1 / math.sqrt(3 * d)),
            (p + "mamba.conv_w", (width, conv_dim), "bfloat16", "normal",
             1 / math.sqrt(3 * width)),
            (p + "mamba.conv_b", (conv_dim,), "bfloat16", "normal",
             1 / math.sqrt(3 * width)),
            (p + "mamba.A_log", (h,), "float32", "a_log", 0.0),
            (p + "mamba.D", (h,), "float32", "one", 0.0),
            (p + "mamba.dt_bias", (h,), "float32", "dt_bias", 0.0),
            (p + "mamba.norm.scale", (di,), "float32", "one", 0.0),
            (p + "mamba.out_proj", (di, d), "bfloat16", "normal",
             1 / math.sqrt(3 * di) / math.sqrt(n_layer)),
        ]
    out.append(("ln_f.scale", (d,), "float32", "one", 0.0))
    return out


def mamba2_weights(seed: int, w: Dict[str, Any], device
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter's initial value, in ``mamba2_leaves`` order, from two
    large draws on ``device``: one bf16 N(0, 1) for all the matrices and
    biases, scaled per leaf, and one float32 U(0, 1) for A (U(1, 16), its
    log kept) and dt (log-uniform in [1e-3, 0.1], floored at 1e-4, kept as
    the softplus inverse): Mamba-2's published initialisation of A and dt.
    Leaves are made one at a time, so the caller holds one draw and its own
    copy."""
    leaves = mamba2_leaves(w)
    g = generator(device, seed, "mamba2-weights")
    n_normal = sum(math.prod(s) for _, s, _, init, _ in leaves if init == "normal")
    heads = [s[0] for _, s, _, init, _ in leaves if init == "a_log"]
    normal = torch.randn(n_normal, generator=g, device=device, dtype=torch.bfloat16)
    uni = torch.rand(2 * sum(heads), generator=g, device=device, dtype=torch.float32)
    o_n = o_a = 0
    o_dt = sum(heads)
    for name, shape, dtype, init, std in leaves:
        n = math.prod(shape)
        if init == "normal":
            t = normal[o_n:o_n + n].view(shape) * std
            o_n += n
        elif init == "one":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        elif init == "a_log":
            t = torch.log(1.0 + 15.0 * uni[o_a:o_a + n])
            o_a += n
        else:  # dt_bias
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(lo + (hi - lo) * uni[o_dt:o_dt + n]).clamp(min=1e-4)
            t = dt + torch.log(-torch.expm1(-dt))
            o_dt += n
        yield name, t.to(getattr(torch, dtype))


_PROBS: Dict[Tuple[int, str], torch.Tensor] = {}


def token_batch(seed: int, stream: str, step: int, batch: int, seq: int,
                vocab: int, device, period: int = 8) -> Dict[str, torch.Tensor]:
    """Batch ``step`` of token stream ``stream``: ``batch`` rows of ``seq + 1``
    ids from a Zipf (1 / rank) unigram law over ``vocab`` ids, half the rows
    (drawn) made periodic with ``period`` so that a model can learn; returns
    ``tokens`` and ``labels`` (the next ids), int64 on ``device``."""
    key = (vocab, str(device))
    if key not in _PROBS:
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
        _PROBS[key] = (1.0 / ranks / (1.0 / ranks).sum()).float().to(device)
    g = generator(device, seed, "tokens", stream, step)
    ids = torch.multinomial(_PROBS[key], batch * (seq + 1), replacement=True,
                            generator=g).view(batch, seq + 1)
    periodic = torch.rand((batch, 1), generator=g, device=device) < 0.5
    planted = ids[:, :period].repeat(1, -(-(seq + 1) // period))[:, :seq + 1]
    ids = torch.where(periodic, planted, ids)
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}
