"""A plain float32 Zamba2 language model (arXiv:2411.15242) and the AdamW
step of the training cell, in plain PyTorch, for the comparison that
decides the ``zamba2-7b`` cell's ``correct``.

It follows ``transformers`` 4.57.6, ``models/zamba2/modeling_zamba2.py``
(cited by line).  Parameters are a ``{name: tensor}`` dict named as the
cell's ``zamba2_leaves`` names them, each matrix applied as
``x @ w`` (the transpose of an ``nn.Linear`` weight).  ``x0`` is the
embedding (l. 1287-1290); each layer ``i`` is

    h + Mamba(RMSNorm(h + t))    (l. 1078-1097; t = 0 without a call)

and at the hybrid layers ``t`` is a call ``c`` of shared block ``c % G``
(l. 1243-1245, 1413):

    u = RMSNorm_in([h, x0])                    l. 1016-1017
    q, k, v = u Wq, u Wk, u Wv; RoPE on q, k   l. 420-438, 228-235, 289-295
    a = softmax(q k^T / sqrt(hd / 2), causal) v Wo     l. 355, 444-456
    [g, up] = RMSNorm_ff(a) W_gate_up + (RMSNorm_ff(a) A_c) B_c   l. 1028, 960-962
    t = (GELU(g) * up) W_down W_linear,c       l. 964-967, 1158

with the exact GELU (``hidden_act`` "gelu").  The Mamba mixer: the
in-projection into z, x, B, C and dt; a causal depthwise convolution of
width ``d_conv`` over (x, B, C) with its bias, then SiLU; dt =
softplus(dt + dt_bias); A = -exp(A_log); the SSD scan in chunks; y + D x;
the gated norm, grouped: RMSNorm over each of the ``ngroups`` slices of
y · SiLU(z) (Zamba2RMSNormGated, l. 60-78), then the scale; the
out-projection.  Then RMSNorm and the logits against the tied embedding,
over every row of the table as the port lays it out, and the mean token
cross entropy.

Departures from ``modeling_zamba2.py``, each noted:

* dt is not clamped below: this follows the card's path
  (``mamba_chunk_scan_combined`` without ``dt_limit``, l. 698-712), not the
  CPU path's ``clamp(dt, time_step_min)`` (l. 805);
* the attention mask is a boolean one (``-inf`` for the masked scores,
  not ``finfo.min`` added), which gives the same probabilities;
* the SSD scan is ``reference.mamba2.ssd``'s chunked form, not the
  segment-sum one, the same function.

Everything is computed in float32 with TF32 off, and each layer and each
call is recomputed in the backward (``torch.utils.checkpoint``) so that
the cut model fits the card.  ``precision="fp8"`` is the control: the
operands of every projection and of the logits rounded to float8 e4m3
(``reference.mamba2``'s), the gradient passed through unchanged.

AdamW as ``reference.mamba2`` has it, with the port's decay rule: every
leaf decays but the final norm's and the shared blocks' norm scales (the
1-D leaves that no layer stacks).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from insitu_bench.reference import mamba2 as m2

Params = Dict[str, torch.Tensor]
GradHook = m2.GradHook
no_tf32 = m2.no_tf32
rmsnorm = m2.rmsnorm
lr_at = m2.lr_at
_mm = m2._mm


def grouped_rmsnorm(x: torch.Tensor, scale: torch.Tensor, groups: int,
                    eps: float) -> torch.Tensor:
    xg = x.unflatten(-1, (groups, -1))
    xg = xg * torch.rsqrt(torch.mean(xg * xg, dim=-1, keepdim=True) + eps)
    return xg.flatten(-2) * scale


def mamba(params: Params, i: int, u: torch.Tensor, w: Dict, precision: str):
    """The mixer of layer ``i`` on its normed input ``u`` (l. 735-914)."""
    m = f"layers.{i}.mamba."
    di = w["expand"] * w["d_model"]
    g, n, hd = w["ngroups"], w["d_state"], w["headdim"]
    heads = di // hd
    zxbcdt = _mm(u, params[m + "in_proj"], precision)
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * n, heads], dim=-1)
    width = params[m + "conv_w"].shape[0]
    bsz, s = xbc.shape[:2]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(padded[:, k:k + s] * params[m + "conv_w"][k] for k in range(width))
    xbc = F.silu(conv + params[m + "conv_b"])
    x, B, C = xbc.split([di, g * n, g * n], dim=-1)
    x = x.reshape(bsz, s, heads, hd)
    dt = F.softplus(dt + params[m + "dt_bias"])
    a = dt * -torch.exp(params[m + "A_log"])
    y = m2.ssd(x * dt[..., None], a, B.reshape(bsz, s, g, n),
               C.reshape(bsz, s, g, n), w["chunk_size"])
    y = y + x * params[m + "D"][:, None]
    y = grouped_rmsnorm(y.reshape(bsz, s, di) * F.silu(z),
                        params[m + "norm.scale"], g, w["norm_eps"])
    return _mm(y, params[m + "out_proj"], precision)


def layer(params: Params, i: int, h: torch.Tensor, t: Optional[torch.Tensor],
          w: Dict, precision: str) -> torch.Tensor:
    x = h if t is None else h + t
    return h + mamba(params, i, rmsnorm(x, params[f"layers.{i}.ln.scale"],
                                        w["norm_eps"]), w, precision)


def rope(s: int, hd: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (S, hd) of the rotate-half RoPE (l. 213-235)."""
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=device,
                                       dtype=torch.float32) / hd)
    ang = torch.arange(s, device=device, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Causal softmax attention, (B, H, S, hd) each (l. 271-292)."""
    s = q.shape[2]
    scores = (q @ k.transpose(-1, -2)) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, -math.inf)
    return torch.softmax(scores, dim=-1) @ v


def shared_call(params: Params, c: int, h: torch.Tensor, x0: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, w: Dict,
                precision: str) -> torch.Tensor:
    """Call ``c`` of its shared block: the ``t`` its hybrid layer adds."""
    blk = f"blocks.{c % w['shared_blocks']}."
    call = f"calls.{c}."
    b, s, _ = h.shape
    nh, hd = w["heads"], w["head_dim"]
    u = rmsnorm(torch.cat([h, x0], dim=-1), params[blk + "ln_in.scale"],
                w["norm_eps"])

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    q, k, v = (heads(_mm(u, params[blk + n], precision)) for n in ("wq", "wk", "wv"))
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    a = attention(q, k, v, (hd / 2) ** -0.5).transpose(1, 2).reshape(b, s, nh * hd)
    a = rmsnorm(_mm(a, params[blk + "wo"], precision), params[blk + "ln_ff.scale"],
                w["norm_eps"])
    gu = _mm(a, params[blk + "gate_up"], precision) + _mm(
        _mm(a, params[call + "adapter_in"], precision),
        params[call + "adapter_out"], precision)
    g, up = gu.chunk(2, dim=-1)
    m = _mm(F.gelu(g) * up, params[blk + "down"], precision)
    return _mm(m, params[call + "linear"], precision)


def hidden(params: Params, tokens: torch.Tensor, w: Dict,
           precision: str = "fp32") -> torch.Tensor:
    """The hidden state after the final norm (B, S, d)."""
    x0 = params["embed.tok"][tokens]
    h = x0
    cos, sin = rope(tokens.shape[1], w["head_dim"], w["rope_theta"], x0.device)
    calls = {layer_id: c for c, layer_id in enumerate(w["hybrid_layers"])}
    grad = torch.is_grad_enabled()
    for i in range(w["n_layer"]):
        t = None
        if i in calls:
            args = (params, calls[i], h, x0, cos, sin, w, precision)
            t = (checkpoint(shared_call, *args, use_reentrant=False) if grad
                 else shared_call(*args))
        args = (params, i, h, t, w, precision)
        h = checkpoint(layer, *args, use_reentrant=False) if grad else layer(*args)
    return rmsnorm(h, params["ln_f.scale"], w["norm_eps"])


def logits(params: Params, tokens: torch.Tensor, w: Dict,
           precision: str = "fp32") -> torch.Tensor:
    return _mm(hidden(params, tokens, w, precision), params["embed.tok"].T, precision)


def loss(params: Params, batch: Dict[str, torch.Tensor], w: Dict,
         precision: str = "fp32") -> torch.Tensor:
    lg = logits(params, batch["tokens"], w, precision)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, batch["labels"][..., None])[..., 0]
    return torch.mean(lse - picked)


def decays(name: str) -> bool:
    return not (name.endswith(".scale") and not name.startswith("layers."))


@torch.no_grad()
def adamw(params: Params, grads: Params, m: Params, v: Params, step: int,
          o: Dict, bf16: List[str]) -> None:
    """One AdamW step ``step`` (from 1) in place: ``reference.mamba2``'s
    arithmetic with this model's decay rule."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    clip = torch.clamp(o["grad_clip"] / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_at(o, step)
    bc1, bc2 = 1 - o["b1"] ** step, 1 - o["b2"] ** step
    for name, p in params.items():
        g = grads[name] * clip
        m[name].mul_(o["b1"]).add_(g * (1 - o["b1"]))
        v[name].mul_(o["b2"]).add_(g * g * (1 - o["b2"]))
        update = (m[name] / bc1) / (torch.sqrt(v[name] / bc2) + o["eps"])
        if decays(name):
            update = update + o["weight_decay"] * p
        new = p - lr * update
        if name in bf16:
            new = new.to(torch.bfloat16).float()
        p.copy_(new)


def train(params: Params, batches: List[Dict[str, torch.Tensor]], w: Dict,
          o: Dict, bf16: List[str], precision: str = "fp32",
          grad_hook: Optional[GradHook] = None) -> Tuple[List[float], Dict[str, float]]:
    """``reference.mamba2.train`` for this model: each step's loss and the
    first gradient as the optimizer holds it, by leaf; ``params`` end as
    the weights after the last step."""
    for p in params.values():
        p.requires_grad_(True)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], {}
    names = list(params)
    for step, batch in enumerate(batches, 1):
        value = loss(params, batch, w, precision)
        grads = dict(zip(names, torch.autograd.grad(value, [params[k] for k in names])))
        if grad_hook is not None:
            grads = grad_hook(step, grads)
        losses.append(float(value.detach()))
        adamw(params, grads, m, v, step, o, bf16)
        del grads, value
        if step == 1:
            first = {k: float((m[k] / (1 - o["b1"])).norm()) for k in names}
    for p in params.values():
        p.requires_grad_(False)
    return losses, first
