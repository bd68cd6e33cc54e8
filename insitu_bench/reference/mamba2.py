"""A plain float32 Mamba-2 language model (arXiv:2405.21060) and the AdamW
step of the training cell, in plain PyTorch, for the comparison that
decides the training cell's ``correct``.

Parameters are a ``{name: tensor}`` dict named as ``lib.inputs.
mamba2_leaves`` names them.  Each layer: RMSNorm; the in-projection into z,
x, B, C and dt; a causal depthwise convolution of width ``d_conv`` over
(x, B, C) with its bias, then SiLU; dt = softplus(dt + dt_bias), A =
-exp(A_log); the SSD scan of (x·dt, A·dt, B, C) in chunks; y + D·x; the
gated RMSNorm norm(y · SiLU(z)); the out-projection; the residual.  Then
RMSNorm and logits against the tied embedding, over every row of the table
as the port lays it out (its padding rows too), and the mean token cross
entropy.  Everything is computed in float32 with TF32 off, and each layer
is recomputed in the backward (``torch.utils.checkpoint``) so that the
full model fits the card.

``precision="fp8"`` is the control: the operands of the in- and
out-projections and of the logits rounded to float8 e4m3 (one scale per
tensor, from its largest magnitude), the gradient passed through unchanged.

AdamW as the configuration states: clipping by the global norm of all the
gradients, moments in float32, bias corrections, decoupled weight decay on
every leaf but the final norm's scale, the learning rate of a linear warmup
and cosine decay, and each bf16 parameter rounded back to bf16 after its
update (the configuration keeps bf16 parameters).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
GradHook = Callable[[int, Params], Params]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _FakeFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-12) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = _FakeFp8.apply(a), _FakeFp8.apply(b)
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def ssd(x, a, B, C, chunk: int):
    """y[t] = sum_{s <= t} C[t]·B[s] exp(a[s+1] + ... + a[t]) x[s], by chunks.
    x (b, s, h, p), a (b, s, h), B and C (b, s, g, n), heads split evenly
    over the groups."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x, a, B, C = (torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
                      for t in (x, a, B, C))
    x = x.reshape(b, nc, q, g, r, p)
    a = a.reshape(b, nc, q, g, r)
    B = B.reshape(b, nc, q, g, n)
    C = C.reshape(b, nc, q, g, n)
    cs = torch.cumsum(a, dim=2)                                    # (b,c,q,g,r)
    diff = cs[:, :, :, None] - cs[:, :, None, :]                   # (b,c,i,j,g,r)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal[None, None, :, :, None, None], torch.exp(
        torch.where(causal[None, None, :, :, None, None], diff, 0.0)), 0.0)
    weights = torch.einsum("bcign,bcjgn->bcijg", C, B)[..., None] * decay
    y = torch.einsum("bcijgr,bcjgrp->bcigrp", weights, x)
    to_end = torch.exp(cs[:, :, -1:] - cs)                         # (b,c,q,g,r)
    states = torch.einsum("bcjgn,bcjgrp->bcgrnp", B, x * to_end[..., None])
    state = x.new_zeros((b, g, r, n, p))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cs[:, c, -1])[..., None, None] + states[:, c]
    entering = torch.stack(entering, 1)                            # (b,c,g,r,n,p)
    y = y + torch.einsum("bcign,bcgrnp->bcigrp", C, entering) * torch.exp(cs)[..., None]
    return y.reshape(b, nc * q, h, p)[:, :s]


def layer(params: Params, i: int, h: torch.Tensor, w: Dict, precision: str):
    pre = f"layers.{i}."
    m = pre + "mamba."
    d = w["d_model"]
    di = w["expand"] * d
    g, n, hd = w["ngroups"], w["d_state"], w["headdim"]
    heads = di // hd
    eps = w["norm_eps"]
    u = rmsnorm(h, params[pre + "ln.scale"], eps)
    zxbcdt = _mm(u, params[m + "in_proj"], precision)
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * n, heads], dim=-1)
    width = params[m + "conv_w"].shape[0]
    s = xbc.shape[1]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(padded[:, k:k + s] * params[m + "conv_w"][k] for k in range(width))
    xbc = F.silu(conv + params[m + "conv_b"])
    x, B, C = xbc.split([di, g * n, g * n], dim=-1)
    bsz = x.shape[0]
    x = x.reshape(bsz, s, heads, hd)
    dt = F.softplus(dt + params[m + "dt_bias"])
    a = dt * -torch.exp(params[m + "A_log"])
    y = ssd(x * dt[..., None], a, B.reshape(bsz, s, g, n), C.reshape(bsz, s, g, n),
            w["chunk_size"])
    y = y + x * params[m + "D"][:, None]
    y = rmsnorm(y.reshape(bsz, s, di) * F.silu(z), params[m + "norm.scale"], eps)
    return h + _mm(y, params[m + "out_proj"], precision)


def loss(params: Params, batch: Dict[str, torch.Tensor], w: Dict,
         precision: str = "fp32") -> torch.Tensor:
    tok = params["embed.tok"]
    h = tok[batch["tokens"]]
    for i in range(w["n_layer"]):
        if torch.is_grad_enabled():
            h = checkpoint(layer, params, i, h, w, precision, use_reentrant=False)
        else:
            h = layer(params, i, h, w, precision)
    h = rmsnorm(h, params["ln_f.scale"], w["norm_eps"])
    logits = _mm(h, tok.T, precision)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return torch.mean(lse - picked)


def lr_at(o: Dict, step: int) -> float:
    """Linear warmup over ``warmup_steps``, then cosine decay to
    ``min_lr_ratio`` of ``lr`` at ``total_steps``."""
    if step < o["warmup_steps"]:
        return o["lr"] * step / max(o["warmup_steps"], 1)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["lr"] * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def decays(name: str) -> bool:
    return name != "ln_f.scale"


@torch.no_grad()
def adamw(params: Params, grads: Params, m: Params, v: Params, step: int,
          o: Dict, bf16: List[str]) -> None:
    """One AdamW step ``step`` (from 1) in place."""
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
    """Follow ``len(batches)`` steps from ``params`` (float32, changed in
    place: they end as the weights after the last step); returns each step's
    loss and the first gradient as the optimizer holds it (its first moment
    after step 1 over 1 - b1), by leaf.  ``grad_hook(step, grads)``, where
    given, returns the gradients the optimizer gets in place of ``grads``."""
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
