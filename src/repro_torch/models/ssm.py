"""Mamba2 (SSD, state-space duality) language model (``src/repro/models/
ssm.py``, arXiv:2405.21060).

The chunked SSD scan: an intra-chunk part quadratic in the chunk length
only, and an inter-chunk state recurrence.  ``ssd_chunked`` is the plain
torch version (``use_flash=False``); with ``use_flash`` the intra-chunk part
runs in the K4 kernel (``kernels.ops.ssd_chunked_kernel``).  Decode is O(1)
per token: a (heads, state, head_dim) state and a causal-conv ring of
width - 1 positions.

Layers are an ``nn.ModuleList``; parameter ``layers.<i>.<name>`` is slice i
of the reference's stacked ``layers/<name>``.  The cache keeps the
reference's stacked layout, ``conv`` (L, B, W-1, C) and ``ssm`` (L, B, H,
N, P) float32, and is updated in place.  Under autograd each layer runs
under the config's ``remat`` policy (``layers.remat``); the K4 scan is
differentiable (``kernels.ops.ssd_chunked_kernel``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import torch_dtype
from ..kernels import ops as kops
from ..parallel.sharding import (axis_index, axis_size, constrain, fit,
                                 local_apply, logical_to_spec, weight)
from . import layers as L

__all__ = ["segsum", "ssd_chunked", "ssd_decode_step", "Mamba", "MambaLM",
           "init", "mamba_specs", "layer_specs", "param_specs", "forward",
           "loss_fn", "init_cache", "cache_specs", "prefill", "decode_step"]

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- SSD core
def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] for
    i >= j, -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int = 256,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, plain torch.  x (B,S,H,P) pre-multiplied by dt;
    dA (B,S,H); Bm/Cm (B,S,G,N).  Returns (y (B,S,H,P), final state
    (B,H,N,P))."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    r = h // g
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s

    def pad3(a):
        if not pad:
            return a
        return torch.cat([a, a.new_zeros((b, pad) + tuple(a.shape[2:]))], dim=1)

    xp = pad3(x).reshape(b, nc, q, h, p)
    dAp = pad3(dA).reshape(b, nc, q, h)
    Bp = pad3(Bm).reshape(b, nc, q, g, n)
    Cp = pad3(Cm).reshape(b, nc, q, g, n)

    dA_cs = torch.cumsum(dAp, dim=2)                          # (b,nc,q,h)
    # --- intra-chunk (quadratic in q) ---
    Lmat = torch.exp(segsum(dAp.movedim(3, 2)))               # (b,nc,h,q,q)
    Lmat = torch.where(torch.isfinite(Lmat), Lmat, 0.0)
    scores = torch.einsum("bcign,bcjgn->bcgij", Cp, Bp)       # (b,nc,g,q,q)
    scores = scores.reshape(b, nc, g, 1, q, q)
    Lh = Lmat.reshape(b, nc, g, r, q, q)
    xg = xp.reshape(b, nc, q, g, r, p)
    y_diag = torch.einsum("bcgrij,bcjgrp->bcigrp", scores * Lh, xg)

    # --- chunk states ---
    decay_last = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)      # (b,nc,q,h)
    states = torch.einsum("bcjgn,bcjgrp->bcgrnp", Bp,
                          xg * decay_last.reshape(b, nc, q, g, r, 1))

    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(dA_cs[:, :, -1, :]).reshape(b, nc, g, r, 1, 1)
    prev = (torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
            if initial_state is None else initial_state.to(x.dtype))
    prev = prev.reshape(b, g, r, n, p)
    prevs = []
    for c in range(nc):                    # state entering each chunk
        prevs.append(prev)
        prev = prev * chunk_decay[:, c] + states[:, c]
    prevs_t = torch.stack(prevs, dim=1)                       # (b,nc,g,r,n,p)

    # --- off-diagonal contribution ---
    in_decay = torch.exp(dA_cs)                               # (b,nc,q,h)
    y_off = torch.einsum("bcign,bcgrnp->bcigrp", Cp, prevs_t)
    y_off = y_off * in_decay.reshape(b, nc, q, g, r, 1)

    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y, prev.reshape(b, h, n, p)


def ssd_decode_step(state, x, dA, Bm, Cm):
    """O(1) recurrent update.  state (B,H,N,P); x (B,H,P) pre-multiplied by
    dt; dA (B,H); Bm/Cm (B,G,N).  Returns (y (B,H,P), new state)."""
    h = state.shape[1]
    r = h // Bm.shape[1]
    dec = torch.exp(dA)[..., None, None]
    Bh = Bm.repeat_interleave(r, dim=1)
    Ch = Cm.repeat_interleave(r, dim=1)
    new = state * dec + Bh[..., :, None] * x[..., None, :]
    return torch.einsum("bhn,bhnp->bhp", Ch, new), new


# ------------------------------------------------------------- Mamba block
def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv of width W.  xBC (B,S,C); w (W,C); state
    (B, W-1, C) history for decode.  Returns (silu(out + b), new state)."""
    width = w.shape[0]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], width - 1, xBC.shape[2]))
    else:
        pad = state.to(xBC.dtype)
    xfull = torch.cat([pad, xBC], dim=1)                      # (B, S+W-1, C)
    s = xBC.shape[1]
    out = xfull[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xfull[:, i:i + s] * w[i]
    return F.silu(out + b), xfull[:, -(width - 1):]


def _heads_split(cfg) -> Optional[str]:
    """``"tensor"`` when the tensor axes split the SSD heads evenly and
    each rank's heads read whole groups (or one group), else None."""
    n = axis_size("tensor")
    h, g = cfg.ssm_heads, cfg.ssm_groups
    if n == 1 or h % n or logical_to_spec(("batch", "tensor"))[1] is None:
        return None             # (the batch takes the tensor axes: moe_ep)
    h_loc, per = h // n, h // g
    return "tensor" if h_loc % per == 0 or per % h_loc == 0 else None


def _mixer(cfg, split, xBC, dtp, A_log, dt_bias, D, ssm0, dtype):
    """The SSD part of the block on this rank's heads (all of them on one
    device): xBC (B, S, C) after the conv, dtp (B, S, H), ssm0 (B, H_loc,
    N, P) or None.  Returns (y (B, S, H_loc * P) in ``dtype``, the new
    state)."""
    b, s, _ = xBC.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_head_dim
    xin = xBC[..., :di].reshape(b, s, h, pdim)
    Bm = xBC[..., di:di + g * n].reshape(b, s, g, n)
    Cm = xBC[..., di + g * n:].reshape(b, s, g, n)
    if split is not None and axis_size(split) > 1:   # this rank's heads
        h_loc = h // axis_size(split)
        h0 = axis_index(split) * h_loc
        per = h // g
        g0, g1 = h0 // per, (h0 + h_loc - 1) // per + 1
        xin, Bm, Cm = xin[:, :, h0:h0 + h_loc], Bm[:, :, g0:g1], Cm[:, :, g0:g1]
        dtp, dt_bias = dtp[..., h0:h0 + h_loc], dt_bias[h0:h0 + h_loc]
        A_log, D = A_log[h0:h0 + h_loc], D[h0:h0 + h_loc]
    dt = F.softplus(dtp.float() + dt_bias)                          # (B,S,H)
    dA = dt * -torch.exp(A_log)
    xdt = xin.float() * dt[..., None]

    if ssm0 is not None and s == 1:
        y, new_ssm = ssd_decode_step(
            ssm0.float(), xdt[:, 0], dA[:, 0], Bm[:, 0].float(), Cm[:, 0].float())
        y = y[:, None]
    else:
        init_state = ssm0.float() if ssm0 is not None else None
        ssd = kops.ssd_chunked_kernel if cfg.use_flash else ssd_chunked
        y, new_ssm = ssd(xdt, dA, Bm.float(), Cm.float(),
                         chunk=cfg.ssd_chunk, initial_state=init_state)

    y = y + xin.float() * D[None, None, :, None]
    return y.reshape(b, s, -1).to(dtype), new_ssm


class Mamba(nn.Module):
    """The Mamba2 block; the config passed to ``forward`` decides the path
    (``use_flash``, chunk), the one given here only the shapes."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.n_layers = cfg.n_layers
        d, di = cfg.d_model, cfg.d_inner
        g, n, h, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.conv_width
        conv_dim = di + 2 * g * n
        dt = torch_dtype(cfg.dtype)
        f32 = torch.float32
        self.in_proj = L._param((d, 2 * di + 2 * g * n + h), dt, device)
        self.conv_w = L._param((w, conv_dim), dt, device)
        self.conv_b = L._param((conv_dim,), dt, device)
        self.A_log = L._param((h,), f32, device)
        self.D = L._param((h,), f32, device)
        self.dt_bias = L._param((h,), f32, device)
        self.norm = L.RMSNorm(di, cfg.norm_eps, device)
        self.out_proj = L._param((di, d), dt, device)

    def reset_parameters(self, generator=None) -> None:
        d, width, di = (self.in_proj.shape[0], self.conv_w.shape[0],
                        self.out_proj.shape[0])
        L.normal_(self.in_proj, 1.0 / math.sqrt(d), generator)
        L.normal_(self.conv_w, 1.0 / math.sqrt(width), generator)
        L.normal_(self.out_proj, 1.0 / math.sqrt(di)
                  / math.sqrt(2 * self.n_layers), generator)
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.dt_bias.zero_()

    def forward(self, x: torch.Tensor, cfg, cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B,S,d) -> (B,S,d).  cache {"conv": (B,W-1,C), "ssm":
        (B,H,N,P)}, written in place."""
        di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        zxbcdt = constrain(x @ weight(self.in_proj, ("fsdp", "tensor")),
                           ("batch", None, "tensor"))
        if torch.is_grad_enabled():
            # whole along its features before it is cut into z, xBC and dt
            # (the cuts do not fall on the split), so that the gradient comes
            # back in the layout above: DTensor's own slice backward may
            # split it along the sequence, which the in-projection's backward
            # cannot flatten with a batch split (one row per data rank)
            zxbcdt = constrain(zxbcdt, ("batch", None, None))
        z = zxbcdt[..., :di]
        xBC = zxbcdt[..., di:2 * di + 2 * g * n]
        dtp = zxbcdt[..., 2 * di + 2 * g * n:]
        conv_state = cache["conv"] if cache is not None else None
        # the depthwise conv on each rank's channels, the scan on its heads
        cax = fit(("batch", None, "tensor"), xBC.shape)
        xBC, new_conv = local_apply(
            _causal_conv, (xBC, self.conv_w, self.conv_b, conv_state),
            (cax, cax[1:], cax[2:], cax), (cax, cax), summed=(1, 2))
        split = _heads_split(cfg)
        y, new_ssm = local_apply(
            lambda xBC, dtp, A_log, dt_bias, D, ssm0: _mixer(
                cfg, split, xBC, dtp, A_log, dt_bias, D, ssm0, x.dtype),
            (xBC, dtp, self.A_log, self.dt_bias, self.D,
             cache["ssm"] if cache is not None else None),
            (("batch", None, None),) * 2 + ((None,),) * 3
            + (("batch", split, None, None),),
            (("batch", None, split), ("batch", split, None, None)),
            summed=(0, 1, 2, 3, 4))
        y = y * F.silu(z)
        # the gated norm, grouped as the B/C groups (published Mamba-2's
        # RMSNormGated and Zamba2RMSNormGated: group size d_inner / G)
        y = (self.norm(y) if g == 1 else
             L.rmsnorm_grouped(self.norm.scale, y, g, self.norm.eps))
        out = constrain(y @ weight(self.out_proj, ("tensor", "fsdp")),
                        ("batch", "seq", "fsdp"))
        new_cache = None
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(new_ssm)
            new_cache = cache
        return out, new_cache


class MambaLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mamba = Mamba(cfg, device)

    def forward(self, h, cfg, cache=None):
        o, nc = self.mamba(self.ln(h), cfg, cache)
        return h + o, nc


class MambaLM(nn.Module):
    """``embed``, ``layers`` (an ``nn.ModuleList``), ``ln_f``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"not an ssm config: family {cfg.family!r}")
        self.embed = L.Embed(cfg, device)
        self.layers = nn.ModuleList(MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


def mamba_specs(cfg) -> L.Specs:
    return {"in_proj": ("fsdp", "tensor"), "conv_w": (None, "tensor"),
            "conv_b": ("tensor",), "A_log": (None,), "D": (None,),
            "dt_bias": (None,), "out_proj": ("tensor", "fsdp"),
            **L.prefixed("norm", L.norm_specs())}


def layer_specs(cfg) -> L.Specs:
    """The specs of one ``MambaLayer``."""
    return {**L.prefixed("ln", L.norm_specs()),
            **L.prefixed("mamba", mamba_specs(cfg))}


def param_specs(cfg) -> L.Specs:
    """Each parameter's logical sharding axes, keyed by parameter name."""
    return {**L.prefixed("embed", L.embed_specs(cfg)),
            **L.stacked("layers", cfg.n_layers, layer_specs(cfg)),
            **L.prefixed("ln_f", L.norm_specs())}


def init(cfg, generator: Optional[torch.Generator] = None,
         device=None) -> MambaLM:
    model = MambaLM(cfg, device)
    model.reset_parameters(generator)
    return model


def forward(model: MambaLM, cfg, tokens: torch.Tensor,
            cache: Optional[Cache] = None
            ) -> Tuple[torch.Tensor, Optional[Cache]]:
    h = L.embed_lookup(model.embed, tokens)
    for i, layer in enumerate(model.layers):
        if cache is None:
            h = L.remat(cfg.remat, lambda x, f=layer: f(x, cfg)[0], h)
            continue
        h, _ = layer(h, cfg, {"conv": cache["conv"][i], "ssm": cache["ssm"][i]})
    return model.ln_f(h), cache


def loss_fn(model: MambaLM, cfg, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) -> the mean token cross entropy
    (ssm.py:283-285)."""
    h, _ = forward(model, cfg, batch["tokens"])
    return L.chunked_cross_entropy(h, model.embed, batch["labels"],
                                   cfg.loss_chunk)


def init_cache(cfg, batch: int, max_len: int = 0, dtype=torch.bfloat16,
               device=None) -> Cache:
    """O(1) in the sequence length (``max_len`` is unused: same signature
    as the other families)."""
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    conv_dim = di + 2 * g * n
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads, n,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }


def cache_specs(cfg) -> Dict[str, tuple]:
    """The cache's logical sharding axes, keyed as ``init_cache``'s dict."""
    return {"conv": (None, "batch", None, "tensor"),
            "ssm": (None, "batch", "tensor", None, None)}


def prefill(model: MambaLM, cfg, tokens: torch.Tensor, cache: Cache):
    h, new_cache = forward(model, cfg, tokens, cache=cache)
    return L.unembed(model.embed, h[:, -1:]), new_cache


def decode_step(model: MambaLM, cfg, token: torch.Tensor, cache: Cache):
    h, new_cache = forward(model, cfg, token, cache=cache)
    return L.unembed(model.embed, h), new_cache
