"""Collective-byte accounting and roofline terms for the dry run
(``src/repro/launch/hlo.py``).

Two ways to count a step's collectives, one result type
(``CollectiveStats``: bytes and calls by kind):

* ``collective_bytes(hlo_text)`` reads SPMD-partitioned XLA HLO text (the
  per-device module) and sums the result sizes of every cross-device
  collective.  It is the reference's reader, kept in plain Python so that a
  dump from the JAX package can be read here without JAX (nothing in the
  port calls it: the port traces, it does not compile).  Collective bytes
  inside a ``while`` body are multiplied by the loop's trip count (from
  ``known_trip_count`` in the backend config, else the largest integer
  constant of the loop condition), nested loops multiplying through: the
  reference runs its layer stack under ``lax.scan``.
* ``CommLog`` is the port's own: a ``TorchDispatchMode`` that records every
  collective the traced step dispatches (DTensor's functional collectives
  and the ``c10d`` ops that ``moe_a2a`` calls), each with its kind, its
  result's bytes and its group's size.  The port runs its layers eagerly,
  one after the other, so the trace meets each layer's collectives once per
  layer: the count needs no trip-count scaling and comes out as the
  reference's scaled one.

Byte factors are the standard ring estimates, applied to the RESULT shape
(documented, approximate):

    all-gather         : output bytes          (each device receives out-in)
    all-reduce         : 2 x bytes             (reduce-scatter + all-gather)
    reduce-scatter     : output bytes x group size (= input bytes)
    all-to-all         : bytes
    collective-permute : bytes

The compute and memory terms come from documented analytic counters
(``analytic_stats``), as the reference's do (its ``cost_analysis()`` counts
a ``while`` body once); ``FlopCounterMode``'s raw count is recorded beside
them.

Hardware constants are the NVIDIA H100 SXM's (H100 80GB HBM3) at its full
700 W power limit, from the data sheet: 989e12 dense bf16 tensor-core
FLOP/s, 3.35e12 B/s HBM3, and NVLink 4 at 450e9 B/s per direction, the one
direction of one card's links that a ring step uses (the conservative
charge, as the reference charges one link).  ``PEAKS`` holds the rates of
each card the port knows, by device name; ``chip_smoke.py`` reads it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed import ProcessGroup
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.utils._python_dispatch import TorchDispatchMode

# (device-name key, HBM bytes/s, dense bf16 FLOP/s, float32 CUDA-core
# FLOP/s), NVIDIA data sheets at the full power limit (700 W for the SXM)
PEAKS = (("H100 80GB HBM3", 3.35e12, 989e12, 67e12),
         ("H100 SXM", 3.35e12, 989e12, 67e12),
         ("H100 NVL", 3.9e12, 835e12, 60e12),
         ("H100 PCIe", 2.0e12, 756e12, 51e12),
         ("H200", 4.8e12, 989e12, 67e12))

LINK_BW = 450e9            # H100 SXM at 700 W: NVLink 4 bytes/s, one direction


def peaks(name: str) -> Tuple[float, float, float]:
    """(HBM bytes/s, bf16 FLOP/s, float32 FLOP/s) of the card ``name``
    (``torch.cuda.get_device_name``)."""
    for key, *rates in PEAKS:
        if key in name:
            return tuple(rates)
    raise RuntimeError(f"no peak rates on record for {name!r}")


_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
# Factors applied to the RESULT shape (post-optimization HLO prints operands
# without inline types): all-gather out bytes ~ bytes received; all-reduce
# in == out, ring moves ~2x; reduce-scatter in = out * group_size;
# all-to-all / collective-permute in == out.
_COLLECTIVES = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": None,   # out bytes * group size
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
# one regex per op kind: " = <shape(s)> <kind>(" start/done variants included
_OP_RE = re.compile(
    r"=\s+(.*?)\s+(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(([^)\n]*)\)([^\n]*)")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s+\([^\n]*?\)\s+->", re.M)
_WHILE_RE = re.compile(
    r"while\(.*?\), condition=%?([\w\.\-]+), body=%?([\w\.\-]+)"
    r"(?:.*?known_trip_count\":\{\"n\":\"(\d+)\"\})?")
_CALL_RE = re.compile(r"\b(?:call|conditional)\(.*?to_apply=%?([\w\.\-]+)")


def _split_computations(hlo_text: str) -> Dict[str, str]:
    """Map computation name -> body text (between its header and final '}')."""
    comps: Dict[str, str] = {}
    headers = [(m.group(1), m.start()) for m in _COMP_RE.finditer(hlo_text)]
    for i, (name, start) in enumerate(headers):
        end = headers[i + 1][1] if i + 1 < len(headers) else len(hlo_text)
        comps[name] = hlo_text[start:end]
    return comps


def _group_size(attrs: str) -> int:
    m = _GROUPS_IOTA_RE.search(attrs)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(attrs)
    if m:
        return m.group(1).count(",") + 1
    return 1


def _direct_collectives(body: str) -> Dict[str, Tuple[int, int]]:
    out: Dict[str, Tuple[int, int]] = {}
    for m in _OP_RE.finditer(body):
        result_txt, kind, _operands_txt, attrs = m.groups()
        factor = _COLLECTIVES[kind]
        if factor is None:  # reduce-scatter: input = output * group size
            factor = float(_group_size(attrs))
        raw = _shape_bytes(result_txt)
        b, c = out.get(kind, (0, 0))
        out[kind] = (b + int(raw * factor), c + 1)
    return out


def collective_bytes(hlo_text: str, entry: Optional[str] = None) -> CollectiveStats:
    """Sum collective traffic (per-device bytes) from partitioned HLO text.

    While bodies are scaled by their trip count (from ``known_trip_count`` in
    the backend config, falling back to the largest integer constant in the
    loop condition), so collectives under ``lax.scan`` are charged once per
    iteration -- XLA's own cost analysis counts them once per *loop*.
    """
    comps = _split_computations(hlo_text)
    if entry is None:
        m = re.search(r"^ENTRY\s+%?([\w\.\-]+)", hlo_text, re.M)
        entry = m.group(1) if m else next(iter(comps), None)

    memo: Dict[str, Dict[str, Tuple[int, int]]] = {}

    def trip_count(cond_name: str, explicit: Optional[str]) -> int:
        if explicit:
            return int(explicit)
        body = comps.get(cond_name, "")
        consts = [int(c) for c in re.findall(r"constant\((\d+)\)", body)]
        return max(consts) if consts else 1

    def acc(dst: Dict[str, Tuple[int, int]], src: Dict[str, Tuple[int, int]],
            mult: int = 1) -> None:
        for k, (b, c) in src.items():
            b0, c0 = dst.get(k, (0, 0))
            dst[k] = (b0 + b * mult, c0 + c * mult)

    def walk(name: str, seen=()) -> Dict[str, Tuple[int, int]]:
        if name in memo:
            return memo[name]
        if name in seen or name not in comps:
            return {}
        body = comps[name]
        total: Dict[str, Tuple[int, int]] = {}
        acc(total, _direct_collectives(body))
        for m in _WHILE_RE.finditer(body):
            cond, wbody, tc = m.groups()
            n = trip_count(cond, tc)
            acc(total, walk(wbody, seen + (name,)), n)
        for m in _CALL_RE.finditer(body):
            acc(total, walk(m.group(1), seen + (name,)))
        memo[name] = total
        return total

    stats = CollectiveStats()
    result = walk(entry) if entry else {}
    for k, (b, c) in result.items():
        stats.bytes_by_kind[k] = b
        stats.count_by_kind[k] = c
    return stats


# ------------------------------------------------------- traced collectives
# op name -> (kind, which tensor argument is the result, ring factor; None:
# the group size, as for reduce-scatter above).  The functional ops and
# ``shard_dim_alltoall`` (a change of split dimension on a CUDA mesh; on a
# CPU mesh DTensor gathers and chunks instead, since gloo has no
# all-to-all, so a CPU trace records an all-gather there) are DTensor's;
# the c10d ops are what ``torch.distributed``'s in-place calls
# (``moe_a2a``) dispatch.
_TRACED = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", None, 1.0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", None, 1.0),
    "_c10d_functional.all_reduce": ("all-reduce", None, 2.0),
    "_c10d_functional.all_reduce_": ("all-reduce", None, 2.0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", None, None),
    "_c10d_functional.all_to_all_single": ("all-to-all", None, 1.0),
    "_c10d_functional_autograd.all_gather_into_tensor": ("all-gather", None, 1.0),
    "_c10d_functional_autograd.reduce_scatter_tensor": ("reduce-scatter", None, None),
    "_c10d_functional_autograd.all_to_all_single": ("all-to-all", None, 1.0),
    "_dtensor.shard_dim_alltoall": ("all-to-all", None, 1.0),
    "c10d._allgather_base_": ("all-gather", 0, 1.0),
    "c10d.allreduce_": ("all-reduce", 0, 2.0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0, None),
    "c10d.alltoall_base_": ("all-to-all", 0, 1.0),
}


def _nbytes(t: Any) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(u) for u in t)
    return t.numel() * t.element_size() if hasattr(t, "numel") else 0


def _traced_group_size(args) -> int:
    """The group size of a collective's arguments: the first
    ``ProcessGroup`` (boxed as a ``ScriptObject``, the ``c10d`` ops) or the
    last string (a group name: the functional ops end with it)."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return int(ProcessGroup.unbox(a).size())
    names = [a for a in args if isinstance(a, str)]
    return int(_resolve_process_group(names[-1]).size()) if names else 1


def desugars(func, types) -> bool:
    """Whether a dispatch mode should hand this op back (``NotImplemented``)
    so that a tensor subclass lowers it first: an op on ``DTensor``s (or
    on the waiting results of functional collectives) runs with every mode
    still active once its subclass takes it, so the mode then sees the
    local ops and the collectives of its redistributions, sharding
    propagation's included, as torch's ``CommDebugMode`` does.  A
    higher-order operator is never handed back."""
    if isinstance(func, torch._ops.HigherOrderOperator):
        return False
    from torch.distributed._functional_collectives import AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, (DTensor, AsyncCollectiveTensor)) for t in types)


class CommLog(TorchDispatchMode):
    """Records every collective dispatched inside it: one ``(kind, bytes,
    group size, result shape)`` entry per call in ``calls``; ``stats()`` sums them with
    the ring factors into a ``CollectiveStats``.  A group of one rank moves
    nothing and is not recorded.  Ops on ``DTensor``s are handed back
    (``desugars``), so the collectives DTensor adds inside an op (a weight
    gathered for a matmul, a partial sum reduced) are recorded as well as
    the explicit ones."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[str, int, int, Tuple[int, ...]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if desugars(func, types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        spec = _TRACED.get(func.name().replace("::", "."))
        if spec is not None:
            kind, at, factor = spec
            n = _traced_group_size(tuple(args) + tuple((kwargs or {}).values()))
            if n > 1:
                res = out if at is None else args[at]
                self.calls.append((kind, int(_nbytes(res) * (n if factor is None
                                                             else factor)),
                                   n, tuple(getattr(res, "shape", ()))))
        return out

    def stats(self) -> CollectiveStats:
        st = CollectiveStats()
        for kind, b, *_ in self.calls:
            st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0) + b
            st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + 1
        return st


# the roofline's card: its HBM and dense bf16 rates from ``PEAKS``
HBM_BW, PEAK_FLOPS, _ = peaks("H100 SXM")


@dataclass
class Roofline:
    flops: float                 # per-device HLO flops
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective bytes
    model_flops: float           # 6*N*D useful flops (per device)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's peak the *useful* work achieves at the
        bound: (model_flops/peak) / t_bound."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.t_bound

    def to_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# --------------------------------------------------------------------------
# Analytic per-device FLOP / HBM-traffic counters (documented napkin math).
#
# XLA's cost_analysis() counts while bodies once, which makes it useless for
# scanned layer stacks; these counters implement the standard accounting:
# matmul flops = 2*m*n*k, attention = 2 * S_ctx * h * hd per token per matmul
# (causal halves the average context), train = fwd * 3 (+1 fwd under full
# remat).  HBM traffic: every device reads its model-axis shard of all weights
# once per pass, plus activation checkpoints, optimizer state, and KV cache.
# --------------------------------------------------------------------------

def _dt_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _attn_flops_per_tok(cfg, ctx: float, causal: bool) -> float:
    """Score + AV flops per token with average context ``ctx``."""
    eff = ctx / 2 if causal else ctx
    if cfg.window:
        eff = min(eff, float(cfg.window))
    return 4.0 * eff * cfg.n_heads * cfg.resolved_head_dim


def _attn_proj_flops_per_tok(cfg) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return 2.0 * (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                  + cfg.n_heads * hd * d)


def _ffn_flops_per_tok(cfg) -> float:
    return 2.0 * 3 * cfg.d_model * cfg.d_ff


def _moe_flops_per_tok(cfg) -> float:
    cap = cfg.top_k * cfg.capacity_factor
    f = 2.0 * cfg.d_model * cfg.n_experts          # router
    f += 2.0 * 3 * cfg.d_model * cfg.moe_ffn * cap  # experts (padded buffers)
    if cfg.dense_residual:
        f += _ffn_flops_per_tok(cfg)
    return f


def _ssm_flops_per_tok(cfg) -> float:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p, q = cfg.ssm_head_dim, cfg.ssd_chunk
    conv_dim = di + 2 * g * n
    f = 2.0 * d * (2 * di + 2 * g * n + h)          # in_proj
    f += 2.0 * cfg.conv_width * conv_dim            # causal conv
    f += 2.0 * q * g * n + 2.0 * q * p * h          # intra-chunk scores + y
    f += 4.0 * n * p * h                            # states + y_off
    f += 2.0 * di * d                               # out_proj
    return f


def _layer_flops_per_tok(cfg, ctx: float, causal: bool = True) -> float:
    if cfg.family in ("dense", "vlm"):
        return (_attn_proj_flops_per_tok(cfg) + _attn_flops_per_tok(cfg, ctx, causal)
                + _ffn_flops_per_tok(cfg))
    if cfg.family == "moe":
        return (_attn_proj_flops_per_tok(cfg) + _attn_flops_per_tok(cfg, ctx, causal)
                + _moe_flops_per_tok(cfg))
    if cfg.family == "ssm":
        return _ssm_flops_per_tok(cfg)
    raise ValueError(cfg.family)


def forward_flops(cfg, batch: int, seq: int) -> float:
    """Global forward flops for one pass over (batch, seq) tokens."""
    toks = float(batch * seq)
    if cfg.family == "vlm":
        seq = seq + cfg.vision_tokens
        toks = float(batch * seq)
    unembed = 2.0 * cfg.d_model * cfg.vocab * batch * seq

    if cfg.family in ("dense", "moe", "vlm"):
        per = _layer_flops_per_tok(cfg, float(seq))
        return cfg.n_layers * per * toks + unembed
    if cfg.family == "ssm":
        return cfg.n_layers * _ssm_flops_per_tok(cfg) * toks + unembed
    if cfg.family == "hybrid":
        ng = cfg.n_layers // (cfg.attn_every or cfg.n_layers)
        mamba = cfg.n_layers * _ssm_flops_per_tok(cfg) * toks
        # shared attention block (dense-layer shape) applied ng times
        dense_like = (_attn_proj_flops_per_tok(cfg)
                      + _attn_flops_per_tok(cfg, float(seq), True)
                      + _ffn_flops_per_tok(cfg))
        return mamba + ng * dense_like * toks + unembed
    if cfg.family == "encdec":
        enc_toks = float(batch * cfg.source_len)
        enc = cfg.enc_layers * (_attn_proj_flops_per_tok(cfg)
                                + _attn_flops_per_tok(cfg, float(cfg.source_len), False)
                                + _ffn_flops_per_tok(cfg)) * enc_toks
        cross = (2.0 * (cfg.d_model * cfg.n_heads * cfg.resolved_head_dim * 2)
                 + _attn_flops_per_tok(cfg, float(cfg.source_len), False))
        dec = cfg.n_layers * (_attn_proj_flops_per_tok(cfg)
                              + _attn_flops_per_tok(cfg, float(seq), True)
                              + cross + _ffn_flops_per_tok(cfg)) * toks
        return enc + dec + unembed
    raise ValueError(cfg.family)


def decode_flops(cfg, batch: int, ctx: int) -> float:
    """Global flops for ONE decode step (1 new token/seq, cache length ctx)."""
    b = float(batch)
    unembed = 2.0 * cfg.d_model * cfg.vocab * b
    if cfg.family in ("dense", "moe", "vlm"):
        per = ((_attn_proj_flops_per_tok(cfg) + _attn_flops_per_tok(cfg, ctx, False))
               + (_moe_flops_per_tok(cfg) if cfg.family == "moe"
                  else _ffn_flops_per_tok(cfg)))
        return cfg.n_layers * per * b + unembed
    if cfg.family == "ssm":
        d, di = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        per = (2.0 * d * (2 * di + 2 * g * n + h) + 4.0 * di * n + 2.0 * di * d)
        return cfg.n_layers * per * b + unembed
    if cfg.family == "hybrid":
        d, di = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        per = (2.0 * d * (2 * di + 2 * g * n + h) + 4.0 * di * n + 2.0 * di * d)
        ng = cfg.n_layers // (cfg.attn_every or cfg.n_layers)
        ring = min(ctx, cfg.window) if cfg.window else ctx
        shared = (_attn_proj_flops_per_tok(cfg)
                  + _attn_flops_per_tok(cfg, float(ring), False)
                  + _ffn_flops_per_tok(cfg))
        return (cfg.n_layers * per + ng * shared) * b + unembed
    if cfg.family == "encdec":
        per = (_attn_proj_flops_per_tok(cfg) + _attn_flops_per_tok(cfg, ctx, False)
               + 2.0 * cfg.d_model * cfg.n_heads * cfg.resolved_head_dim
               + _attn_flops_per_tok(cfg, float(cfg.source_len), False)
               + _ffn_flops_per_tok(cfg))
        return cfg.n_layers * per * b + unembed
    raise ValueError(cfg.family)


def _cache_bytes(cfg, batch: int, max_len: int) -> float:
    hd = cfg.resolved_head_dim
    if cfg.family in ("dense", "moe", "vlm"):
        return 2.0 * cfg.n_layers * batch * max_len * cfg.n_kv_heads * hd * 2
    if cfg.family == "ssm":
        di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        conv = cfg.n_layers * batch * (cfg.conv_width - 1) * (di + 2 * g * n) * 2
        ssm = cfg.n_layers * batch * cfg.ssm_heads * n * cfg.ssm_head_dim * 4
        return float(conv + ssm)
    if cfg.family == "hybrid":
        base = _cache_bytes(cfg.replace(family="ssm"), batch, max_len)
        ng = cfg.n_layers // (cfg.attn_every or cfg.n_layers)
        ring = min(max_len, cfg.window) if cfg.window else max_len
        return base + 2.0 * ng * batch * ring * cfg.n_kv_heads * hd * 2
    if cfg.family == "encdec":
        self_c = 2.0 * cfg.n_layers * batch * max_len * cfg.n_kv_heads * hd * 2
        cross = 2.0 * cfg.n_layers * batch * cfg.source_len * cfg.n_kv_heads * hd * 2
        return self_c + cross
    raise ValueError(cfg.family)


def analytic_stats(cfg, shape, n_data: int, n_model: int,
                   accum_steps: int = 1) -> Dict[str, float]:
    """Per-device analytic (flops, hbm_bytes) for one step of this cell."""
    b, s = shape.global_batch, shape.seq_len
    batch_sharded = (b % n_data == 0)
    flop_div = n_model * (n_data if batch_sharded else 1)
    pbytes = cfg.param_count() * _dt_bytes(cfg)
    p_loc = pbytes / (n_data * n_model)
    p_gathered = pbytes / n_model          # per-device weight reads per pass
    b_loc = b // n_data if batch_sharded else b
    act = _dt_bytes(cfg)

    if shape.kind == "train":
        fwd = forward_flops(cfg, b, s)
        mult = 4.0 if cfg.remat == "full" else 3.0
        flops = fwd * mult / flop_div
        # weights: fwd + 2x bwd + recompute reads; optimizer: p,m,v r/w; grads
        opt_b = 4 if cfg.opt_state_dtype == "float32" else 2
        n_loc = cfg.param_count() / (n_data * n_model)   # local param count
        weight_traffic = p_gathered * mult * max(1, accum_steps)
        opt_traffic = (p_loc * 2            # param read + write
                       + n_loc * opt_b * 4  # m, v read + write
                       + n_loc * 4 * 2)     # f32 grads write + read
        ckpt = cfg.n_layers * b_loc * s * cfg.d_model * act * 2
        hbm = weight_traffic + opt_traffic + ckpt
        return {"flops": flops, "hbm_bytes": hbm}

    if shape.kind == "prefill":
        fwd = forward_flops(cfg, b, s)
        flops = fwd / flop_div
        cache = _cache_bytes(cfg, b, s) / (max(1, n_data if batch_sharded else 1)
                                           * n_model)
        acts = cfg.n_layers * b_loc * s * cfg.d_model * act * 2
        hbm = p_gathered + acts + cache
        return {"flops": flops, "hbm_bytes": hbm}

    # decode
    flops = decode_flops(cfg, b, s) / flop_div
    cache = _cache_bytes(cfg, b, s) / (max(1, n_data if batch_sharded else 1)
                                       * n_model)
    hbm = p_gathered + cache   # read all local weights + full cache per step
    return {"flops": flops, "hbm_bytes": hbm}


def model_flops_per_device(cfg, shape, n_devices: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D forward-only.
    D = tokens processed by the step; per-device share."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        total = 2.0 * n * tokens
    return total / n_devices
