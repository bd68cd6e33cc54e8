"""Fused AdamW on the card: the plan, the binding and the launches.

``csrc/adamw.cu`` holds three kernels (see the source's header for what
they compute, their bound and their design): ``adamw_sumsq`` writes one
partial sum of squares per (gradient, chunk), ``adamw_finish`` adds them
in the reference's order into the global norm and the clip scale, and
``adamw_update`` updates parameters and moments in place, one dtype triple
(parameter, gradient, moment) a launch.  Each kernel takes its table of
leaves as kernel parameters, so a table longer than one launch holds is
cut into several launches, and nothing is copied from the host.

``make_plan`` is the host's side as a pure function of the leaves' sizes,
dtypes, decay flags, classes of sharding and the reference's groups: which
launches, which leaves each one takes, where each leaf's partials lie.
``sumsq_and_finish`` and ``update`` launch a plan on PyTorch's current
stream with the tensors' addresses filled in; ``train.optim.adamw_update``
orchestrates them and keeps the plain loop for tensors on the CPU.  Every
launch is counted in ``build.launch_counts()`` under ``NAMES``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build as _build

__all__ = ["NAMES", "CHUNK", "MAX_NORM", "MAX_UPDATE", "MAX_FINISH", "CLASSES",
           "STATS", "Leaf", "Plan", "make_plan", "plan_cached", "launches",
           "sumsq_and_finish", "Hyper", "update"]

NAMES = ("adamw_sumsq", "adamw_finish", "adamw_update")
# The kernel's limits (csrc/adamw.cu; checked against the library at load)
CHUNK = 16384            # elements of a leaf per block
MAX_NORM = 168           # leaves per adamw_sumsq launch
MAX_UPDATE = 80          # leaves per adamw_update launch
MAX_FINISH = 960         # leaves per adamw_finish launch
CLASSES = 8              # classes of sharding one finish tells apart
STATS = 12               # float32 scratch: norm, scale, class totals, carry
GROUP_END = 1 << 31
CLASS_SHIFT = 28
MAX_GRID = 2**31 - 1
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

NORM_ENTRY = np.dtype([("g", "<u8"), ("n", "<i8"), ("block0", "<u4"),
                       ("partial0", "<u4")])
UPDATE_ENTRY = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                         ("n", "<i8"), ("block0", "<u4"), ("decay", "<u4")])

_lib: Any = None


class Leaf(NamedTuple):
    """One leaf as the plan sees it: its element count, the dtype names of
    its parameter, gradient and moments, whether it decays, and its class
    of sharding (0 for a plain tensor)."""
    numel: int
    dtypes: Tuple[str, str, str]
    decays: bool
    cls: int = 0


@dataclass(frozen=True)
class NormLaunch:
    gdt: str
    leaves: np.ndarray       # leaf indices, one an entry
    entries: np.ndarray      # NORM_ENTRY, "g" filled in at launch
    blocks: int


@dataclass(frozen=True)
class FinishLaunch:
    leaves: np.ndarray       # leaf indices in the reference's order
    counts: np.ndarray       # uint32: partials | class << 28 | group end << 31
    first_partial: int
    flags: int               # 1 first, 2 last, 4 write the norm and scale


@dataclass(frozen=True)
class UpdateLaunch:
    dtypes: Tuple[str, str, str]
    leaves: np.ndarray
    entries: np.ndarray      # UPDATE_ENTRY, pointers filled in at launch
    blocks: int


@dataclass(frozen=True)
class Plan:
    norm: Tuple[NormLaunch, ...]
    finish: Tuple[FinishLaunch, ...]
    update: Tuple[UpdateLaunch, ...]
    partials: int


def _chunks(n: int) -> int:
    return -(-n // CHUNK)


def _tables(idx: Sequence[int], leaves: Sequence[Leaf], cap: int):
    """``idx`` cut into runs of at most ``cap`` leaves whose chunks fit one
    grid: (leaves, first block of each, blocks)."""
    runs, cur, block0, blocks = [], [], [], 0
    for i in idx:
        n = _chunks(leaves[i].numel)
        if n > MAX_GRID:
            raise ValueError(f"adamw: a leaf of {leaves[i].numel} elements "
                             f"exceeds one grid")
        if cur and (len(cur) == cap or blocks + n > MAX_GRID):
            runs.append((cur, block0, blocks))
            cur, block0, blocks = [], [], 0
        cur.append(i)
        block0.append(blocks)
        blocks += n
    if cur:
        runs.append((cur, block0, blocks))
    return runs


def make_plan(leaves: Sequence[Leaf], groups: Sequence[Sequence[int]],
              finalize: bool = True) -> Plan:
    """The launches of one update of ``leaves``.  ``groups`` are the leaf
    indices grouped by the reference's leaf, in the reference's order (as
    ``optim.reference_order`` gives them); the norm adds each leaf's
    partials, the leaves of a group, then the groups in that order, each
    class of sharding apart.  With ``finalize`` (one class, no ranks to
    reduce over) the last finish writes the norm and the clip scale."""
    if not leaves:
        raise ValueError("adamw: no leaves")
    order = [i for grp in groups for i in grp]
    if sorted(order) != list(range(len(leaves))):
        raise ValueError("adamw: the groups must hold every leaf once")
    classes = 1 + max(leaf.cls for leaf in leaves)
    if min(leaf.cls for leaf in leaves) < 0 or classes > CLASSES:
        raise ValueError(f"adamw: classes of sharding must lie in [0, {CLASSES})")
    if finalize and classes != 1:
        raise ValueError("adamw: only a tree of one class is finalised on the card")
    for leaf in leaves:
        if leaf.numel < 0 or any(d not in DTYPE_CODES for d in leaf.dtypes):
            raise ValueError(f"adamw: a leaf the kernel does not take: {leaf}")

    # partials laid out in the reference's order; a group ends at its last
    # leaf or where the class changes
    partial0, counts, off = {}, [], 0
    for grp in groups:
        for k, i in enumerate(grp):
            n = _chunks(leaves[i].numel)
            if n >= 1 << CLASS_SHIFT:
                raise ValueError(f"adamw: a leaf of {leaves[i].numel} elements "
                                 f"has more partials than a finish entry counts")
            end = k == len(grp) - 1 or leaves[grp[k + 1]].cls != leaves[i].cls
            partial0[i] = off
            counts.append(n | (leaves[i].cls << CLASS_SHIFT) | (GROUP_END if end else 0))
            off += n
    if off >= 2**32:
        raise ValueError("adamw: more partials than 32 bits index")
    finish = []
    for s in range(0, len(order), MAX_FINISH):
        last = s + MAX_FINISH >= len(order)
        finish.append(FinishLaunch(
            leaves=np.asarray(order[s:s + MAX_FINISH], np.int64),
            counts=np.asarray(counts[s:s + MAX_FINISH], np.uint32),
            first_partial=partial0[order[s]],
            flags=(s == 0) | (2 if last else 0) | (4 if last and finalize else 0)))

    def by(key):
        out: Dict[Any, List[int]] = {}
        for i, leaf in enumerate(leaves):
            if leaf.numel:
                out.setdefault(key(leaf), []).append(i)
        return out

    norm = []
    for gdt, idx in by(lambda leaf: leaf.dtypes[1]).items():
        for run, block0, blocks in _tables(idx, leaves, MAX_NORM):
            e = np.zeros(len(run), NORM_ENTRY)
            e["n"] = [leaves[i].numel for i in run]
            e["block0"] = block0
            e["partial0"] = [partial0[i] for i in run]
            norm.append(NormLaunch(gdt, np.asarray(run, np.int64), e, blocks))
    update = []
    for dts, idx in by(lambda leaf: leaf.dtypes).items():
        for run, block0, blocks in _tables(idx, leaves, MAX_UPDATE):
            e = np.zeros(len(run), UPDATE_ENTRY)
            e["n"] = [leaves[i].numel for i in run]
            e["block0"] = block0
            e["decay"] = [int(leaves[i].decays) for i in run]
            update.append(UpdateLaunch(dts, np.asarray(run, np.int64), e, blocks))
    return Plan(tuple(norm), tuple(finish), tuple(update), off)


def launches(plan: Plan) -> Dict[str, int]:
    """Each kernel's launches in one update of ``plan``."""
    return dict(zip(NAMES, (len(plan.norm), len(plan.finish), len(plan.update))))


_plans: Dict[Any, Plan] = {}


def plan_cached(key: Any, leaves_groups) -> Plan:
    """``make_plan(*leaves_groups())`` once per ``key`` (the leaves' names,
    sizes, dtypes and classes): the step's tree keeps its plan."""
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) >= 16:
            _plans.clear()
        plan = _plans[key] = make_plan(*leaves_groups())
    return plan


def _library() -> Any:
    global _lib
    if _lib is None:
        lib = _build.load("adamw")
        lib.wlk_adamw_sumsq.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.wlk_adamw_finish.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_void_p]
        lib.wlk_adamw_update.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        lib.wlk_adamw_limits.argtypes = [ctypes.c_void_p]
        for fn in (lib.wlk_adamw_sumsq, lib.wlk_adamw_finish, lib.wlk_adamw_update,
                   lib.wlk_adamw_limits):
            fn.restype = ctypes.c_int
        limits = (ctypes.c_int * 6)()
        lib.wlk_adamw_limits(limits)
        want = (CHUNK, MAX_NORM, MAX_UPDATE, MAX_FINISH, CLASSES, STATS)
        if tuple(limits) != want:
            raise RuntimeError(f"adamw: the library's limits {tuple(limits)} "
                               f"are not the wrapper's {want}")
        _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _build.count(name)


def _pointers(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in tensors), np.uint64, len(tensors))


def sumsq_and_finish(plan: Plan, grads: Sequence[torch.Tensor], clip: float
                     ) -> torch.Tensor:
    """The norm pass over ``grads`` (this rank's tensors, the plan's leaf
    order): the ``STATS`` float32 scratch, holding at 0 and 1 the norm and
    the clip scale where the plan finalises, at ``2 + c`` class c's sum of
    squares."""
    lib = _library()
    dev = grads[0].device
    partials = torch.empty(max(plan.partials, 1), dtype=torch.float32, device=dev)
    stats = torch.empty(STATS, dtype=torch.float32, device=dev)
    gptr = _pointers(grads)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for ln in plan.norm:
            e = ln.entries.copy()
            e["g"] = gptr[ln.leaves]
            _check(lib.wlk_adamw_sumsq(e.ctypes.data, len(e), ln.blocks,
                                       partials.data_ptr(), DTYPE_CODES[ln.gdt],
                                       stream), "adamw_sumsq")
        for ln in plan.finish:
            _check(lib.wlk_adamw_finish(ln.counts.ctypes.data, len(ln.counts),
                                        ln.first_partial, partials.data_ptr(),
                                        stats.data_ptr(), ln.flags, float(clip),
                                        stream), "adamw_finish")
    return stats


class Hyper(NamedTuple):
    """The update's float32 constants, as the plain loop rounds them."""
    b1: float
    omb1: float
    b2: float
    omb2: float
    eps: float
    wd: float


def update(plan: Plan, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           m: Sequence[torch.Tensor], v: Sequence[torch.Tensor], lr: torch.Tensor,
           bc1: torch.Tensor, bc2: torch.Tensor, scale: Optional[torch.Tensor],
           hyper: Hyper) -> None:
    """The update pass, in place: every leaf's parameter and moments from
    its gradient, with the 0-d float32 device scalars ``lr``, ``bc1``,
    ``bc2`` and ``scale`` (None: no clipping)."""
    lib = _library()
    dev = params[0].device
    ptrs = {k: _pointers(ts) for k, ts in (("p", params), ("g", grads), ("m", m),
                                            ("v", v))}
    for t in (lr, bc1, bc2) + ((scale,) if scale is not None else ()):
        if t.dtype != torch.float32 or t.device != dev or t.numel() != 1:
            raise ValueError("adamw: lr, bc1, bc2 and scale must be float32 "
                             "scalars on the parameters' device")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for ln in plan.update:
            e = ln.entries.copy()
            for k, p in ptrs.items():
                e[k] = p[ln.leaves]
            codes = [DTYPE_CODES[d] for d in ln.dtypes]
            _check(lib.wlk_adamw_update(
                e.ctypes.data, len(e), ln.blocks, *codes, lr.data_ptr(),
                bc1.data_ptr(), bc2.data_ptr(),
                scale.data_ptr() if scale is not None else None, *hyper, stream),
                "adamw_update")
