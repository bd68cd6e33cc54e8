"""Reshard-plan coverage verifier (WLK225 / WLK226).

The M->N planner in ``core.redistribute`` is pure index arithmetic, which
makes it cheap to *prove* a compiled plan correct instead of trusting it:

* **WLK225** -- exactly-once coverage: the transfers feeding each
  destination rank must tile that rank's declared block exactly -- no
  element left unwritten (a silent hole the executor fills with stale
  bytes) and no element written twice (last-writer-wins nondeterminism
  across source ranks).
* **WLK226** -- bounds: every slab box the plan will index (source blocks,
  destination blocks, and each transfer region) must lie inside the
  dataset's global extent; an out-of-bounds box either crashes the
  executor or silently wraps a negative start.

:func:`verify_plan` checks one :class:`~repro_torch.core.redistribute.CompiledPlan`
(the library call the fault-injection fixtures and tests use);
:func:`verify_edge` compiles the plan for a declared (shape, axis, M, N)
edge and verifies it -- the workflow analyzer runs this for every
``redistribute`` inport whose dsets carry a full ``shape:`` hint, so
``python -m repro_torch.analysis check`` proves plan coverage for every declared
edge before anything runs.

The exactly-once argument needs no coverage bitmap: if every transfer box
is contained in its destination block, no two transfer boxes overlap, and
their volumes sum to the block's volume, the boxes tile the block exactly.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

from .diagnostics import Diagnostic, Findings, Location

__all__ = ["verify_plan", "verify_edge"]

Box = Tuple[Tuple[int, ...], Tuple[int, ...]]  # (starts, shape)


def _volume(shape: Sequence[int]) -> int:
    return math.prod(int(s) for s in shape) if shape else 0


def _overlap(a: Box, b: Box) -> bool:
    return all(max(as_, bs_) < min(as_ + ash, bs_ + bsh)
               for (as_, ash), (bs_, bsh) in zip(zip(*a), zip(*b)))


def _contains(outer: Box, inner: Box) -> bool:
    return all(os_ <= is_ and is_ + ish <= os_ + osh
               for (os_, osh), (is_, ish) in zip(zip(*outer), zip(*inner)))


def _in_bounds(box: Box, extent: Sequence[int]) -> bool:
    starts, shape = box
    if len(starts) != len(extent) or len(shape) != len(extent):
        return False
    return all(0 <= s and 0 <= n and s + n <= e
               for s, n, e in zip(starts, shape, extent))


def verify_plan(plan: Any, *, context: str = "",
                location: Optional[Location] = None) -> Findings:
    """Verify a compiled plan's bounds and exactly-once coverage.

    ``plan`` needs the ``CompiledPlan`` surface: ``shape``, ``src``,
    ``dst`` (global boxes) and ``per_dst[r]`` (the transfers feeding dst
    rank r, each with ``global_starts``/``shape``/``src_rank``).
    ``context`` prefixes every message (e.g. ``"edge sim->viz:data.h5"``);
    ``location`` anchors the findings for the workflow analyzer.
    """
    out = Findings()
    loc = location or Location()
    ctx = f"{context}: " if context else ""
    extent = tuple(int(s) for s in plan.shape)

    def add(code: str, msg: str) -> None:
        out.add(Diagnostic(code, ctx + msg, loc))

    for label, boxes in (("src", plan.src), ("dst", plan.dst)):
        for r, box in enumerate(boxes):
            if not _in_bounds(box, extent):
                add("WLK226",
                    f"{label} rank {r} block {box} out of bounds for "
                    f"global extent {list(extent)}")

    for dr, dbox in enumerate(plan.dst):
        slabs = plan.per_dst[dr]
        regions = [(tuple(t.global_starts), tuple(t.shape)) for t in slabs]
        for t, region in zip(slabs, regions):
            if not _in_bounds(region, extent):
                add("WLK226",
                    f"transfer src {t.src_rank} -> dst {dr} slab box "
                    f"{region} out of bounds for global extent "
                    f"{list(extent)}")
            elif not _contains(dbox, region):
                add("WLK226",
                    f"transfer src {t.src_rank} -> dst {dr} slab box "
                    f"{region} escapes the destination block {dbox}")
        for i in range(len(regions)):
            for j in range(i + 1, len(regions)):
                if _overlap(regions[i], regions[j]):
                    add("WLK225",
                        f"dst rank {dr} element(s) written twice: transfer "
                        f"boxes {regions[i]} and {regions[j]} overlap "
                        f"(last-writer-wins nondeterminism)")
        want = _volume(dbox[1])
        got = sum(_volume(r[1]) for r in regions)
        if got < want:
            add("WLK225",
                f"dst rank {dr} block {dbox} covered by {got} of {want} "
                f"elements -- {want - got} element(s) never written")
        elif got > want:
            add("WLK225",
                f"dst rank {dr} block {dbox} receives {got} elements for "
                f"{want} slots -- duplicated or escaping transfers")
    return out


def verify_edge(shape: Sequence[int], axis: int, src_nranks: int,
                dst_nranks: int, *, context: str = "",
                location: Optional[Location] = None) -> Findings:
    """Compile the plan for one declared edge and verify it.

    ``shape`` is the dataset's ``shape:`` hint; the producer side owns the
    dataset as ``src_nranks`` even blocks along ``axis`` and the consumer
    wants ``dst_nranks`` blocks along the same axis (the runtime's default
    layout for a ``redistribute`` inport).
    """
    from ..core.redistribute import CompiledPlan, even_blocks
    shape = tuple(int(s) for s in shape)
    src = even_blocks(shape, max(1, int(src_nranks)), axis=axis)
    dst = even_blocks(shape, max(1, int(dst_nranks)), axis=axis)
    plan = CompiledPlan(src, dst, shape)
    return verify_plan(plan, context=context, location=location)
