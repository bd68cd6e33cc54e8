"""M->N data redistribution -- the LowFive data-redistribution layer.

A producer running M (logical) ranks owns a dataset as M hyperslab blocks; a
consumer running N ranks wants it as N blocks.  LowFive plans which pieces of
which producer block each consumer rank needs and moves exactly those bytes.
We reproduce that planner (pure index arithmetic, testable to the byte) plus
the executors the transport hot path runs:

* ``CompiledPlan``   -- a plan compiled once into per-dst *coalesced* slab
  descriptors (adjacent transfers merged into contiguous runs) with an
  aligned-boundary detector: when every dst block coincides with exactly one
  src block the exchange degenerates to CoW views (zero bytes copied).
* ``PlanCache``      -- process-wide LRU keyed on (src blocks, dst blocks,
  shape, dtype); steady-state steps re-plan nothing (metadata is per-shape,
  not per-step).  ``Channel`` consults it on every served dataset.
* scatter executor   -- ``CompiledPlan.execute`` writes straight into
  preallocated per-rank destination blocks from per-rank source blocks; no
  global-array materialization, one numpy slice copy per coalesced run.
* torch pack executor -- ``execute_pack_torch`` lowers a cached plan's
  runs to ``kernels.pack`` tile offsets (the CUDA kernels for a CUDA
  tensor, their plain versions for a CPU one) for device-resident reshard.  Rank>2 plans decomposed
  along ONE axis are lowered by *flattening* the non-decomposed axes into a
  virtual row/column dimension (``PackGeometry``) -- the kernels stay 2-D;
  only genuinely cross-axis N-D decompositions fall back to the numpy
  scatter executors.  ``slab_box`` runs the same gathers in *slab-local*
  source coordinates, so a consumer holding only its received slab (not the
  global extent) still reshards on device.
* ``reshard_torch``  -- moving a tensor onto the consumer task's device.

Subset writers (paper §3.2.2): ``gather_to_writers`` collapses an M-block
ownership onto the first k ranks, reproducing the LAMMPS rank-0 gather.
``RedistSpec`` is the per-channel declaration (decomposition axis + rank
counts from the consumer's YAML) the driver wires from the workflow graph.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..analysis.lockcheck import make_lock
from ..convert import as_dtype, dtype_name, host_dtype
from .datamodel import BlockOwnership, Dataset, transport_stats

__all__ = [
    "even_blocks",
    "intersect",
    "Transfer",
    "plan_redistribution",
    "coalesce_transfers",
    "CompiledPlan",
    "PackGeometry",
    "PlanCache",
    "plan_cache",
    "reset_plan_cache",
    "RedistSpec",
    "redistribute_numpy",
    "redistribute_cached",
    "execute_pack_torch",
    "execute_pack_torch_all",
    "gather_to_writers",
    "reshard_torch",
]

Box = Tuple[Tuple[int, ...], Tuple[int, ...]]  # (starts, shape)


def even_blocks(shape: Sequence[int], nranks: int, axis: int = 0) -> List[Box]:
    """Even 1-D decomposition along ``axis`` (LowFive's default layout)."""
    shape = tuple(int(s) for s in shape)
    n = shape[axis]
    base, rem = divmod(n, nranks)
    out: List[Box] = []
    off = 0
    for r in range(nranks):
        cnt = base + (1 if r < rem else 0)
        starts = tuple(off if a == axis else 0 for a in range(len(shape)))
        bshape = tuple(cnt if a == axis else s for a, s in enumerate(shape))
        out.append((starts, bshape))
        off += cnt
    return out


def intersect(a: Box, b: Box) -> Optional[Box]:
    """Intersection of two boxes in global index space, or None."""
    starts, shape = [], []
    for (as_, ash), (bs_, bsh) in zip(zip(*a), zip(*b)):
        lo = max(as_, bs_)
        hi = min(as_ + ash, bs_ + bsh)
        if hi <= lo:
            return None
        starts.append(lo)
        shape.append(hi - lo)
    return tuple(starts), tuple(shape)


@dataclass(frozen=True)
class Transfer:
    """One piece: src_rank's block region -> dst_rank's block region."""

    src_rank: int
    dst_rank: int
    global_starts: Tuple[int, ...]
    shape: Tuple[int, ...]

    @property
    def nbytes_factor(self) -> int:
        return int(np.prod(self.shape))


def plan_redistribution(src: Sequence[Box], dst: Sequence[Box]) -> List[Transfer]:
    """All (src_rank, dst_rank, region) triples with nonempty overlap.

    This is the metadata-only planning step LowFive performs from the HDF5
    dataspace descriptions -- no data is touched.
    """
    out: List[Transfer] = []
    for dr, dbox in enumerate(dst):
        for sr, sbox in enumerate(src):
            ov = intersect(sbox, dbox)
            if ov is not None:
                out.append(Transfer(sr, dr, ov[0], ov[1]))
    return out


def coalesce_transfers(
    transfers: Sequence[Transfer], ignore_src: bool = False
) -> List[Transfer]:
    """Merge transfers that tile contiguously along one axis into single runs.

    By default only transfers with the same (src_rank, dst_rank) merge -- the
    scatter executor reads per-src-rank local blocks, so a run must stay
    inside one source block.  With ``ignore_src=True`` runs merge *across*
    source ranks (merged runs carry ``src_rank=-1``): the global-buffer
    executor reads one stitched array, so a dst block fed by k adjacent
    producer blocks collapses to one slice copy.  Merging is greedy over the
    start-sorted list: two boxes merge when they agree on every axis except
    one, where they abut.
    """
    out: List[Transfer] = []
    for t in sorted(transfers, key=lambda t: (t.dst_rank, t.global_starts, t.src_rank)):
        if out:
            p = out[-1]
            if p.dst_rank == t.dst_rank and (ignore_src or p.src_rank == t.src_rank):
                diff = [
                    a
                    for a in range(len(t.shape))
                    if p.global_starts[a] != t.global_starts[a]
                    or p.shape[a] != t.shape[a]
                ]
                if len(diff) == 1:
                    a = diff[0]
                    if (
                        p.global_starts[a] + p.shape[a] == t.global_starts[a]
                        and all(p.shape[b] == t.shape[b] for b in range(len(t.shape)) if b != a)
                    ):
                        merged = tuple(
                            p.shape[b] + t.shape[b] if b == a else p.shape[b]
                            for b in range(len(t.shape))
                        )
                        rank = p.src_rank if p.src_rank == t.src_rank else -1
                        out[-1] = Transfer(rank, p.dst_rank, p.global_starts, merged)
                        continue
        out.append(t)
    return out


@dataclass(frozen=True)
class PackGeometry:
    """How a single-axis N-D plan flattens onto the 2-D pack kernels.

    The kernels (``pack_blocks`` / ``pack_cols``) copy row/column tiles of a
    2-D buffer.  An N-D plan whose every coalesced run spans the full extent
    of all axes except one (``axis``) is equivalent to a 2-D gather on a
    reshaped view of the same row-major bytes:

    * ``axis == 0``  -> ``mode="rows"``: view ``(shape[0], prod(shape[1:]))``;
      runs along axis 0 map 1:1 to row runs (``scale == 1``).
    * ``axis  > 0``  -> ``mode="cols"``: view
      ``(prod(shape[:axis]), shape[axis] * inner)`` with
      ``inner = prod(shape[axis+1:])``; a run of ``cnt`` indices starting at
      ``start`` along ``axis`` maps to the contiguous column run
      ``(start * scale, cnt * scale)`` with ``scale == inner``.

    This is the flatten transform; unflattening a gathered 2-D block back to
    the N-D destination block is a plain ``reshape`` (the bytes are already
    in row-major destination order).
    """

    axis: int    # decomposed axis in the N-D frame
    mode: str    # "rows" | "cols" -- which kernel tile layout serves it
    rows: int    # flattened view rows
    cols: int    # flattened view cols
    scale: int   # flattened units per index along ``axis`` (1 in rows mode)

    def covers_slab(self, slab_box: Box, shape: Sequence[int]) -> bool:
        """Can the kernel lowering gather from this slab?  True when the
        slab spans the full extent of every NON-decomposed axis (the shape
        a 1-D decomposition slot always has) -- the single source of truth
        for both the reshard dispatch predicate and the executor's
        validation."""
        starts, sshape = slab_box
        return all(
            s == 0 and n == shape[a]
            for a, (s, n) in enumerate(zip(starts, sshape))
            if a != self.axis)


def _geometry_for_axis(shape: Sequence[int], axis: int) -> PackGeometry:
    shape = tuple(int(s) for s in shape)
    if axis == 0:
        return PackGeometry(axis=0, mode="rows", rows=shape[0],
                            cols=int(np.prod(shape[1:], dtype=np.int64)),
                            scale=1)
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64)) if axis + 1 < len(shape) else 1
    return PackGeometry(axis=axis, mode="cols",
                        rows=int(np.prod(shape[:axis], dtype=np.int64)),
                        cols=shape[axis] * inner, scale=inner)


class CompiledPlan:
    """A redistribution plan compiled once for a (src, dst, shape, dtype) key.

    ``per_dst[r]`` holds dst rank r's per-source slab descriptors (what the
    scatter executor copies out of each producer block); ``per_dst_runs[r]``
    holds the same bytes *coalesced across source ranks* into contiguous runs
    (what the global-buffer executor and the pack-kernel lowering walk -- a
    dst block fed by k adjacent producer blocks is one run, one copy).
    ``aligned`` marks the degenerate exchange where every dst block coincides
    with exactly one src block (boundaries line up), so the transport can
    ship CoW views with zero bytes copied instead of executing any transfer.
    """

    __slots__ = ("src", "dst", "shape", "dtype", "per_dst", "per_dst_runs",
                 "transfers", "identity", "aligned", "nbytes_planned",
                 "_pack_cache", "_pack_lock", "_pack_geom")

    def __init__(self, src: Sequence[Box], dst: Sequence[Box],
                 shape: Sequence[int], dtype: Any = np.float64):
        self.src: Tuple[Box, ...] = tuple(src)
        self.dst: Tuple[Box, ...] = tuple(dst)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = as_dtype(dtype)
        raw = plan_redistribution(self.src, self.dst)
        per_dst: List[Tuple[Transfer, ...]] = []
        per_dst_runs: List[Tuple[Transfer, ...]] = []
        for dr in range(len(self.dst)):
            mine = [t for t in raw if t.dst_rank == dr]
            per_dst.append(tuple(coalesce_transfers(mine)))
            per_dst_runs.append(tuple(coalesce_transfers(mine, ignore_src=True)))
        self.per_dst: Tuple[Tuple[Transfer, ...], ...] = tuple(per_dst)
        self.per_dst_runs: Tuple[Tuple[Transfer, ...], ...] = tuple(per_dst_runs)
        self.transfers: Tuple[Transfer, ...] = tuple(
            t for slabs in per_dst for t in slabs)
        self.identity = self.src == self.dst
        self.aligned = self.identity or all(
            len(slabs) <= 1
            and all(
                (t.global_starts, t.shape) == self.dst[dr]
                and (t.global_starts, t.shape) == self.src[t.src_rank]
                for t in slabs
            )
            for dr, slabs in enumerate(self.per_dst)
        )
        self.nbytes_planned = (
            sum(t.nbytes_factor for t in self.transfers) * self.dtype.itemsize
        )
        self._pack_cache: Dict[Tuple[int, int, str, int], Tuple[np.ndarray, Tuple[Tuple[int, int], ...]]] = {}
        self._pack_lock = make_lock("leaf:pack_cache")
        self._pack_geom = self._compute_pack_geometry()

    # ------------------------------------------------------------- executors
    def dst_bytes(self, ranks: Sequence[int]) -> int:
        """Planned bytes landing on the given dst ranks."""
        return sum(
            t.nbytes_factor for r in ranks for t in self.per_dst[r]
        ) * self.dtype.itemsize

    def execute(
        self,
        src_blocks: Sequence[np.ndarray],
        out: Optional[Sequence[np.ndarray]] = None,
        ranks: Optional[Sequence[int]] = None,
    ) -> List[np.ndarray]:
        """Scatter per-src-rank blocks into per-dst-rank blocks.

        ``src_blocks[r]`` is src rank r's local block (shape ``src[r][1]``).
        Writes go straight into ``out`` (preallocated per-rank destination
        blocks; allocated here if not given) -- the global array is never
        materialized, and each coalesced run is one numpy slice copy.
        ``ranks`` restricts the scatter to those dst ranks (the returned list
        is aligned to it) -- a consumer instance computes only its own blocks.
        """
        wanted = list(range(len(self.dst))) if ranks is None else list(ranks)
        if out is None:
            out = [np.empty(self.dst[r][1], dtype=host_dtype(self.dtype))
                   for r in wanted]
        for i, dr in enumerate(wanted):
            dstarts = self.dst[dr][0]
            for t in self.per_dst[dr]:
                sstarts = self.src[t.src_rank][0]
                s_sl = tuple(
                    slice(g - s, g - s + n)
                    for g, s, n in zip(t.global_starts, sstarts, t.shape)
                )
                d_sl = tuple(
                    slice(g - s, g - s + n)
                    for g, s, n in zip(t.global_starts, dstarts, t.shape)
                )
                out[i][d_sl] = src_blocks[t.src_rank][s_sl]
        return list(out)

    def execute_global(
        self,
        global_array: np.ndarray,
        out: Optional[Sequence[np.ndarray]] = None,
        ranks: Optional[Sequence[int]] = None,
    ) -> List[np.ndarray]:
        """Scatter from the stitched global array (the in-process transport
        holds one buffer for all producer ranks) into per-dst-rank blocks.

        Walks ``per_dst_runs``: transfers coalesced across source ranks, so a
        dst block fed by k adjacent producer blocks is one slice copy.
        ``ranks`` restricts to those dst ranks, as in ``execute``."""
        wanted = list(range(len(self.dst))) if ranks is None else list(ranks)
        if out is None:
            out = [np.empty(self.dst[r][1], dtype=global_array.dtype)
                   for r in wanted]
        for i, dr in enumerate(wanted):
            dstarts = self.dst[dr][0]
            for t in self.per_dst_runs[dr]:
                g_sl = tuple(
                    slice(s, s + n) for s, n in zip(t.global_starts, t.shape)
                )
                d_sl = tuple(
                    slice(g - s, g - s + n)
                    for g, s, n in zip(t.global_starts, dstarts, t.shape)
                )
                out[i][d_sl] = global_array[g_sl]
        return list(out)

    # ----------------------------------------------------- pack-kernel lowering
    def _compute_pack_geometry(self) -> Optional[PackGeometry]:
        """The flatten geometry covering this plan, if any.

        A plan is kernel-lowerable when every coalesced run spans the full
        extent of every axis except ONE -- any rank >= 2, any single
        decomposed axis.  Axis 0 lowers to row tiles, any other axis to
        column tiles of the flattened view (see ``PackGeometry``).  ``None``
        for 1-D plans and genuinely cross-axis N-D tilings (e.g. quadrant
        decompositions) -- those take the numpy scatter executors.
        """
        if len(self.shape) < 2:
            return None
        runs = [t for slabs in self.per_dst_runs for t in slabs]
        for axis in range(len(self.shape)):
            if all(
                all(t.global_starts[b] == 0 and t.shape[b] == self.shape[b]
                    for b in range(len(self.shape)) if b != axis)
                for t in runs
            ):
                return _geometry_for_axis(self.shape, axis)
        return None

    @property
    def pack_geometry(self) -> Optional[PackGeometry]:
        return self._pack_geom

    @property
    def pack_mode(self) -> Optional[str]:
        """``"rows"`` / ``"cols"`` tile layout of the lowered plan, or
        ``None`` when only the numpy executors can serve it."""
        return self._pack_geom.mode if self._pack_geom is not None else None

    @property
    def pack_axis(self) -> Optional[int]:
        """The decomposed axis the kernel lowering gathers along."""
        return self._pack_geom.axis if self._pack_geom is not None else None

    def axis_runs(self, dst_rank: int, axis: int) -> List[Tuple[int, int]]:
        """dst_rank's coalesced (start, count) runs along ``axis``.

        Every run must span the full extent of every OTHER axis -- the
        invariant that lets the flatten transform map it onto contiguous
        row/column runs of the 2-D kernel view.
        """
        runs: List[Tuple[int, int]] = []
        for t in self.per_dst_runs[dst_rank]:
            for b in range(len(self.shape)):
                if b == axis:
                    continue
                if t.global_starts[b] != 0 or t.shape[b] != self.shape[b]:
                    raise ValueError(
                        f"pack lowering along axis {axis} needs runs spanning "
                        f"the full extent of axis {b}, got {t}")
            runs.append((t.global_starts[axis], t.shape[axis]))
        return runs

    def row_runs(self, dst_rank: int) -> List[Tuple[int, int]]:
        """2-D compatibility shim: runs along axis 0 (full-width row slabs)."""
        if len(self.shape) != 2:
            raise ValueError(f"row_runs needs a 2-D plan, got shape {self.shape}")
        return self.axis_runs(dst_rank, 0)

    def col_runs(self, dst_rank: int) -> List[Tuple[int, int]]:
        """2-D compatibility shim: runs along axis 1 (full-height col slabs)."""
        if len(self.shape) != 2:
            raise ValueError(f"col_runs needs a 2-D plan, got shape {self.shape}")
        return self.axis_runs(dst_rank, 1)

    def pack_tiles(
        self, dst_rank: int, tile_rows: int = 8, mode: str = "rows",
        slab_start: int = 0, slab_extent: Optional[int] = None,
    ) -> Tuple[np.ndarray, Tuple[Tuple[int, int], ...]]:
        """Lower dst_rank's runs to pack-kernel tile offsets (cached).

        Returns ``(tile_offsets, segments)``: the int32 source tile index per
        output tile (the kernel's offsets operand) and, per run,
        ``(offset_in_packed_output, count)`` to trim the tile padding back to
        the exact rows (``mode="rows"``) or columns (``mode="cols"``).  All
        quantities are in *decomposed-axis units* -- the executor scales by
        ``PackGeometry.scale`` when the plan is a flattened N-D one.

        ``slab_start`` / ``slab_extent`` shift the runs into slab-local
        source coordinates: a consumer holding only its received slab (whose
        origin along the decomposed axis is ``slab_start`` and whose length
        is ``slab_extent``) gathers from a buffer where global index ``g``
        lives at local index ``g - slab_start``; a run falling outside
        ``[slab_start, slab_start + slab_extent)`` on EITHER side raises --
        an out-of-bounds tile would silently corrupt the block.
        """
        geom = self._resolve_geometry(mode)
        key = (dst_rank, tile_rows, mode, slab_start, slab_extent)
        with self._pack_lock:
            hit = self._pack_cache.get(key)
        if hit is not None:
            return hit
        runs = self.axis_runs(dst_rank, geom.axis)
        tiles: List[int] = []
        segs: List[Tuple[int, int]] = []
        for start, cnt in runs:
            start -= slab_start
            if start < 0 or (slab_extent is not None
                             and start + cnt > slab_extent):
                raise ValueError(
                    f"dst rank {dst_rank} needs axis-{geom.axis} run "
                    f"[{start + slab_start}, {start + slab_start + cnt}) but "
                    f"the slab covers [{slab_start}, "
                    f"{slab_start + (slab_extent if slab_extent is not None else 0)}"
                    f"); the slab does not cover this rank")
            t0 = start // tile_rows
            t1 = -(-(start + cnt) // tile_rows)
            segs.append((len(tiles) * tile_rows + (start - t0 * tile_rows), cnt))
            tiles.extend(range(t0, t1))
        result = (np.asarray(tiles, dtype=np.int32), tuple(segs))
        with self._pack_lock:
            self._pack_cache[key] = result
        return result

    def _resolve_geometry(self, mode: str) -> PackGeometry:
        """Geometry for an explicit ``mode`` request.  2-D plans honor a
        forced mode (either axis may be lowerable); N-D plans must match
        their detected geometry -- there is no alternative flattening."""
        if len(self.shape) == 2:
            return _geometry_for_axis(self.shape, 0 if mode == "rows" else 1)
        geom = self._pack_geom
        if geom is None or geom.mode != mode:
            raise ValueError(
                f"plan over shape {self.shape} has no {mode!r} lowering "
                f"(pack_mode={self.pack_mode!r})")
        return geom


def _resolve_pack_geom(plan: CompiledPlan, mode: Optional[str]) -> PackGeometry:
    if mode is None:
        geom = plan.pack_geometry
        if geom is None:
            raise ValueError(
                f"plan is not pack-kernel lowerable (shape {plan.shape}, "
                f"pack_mode={plan.pack_mode!r}); use the numpy scatter executors")
        return geom
    if mode not in ("rows", "cols"):
        raise ValueError(
            f"plan is not pack-kernel lowerable (shape {plan.shape}, "
            f"pack_mode={plan.pack_mode!r}); use the numpy scatter executors")
    return plan._resolve_geometry(mode)


def _flatten(plan: CompiledPlan, src, geom: PackGeometry,
             slab_box: Optional[Box]):
    """Flatten the (slab or global) device buffer onto the 2-D kernel frame
    (a view; one counted copy only for a strided slab).  A ragged tail tile
    is left to the pack wrappers, which read past-the-end elements as zeros.
    Returns ``(src2d, slab_start, slab_extent)`` -- the slab's origin and
    length along the decomposed axis (the global extent when ``slab_box``
    is None).

    ``slab_box`` declares that ``src`` holds only the slab
    ``(starts, shape)`` of the global index space; the slab must span the
    full extent of every non-decomposed axis (the shape a 1-D decomposition
    slot always has), and gathers then run in slab-local coordinates.
    """
    expect = tuple(plan.shape) if slab_box is None else tuple(slab_box[1])
    slab_start = 0
    slab_extent = plan.shape[geom.axis]
    if slab_box is not None:
        if not geom.covers_slab(slab_box, plan.shape):
            raise ValueError(
                f"slab {slab_box} does not span the full extent of every "
                f"non-decomposed axis of shape {plan.shape}; the kernel "
                f"lowering gathers along axis {geom.axis} only")
        slab_start = int(slab_box[0][geom.axis])
        slab_extent = int(slab_box[1][geom.axis])
    if len(src.shape) != len(expect) or any(
        s != e for a, (s, e) in enumerate(zip(src.shape, expect))
        if a != geom.axis
    ) or src.shape[geom.axis] < expect[geom.axis]:
        raise ValueError(
            f"pack source has shape {tuple(src.shape)}, expected "
            f"{expect} (axis {geom.axis} may be pre-padded)")
    if not src.is_contiguous():
        # a slab view along any axis but 0 is strided; the kernels take
        # C-contiguous buffers, so copy once here, counted
        src = src.contiguous()
        transport_stats().record_copy(src.nbytes)
    # flatten: row-major bytes are already in kernel order (see PackGeometry)
    n_axis = int(src.shape[geom.axis])
    if geom.mode == "rows":
        return src.reshape(n_axis, geom.cols), slab_start, slab_extent
    return src.reshape(geom.rows, n_axis * geom.scale), slab_start, slab_extent


def _pack_gather(plan: CompiledPlan, dst_rank: int, src2d,
                 tile_rows: int, geom: PackGeometry, slab_start: int,
                 slab_extent: Optional[int] = None):
    """Gather one dst rank's block from the flattened 2-D buffer and
    unflatten it back to the N-D destination block shape."""
    from ..kernels import ops

    dshape = plan.dst[dst_rank][1]
    tiles, segs = plan.pack_tiles(dst_rank, tile_rows, mode=geom.mode,
                                  slab_start=slab_start,
                                  slab_extent=slab_extent)
    if tiles.size == 0:
        return torch.zeros(dshape, dtype=src2d.dtype, device=src2d.device)
    if geom.mode == "rows":
        packed = ops.pack_blocks(src2d, tiles, tile_rows=tile_rows)
        parts = [packed[a : a + c] for a, c in segs]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    else:
        k = geom.scale
        packed = ops.pack_cols(src2d, tiles, tile_cols=tile_rows * k)
        parts = [packed[:, a * k : (a + c) * k] for a, c in segs]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return out.reshape(dshape)


def execute_pack_torch(plan: CompiledPlan, dst_rank: int, src: torch.Tensor,
                       tile_rows: int = 8, mode: Optional[str] = None,
                       slab_box: Optional[Box] = None) -> torch.Tensor:
    """Device-resident reshard: gather dst_rank's block with the pack
    kernels (``kernels.ops``: CUDA on a CUDA tensor, plain torch on CPU).

    ``src`` is the device buffer holding the global index space -- or, with
    ``slab_box=(starts, shape)``, only that slab of it (a received payload);
    gathers then run in slab-local source coordinates and every requested
    dst block must lie inside the slab.  Rank>2 buffers are flattened onto
    the 2-D kernel frame per the plan's ``PackGeometry`` and the gathered
    block is reshaped back -- the kernels themselves stay 2-D.

    ``mode`` picks the tile layout -- ``"rows"`` (``pack_blocks``, axis-0
    decompositions) or ``"cols"`` (``pack_cols``, any other axis); ``None``
    takes the plan's detected ``pack_mode``.  ``tile_rows`` is the tile
    extent in decomposed-axis units.  Tile offsets come from the cached plan
    lowering (``plan.pack_tiles``); ragged run boundaries are gathered at
    tile granularity and trimmed back here.  Gathering several dst ranks
    from one buffer?  Use ``execute_pack_torch_all`` so the flatten (and
    any contiguous copy of a strided slab) happens once, not per rank.  The
    block stays on ``src``'s device.
    """
    geom = _resolve_pack_geom(plan, mode)
    src2d, slab_start, slab_extent = _flatten(plan, src, geom, slab_box)
    return _pack_gather(plan, dst_rank, src2d, tile_rows, geom, slab_start,
                        slab_extent)


def execute_pack_torch_all(plan: CompiledPlan, src: torch.Tensor,
                           tile_rows: int = 8, mode: Optional[str] = None,
                           slab_box: Optional[Box] = None,
                           ranks: Optional[Sequence[int]] = None
                           ) -> List[torch.Tensor]:
    """Gather dst-rank blocks (all of them, or just ``ranks``) from ONE
    device buffer -- the global extent, or a received slab (``slab_box``).

    Flattens once for the whole exchange instead of once per kernel call,
    then reuses the 2-D buffer for each rank's tile gather.
    Returns the block list aligned to ``ranks`` (default: every dst rank).
    """
    geom = _resolve_pack_geom(plan, mode)
    src2d, slab_start, slab_extent = _flatten(plan, src, geom, slab_box)
    wanted = range(len(plan.dst)) if ranks is None else ranks
    return [_pack_gather(plan, r, src2d, tile_rows, geom, slab_start,
                         slab_extent)
            for r in wanted]


class PlanCache:
    """Thread-safe LRU of compiled plans keyed on (src, dst, shape, dtype).

    The dtype part of the key is ``convert.dtype_name`` -- one spelling for
    a numpy dtype and the torch dtype of the same name.

    Planning is O(M*N) index arithmetic per dataset; the key is pure shape
    metadata, so a steady-state workflow hits the cache on every step after
    the first.  ``snapshot()`` exposes hit/miss/eviction counters for the
    redistribution benchmark.
    """

    def __init__(self, maxsize: int = 256):
        self.maxsize = int(maxsize)
        self._lock = make_lock("leaf:plan_cache")
        self._plans: "OrderedDict[Tuple, CompiledPlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, src: Sequence[Box], dst: Sequence[Box],
            shape: Sequence[int], dtype: Any) -> CompiledPlan:
        key = (tuple(src), tuple(dst), tuple(int(s) for s in shape),
               dtype_name(dtype))
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.hits += 1
                self._plans.move_to_end(key)
                return plan
            self.misses += 1
        # compile outside the lock -- planning may be slow for large M*N
        plan = CompiledPlan(src, dst, shape, dtype)
        with self._lock:
            self._plans[key] = plan
            self._plans.move_to_end(key)
            while len(self._plans) > self.maxsize:
                self._plans.popitem(last=False)
                self.evictions += 1
        return plan

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._plans),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0,
            }

    def reset(self) -> None:
        with self._lock:
            self._plans.clear()
            self.hits = self.misses = self.evictions = 0


_PLAN_CACHE = PlanCache()


def plan_cache() -> PlanCache:
    return _PLAN_CACHE


def reset_plan_cache() -> None:
    _PLAN_CACHE.reset()


@dataclass(frozen=True)
class RedistSpec:
    """A consumer port's declared ownership, carried onto the Channel.

    The consumer task's ensemble instances spatially partition each matched
    dataset along ``axis`` into ``nslots`` slabs (instance ``slot`` owns slab
    ``slot``); within the instance, ``nranks`` logical ranks (``io_procs``
    when subset writers are declared) subdivide the slab.  The frozen
    dataclass doubles as the fan-out payload-cache key.
    """

    axis: int = 0
    nslots: int = 1
    slot: int = 0
    nranks: int = 1

    def dst_boxes(self, shape: Sequence[int]) -> Tuple[List[Box], List[Box]]:
        """(full N-rank dst decomposition, per-instance slot boxes).

        The full decomposition (all instances' ranks, slot-major) keys the
        plan cache so sibling channels of one edge share one compiled plan.
        """
        slot_boxes = even_blocks(shape, self.nslots, axis=self.axis)
        dst: List[Box] = []
        for b_starts, b_shape in slot_boxes:
            for starts, sh in even_blocks(b_shape, self.nranks, axis=self.axis):
                dst.append(
                    (tuple(s + b for s, b in zip(starts, b_starts)), sh))
        return dst, slot_boxes

    def my_ranks(self) -> range:
        return range(self.slot * self.nranks, (self.slot + 1) * self.nranks)


def redistribute_numpy(
    global_array: np.ndarray,
    src: Sequence[Box],
    dst: Sequence[Box],
) -> List[np.ndarray]:
    """Execute a plan: return the N consumer-rank blocks.

    ``global_array`` stands for the union of producer blocks (the runtime
    ships whole File objects; per-rank data would be stitched identically).
    Executed transfer-by-transfer so the byte accounting matches the plan.
    """
    plan = plan_redistribution(src, dst)
    outs: List[np.ndarray] = [
        np.empty(shape, dtype=global_array.dtype) for (_, shape) in dst
    ]
    for t in plan:
        g = tuple(slice(s, s + n) for s, n in zip(t.global_starts, t.shape))
        dstarts = dst[t.dst_rank][0]
        l = tuple(
            slice(gs - ds, gs - ds + n)
            for gs, ds, n in zip(t.global_starts, dstarts, t.shape)
        )
        outs[t.dst_rank][l] = global_array[g]
    return outs


def redistribute_cached(
    global_array: np.ndarray,
    src: Sequence[Box],
    dst: Sequence[Box],
    cache: Optional[PlanCache] = None,
) -> List[np.ndarray]:
    """Drop-in for ``redistribute_numpy`` through the plan cache: the O(M*N)
    intersection is computed once per (src, dst, shape, dtype) key and the
    coalesced scatter executor writes straight into per-rank blocks."""
    cache = cache or plan_cache()
    plan = cache.get(src, dst, global_array.shape, global_array.dtype)
    return plan.execute_global(global_array)


def gather_to_writers(ownership: BlockOwnership, io_procs: int) -> BlockOwnership:
    """Collapse ownership onto the first ``io_procs`` ranks (subset writers).

    With io_procs=1 this reproduces LAMMPS' gather-to-rank-0 idiom: rank 0
    owns the whole global extent and is the only rank participating in the
    data exchange; remaining ranks compute but do no I/O (paper §3.2.2).
    """
    if not ownership.blocks:
        return ownership
    ndim = len(next(iter(ownership.blocks.values()))[0])
    lo = [min(s[a] for s, _ in ownership.blocks.values()) for a in range(ndim)]
    hi = [
        max(s[a] + sh[a] for s, sh in ownership.blocks.values()) for a in range(ndim)
    ]
    global_box = (tuple(lo), tuple(h - l for l, h in zip(lo, hi)))
    blocks = even_blocks(global_box[1], io_procs, axis=0)
    out = BlockOwnership()
    for r, (starts, shape) in enumerate(blocks):
        shifted = tuple(s + l for s, l in zip(starts, lo))
        out.add(r, shifted, shape)
    return out


def reshard_torch(arr: torch.Tensor, device: Any) -> torch.Tensor:
    """Move a tensor onto a consumer task's device (a no-op when it is
    already there)."""
    return arr.to(device)
