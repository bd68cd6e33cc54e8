"""HDF5-style hierarchical data model (the LowFive/HDF5 data-model layer).

The real Wilkins rides on HDF5's data model via the LowFive VOL plugin.  h5py /
libhdf5 are not available in this environment, so we implement the *data model*
itself -- hierarchical groups, typed n-dimensional datasets, attributes, and
hyperslab (partial) selection -- with numpy arrays and torch tensors as
storage.  The VOL boundary (``repro_torch.core.vol``) intercepts operations
on this tree exactly like LowFive intercepts HDF5 calls, which is the
interface the paper actually defines.

Objects
-------
``Dataset``  -- typed ndarray leaf + attributes + (optional) per-rank block
                ownership map used by the M->N redistribution layer.  Supports
                copy-on-write views (``Dataset.view()``): the underlying
                ndarray is shared read-only across any number of views and the
                copy is deferred to the first write, so fan-out transport ships
                metadata, not data.
``Group``    -- named children (groups or datasets) + attributes.
``File``     -- root group + filename; knows how to spill to / load from disk
                (raw binary container: json header + 64-byte-aligned raw array
                segments, loaded zero-copy via ``np.memmap``).

Paths follow HDF5 conventions: ``/group1/particles`` etc.  Glob matching for
ports ("*.h5", "/particles/*") lives here too since it is a data-model level
concern; patterns are compiled once to regexes and LRU-cached (see
``compile_path_pattern`` / ``compile_file_pattern``).

Ownership rules (see DESIGN.md):

* ``Dataset`` mutation goes through ``__setitem__`` / ``write_slab``; both
  materialize a private copy first if the buffer is shared or read-only
  (memmap).  Copies are counted in ``transport_stats()``.
* ``read_direct`` / ``__getitem__`` return a read-only alias while the buffer
  is shared, so a reader cannot silently corrupt a sibling view.
* A tensor adopted with ``copy=False`` is never written through the data
  model (a write lands in a private host copy), but torch, unlike JAX, lets
  its producer mutate it in place.  The dataset records the tensor's
  version counter at adoption; ``read_direct``, ``view`` and ``slab_view``
  (so every serve) raise once it has moved.
"""

from __future__ import annotations

import fnmatch
import io
import json
import os
import re
import threading
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..analysis import lockcheck as _lc
from ..analysis.lockcheck import make_lock, sched_point
from ..convert import (as_dtype, dtype_name, host_copy, host_dtype,
                       numpy_from_tensor, torch_dtype)

__all__ = [
    "Dataset",
    "Group",
    "File",
    "BlockOwnership",
    "TransportStats",
    "is_device_array",
    "transport_stats",
    "reset_transport_stats",
    "match_path",
    "match_file",
    "compile_path_pattern",
    "compile_file_pattern",
    "split_path",
]

_SPILL_MAGIC = b"WLKNRAW1"
_SPILL_ALIGN = 64


def is_device_array(a: Any) -> bool:
    """True for a ``torch.Tensor`` on any device (device-resident Dataset
    buffers), as a CPU ``jax.Array`` counts in the JAX package.

    The CoW layer treats tensors as permanently shared -- reads alias them
    directly and any write first materializes a private numpy copy; the
    adoption-time version check (``Dataset._check_version``) catches a
    producer mutating one in place.
    """
    return isinstance(a, torch.Tensor)


def _writable_in_place(a: Any) -> bool:
    """Can this buffer be mutated where it sits?  Never true for tensors
    (written only through host copies) -- only for writable host
    ndarrays."""
    return isinstance(a, np.ndarray) and a.flags.writeable


# ---------------------------------------------------------------------------
# transport instrumentation
# ---------------------------------------------------------------------------
class TransportStats:
    """Process-wide counters for data-movement work in the transport path.

    ``bytes_copied`` counts actual buffer materializations (eager copies in
    the legacy path, deferred CoW copies in the fast path); ``views`` counts
    zero-copy dataset views handed out.  Benchmarks reset + read these to
    measure the Fig. 4 overhead lever.
    """

    def __init__(self) -> None:
        self._lock = make_lock("leaf:transport_stats")
        self.copies = 0
        self.bytes_copied = 0
        self.cow_copies = 0
        self.views = 0
        # M->N redistribution accounting (planned vs shipped vs whole-file):
        # per served dataset on a redistributing port, ``planned`` is what the
        # compiled plan says must land on this consumer, ``shipped`` the
        # payload bytes the channel actually enqueued (the slab -- or the
        # whole dataset on the aligned view path, which copies nothing but
        # whose bytes a real wire would still carry), ``baseline`` the
        # whole-dataset bytes the pre-plan transport moved.
        self.redist_planned_bytes = 0
        self.redist_shipped_bytes = 0
        self.redist_baseline_bytes = 0
        self.redist_aligned = 0
        self.redist_slabs = 0
        # Async slab prefetch (channels with a RedistSpec serve payload
        # futures): a *hit* is a payload whose preparation finished before
        # the consumer asked for it -- the slab serve was fully hidden behind
        # consumer compute; a *miss* blocked the consumer for
        # ``prefetch_blocked_s`` of the total ``prefetch_prepared_s``.
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.prefetch_prepared_s = 0.0
        self.prefetch_blocked_s = 0.0
        # preps cancelled before delivery: pool shutdown mid-run, or a
        # `latest` edge dropping a stale in-flight prep when a newer step
        # superseded it (the autotuner reads this as "depth too deep")
        self.prefetch_cancelled = 0
        # TaskComm.reshard executor dispatch: how many calls ran on the
        # pack kernels vs the numpy scatter executors (the benchmark and
        # tests assert "no numpy fallback" through these)
        self.reshard_pack = 0
        self.reshard_numpy = 0

    def record_copy(self, nbytes: int, cow: bool = False) -> None:
        with self._lock:
            self.copies += 1
            self.bytes_copied += int(nbytes)
            if cow:
                self.cow_copies += 1

    def record_view(self) -> None:
        with self._lock:
            self.views += 1

    def record_prefetch_prepare(self, elapsed_s: float) -> None:
        with self._lock:
            self.prefetch_prepared_s += float(elapsed_s)

    def record_reshard(self, pack: bool) -> None:
        with self._lock:
            if pack:
                self.reshard_pack += 1
            else:
                self.reshard_numpy += 1

    def record_prefetch_cancelled(self) -> None:
        with self._lock:
            self.prefetch_cancelled += 1

    def record_prefetch(self, hit: bool, blocked_s: float = 0.0) -> None:
        with self._lock:
            if hit:
                self.prefetch_hits += 1
            else:
                self.prefetch_misses += 1
                self.prefetch_blocked_s += float(blocked_s)

    def record_redistribution(self, planned: int, shipped: int, baseline: int,
                              aligned: bool) -> None:
        with self._lock:
            self.redist_planned_bytes += int(planned)
            self.redist_shipped_bytes += int(shipped)
            self.redist_baseline_bytes += int(baseline)
            if aligned:
                self.redist_aligned += 1
            else:
                self.redist_slabs += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "copies": self.copies,
                "bytes_copied": self.bytes_copied,
                "cow_copies": self.cow_copies,
                "views": self.views,
                "redist_planned_bytes": self.redist_planned_bytes,
                "redist_shipped_bytes": self.redist_shipped_bytes,
                "redist_baseline_bytes": self.redist_baseline_bytes,
                "redist_aligned": self.redist_aligned,
                "redist_slabs": self.redist_slabs,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_misses": self.prefetch_misses,
                "prefetch_prepared_s": self.prefetch_prepared_s,
                "prefetch_blocked_s": self.prefetch_blocked_s,
                "prefetch_cancelled": self.prefetch_cancelled,
                "reshard_pack": self.reshard_pack,
                "reshard_numpy": self.reshard_numpy,
            }

    def reset(self) -> None:
        with self._lock:
            self.copies = self.bytes_copied = self.cow_copies = self.views = 0
            self.redist_planned_bytes = self.redist_shipped_bytes = 0
            self.redist_baseline_bytes = 0
            self.redist_aligned = self.redist_slabs = 0
            self.prefetch_hits = self.prefetch_misses = 0
            self.prefetch_cancelled = 0
            self.prefetch_prepared_s = self.prefetch_blocked_s = 0.0
            self.reshard_pack = self.reshard_numpy = 0


_TRANSPORT_STATS = TransportStats()


def transport_stats() -> TransportStats:
    return _TRANSPORT_STATS


def reset_transport_stats() -> None:
    _TRANSPORT_STATS.reset()


# ---------------------------------------------------------------------------
# glob matching (LRU-cached compiled regexes)
# ---------------------------------------------------------------------------
def split_path(path: str) -> List[str]:
    """Split an HDF5 path into components, ignoring leading/duplicate slashes."""
    return [p for p in path.split("/") if p]


@lru_cache(maxsize=4096)
def _compile_fnmatch(pattern: str) -> "re.Pattern[str]":
    return re.compile(fnmatch.translate(pattern))


class PathMatcher:
    """A compiled HDF5-path glob (LowFive prefix semantics, see match_path)."""

    __slots__ = ("pattern", "_regexes")

    def __init__(self, pattern: str):
        self.pattern = pattern
        pat = "/" + "/".join(split_path(pattern))
        regexes = [_compile_fnmatch(pat)]
        if pat.endswith("/*"):
            # prefix semantics for trailing '*': /a/* also matches deeper paths
            regexes.append(_compile_fnmatch(pat + "/*"))
        # a pattern naming a group matches everything below it
        regexes.append(_compile_fnmatch(pat.rstrip("/") + "/*"))
        self._regexes = tuple(regexes)

    def matches(self, path: str) -> bool:
        p = "/" + "/".join(split_path(path))
        return any(r.match(p) is not None for r in self._regexes)


class FileMatcher:
    """A compiled filename glob (basename semantics)."""

    __slots__ = ("pattern", "_regex")

    def __init__(self, pattern: str):
        self.pattern = pattern
        self._regex = _compile_fnmatch(os.path.basename(pattern))

    def matches(self, filename: str) -> bool:
        return self._regex.match(os.path.basename(filename)) is not None


@lru_cache(maxsize=4096)
def compile_path_pattern(pattern: str) -> PathMatcher:
    return PathMatcher(pattern)


@lru_cache(maxsize=4096)
def compile_file_pattern(pattern: str) -> FileMatcher:
    return FileMatcher(pattern)


def match_path(pattern: str, path: str) -> bool:
    """HDF5-path glob matching. ``/group1/*`` matches ``/group1/grid``.

    A bare ``*`` component matches one level; a trailing ``*`` after a group
    prefix matches any suffix (LowFive-style prefix semantics), so
    ``/particles/*`` matches ``/particles/pos/value`` as well.
    """
    return compile_path_pattern(pattern).matches(path)


def match_file(pattern: str, filename: str) -> bool:
    """Filename glob matching: ``plt*.h5`` matches ``plt00010.h5``."""
    return compile_file_pattern(pattern).matches(filename)


@dataclass
class BlockOwnership:
    """Which logical producer rank owns which hyperslab of a dataset.

    ``blocks[rank] = (starts, shape)`` -- the rank's block in global index
    space.  This is the metadata LowFive exchanges to plan M->N
    redistribution; we carry it on the Dataset so the redistribution layer can
    compute overlaps without touching the data.
    """

    blocks: Dict[int, Tuple[Tuple[int, ...], Tuple[int, ...]]] = field(
        default_factory=dict
    )

    def add(self, rank: int, starts: Sequence[int], shape: Sequence[int]) -> None:
        self.blocks[rank] = (tuple(starts), tuple(shape))

    def nranks(self) -> int:
        return len(self.blocks)


def _buffer_key(arr: Any) -> int:
    """Stable identity of the underlying memory for the race detector:
    views of the same allocation map to the same key (walk the ``.base``
    chain, take the data pointer), so a slab view and its source dataset
    are recognized as touching one buffer.  A tensor is keyed by its
    storage's address, on the host and on the card alike, which every view
    of it shares (a tensor has no ``__array_interface__``, and its
    ``id()`` would give each view a key of its own)."""
    if isinstance(arr, torch.Tensor):
        return arr.untyped_storage().data_ptr()
    base = arr
    while isinstance(base, np.ndarray) and base.base is not None:
        base = base.base
    try:
        return base.__array_interface__["data"][0]
    except (AttributeError, TypeError, KeyError):
        return id(base)


def _race_point(tag: str, arr: Any, mode: str) -> None:
    """Shadow-state access for the explorer's happens-before checker.

    Gated on the raw controller global so the disabled path never walks
    the buffer's base chain -- one module-attribute load and a None test."""
    if _lc._EXPLORE_CONTROLLER is not None:
        sched_point(tag, key=("buf", _buffer_key(arr)), access=mode)


def _tensor_read(tag: str, arr: Any) -> None:
    """A tracked read of a tensor buffer: no yield point, as the JAX package
    has none at the read of an immutable ``jax.Array``, but the race
    detector sees it (a tensor is mutable)."""
    if _lc._EXPLORE_CONTROLLER is not None:
        _lc.access_point(tag, ("buf", _buffer_key(arr)), "r")


class _Share:
    """Refcount for an ndarray buffer shared across CoW dataset views.

    Every ``count`` mutation happens under ``lock``, and the (share, buffer)
    pair on a Dataset is only ever read or swapped while holding the lock of
    the share being replaced -- see ``Dataset._acquire_share`` /
    ``Dataset._ensure_writable``.  Without that pairing a ``view()`` racing a
    CoW materialization can increment a share the writer is detaching and
    then alias the writer's fresh private buffer (torn capture)."""

    __slots__ = ("count", "lock")

    def __init__(self, count: int = 1):
        self.count = count
        self.lock = make_lock("leaf:share")


class Dataset:
    """A typed n-d array leaf with attributes and hyperslab read/write.

    Buffers are copy-on-write: ``view()`` shares the ndarray (refcounted via
    ``_Share``); the first write through any sharer materializes a private
    copy.  Datasets loaded from the spill container are ``np.memmap`` backed
    and obey the same rule (read-only until first write copies).
    """

    def __init__(
        self,
        name: str,
        shape: Tuple[int, ...],
        dtype: Any,
        data: Optional[np.ndarray] = None,
        parent: Optional["Group"] = None,
        copy: bool = True,
    ):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = as_dtype(dtype)
        self.attrs: Dict[str, Any] = {}
        self.parent = parent
        self.ownership: Optional[BlockOwnership] = None
        self._share = _Share(1)
        # version counter of an adopted tensor (None for host buffers)
        self._version: Optional[int] = None
        if data is not None:
            # keep subclasses (np.memmap) and device arrays intact on the
            # zero-copy path; everything else coerces to ndarray
            if isinstance(data, np.ndarray) or is_device_array(data):
                arr = data
            else:
                arr = np.asarray(data)
            assert tuple(arr.shape) == self.shape, (arr.shape, self.shape)
            if copy:
                # Snapshot the caller's array into the file (h5py semantics).
                # Adopting a caller-owned buffer would hand the CoW layer an
                # alias the caller can mutate behind its back -- one copy at
                # creation buys a sound invariant: every Dataset buffer is
                # reachable only through Datasets.
                if is_device_array(arr):
                    out = host_copy(arr.to(dtype=torch_dtype(self.dtype)))
                else:
                    if arr.dtype.name == "bfloat16":  # keep the bits
                        arr = arr.view(np.int16)
                    out = np.array(arr, dtype=host_dtype(self.dtype), order="C")
                _TRANSPORT_STATS.record_copy(out.nbytes)
                self._data = out
            else:
                # Internal zero-copy path (spill load, legacy filter): the
                # caller guarantees nothing else writes this buffer.  A
                # read-only buffer (e.g. an np.memmap opened mode="r") stays
                # shared until the first write triggers the CoW copy.
                assert dtype_name(arr.dtype) in (dtype_name(self.dtype),
                                                 host_dtype(self.dtype).name), \
                    (arr.dtype, self.dtype)
                if is_device_array(arr):
                    if arr.is_inference():
                        raise ValueError(
                            f"dataset {name!r}: an inference-mode tensor has "
                            f"no version counter to guard against in-place "
                            f"writes; create it under torch.no_grad()")
                    self._version = arr._version
                self._data = arr
        else:
            self._data = np.zeros(self.shape, dtype=host_dtype(self.dtype))

    # -- copy-on-write ------------------------------------------------------
    def _acquire_share(self) -> Tuple[_Share, np.ndarray]:
        """Atomically (share.count += 1, snapshot (share, data)).

        A concurrent ``_ensure_writable`` may swap ``self._share`` /
        ``self._data`` between our read of the share and taking its lock; the
        identity re-check restarts so the increment always lands on the share
        that actually guards the buffer we alias."""
        while True:
            share = self._share
            # the torn-capture window (PR 3): a writer may swap the share
            # between this read and the lock below -- the identity re-check
            # restarts; the yield point lets the explorer preempt HERE
            sched_point("Dataset._acquire_share", key=("share", id(share)))
            with share.lock:
                if share is self._share:
                    share.count += 1
                    return share, self._data

    def _check_version(self, buf: Any) -> None:
        """Raise if an adopted tensor was written in place since adoption
        (views share the counter, so a slab sees writes to its base)."""
        if self._version is not None and is_device_array(buf) \
                and buf._version != self._version:
            raise RuntimeError(
                f"dataset {self.name!r}: its tensor was modified in place "
                f"after the dataset adopted it (copy=False); write a new "
                f"tensor per timestep instead of reusing the served one")

    def view(self, parent: Optional["Group"] = None) -> "Dataset":
        """Zero-copy view sharing this dataset's buffer (copy deferred to
        first write, on either side).  Attributes are shallow-copied so a
        view can annotate without touching the source."""
        ds = Dataset.__new__(Dataset)
        ds.name = self.name
        ds.shape = self.shape
        ds.dtype = self.dtype
        ds.attrs = dict(self.attrs)
        ds.parent = parent
        ds.ownership = self.ownership
        ds._share, ds._data = self._acquire_share()
        ds._version = self._version
        self._check_version(ds._data)
        _TRANSPORT_STATS.record_view()
        return ds

    def slab_view(self, starts: Sequence[int], shape: Sequence[int],
                  parent: Optional["Group"] = None) -> "Dataset":
        """Zero-copy hyperslab view: a Dataset over ``self._data[starts:+shape]``.

        Shares this dataset's ``_Share`` (like ``view``), so the CoW rules
        hold: the slab is read-only while shared and a first write through
        either side copies only that side's bytes (the slab copies its slab,
        not the whole buffer).  This is what a redistributing channel ships --
        the consumer's owned box, zero bytes moved at serve time.
        """
        slc = tuple(slice(s, s + n) for s, n in zip(starts, shape))
        ds = Dataset.__new__(Dataset)
        ds.name = self.name
        ds.shape = tuple(int(n) for n in shape)
        ds.dtype = self.dtype
        ds.attrs = dict(self.attrs)
        ds.parent = parent
        ds.ownership = None
        ds._share, base = self._acquire_share()
        ds._version = self._version
        self._check_version(base)
        ds._data = base[slc]
        _TRANSPORT_STATS.record_view()
        return ds

    @property
    def share_count(self) -> int:
        share = self._share
        with share.lock:
            return share.count

    def _is_exclusive(self) -> bool:
        share = self._share
        with share.lock:
            return share is self._share and share.count == 1 \
                and _writable_in_place(self._data)

    def _ensure_writable(self) -> None:
        """Materialize a private copy if the buffer is shared or read-only
        (memmap, tensor -- a write always lands in a private host copy, so
        the producer's tensor is never written through the data model)."""
        while True:
            share = self._share
            sched_point("Dataset._ensure_writable", key=("share", id(share)))
            with share.lock:
                if share is not self._share:
                    continue  # a concurrent writer swapped us; re-read
                if share.count == 1 and _writable_in_place(self._data):
                    return
                # Copy AND swap while holding the share lock: a sibling
                # sharer must not pass its own count==1 fast path and write
                # the buffer in place before this snapshot is complete
                # (torn-copy race), and a concurrent ``view()`` must never
                # observe the new private buffer paired with the old share
                # (torn-capture race -- see _acquire_share).
                if is_device_array(self._data):
                    self._check_version(self._data)
                    new = host_copy(self._data)
                else:
                    new = np.array(self._data)
                share.count -= 1
                self._data = new
                self._version = None
                self._share = _Share(1)
                break
        _TRANSPORT_STATS.record_copy(new.nbytes, cow=True)

    # -- HDF5-ish surface ---------------------------------------------------
    @property
    def path(self) -> str:
        if self.parent is None:
            return "/" + self.name
        return self.parent.path.rstrip("/") + "/" + self.name

    def __getitem__(self, key) -> np.ndarray:
        return self.read_direct()[key]

    def __setitem__(self, key, value) -> None:
        self._ensure_writable()
        _race_point("Dataset.__setitem__", self._data, "w")
        self._data[key] = value

    def read_direct(self) -> np.ndarray:
        """The backing array; a read-only alias while the buffer is shared.

        Tensors are returned as-is -- callers see a ``torch.Tensor`` and may
        hand it straight to the pack-kernel executors without a host
        round-trip -- after the check that nothing wrote it in place since
        adoption.  Unlike a ``jax.Array`` a tensor is mutable, so its read
        is a tracked access for the race detector too.
        """
        if is_device_array(self._data):
            _tensor_read("Dataset.read_direct", self._data)
            self._check_version(self._data)
            return self._data
        _race_point("Dataset.read_direct", self._data, "r")
        if self._is_exclusive():
            return self._data
        alias = self._data.view()
        alias.flags.writeable = False
        return alias

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize if self.shape else self.dtype.itemsize

    def select(self, starts: Sequence[int], shape: Sequence[int]) -> np.ndarray:
        """Hyperslab read (contiguous block selection)."""
        slc = tuple(slice(s, s + n) for s, n in zip(starts, shape))
        return self.read_direct()[slc]

    def write_slab(self, starts: Sequence[int], block: np.ndarray) -> None:
        self._ensure_writable()
        _race_point("Dataset.write_slab", self._data, "w")
        slc = tuple(slice(s, s + n) for s, n in zip(starts, block.shape))
        self._data[slc] = block

    def __repr__(self) -> str:
        return f"<Dataset {self.path} shape={self.shape} dtype={self.dtype}>"


class Group:
    """Named collection of sub-groups and datasets."""

    def __init__(self, name: str, parent: Optional["Group"] = None):
        self.name = name
        self.parent = parent
        self.children: Dict[str, Union["Group", Dataset]] = {}
        self.attrs: Dict[str, Any] = {}

    @property
    def path(self) -> str:
        if self.parent is None:
            return "/"
        base = self.parent.path
        return (base if base.endswith("/") else base + "/") + self.name

    def require_group(self, path: str) -> "Group":
        node: Group = self
        for comp in split_path(path):
            child = node.children.get(comp)
            if child is None:
                child = Group(comp, parent=node)
                node.children[comp] = child
            elif not isinstance(child, Group):
                raise TypeError(f"{child.path} is a dataset, not a group")
            node = child
        return node

    def create_dataset(
        self,
        path: str,
        shape: Optional[Tuple[int, ...]] = None,
        dtype: Any = None,
        data: Optional[np.ndarray] = None,
        copy: bool = True,
    ) -> Dataset:
        comps = split_path(path)
        if not comps:
            raise ValueError("empty dataset path")
        parent = self.require_group("/".join(comps[:-1])) if len(comps) > 1 else self
        if data is not None:
            if not isinstance(data, np.ndarray) and not is_device_array(data):
                data = np.asarray(data)
            shape = tuple(data.shape) if shape is None else tuple(shape)
            dtype = data.dtype if dtype is None else dtype
        if shape is None or dtype is None:
            raise ValueError("need shape+dtype or data")
        ds = Dataset(comps[-1], tuple(shape), dtype, data=data, parent=parent, copy=copy)
        parent.children[comps[-1]] = ds
        return ds

    def attach_view(self, ds: Dataset) -> Dataset:
        """Graft a zero-copy view of ``ds`` at the same path under this root."""
        comps = split_path(ds.path)
        parent = self.require_group("/".join(comps[:-1])) if len(comps) > 1 else self
        v = ds.view(parent=parent)
        parent.children[comps[-1]] = v
        return v

    def attach_slab(self, ds: Dataset, starts: Sequence[int],
                    shape: Sequence[int]) -> Dataset:
        """Graft a zero-copy hyperslab view of ``ds`` at the same path."""
        comps = split_path(ds.path)
        parent = self.require_group("/".join(comps[:-1])) if len(comps) > 1 else self
        v = ds.slab_view(starts, shape, parent=parent)
        parent.children[comps[-1]] = v
        return v

    def get(self, path: str) -> Optional[Union["Group", Dataset]]:
        node: Union[Group, Dataset] = self
        for comp in split_path(path):
            if not isinstance(node, Group):
                return None
            nxt = node.children.get(comp)
            if nxt is None:
                return None
            node = nxt
        return node

    def __getitem__(self, path: str) -> Union["Group", Dataset]:
        node = self.get(path)
        if node is None:
            raise KeyError(f"no object at {path!r} under {self.path!r}")
        return node

    def __contains__(self, path: str) -> bool:
        return self.get(path) is not None

    def visit_datasets(self) -> Iterator[Dataset]:
        for child in self.children.values():
            if isinstance(child, Dataset):
                yield child
            else:
                yield from child.visit_datasets()

    def __repr__(self) -> str:
        return f"<Group {self.path} ({len(self.children)} children)>"


def _align_up(n: int, align: int = _SPILL_ALIGN) -> int:
    return (n + align - 1) // align * align


class File(Group):
    """Root of the tree; also the unit of transport in Wilkins.

    LowFive serves data producer->consumer at file-close granularity; the
    channel layer ships ``File`` objects (or their metadata + selected
    datasets).  ``save``/``load`` implement the *file* transport option
    (``file: 1`` in YAML) -- data spilled through the filesystem in a raw
    binary container: an 8-byte magic, a json header, then each dataset's
    bytes at a 64-byte-aligned offset.  ``load`` maps the segments with
    ``np.memmap`` so reading a spill does zero redundant copies; the CoW rule
    on ``Dataset`` materializes a private buffer only on first write.
    """

    def __init__(self, filename: str):
        super().__init__("")
        self.filename = filename
        self.closed = False

    @property
    def path(self) -> str:
        return "/"

    # -- zero-copy structural view ------------------------------------------
    def view(self) -> "File":
        """Structural clone whose datasets are CoW views of this file's.

        This is what fan-out ships: N consumers get N cheap trees over ONE
        payload; the refcount on each dataset's ``_Share`` tracks the sharing.
        """
        out = File(self.filename)
        out.attrs.update(self.attrs)

        def walk(src: Group, dst: Group) -> None:
            for nm, child in src.children.items():
                if isinstance(child, Dataset):
                    dst.children[nm] = child.view(parent=dst)
                else:
                    g = dst.require_group(nm)
                    g.attrs.update(child.attrs)
                    walk(child, g)

        walk(self, out)
        return out

    # -- disk container (the ``file: 1`` transport path) ---------------------
    def save(self, directory: str, basename: Optional[str] = None) -> str:
        os.makedirs(directory, exist_ok=True)
        target = os.path.join(directory, basename or os.path.basename(self.filename))
        entries: List[Tuple[str, Dataset]] = []

        def walk(g: Group, prefix: str) -> None:
            for nm, child in g.children.items():
                p = prefix + "/" + nm
                if isinstance(child, Dataset):
                    entries.append((p, child))
                else:
                    walk(child, p)

        walk(self, "")
        meta: Dict[str, Any] = {
            "filename": self.filename,
            "attrs": _jsonable(self.attrs),
            "datasets": {},
        }
        rel = 0
        for p, ds in entries:
            rel = _align_up(rel)
            meta["datasets"][p] = {
                "dtype": _spill_dtype_str(ds.dtype),
                "shape": list(ds.shape),
                "offset": rel,
                "nbytes": ds.nbytes,
                "attrs": _jsonable(ds.attrs),
                "ownership": (
                    {str(r): [list(s), list(sh)] for r, (s, sh) in ds.ownership.blocks.items()}
                    if ds.ownership
                    else None
                ),
            }
            rel += ds.nbytes
        header = json.dumps(meta).encode()
        data_start = _align_up(len(_SPILL_MAGIC) + 8 + len(header))

        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_SPILL_MAGIC)
            f.write(len(header).to_bytes(8, "little"))
            f.write(header)
            f.write(b"\0" * (data_start - f.tell()))
            for p, ds in entries:
                if ds.nbytes == 0:
                    continue  # memoryview can't cast zero-size shapes
                off = data_start + meta["datasets"][p]["offset"]
                f.write(b"\0" * (off - f.tell()))
                arr = ds.read_direct()
                if is_device_array(arr):
                    arr = numpy_from_tensor(arr)  # spill needs host bytes
                if not arr.flags.c_contiguous:
                    arr = np.ascontiguousarray(arr)
                f.write(memoryview(arr).cast("B"))
        os.replace(tmp, target)  # atomic
        return target

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "File":
        with open(path, "rb") as f:
            magic = f.read(len(_SPILL_MAGIC))
            if magic != _SPILL_MAGIC:
                f.seek(0)
                return cls._load_legacy(f)
            hlen = int.from_bytes(f.read(8), "little")
            meta = json.loads(f.read(hlen).decode())
            data_start = _align_up(len(_SPILL_MAGIC) + 8 + hlen)
            out = cls(meta["filename"])
            out.attrs.update(meta.get("attrs") or {})
            for dpath, info in meta["datasets"].items():
                dt = np.dtype(info["dtype"])
                shape = tuple(info["shape"])
                nbytes = int(info["nbytes"])
                off = data_start + int(info["offset"])
                if nbytes == 0:
                    arr = np.zeros(shape, dtype=dt)
                elif mmap:
                    mm = np.memmap(path, dtype=dt, mode="r", offset=off,
                                   shape=shape if shape else (1,))
                    arr = mm if shape else mm.reshape(())
                else:
                    f.seek(off)
                    buf = f.read(nbytes)
                    _TRANSPORT_STATS.record_copy(nbytes)
                    arr = np.frombuffer(bytearray(buf), dtype=dt).reshape(shape)
                ds = out.create_dataset(dpath, data=arr, copy=False)
                ds.attrs.update(info.get("attrs") or {})
                own = info.get("ownership")
                if own:
                    bo = BlockOwnership()
                    for r, (s, sh) in own.items():
                        bo.add(int(r), s, sh)
                    ds.ownership = bo
            return out

    @classmethod
    def _load_legacy(cls, f) -> "File":
        # pre-raw-container format: u64 header length + json + npz blob
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode())
        npz = np.load(io.BytesIO(f.read()))
        out = cls(meta["filename"])
        for dpath, info in meta["datasets"].items():
            ds = out.create_dataset(dpath, data=npz[info["key"]], copy=False)
            ds.attrs.update(info.get("attrs") or {})
            own = info.get("ownership")
            if own:
                bo = BlockOwnership()
                for r, (s, sh) in own.items():
                    bo.add(int(r), s, sh)
                ds.ownership = bo
        return out

    def total_bytes(self) -> int:
        return sum(d.nbytes for d in self.visit_datasets())

    def copy_meta_only(self) -> "File":
        """Shallow structural copy (metadata broadcast path, cf. Listing 5)."""
        out = File(self.filename)

        def walk(src: Group, dst: Group) -> None:
            dst.attrs.update(src.attrs)
            for nm, child in src.children.items():
                if isinstance(child, Dataset):
                    nd = dst.create_dataset(nm, shape=child.shape, dtype=child.dtype)
                    nd.attrs.update(child.attrs)
                    nd.ownership = child.ownership
                else:
                    walk(child, dst.require_group(nm))

        walk(self, out)
        return out


def _spill_dtype_str(dt: Any) -> str:
    """The header's dtype string, as the JAX package writes it (numpy's
    ``.str``; ``ml_dtypes`` spells bfloat16 ``"<V2"``)."""
    return "<V2" if dtype_name(dt) == "bfloat16" else np.dtype(dt).str


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[k] = v
    return out
