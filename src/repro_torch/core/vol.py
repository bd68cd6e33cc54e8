"""VOL interception layer -- the LowFive analogue.

LowFive is an HDF5 Virtual Object Layer plugin: user task code performs
ordinary HDF5 I/O, and the plugin redirects it over memory/MPI or files, and
exposes callback hooks at I/O execution points.  Here the same boundary is
implemented over ``repro_torch.core.datamodel``: the user task code calls the
``repro_torch.core.h5`` API (identical standalone and in-workflow); when a workflow
is active, an ambient ``VOL`` object intercepts opens/closes/reads/writes.

The VOL object carries (mirroring the LowFive API used in the paper's
Listing 5):

* per-pattern memory/file properties (``set_memory`` / ``set_file``),
* outgoing and incoming channels (set by the driver, matched data-centrically),
* callback registry: ``set_before_file_open``, ``set_after_file_open``,
  ``set_before_file_close``, ``set_after_file_close``,
  ``set_after_dataset_write``, ``set_before_dataset_open``,
* ``serve_all()``, ``clear_files()``, ``broadcast_files()``,
  ``file_close_counter`` -- the exact surface used by the Nyx custom-action
  script in the paper,
* flow control is enforced by the channels the files are served into.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..analysis.lockcheck import make_lock, sched_point
from ..obs.recorder import flow_id
from .channel import (NO_DATA, Channel, ChannelMux, enter_mux_wait_scope,
                      exit_mux_wait_scope)
from .datamodel import BlockOwnership, File, compile_file_pattern

__all__ = ["VOL", "current_vol", "push_vol", "pop_vol"]

_tls = threading.local()


def current_vol() -> Optional["VOL"]:
    return getattr(_tls, "vol_stack", [None])[-1]


def push_vol(vol: Optional["VOL"]) -> None:
    if not hasattr(_tls, "vol_stack"):
        _tls.vol_stack = [None]
    _tls.vol_stack.append(vol)


def pop_vol() -> None:
    _tls.vol_stack.pop()


class VOL:
    """Per task-instance interception object (one LowFive plugin instance)."""

    def __init__(self, task: str, instance: int = 0, rank: int = 0, nprocs: int = 1,
                 io_procs: Optional[int] = None):
        self.task = task
        self.instance = instance
        self.rank = rank
        self.nprocs = nprocs
        self.io_procs = io_procs if io_procs is not None else nprocs

        self.outgoing: List[Channel] = []
        self.incoming: List[Channel] = []

        # (filename_pattern -> mode) properties; "memory" wins by default
        self._props: Dict[str, str] = {}

        # declared producer ownership per outport pattern (driver sets these
        # from YAML ``outports: [{ownership: {axis: A}}]``): every dataset
        # written to a matching file gets an even per-rank BlockOwnership
        # stamped at close, replacing create_dataset(ownership=...) calls
        self._ownership: List[Tuple[Any, int, int]] = []  # (matcher, axis, nranks)

        # callback registry (LowFive execution points)
        self._cb: Dict[str, Optional[Callable[[Any], None]]] = {
            "before_file_open": None,
            "after_file_open": None,
            "before_file_close": None,
            "after_file_close": None,
            "after_dataset_write": None,
            "before_dataset_open": None,
        }

        # per-run scheduler runtime (driver-attached): producer file closes
        # and consumer intercepted opens are the step events that drive the
        # depth-autotuner / telemetry tick (see scheduler.SchedulerRuntime)
        self.scheduler = None
        # per-run supervisor (driver-attached): fault-injection points fire
        # through it, and served files are stamped with the incarnation's
        # epoch (``wilkins_epoch`` attr) at close
        self.supervisor = None
        # per-run span recorder (driver-attached; None = untraced run)
        self.tracer = None

        self.file_close_counter = 0
        self.file_open_counter = 0
        self.dataset_write_counter = 0
        self._unserved: List[File] = []
        self._broadcast_log: List[str] = []
        self._open_files: Dict[str, File] = {}
        self.log: List[Tuple[float, str]] = []
        # Serialize serving against the rescale channel swap: a resize of a
        # downstream task replaces entries of ``self.outgoing`` under this
        # lock, so a serve never straddles old and new channel sets.
        self.serve_lock = make_lock(f"vol.serve:{task}[{instance}]")

    # ------------------------------------------------------------ properties
    def set_memory(self, filename_pattern: str, dset_pattern: str = "*") -> None:
        self._props[filename_pattern] = "memory"

    def set_file(self, filename_pattern: str, dset_pattern: str = "*") -> None:
        self._props[filename_pattern] = "file"

    def set_ownership(self, filename_pattern: str, axis: int, nranks: int) -> None:
        """Declare that this task's ``nranks`` logical ranks own an even
        ``axis`` decomposition of every dataset written to matching files."""
        self._ownership.append((compile_file_pattern(filename_pattern),
                                int(axis), int(nranks)))

    def _stamp_ownership(self, f: File) -> None:
        """Apply declared producer ownership to a file at close time.

        Datasets that already carry an ownership map (task code called
        ``create_dataset(ownership=...)``) are left alone; scalars have no
        decomposition axis and are skipped; an axis beyond a dataset's rank
        is a workflow-description error and raises clearly."""
        from .redistribute import even_blocks

        for matcher, axis, nranks in self._ownership:
            if not (matcher.matches(f.filename)
                    or compile_file_pattern(f.filename).matches(matcher.pattern)):
                continue
            for ds in f.visit_datasets():
                if ds.ownership is not None and ds.ownership.blocks:
                    continue
                if not ds.shape:
                    continue  # scalar: nothing to decompose
                if axis >= len(ds.shape):
                    raise ValueError(
                        f"task {self.task!r}: declared ownership axis {axis} "
                        f"out of range for dataset {ds.path} with shape "
                        f"{ds.shape} in {f.filename!r}")
                own = BlockOwnership()
                for r, (s, sh) in enumerate(
                        even_blocks(ds.shape, nranks, axis=axis)):
                    own.add(r, s, sh)
                ds.ownership = own

    # ------------------------------------------------------------- callbacks
    def set_before_file_open(self, cb: Callable[[Any], None]) -> None:
        self._cb["before_file_open"] = cb

    def set_after_file_open(self, cb: Callable[[Any], None]) -> None:
        self._cb["after_file_open"] = cb

    def set_before_file_close(self, cb: Callable[[Any], None]) -> None:
        self._cb["before_file_close"] = cb

    def set_after_file_close(self, cb: Callable[[Any], None]) -> None:
        self._cb["after_file_close"] = cb

    def set_after_dataset_write(self, cb: Callable[[Any], None]) -> None:
        self._cb["after_dataset_write"] = cb

    def set_before_dataset_open(self, cb: Callable[[Any], None]) -> None:
        self._cb["before_dataset_open"] = cb

    def _fire(self, point: str, arg: Any) -> bool:
        """Fire a callback; returns True if a user callback handled the point."""
        cb = self._cb[point]
        if cb is not None:
            cb(arg)
            return True
        return False

    # --------------------------------------------------------- LowFive verbs
    def serve_all(self, memory: bool = True, file: bool = True) -> int:
        """Serve every unserved file to all matching outgoing channels.

        Flow control happens inside ``Channel.offer`` -- a skip there is not an
        error, it is the strategy working as intended.

        A per-file payload cache is shared across the fan-out: every channel
        with the same dataset selection AND the same declared M->N ownership
        (``Channel.redistribute``) ships a CoW view over ONE filtered payload
        instead of materializing its own copy (zero-copy fast path).  Sibling
        consumer instances of a redistributing port own different slabs, so
        they intentionally miss each other's cache entries.
        """
        n = 0
        sched_point("VOL.serve_all", key=("vol", id(self)))
        with self.serve_lock:
            for f in list(self._unserved):
                payload_cache: Dict[Any, File] = {}
                for ch in self.outgoing:
                    if not ch.matches_file(f.filename):
                        continue
                    if ch.mode == "memory" and not memory:
                        continue
                    if ch.mode == "file" and not file:
                        continue
                    if ch.offer(f, _payload_cache=payload_cache):
                        n += 1
        return n

    def clear_files(self) -> None:
        self._unserved.clear()

    def broadcast_files(self) -> None:
        """Rank-0 metadata broadcast (Nyx idiom). In the single-driver
        execution model this records the structural copy; per-rank views all
        share the driver's tree, so the broadcast is a metadata no-op but the
        event is logged for the custom-action tests."""
        self._broadcast_log.append(
            f"bcast@close={self.file_close_counter} files={[f.filename for f in self._unserved]}"
        )

    # ------------------------------------------------- h5-facing entry points
    def on_file_create(self, f: File) -> None:
        self._open_files[f.filename] = f

    def on_file_close(self, f: File) -> None:
        t0 = time.monotonic()
        sup = self.supervisor  # local: the driver may detach it concurrently
        if sup is not None:
            # every step boundary is a health signal for the stall watchdog
            sup.heartbeat(self.task, self.instance)
            # fault point "close": the producer crashes AT the step boundary,
            # before this step's data is served -- the canonical lost-step
            # (step is 0-based: the close about to complete)
            sup.fire(self.task, self.instance, "close", self.file_close_counter)
            # stamp the incarnation's epoch so consumers (and the recovery
            # tests) can tell which incarnation produced a payload
            f.attrs["wilkins_epoch"] = sup.epoch(self.task, self.instance)
        self._stamp_ownership(f)
        self._fire("before_file_close", f)
        self.file_close_counter += 1
        self._unserved.append(f)
        self._open_files.pop(f.filename, None)
        self.log.append((time.monotonic(), f"close:{f.filename}"))
        if not self._fire("after_file_close", f):
            # Default behaviour: serve at close, then drop our reference --
            # exactly LowFive's serve-on-close convention.
            self.serve_all(True, True)
            self.clear_files()
        tr = self.tracer  # local: the driver may detach it concurrently
        if tr is not None:
            # lifecycle span, not a wait: the rendezvous-blocked portion is
            # claimed by the nested channel.offer spans, the rest is serve
            # work (filter/slab/spill) on the producer's own clock
            tr.record("vol", "vol.close", self.task, self.instance, t0,
                      time.monotonic(), step=self.file_close_counter - 1,
                      filename=f.filename)
        sched = self.scheduler  # local: the driver may detach it concurrently
        if sched is not None:
            sched.notify_step("file_close")

    def on_file_open(self, filename: str) -> Optional[File]:
        """Consumer-side open: pull the next version from a matching channel.

        A consumer port may aggregate several producer instances (fan-in).
        All matching channels are multiplexed over one condition variable
        (``ChannelMux``): the consumer scans non-blockingly, then sleeps until
        ANY channel serves or finishes -- no polling loop.  The version-token
        handshake (token taken *before* the scan) makes a serve that lands
        between scan and wait impossible to miss.
        """
        sup = self.supervisor  # local: the driver may detach it concurrently
        if sup is not None:
            sup.heartbeat(self.task, self.instance)
            # fault point "open": the consumer crashes before asking for
            # data (nothing delivered yet -- restart re-opens cleanly)
            sup.fire(self.task, self.instance, "open", self.file_open_counter)
        self._fire("before_file_open", filename)
        chans = [c for c in self.incoming if c.matches_file(filename)]
        if not chans:
            return None  # not intercepted -> caller falls back to standalone
        mux = ChannelMux()
        for c in chans:
            c.add_listener(mux)
            # advertise the blocked consumer so `latest` producers serve us
            c.set_consumer_waiting(True)
        t0 = time.monotonic()
        # nested-wait guard: this loop accounts the whole multiplexed wait
        # itself, so a get() issued on one of these channels from inside the
        # scope must not add the same wall time to consumer_wait_s again
        scope = enter_mux_wait_scope(chans)
        try:
            while True:
                token = mux.token()
                any_live = False
                # the wait ends when data is FOUND; delivery work after the
                # take (future result on a prefetch miss, spill load) is
                # accounted by prefetch_blocked_s, never re-counted as wait
                t_scan = time.monotonic()
                for c in chans:
                    r = c.try_get()
                    if r is NO_DATA:
                        any_live = True
                    elif r is not None:
                        # under the channel lock: every other writer of
                        # consumer_wait_s holds it, and += on a float is
                        # read-modify-write -- a concurrent get() on a
                        # sibling consumer could otherwise lose the update
                        with c._lock:
                            c.stats.consumer_wait_s += t_scan - t0
                        # wait accounted: callbacks below may block anew
                        exit_mux_wait_scope(scope)
                        step = self.file_open_counter
                        self.file_open_counter += 1
                        tr = self.tracer  # local: driver may detach it
                        if tr is not None:
                            tr.record("vol", "vol.open.wait", self.task,
                                      self.instance, t0, t_scan, step=step,
                                      flow=("f", flow_id(c.name,
                                                         c.delivered_seq)),
                                      edge=c.name)
                        if sup is not None:
                            # fault point "recv": the payload WAS delivered
                            # (the channel's watermark moved, the replay
                            # buffer recorded it) but the task never saw it
                            # -- the window only the replay protocol covers
                            sup.fire(self.task, self.instance, "recv", step)
                        self._fire("after_file_open", r)
                        sched = self.scheduler  # local: driver may detach it
                        if sched is not None:
                            sched.notify_step("file_open")
                        return r
                if not any_live:
                    return None  # all producers report all-done (query protocol)
                if sup is not None:
                    # bounded sleep + heartbeat: a consumer parked in the
                    # fan-in mux is starved, not stalled (watchdog hysteresis)
                    sup.heartbeat(self.task, self.instance)
                    mux.wait(token, timeout=sup.wait_quantum(self.task))
                else:
                    mux.wait(token)
        finally:
            exit_mux_wait_scope(scope)  # idempotent on the delivery path
            for c in chans:
                c.set_consumer_waiting(False)
                c.remove_listener(mux)

    def on_dataset_write(self, ds) -> None:
        self.dataset_write_counter += 1
        self._fire("after_dataset_write", ds)

    def on_dataset_open(self, path: str) -> None:
        self._fire("before_dataset_open", path)

    # ------------------------------------------------------------- restart
    def reset_for_restart(self) -> None:
        """Fresh-incarnation reset: drop the dead incarnation's unserved
        files and open handles, restart the step counters.  Channel-side
        state (serve seqs, flow-control counters) is rewound separately by
        ``Channel.quarantine_producer`` -- the two never disagree because
        the supervisor calls both under the restart barrier."""
        self._unserved.clear()
        self._open_files.clear()
        self.file_close_counter = 0
        self.file_open_counter = 0
        self.dataset_write_counter = 0

    def update_ownership_nranks(self, old_nranks: int, new_nranks: int) -> None:
        """nprocs rescale: re-point declared producer decompositions at the
        new logical rank count (entries pinned to other counts -- an explicit
        YAML ``nranks:`` -- are left alone)."""
        self._ownership = [
            (m, axis, new_nranks if n == old_nranks else n)
            for (m, axis, n) in self._ownership]

    # ------------------------------------------------------------- shutdown
    def finalize(self) -> None:
        """Task function returned: serve any leftover files, mark all-done."""
        if self._unserved:
            self.serve_all(True, True)
            self.clear_files()
        with self.serve_lock:
            for ch in self.outgoing:
                ch.finish()

    def __repr__(self) -> str:
        return (f"<VOL task={self.task}[{self.instance}] out={len(self.outgoing)} "
                f"in={len(self.incoming)} closes={self.file_close_counter}>")
