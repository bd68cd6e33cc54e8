"""Producer->consumer channels with Wilkins' three flow-control strategies.

A Channel couples one producer task *instance* to one consumer task *instance*
for one matched (filename pattern, dataset patterns) port pair.  Channels are
created by the driver from the data-centric YAML matching (``graph.py``) --
users never construct them.

Flow control (paper §3.6), selected by ``io_freq``:

* ``all``    (io_freq in {0,1}) -- rendezvous: the producer blocks at file
  close until a queue slot frees up (bounded ring queue of ``queue_depth``
  items, default 1 = the paper's depth-1 rendezvous; depth >= 2 pipelines the
  producer ahead of the consumer).
* ``some``   (io_freq = N > 1) -- the producer serves only every Nth file
  close; skipped closes drop the data immediately and the producer continues.
* ``latest`` (io_freq = -1)    -- the producer serves only if the consumer is
  currently waiting for data; otherwise it skips this timestep.  Older data
  are never queued, so the consumer always sees the freshest snapshot.

Transport fast path: ``filter_file`` ships copy-on-write dataset *views*
(``Dataset.view``), so a fan-out of N channels serves ONE filtered payload --
the per-dataset ``_Share`` refcount tracks the sharing and the first consumer
write materializes a private copy.  Pass ``zero_copy=False`` to get the old
materialize-per-channel behaviour (the benchmark's legacy baseline).

The channel also implements the producer-query protocol of §3.5.1: when the
producer finishes it marks the channel done; a consumer ``get()`` after that
returns ``None`` ("all done"), which is how stateful consumers exit their loop
and how the driver decides to stop relaunching stateless consumers.  A
``get(timeout=...)`` that elapses raises ``ChannelTimeout`` -- timeouts are
*not* conflated with producer-done.

Every state transition is recorded as a timestamped event so benchmarks can
reconstruct the paper's Fig. 5 Gantt charts.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..analysis.lockcheck import (check_blocking, hb_consume, hb_publish,
                                  make_condition, make_lock, sched_point)
from ..obs.recorder import flow_id
from ..convert import host_copy
from .datamodel import (BlockOwnership, File, compile_file_pattern,
                        compile_path_pattern, is_device_array, transport_stats)
from .redistribute import RedistSpec, plan_cache
from .scheduler import FifoPolicy, QueuePolicy, ResizableSemaphore

__all__ = [
    "FlowControl",
    "Channel",
    "ChannelStats",
    "ChannelTimeout",
    "ChannelError",
    "ChannelMux",
    "NO_DATA",
    "PrefetchPool",
    "configure_prefetch_pool",
    "shutdown_prefetch_pool",
    "DEFAULT_PREFETCH_DEPTH",
]


def _host_copy(buf: Any) -> np.ndarray:
    """A private host copy of a dataset's read buffer -- the legacy
    transport's eager materialization; a tensor crosses to the host
    explicitly, as a ``jax.Array`` does in the JAX package."""
    return host_copy(buf) if is_device_array(buf) else np.array(buf)


class ChannelTimeout(Exception):
    """``Channel.get(timeout=...)`` elapsed with no data and no producer-done."""


class ChannelError(Exception):
    """The peer producer failed permanently (poison pill).

    Raised by ``get``/``try_get`` the moment the driver poisons the channel
    -- a consumer blocked on a dead producer learns *which* task died and
    why (the producer's exception is chained as ``__cause__``) instead of
    waiting out its timeout for an opaque ``ChannelTimeout``.  Carries
    ``task`` and ``instance`` of the dead producer.
    """

    def __init__(self, msg: str, task: str = "?", instance: int = -1):
        super().__init__(msg)
        self.task = task
        self.instance = instance


class _NoData:
    """Sentinel: channel queue is empty but the producer is still live."""

    _instance: Optional["_NoData"] = None

    def __new__(cls) -> "_NoData":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "NO_DATA"


NO_DATA = _NoData()


# --- nested-wait accounting guard (satellite: counter consistency) ----------
# The VOL mux loop accounts its whole multiplexed wait into the channel that
# finally delivers; a ``get()`` on one of those same channels issued INSIDE
# that scope (e.g. from an ``after_file_open`` callback) must not add its own
# wait to ``consumer_wait_s`` again.  The scope is per-thread and nestable.
_MUX_WAIT_SCOPE = threading.local()


def enter_mux_wait_scope(channels: Sequence["Channel"]) -> frozenset:
    """Mark ``channels`` as wait-accounted by the caller; returns the token
    to pass to :func:`exit_mux_wait_scope` (the previous scope)."""
    prev = getattr(_MUX_WAIT_SCOPE, "ids", frozenset())
    _MUX_WAIT_SCOPE.ids = prev | frozenset(id(c) for c in channels)
    return prev


def exit_mux_wait_scope(token: frozenset) -> None:
    """Restore the previous scope (idempotent: tokens nest)."""
    _MUX_WAIT_SCOPE.ids = token


def _in_mux_wait_scope(ch: "Channel") -> bool:
    return id(ch) in getattr(_MUX_WAIT_SCOPE, "ids", frozenset())


class FlowControl:
    ALL = "all"
    SOME = "some"
    LATEST = "latest"

    @staticmethod
    def from_io_freq(io_freq: int) -> Tuple[str, int]:
        """Decode the paper's io_freq field: 0/1 -> all, N>1 -> some(N), -1 -> latest."""
        if io_freq in (0, 1):
            return FlowControl.ALL, 1
        if io_freq > 1:
            return FlowControl.SOME, int(io_freq)
        if io_freq == -1:
            return FlowControl.LATEST, 1
        raise ValueError(
            f"invalid io_freq {io_freq}: use 0/1 (all), N>1 (some: every "
            f"Nth step), or -1 (latest)")


#: default ring size for per-channel event timelines (satellite: bounded so
#: ``record_events=True`` cannot grow memory without limit on long runs)
EVENTS_MAXLEN = 4096

#: default per-edge prefetch depth when a redistributing port does not set
#: ``prefetch: N`` in YAML (max in-flight payload preps on that edge)
DEFAULT_PREFETCH_DEPTH = 2


class PrefetchPool:
    """Shared executor for asynchronous payload preparation (slab prefetch).

    Channels with a RedistSpec enqueue a *future* of the filtered payload, so
    slab construction / eager copies / spill writes overlap with both the
    producer's rendezvous wait and the consumer's compute on the previous
    step.  Unlike ``concurrent.futures.ThreadPoolExecutor`` (whose non-daemon
    workers are joined at interpreter exit -- a payload prep stuck in I/O
    then hangs process shutdown, and a pool nobody shuts down leaks its
    workers across runs), this pool:

    * runs DAEMON workers, so a wedged prep can never hang interpreter exit;
    * supports ``shutdown()``: queued-but-unstarted preps are *cancelled*
      (their futures resolve to CancelledError, which still fires their
      done-callbacks, so per-edge depth slots are released -- the slot-leak
      regression) and workers drain and stop;
    * arbitrates pending preps through a pluggable ``QueuePolicy``
      (``scheduler.FifoPolicy`` -- the default, bit-for-bit the old single
      deque -- or ``scheduler.FairPolicy``, deficit-weighted round-robin by
      per-edge YAML ``weight:``);
    * is created per ``Wilkins.run`` (sized to the run's total prefetch
      depth, policy from the YAML ``scheduler:`` block) and shut down on
      both the success and error paths -- standalone ``Channel`` use falls
      back to a lazy module-level default.
    """

    def __init__(self, max_workers: int = 2,
                 thread_name_prefix: str = "wilkins-prefetch",
                 policy: Optional[QueuePolicy] = None):
        self._cv = make_condition("pool:prefetch")
        self._policy: QueuePolicy = policy if policy is not None else FifoPolicy()
        self._shutdown = False
        # Error accounting (never drop a prep exception on the floor): every
        # prep a worker starts is tracked in ``_inflight`` until it settles;
        # a prep that settles with an exception is remembered in ``_errored``
        # so ``drain_errors`` can report any error the consumer never
        # observed via ``fut.result()`` -- the shutdown-race audit.
        self._inflight: set = set()
        self._errored: List[Future] = []
        self._threads = [
            threading.Thread(target=self._worker,
                             name=f"{thread_name_prefix}-{i}", daemon=True)
            for i in range(max(1, int(max_workers)))
        ]
        for t in self._threads:
            t.start()

    def submit(self, fn: Callable, *args, edge: Optional[str] = None,
               weight: int = 1) -> Future:
        """Enqueue a prep; ``edge``/``weight`` feed the queue policy (the
        FIFO policy ignores them, so plain ``submit(fn)`` is unchanged)."""
        fut: Future = Future()
        fut._wilkins_edge = edge  # type: ignore[attr-defined]
        with self._cv:
            if self._shutdown:
                raise RuntimeError("prefetch pool is shut down")
            self._policy.push((fut, fn, args), edge=edge, weight=weight)
            self._cv.notify()
        return fut

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._policy.pending() and not self._shutdown:
                    self._cv.wait()
                if not self._policy.pending():
                    return  # shutdown and drained
                item = self._policy.pop()
                if item is not None:
                    # claimed under the SAME cv hold as the pop: drain_errors
                    # can never observe "not pending, not in flight" for a
                    # prep a worker is about to run
                    self._inflight.add(item[0])
            if item is None:  # policy raced empty (defensive)
                continue
            fut, fn, args = item
            try:
                if fut.set_running_or_notify_cancel():
                    try:
                        fut.set_result(fn(*args))
                    except BaseException as e:  # surfaced via fut.result()
                        fut.set_exception(e)
            finally:
                with self._cv:
                    self._inflight.discard(fut)
                    if (fut.done() and not fut.cancelled()
                            and fut.exception() is not None):
                        self._errored.append(fut)
                    self._cv.notify_all()

    def drain_errors(self, timeout: Optional[float] = 5.0) -> List[Tuple[Optional[str], BaseException]]:
        """Wait (bounded) for in-flight preps to settle, then return every
        prep exception no consumer observed, as ``(edge, exception)`` pairs.

        This closes the shutdown race: ``shutdown(cancel_pending=True)``
        cancels *queued* preps, but a prep already running on a worker can
        still error after teardown -- with nobody left to call
        ``fut.result()``, the exception used to vanish.  The driver calls
        this after every run and attaches the result to the
        ``WorkflowReport``.  Errors the consumer did re-raise (delivery
        marks the future observed) are not double-reported."""
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Tuple[Optional[str], BaseException]] = []
        with self._cv:
            while self._inflight or self._policy.pending():
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            for fut in self._errored:
                if not getattr(fut, "_wilkins_observed", False):
                    fut._wilkins_observed = True  # type: ignore[attr-defined]
                    out.append((getattr(fut, "_wilkins_edge", None),
                                fut.exception()))
        return out

    def shutdown(self, cancel_pending: bool = True) -> None:
        """Stop accepting work; cancel queued preps; wake and drain workers.

        Running preps are left to finish on their (daemon) worker -- there is
        no way to interrupt them, but they can no longer block exit.
        ``Future.cancel`` fires done-callbacks, so every cancelled prep still
        releases its edge's depth slot (no leak, no over-release)."""
        with self._cv:
            self._shutdown = True
            pending = self._policy.drain() if cancel_pending else []
            self._cv.notify_all()
        for fut, _, _ in pending:
            fut.cancel()

    def alive_workers(self) -> int:
        return sum(t.is_alive() for t in self._threads)


_PREFETCH_POOL: Optional[PrefetchPool] = None
_PREFETCH_POOL_LOCK = make_lock("leaf:prefetch_pool_global")


def _prefetch_pool() -> PrefetchPool:
    global _PREFETCH_POOL
    if _PREFETCH_POOL is None:
        with _PREFETCH_POOL_LOCK:
            if _PREFETCH_POOL is None:
                _PREFETCH_POOL = PrefetchPool(max_workers=2)
    return _PREFETCH_POOL


def configure_prefetch_pool(max_workers: int) -> PrefetchPool:
    """Install a fresh module-default pool (standalone use / tests); any
    previous default is shut down, its queued preps cancelled.  Workflow
    runs do NOT go through the global: ``Wilkins.run`` builds its own pool
    and injects it per channel, so concurrent runs in one process cannot
    cancel each other's in-flight preps."""
    global _PREFETCH_POOL
    with _PREFETCH_POOL_LOCK:
        old, _PREFETCH_POOL = _PREFETCH_POOL, PrefetchPool(max_workers)
        pool = _PREFETCH_POOL
    if old is not None:
        old.shutdown()
    return pool


def shutdown_prefetch_pool() -> None:
    """Shut down the module-default pool (cancelling queued preps) and reset
    the global, so the next standalone use starts from a clean pool."""
    global _PREFETCH_POOL
    with _PREFETCH_POOL_LOCK:
        pool, _PREFETCH_POOL = _PREFETCH_POOL, None
    if pool is not None:
        pool.shutdown()


@dataclass
class ChannelStats:
    served: int = 0
    dropped: int = 0
    bytes_moved: int = 0
    producer_wait_s: float = 0.0
    consumer_wait_s: float = 0.0
    # Per-EDGE prefetch accounting (the process-wide TransportStats keeps the
    # aggregate): the depth autotuner and the telemetry timeline both need to
    # attribute hits/misses/blocked seconds to the edge that earned them.
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    prefetch_cancelled: int = 0
    prefetch_prepared_s: float = 0.0
    prefetch_blocked_s: float = 0.0
    inflight_preps: int = 0  # gauge: preps submitted but not yet done
    # Recovery accounting: serves a restarted producer regenerated that the
    # consumer already held (skipped), payloads requeued for replay after a
    # consumer restart, and preps re-run synchronously after an async prep
    # error (mid-prefetch crash recovery).
    deduped: int = 0
    replayed: int = 0
    prep_retries: int = 0
    # (t, who, what) ring: oldest events roll off past the maxlen, counted
    # in ``events_dropped`` so Gantt consumers know the timeline is truncated
    events: Deque[Tuple[float, str, str]] = field(
        default_factory=lambda: deque(maxlen=EVENTS_MAXLEN))
    events_dropped: int = 0


class ChannelMux:
    """Condition-variable multiplexer: wait for ANY registered channel to
    serve or finish, without polling.

    A channel bumps the mux version (``notify``) on every state change; the
    waiter snapshots the version (``token``) *before* scanning channels, so a
    serve that lands between the scan and the wait is never missed.
    """

    def __init__(self) -> None:
        self._cond = make_condition("leaf:mux")
        self._version = 0

    def notify(self) -> None:
        with self._cond:
            self._version += 1
            self._cond.notify_all()

    def token(self) -> int:
        with self._cond:
            return self._version

    def wait(self, token: int, timeout: Optional[float] = None) -> int:
        """Block until the version moves past ``token`` (or timeout); the
        caller rescans its channels either way, so spurious wakeups are safe."""
        with self._cond:
            if self._version == token:
                self._cond.wait(timeout)  # wilkins: ignore[WLK302] -- caller
                # rescans its channels on every return, so a spurious wakeup
                # or missed-notify race costs one extra scan, never a hang
            return self._version


class Channel:
    """One producer-instance -> consumer-instance coupling for one file port."""

    def __init__(
        self,
        name: str,
        producer: Tuple[str, int],
        consumer: Tuple[str, int],
        filename_pattern: str,
        dset_patterns: Sequence[str],
        mode: str = "memory",  # "memory" (in-situ) | "file" (spill through disk)
        io_freq: int = 1,
        spill_dir: Optional[str] = None,
        record_events: bool = False,
        queue_depth: int = 1,
        zero_copy: bool = True,
        redistribute: Optional[RedistSpec] = None,
        prefetch: Optional[Union[bool, int]] = None,
        events_maxlen: int = EVENTS_MAXLEN,
        weight: int = 1,
        autotune: Optional[Tuple[int, int]] = None,
    ):
        self.name = name
        self.producer = producer
        self.consumer = consumer
        self.filename_pattern = filename_pattern
        self.dset_patterns = list(dset_patterns)
        assert mode in ("memory", "file"), mode
        self.mode = mode
        self.strategy, self.freq = FlowControl.from_io_freq(io_freq)
        self.spill_dir = spill_dir or os.path.join("/tmp", "wilkins_spill")
        self.record_events = record_events
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.queue_depth = int(queue_depth)
        self.zero_copy = bool(zero_copy)
        self.redistribute = redistribute
        # Async payload preparation: ``prefetch`` is the PER-EDGE depth --
        # the max number of in-flight preps on this channel (0 = synchronous
        # serve).  On by default (DEFAULT_PREFETCH_DEPTH) exactly when the
        # channel carries a RedistSpec (slab construction is the serve-side
        # work worth hiding); the YAML inport knob ``prefetch: N`` overrides
        # (0 = off, N >= 1 = depth).  Depth is enforced by a per-channel
        # semaphore over the shared sized pool, so one hot edge cannot
        # monopolize every prefetch worker.
        if prefetch is None:
            depth = DEFAULT_PREFETCH_DEPTH if redistribute is not None else 0
        elif isinstance(prefetch, bool):
            depth = DEFAULT_PREFETCH_DEPTH if prefetch else 0
        else:
            depth = int(prefetch)
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        # Scheduling knobs (see scheduler.py): ``weight`` feeds the fair
        # (DWRR) queue policy; ``autotune=(min, max)`` bounds the depth
        # autotuner and implies prefetch -- the initial depth is clamped
        # into the bounds, so an autotuned edge always starts async.
        if weight < 1:
            raise ValueError(f"scheduler weight must be >= 1, got {weight}")
        self.weight = int(weight)
        if autotune is not None:
            amin, amax = int(autotune[0]), int(autotune[1])
            if amin < 1:
                raise ValueError(
                    f"autotune min depth must be >= 1, got {amin} "
                    f"(use prefetch: 0 to disable prefetch instead)")
            if amax < amin:
                raise ValueError(
                    f"autotune bounds must satisfy min <= max, got "
                    f"[{amin}, {amax}]")
            autotune = (amin, amax)
            depth = min(max(depth, amin), amax)
        self.autotune = autotune
        self.prefetch = depth
        self._prefetch_sem = ResizableSemaphore(depth) if depth else None
        # run-scoped pool injected by the driver (None = module default)
        self._prefetch_pool: Optional[PrefetchPool] = None

        # precompiled matchers (LRU-cached globally, pinned here for the hot path)
        self._file_matcher = compile_file_pattern(filename_pattern)
        self._dset_matchers = [compile_path_pattern(p) for p in self.dset_patterns]
        # filename -> bool memo: the reverse compile in matches_file otherwise
        # runs on every serve/open for every non-matching filename
        self._match_cache: Dict[str, bool] = {}

        self._lock = make_condition(f"channel.cv:{filename_pattern}")
        # bounded ring (queue_depth) of (kind, payload, seq, epoch, src):
        # positions 0/1 are the pre-recovery item layout; ``seq`` is the
        # producer's serve ordinal (dedup watermark), ``epoch`` the
        # incarnation that queued it, ``src`` the source File kept for
        # synchronous prep retry (recovery runs only, else None)
        self._queue: Deque[Tuple[str, Any, int, int, Any]] = deque()
        self._done = False
        # --- recovery protocol state (see recovery.py) -------------------
        # producer side: serve seqs are strictly monotonic; ack_producer
        # snapshots them at a checkpoint so quarantine_producer can rewind.
        self._serve_seq = 0
        self._acked_seq = 0
        self._acked_close_count = 0
        # consumer side: delivered watermark + ack snapshot + the
        # delivered-but-unacked payloads quarantine_consumer will replay.
        self._delivered_seq = 0
        self._acked_delivered_seq = 0
        self._replay: List[Tuple[str, Any, int, int, Any]] = []
        self._replay_enabled = False
        self._epoch = 0
        self._poison: Optional[Tuple[str, int, BaseException]] = None
        self._abandoned = False
        self._prep_retry = False
        # --- elastic rescale state (see recovery.RescaleOp) --------------
        # consumer interrupt: raised out of get/try_get to pull the consumer
        # thread out of its callable so the task can be resized
        self._interrupt: Optional[BaseException] = None
        # producer grace: a retiring channel lets blocked offers complete
        # immediately (ring may transiently exceed depth) so the feeding
        # producer drains out of the rendezvous before the channel swap
        self._grace = False
        # retention ring: when the consumer's policy is a rescale, acked
        # payloads move here (instead of being discarded) so the surgery can
        # re-cut every step after the consistent cut, even for sibling
        # instances that checkpointed ahead of it
        self._retention = False
        self._retained: Deque[Tuple[str, Any, int, int, Any]] = deque()
        self._supervisor: Optional[Any] = None  # RunSupervisor (fault hook)
        self._tracer: Optional[Any] = None      # obs.SpanRecorder (run-scoped)
        # Waiter accounting for the `latest` rendezvous decision: one entry
        # per *distinct consumer thread* currently blocked on this channel,
        # with a nesting depth so a thread registered by the VOL mux
        # (``set_consumer_waiting``) that then blocks in ``get`` still counts
        # once, not twice (double counting skewed the fan-in decision).
        self._waiters: Dict[int, int] = {}
        self._close_count = 0
        self._spill_seq = 0
        self._listeners: List[ChannelMux] = []
        self.stats = ChannelStats(events=deque(maxlen=int(events_maxlen)))

    # ------------------------------------------------------------------ util
    def _event_locked(self, who: str, what: str) -> None:
        if self.record_events:
            ev = self.stats.events
            if ev.maxlen is not None and len(ev) == ev.maxlen:
                self.stats.events_dropped += 1
            ev.append((time.monotonic(), who, what))

    def set_prefetch_pool(self, pool: Optional["PrefetchPool"]) -> None:
        """Attach the run-scoped prefetch pool (driver-owned); ``None``
        detaches and falls back to the lazy module default."""
        self._prefetch_pool = pool

    def set_tracer(self, tracer: Optional[Any]) -> None:
        """Attach the run's ``SpanRecorder`` (None = untraced: every hook
        site below is a single attribute load + None test)."""
        self._tracer = tracer

    def stats_snapshot(self) -> Dict[str, Any]:
        """Point-in-time scalar counters, read under the owning lock --
        the error-report path must never see a half-updated struct (same
        discipline astlint WLK30x enforces on the happy-path mutations)."""
        with self._lock:
            s = self.stats
            return {
                "served": s.served, "dropped": s.dropped,
                "bytes_moved": s.bytes_moved,
                "producer_wait_s": s.producer_wait_s,
                "consumer_wait_s": s.consumer_wait_s,
                "prefetch_hits": s.prefetch_hits,
                "prefetch_misses": s.prefetch_misses,
                "prefetch_cancelled": s.prefetch_cancelled,
                "prefetch_prepared_s": s.prefetch_prepared_s,
                "prefetch_blocked_s": s.prefetch_blocked_s,
                "inflight_preps": s.inflight_preps,
                "deduped": s.deduped, "replayed": s.replayed,
                "prep_retries": s.prep_retries,
                "events_dropped": s.events_dropped,
            }

    # ----------------------------------------------------------- recovery
    def set_supervisor(self, sup: Optional[Any]) -> None:
        """Attach the run's ``RunSupervisor`` (fault-injection hook for the
        async prep path); ``None`` detaches on teardown."""
        self._supervisor = sup

    def set_replay(self, enabled: bool) -> None:
        """Track delivered-but-unacked payloads for consumer-restart replay.

        Only enabled when the consumer's policy is a managed restart -- the
        buffer grows until the consumer checkpoints (cadence guidance in
        DESIGN.md), so always-on would leak on checkpoint-free runs."""
        with self._lock:
            self._replay_enabled = bool(enabled)
            if not enabled:
                self._replay.clear()

    def set_prep_retry(self, enabled: bool) -> None:
        """Recover async prep errors by re-running the (idempotent) prep
        synchronously at delivery instead of failing the consumer."""
        self._prep_retry = bool(enabled)

    def ack_producer(self) -> None:
        """Producer checkpointed: serves so far are durable.  A later
        ``quarantine_producer`` keeps them queued and rewinds the serve/flow
        counters to exactly this point."""
        with self._lock:
            self._acked_seq = self._serve_seq
            self._acked_close_count = self._close_count

    def ack_consumer(self) -> None:
        """Consumer checkpointed: deliveries so far are consumed.  The
        replay buffer empties (into the retention ring when a rescale may
        need to re-cut consumed steps); a later ``quarantine_consumer``
        replays only payloads delivered after this point."""
        with self._lock:
            self._acked_delivered_seq = self._delivered_seq
            if self._retention and self._replay:
                self._retained.extend(self._replay)
            self._replay.clear()

    def set_retention(self, enabled: bool, cap: int = 512) -> None:
        """Keep acked payloads in a bounded ring for rescale re-cutting.

        Only enabled when the consumer's ``on_failure`` policy is a rescale:
        a sibling instance may checkpoint (and ack) steps *past* the
        consistent cut, and the surgery must still re-partition those steps
        for the new instances.  The ring is CoW views, so retention holds
        references, not copies."""
        with self._lock:
            self._retention = bool(enabled)
            self._retained = deque(maxlen=int(cap)) if enabled else deque()

    @property
    def delivered_seq(self) -> int:
        """Consumer-side delivery watermark (checkpoint sidecar feed)."""
        with self._lock:
            return self._delivered_seq

    def _discard_item_locked(self, item: Tuple[str, Any, int, int, Any]) -> None:
        """Drop one queued item (caller holds the lock): cancel an unfinished
        prep (marking it observed so ``drain_errors`` does not report a
        deliberately-quarantined crash), unlink a spill file."""
        kind, payload = item[0], item[1]
        self.stats.dropped += 1
        if kind == "future":
            payload._wilkins_observed = True
            if not payload.cancel():
                self.stats.prefetch_cancelled += 1
                transport_stats().record_prefetch_cancelled()
        elif kind == "file":
            try:
                os.unlink(payload)
            except OSError:
                pass

    def quarantine_producer(self, epoch: int) -> None:
        """The producer incarnation died: drop its un-acked queued payloads
        (the restart regenerates them from the checkpoint; in-flight prefetch
        futures are cancelled, spills unlinked), keep acked-but-undelivered
        ones, and rewind the serve/flow-control counters to the last ack so
        the replayed closes line up.  Waiters are woken to re-rendezvous
        against the new epoch."""
        sched_point("Channel.quarantine_producer", key=("chan", id(self)))
        with self._lock:
            kept: Deque[Tuple[str, Any, int, int, Any]] = deque()
            for item in self._queue:
                if item[2] > self._acked_seq:
                    self._discard_item_locked(item)
                else:
                    kept.append(item)
            self._queue = kept
            self._serve_seq = self._acked_seq
            self._close_count = self._acked_close_count
            self._epoch = max(self._epoch, epoch)
            self._event_locked("producer", f"quarantine:epoch={epoch}")
            if self._tracer is not None:
                self._tracer.instant("recovery", "channel.quarantine_producer",
                                     self.producer[0], self.producer[1],
                                     edge=self.name, epoch=epoch)
            self._lock.notify_all()
        self._notify_listeners()

    def quarantine_consumer(self, epoch: int) -> None:
        """The consumer incarnation died: requeue every delivered-but-unacked
        payload at the head (oldest first) and rewind the dedup watermark to
        the last ack, so the restarted consumer replays exactly the steps it
        had not checkpointed.  A producer blocked in ``offer`` keeps waiting
        for ring space and re-rendezvouses with the new incarnation."""
        sched_point("Channel.quarantine_consumer", key=("chan", id(self)))
        with self._lock:
            if self._replay:
                for item in reversed(self._replay):
                    self._queue.appendleft(item)
                self.stats.replayed += len(self._replay)
                self._replay = []
            self._delivered_seq = self._acked_delivered_seq
            self._epoch = max(self._epoch, epoch)
            self._event_locked("consumer", f"quarantine:epoch={epoch}")
            if self._tracer is not None:
                self._tracer.instant("recovery", "channel.quarantine_consumer",
                                     self.consumer[0], self.consumer[1],
                                     edge=self.name, epoch=epoch)
            self._lock.notify_all()
        self._notify_listeners()

    def poison(self, task: str, instance: int, error: BaseException) -> None:
        """Producer failed permanently: wake blocked consumers with a
        ``ChannelError`` naming the dead task (chained to its exception)
        instead of letting them time out.  Already-queued payloads still
        deliver first -- they were produced before the failure."""
        with self._lock:
            self._poison = (task, instance, error)
            self._event_locked("producer", "poison")
            if self._tracer is not None:
                self._tracer.instant("recovery", "channel.poison", task,
                                     instance, edge=self.name,
                                     error=type(error).__name__)
            self._lock.notify_all()
        self._notify_listeners()

    def abandon_consumer(self) -> None:
        """Consumer gone for good (dropped / failed permanently): queued
        payloads are discarded and every future ``offer`` becomes a counted
        drop, so the producer runs on unimpeded instead of parking in the
        rendezvous wait until the join deadline."""
        with self._lock:
            self._abandoned = True
            for item in self._queue:
                self._discard_item_locked(item)
            self._queue.clear()
            self._event_locked("consumer", "abandoned")
            self._lock.notify_all()
        self._notify_listeners()

    # ------------------------------------------------------- elastic rescale
    def interrupt_consumer(self, exc: BaseException) -> None:
        """Pull the consumer out of this channel: the next (or currently
        blocked) ``get``/``try_get`` raises ``exc`` instead of delivering.
        Used by the rescale protocol to stop sibling instances at a step
        boundary; not an error path -- queued data stays queued and is
        re-cut for the new partition."""
        sched_point("Channel.interrupt_consumer", key=("chan", id(self)))
        with self._lock:
            self._interrupt = exc
            self._event_locked("consumer", "interrupt")
            if self._tracer is not None:
                self._tracer.instant("rescale", "channel.interrupt",
                                     self.consumer[0], self.consumer[1],
                                     edge=self.name)
            self._lock.notify_all()
        self._notify_listeners()

    def rescale_release_producer(self) -> None:
        """Retire-side grace: complete any blocked ``offer`` immediately
        (the ring may transiently exceed ``queue_depth``) so the feeding
        producer drains out of its rendezvous before the channel swap."""
        sched_point("Channel.rescale_release_producer", key=("chan", id(self)))
        with self._lock:
            self._grace = True
            self._event_locked("producer", "rescale_grace")
            self._lock.notify_all()
        self._notify_listeners()

    def rescale_snapshot(self) -> Dict[str, Any]:
        """Counters + every step the surgery may need to re-cut: the
        retention ring (acked), the replay buffer (delivered, unacked) and
        the queue (undelivered).  Items may still be payload *futures*; the
        caller resolves them outside this lock."""
        sched_point("Channel.rescale_snapshot", key=("chan", id(self)))
        with self._lock:
            return {
                "serve_seq": self._serve_seq,
                "acked_seq": self._acked_seq,
                "close_count": self._close_count,
                "acked_close_count": self._acked_close_count,
                "delivered_seq": self._delivered_seq,
                "acked_delivered_seq": self._acked_delivered_seq,
                "done": self._done,
                "items": list(self._retained) + list(self._replay)
                         + list(self._queue),
            }

    def rescale_adopt(self, *, serve_seq: int, acked_seq: int,
                      close_count: int, acked_close_count: int, done: bool,
                      epoch: int, delivered_floor: int) -> None:
        """Initialize a freshly built channel as the continuation of a
        retired edge at a new partition: producer-side counters carry over
        verbatim (the producer's serve ordinals and flow-control phase must
        not restart), the consumer-side watermark rewinds to the consistent
        cut so the preloaded replay delivers, and the epoch is bumped past
        every retired incarnation."""
        sched_point("Channel.rescale_adopt", key=("chan", id(self)))
        with self._lock:
            self._serve_seq = serve_seq
            self._acked_seq = acked_seq
            self._close_count = close_count
            self._acked_close_count = acked_close_count
            self._delivered_seq = delivered_floor
            self._acked_delivered_seq = delivered_floor
            self._done = bool(done)
            self._epoch = max(self._epoch, epoch)
            self._event_locked("producer", f"rescale_adopt:epoch={epoch}")

    def rescale_preload(self, payload: File, seq: int) -> None:
        """Queue one re-partitioned replay payload on an adopted channel
        (bypasses flow control: the seq was already assigned -- and any
        some/latest skipping already applied -- on the retired edge)."""
        sched_point("Channel.rescale_preload", key=("chan", id(self)))
        with self._lock:
            self._queue.append(("memory", payload, seq, self._epoch, None))
            self.stats.replayed += 1
            self.stats.served += 1
            self._event_locked("producer", "rescale_replay")
            self._lock.notify_all()
        self._notify_listeners()

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def set_depth(self, depth: int) -> None:
        """Retune the per-edge prefetch depth at runtime (autotuner hook).

        The new depth is applied under the channel lock, then the in-flight
        semaphore is resized: growing wakes producers blocked in ``offer``;
        shrinking lets the excess in-flight preps drain without interrupting
        any of them.  Only valid on a channel built with prefetch enabled
        (``self._prefetch_sem`` exists); depth must stay >= 1 so a producer
        already committed to the async path can never block forever on a
        zero-limit semaphore.
        """
        depth = int(depth)
        if depth < 1:
            raise ValueError(f"runtime prefetch depth must be >= 1, got {depth}")
        if self._prefetch_sem is None:
            raise ValueError(
                f"channel {self.name} was built without prefetch; "
                f"set prefetch >= 1 (or autotune:) in the workflow YAML")
        with self._lock:
            self.prefetch = depth
            self._prefetch_sem.resize(depth)

    @property
    def max_prefetch_depth(self) -> int:
        """Upper bound on this edge's depth: the autotune max if autotuned,
        else the static depth (used to size the run's prefetch pool)."""
        return self.autotune[1] if self.autotune is not None else self.prefetch

    def _on_prep_done(self, fut: Future) -> None:
        """Done-callback for every submitted prep: completion, error, and
        shutdown-cancel alike release the edge's depth slot and close the
        in-flight gauge; a cancelled prep (pool shutdown, or a `latest`
        edge dropping a stale step) also counts as ``prefetch_cancelled``."""
        self._prefetch_sem.release()
        cancelled = fut.cancelled()
        with self._lock:
            self.stats.inflight_preps -= 1
            if cancelled:
                self.stats.prefetch_cancelled += 1
            inflight = self.stats.inflight_preps
        tr = self._tracer
        if tr is not None:
            tr.counter(f"inflight:{self.name}", inflight)
        if cancelled:
            transport_stats().record_prefetch_cancelled()

    def add_listener(self, mux: ChannelMux) -> None:
        with self._lock:
            self._listeners.append(mux)

    def remove_listener(self, mux: ChannelMux) -> None:
        with self._lock:
            try:
                self._listeners.remove(mux)
            except ValueError:
                pass

    def _notify_listeners(self) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for mux in listeners:
            mux.notify()

    def matches_file(self, filename: str) -> bool:
        # bidirectional: either side's pattern may be the more general one.
        # Memoized per channel: every serve/open probes every channel, and the
        # reverse compile would otherwise run each time for non-matches.
        hit = self._match_cache.get(filename)
        if hit is None:
            hit = self._file_matcher.matches(filename) or compile_file_pattern(
                filename
            ).matches(self.filename_pattern)
            if len(self._match_cache) < 4096:  # bound pathological filename churn
                self._match_cache[filename] = hit
        return hit

    def filter_file(self, f: File) -> File:
        """Data-centric selection: ship only the datasets this port asked for.

        Zero-copy mode grafts CoW views; a port with declared M->N ownership
        (``redistribute``) consults the plan cache and ships only this
        consumer instance's owned slab of each dataset.  Legacy mode
        materializes a private copy per dataset (the seed's per-channel
        deep-copy behaviour).
        """
        out = File(f.filename)
        out.attrs.update(f.attrs)
        for ds in f.visit_datasets():
            if any(m.matches(ds.path) for m in self._dset_matchers):
                if self.redistribute is not None:
                    # the slab contract holds in legacy mode too (the copy is
                    # eager there instead of CoW-deferred)
                    self._attach_redistributed(out, ds)
                elif self.zero_copy:
                    out.attach_view(ds)
                else:
                    buf = _host_copy(ds.read_direct())  # eager materialization
                    transport_stats().record_copy(buf.nbytes)
                    nd = out.create_dataset(ds.path, data=buf, copy=False)
                    nd.attrs.update(ds.attrs)
                    nd.ownership = ds.ownership
        return out

    def _attach_redistributed(self, out: File, ds) -> None:
        """Attach only this consumer instance's owned blocks of ``ds``.

        The M->N plan (src = the dataset's producer BlockOwnership, dst = the
        port-declared consumer decomposition) comes from the process-wide
        ``PlanCache`` -- the O(M*N) intersection runs once per shape/ownership
        key, not per step.  Two fast paths:

        * aligned decompositions (every dst block == one src block) ship a
          whole-dataset CoW view -- zero bytes *copied*, no rearrangement;
          the payload bytes (what a wire would carry rank-to-rank) still
          count as shipped;
        * otherwise the instance's union box ships as a CoW ``slab_view``
          (still zero copies in-process; the slab's nbytes is what would
          cross the wire) with per-rank dst blocks as its ownership map.

        Legacy (``zero_copy=False``) channels honor the same contract with
        eager copies: the consumer still receives only its owned slab, with
        the same attrs and ownership map.
        """
        spec = self.redistribute
        shape = ds.shape
        if not shape or spec.axis >= len(shape):
            out.attach_view(ds)  # scalars / axis mismatch: no decomposition
            return
        if ds.ownership is not None and ds.ownership.blocks:
            src = [ds.ownership.blocks[r] for r in sorted(ds.ownership.blocks)]
        else:
            src = [((0,) * len(shape), shape)]  # unowned: one global block
        dst, slot_boxes = spec.dst_boxes(shape)
        plan = plan_cache().get(src, dst, shape, ds.dtype)

        my_ranks = spec.my_ranks()
        planned = plan.dst_bytes(my_ranks)
        own = BlockOwnership()
        for local, r in enumerate(my_ranks):
            own.add(local, dst[r][0], dst[r][1])

        stats = transport_stats()
        if plan.aligned and spec.nslots == 1:
            if self.zero_copy:
                v = out.attach_view(ds)
            else:
                buf = _host_copy(ds.read_direct())
                stats.record_copy(buf.nbytes)
                v = out.create_dataset(ds.path, data=buf, copy=False)
                v.attrs.update(ds.attrs)
            v.ownership = own
            stats.record_redistribution(planned, ds.nbytes, ds.nbytes,
                                        aligned=True)
            return
        box_starts, box_shape = slot_boxes[spec.slot]
        if self.zero_copy:
            v = out.attach_slab(ds, box_starts, box_shape)
        else:
            slc = tuple(slice(s, s + n) for s, n in zip(box_starts, box_shape))
            buf = _host_copy(ds.read_direct()[slc])
            stats.record_copy(buf.nbytes)
            v = out.create_dataset(ds.path, data=buf, copy=False)
            v.attrs.update(ds.attrs)
        v.ownership = own
        v.attrs["redist_global_shape"] = list(shape)
        v.attrs["redist_box_starts"] = list(box_starts)
        stats.record_redistribution(planned, v.nbytes, ds.nbytes, aligned=False)

    # ------------------------------------------------------------- producer
    def offer(self, f: File, _payload_cache: Optional[Dict[Any, File]] = None) -> bool:
        """Producer-side serve with flow control. Returns True if served.

        Called from the VOL layer at (after-)file-close time, mirroring
        LowFive's serve-on-close. The flow-control decision happens *before*
        any data is filtered, copied, or queued, so a skipped timestep costs
        nothing -- that is the entire point of the paper's §3.6.

        ``_payload_cache`` (passed by ``VOL.serve_all``) shares ONE filtered
        payload across every fan-out channel with the same dataset selection:
        each channel ships a structural ``File.view()`` over the same buffers.

        Prefetching channels (``self.prefetch`` > 0, default for
        redistributing ports) enqueue a *future* of the payload instead:
        ``_prepare`` runs on the shared prefetch pool, overlapping slab
        construction with this producer's rendezvous wait and with the
        consumer's compute on the step it is still holding.  At most
        ``self.prefetch`` preps are in flight per edge (per-channel
        semaphore); a producer outrunning its own preps blocks here.
        Payload bytes are then accounted at delivery time (``_deliver``),
        when the future's size is known.
        """
        with self._lock:
            if self._abandoned:
                # consumer dropped/dead: the serve is a counted no-op
                self.stats.dropped += 1
                self._event_locked("producer", "skip_abandoned")
                return False
            self._close_count += 1
            step = self._close_count - 1
            if self.strategy == FlowControl.SOME and (self._close_count % self.freq) != 0:
                self.stats.dropped += 1
                self._event_locked("producer", "skip_some")
                return False
            if self.strategy == FlowControl.LATEST and not self._waiters:
                # No incoming request from the consumer: skip this timestep
                # and proceed to generating the next one (paper §3.6).
                self.stats.dropped += 1
                self._event_locked("producer", "skip_latest")
                return False
            # every SERVED close gets a monotonic seq; a restarted producer
            # rewound to its last ack regenerates the same seqs, so serves
            # the consumer already delivered are recognized here and skipped
            # (exactly-once delivery across producer restarts)
            self._serve_seq += 1
            seq = self._serve_seq
            if seq <= self._delivered_seq:
                self.stats.deduped += 1
                self._event_locked("producer", "dedup_replay")
                return True
            epoch = self._epoch
            # depth is read under the lock: the autotuner retunes it at
            # runtime via set_depth, also under this lock
            depth = self.prefetch

        # THE unlocked window of the serve protocol: between the flow-control
        # decision above and the enqueue below, a quarantine/rescale/abandon
        # can land -- the explorer preempts here
        sched_point("Channel.offer:prepare", key=("chan", id(self)))
        # keep the source File only when prep retry may need it (recovery
        # runs): retry re-filters from the producer's CoW tree at delivery
        src = f if (depth and self._prep_retry) else None
        if depth:
            # per-edge depth: block until one of this channel's in-flight
            # preps completes (backpressure), never starving other edges
            # of pool workers
            self._prefetch_sem.acquire()
            try:
                pool = self._prefetch_pool or _prefetch_pool()
                fut = pool.submit(self._prepare_timed, f, _payload_cache,
                                  step, edge=self.name, weight=self.weight)
            except BaseException:
                self._prefetch_sem.release()
                raise
            with self._lock:
                self.stats.inflight_preps += 1
                inflight = self.stats.inflight_preps
            if self._tracer is not None:
                self._tracer.counter(f"inflight:{self.name}", inflight)
            # release the slot + close the gauge on completion, error, or
            # cancel alike (shutdown AND the `latest` stale-prep drop)
            fut.add_done_callback(self._on_prep_done)
            item: Tuple[str, Any, int, int, Any] = ("future", fut, seq, epoch, src)
            payload_bytes = None
        else:
            payload, payload_bytes = self._prepare(f, _payload_cache)
            item = (payload[0], payload[1], seq, epoch, None)
        t0 = time.monotonic()
        with self._lock:
            if self.strategy == FlowControl.LATEST and depth:
                # a newer step supersedes any queued payload future whose
                # prep has not finished: cancel it rather than prepare
                # bytes nobody will read (`latest` semantics)
                self._drop_stale_preps_locked()
            self._event_locked("producer", "wait_begin")
            while (len(self._queue) >= self.queue_depth and not self._done
                   and not self._abandoned and not self._grace):
                if self._supervisor is not None:
                    # a producer parked in the rendezvous is starved, not
                    # stalled: keep its heartbeat alive for the watchdog
                    self._supervisor.heartbeat(*self.producer)
                    self._lock.wait(
                        timeout=self._supervisor.wait_quantum(self.producer[0]))
                else:
                    self._lock.wait()
            now = time.monotonic()
            self.stats.producer_wait_s += now - t0
            self._event_locked("producer", "wait_end")
            tr = self._tracer
            if self._abandoned:
                if tr is not None:
                    tr.record("channel", "channel.offer", self.producer[0],
                              self.producer[1], t0, now, step=step,
                              edge=self.name, aborted=True)
                self._discard_item_locked(item)
                return False
            if self._done:
                if tr is not None:
                    tr.record("channel", "channel.offer", self.producer[0],
                              self.producer[1], t0, now, step=step,
                              edge=self.name, aborted=True)
                return False
            self._queue.append(item)
            # HB edge half 1 (offer -> get): the consumer that pops seq
            # joins this clock in _take_locked
            hb_publish(("chan", id(self), seq))
            self.stats.served += 1
            if payload_bytes is not None:
                self.stats.bytes_moved += payload_bytes
            self._event_locked("producer", "serve")
            if tr is not None:
                tr.record("channel", "channel.offer", self.producer[0],
                          self.producer[1], t0, now, step=step,
                          flow=("s", flow_id(self.name, seq)), edge=self.name)
                tr.counter(f"qdepth:{self.name}", len(self._queue), t=now)
            self._lock.notify_all()
        self._notify_listeners()
        return True

    def _drop_stale_preps_locked(self) -> int:
        """Drop queued-but-unfinished payload futures on a `latest` edge
        (caller holds ``self._lock``; a newer step is about to be queued).

        A prep that has not started is cancelled -- its done-callback
        releases the depth slot and counts ``prefetch_cancelled``.  A prep
        already running cannot be stopped, but it leaves the queue here so
        its bytes are never delivered; it is counted as cancelled directly
        (its done-callback will see a *completed* future and only close the
        gauge).  Finished futures stay queued: their bytes exist, and they
        are still the freshest data until the new step lands.
        """
        kept: Deque[Tuple[str, Any, int, int, Any]] = deque()
        dropped = 0
        for item in self._queue:
            kind, payload = item[0], item[1]
            if kind == "future" and not payload.done():
                dropped += 1
                self.stats.dropped += 1
                self._event_locked("producer", "drop_stale_prep")
                if not payload.cancel():
                    self.stats.prefetch_cancelled += 1
                    transport_stats().record_prefetch_cancelled()
            else:
                kept.append(item)
        self._queue = kept
        if dropped:
            self._lock.notify_all()  # a freed ring slot unblocks rendezvous
        return dropped

    def _prepare_timed(
        self, f: File, cache: Optional[Dict[Any, File]] = None, step: int = 0
    ) -> Tuple[Tuple[str, Any], int]:
        """``_prepare`` on the prefetch executor, timed for the overlap
        accounting (prepared vs consumer-blocked seconds).

        Fault-injection point ``prefetch`` fires here (on the pool worker,
        keyed to the *producer* task): an injected crash lands in the
        future's exception and surfaces at delivery -- exactly the surface a
        real prep I/O error would use.  The synchronous retry path goes
        through ``_prepare`` directly and so never re-fires the fault."""
        sup = self._supervisor
        if sup is not None:
            sup.fire(self.producer[0], self.producer[1], "prefetch", step)
        t0 = time.monotonic()
        item, payload_bytes = self._prepare(f, cache)
        dt = time.monotonic() - t0
        transport_stats().record_prefetch_prepare(dt)
        with self._lock:
            self.stats.prefetch_prepared_s += dt
        tr = self._tracer
        if tr is not None:
            # pool workers get their own pseudo-process track: overlapping
            # preps must not stack onto a task instance's timeline
            tr.record("prefetch", "prefetch.prep", "pool",
                      threading.get_ident() & 0xF, t0, t0 + dt, step=step,
                      edge=self.name, bytes=payload_bytes)
        return item, payload_bytes

    def _prepare(
        self, f: File, cache: Optional[Dict[Any, File]] = None
    ) -> Tuple[Tuple[str, Any], int]:
        """Build this channel's payload; returns (queue item, payload bytes).

        The fan-out payload cache key includes the redistribution spec: two
        consumer instances of an M->N port own *different* slabs, so only
        channels with the same selection AND the same owned blocks may share
        one filtered payload.

        Prefetching channels may run this concurrently on the executor; the
        cache get/set are GIL-atomic and a lost race merely duplicates the
        (cheap, CoW) filter work for one step, never corrupts a payload.
        """
        if self.zero_copy:
            key = (tuple(self.dset_patterns), self.redistribute)
            base = cache.get(key) if cache is not None else None
            if base is None:
                base = self.filter_file(f)
                if cache is not None:
                    cache[key] = base
            sub = base.view()  # per-channel tree, shared buffers
        else:
            sub = self.filter_file(f)
        payload_bytes = sub.total_bytes()
        if self.mode == "file":
            # Spill through "disk" -- the paper's ``file: 1`` transport path.
            # One container per served step so queued (queue_depth > 1) and
            # concurrently-read spills never clobber each other.
            with self._lock:
                seq = self._spill_seq
                self._spill_seq += 1
            base_name = f"{os.path.basename(f.filename)}.{_sanitize(self.name)}.{seq:06d}"
            path = sub.save(self.spill_dir, basename=base_name)
            return ("file", path), payload_bytes
        return ("memory", sub), payload_bytes

    def finish(self) -> None:
        """Producer signals all-done (query protocol: empty filename list)."""
        with self._lock:
            self._done = True
            self._event_locked("producer", "done")
            self._lock.notify_all()
        self._notify_listeners()

    # ------------------------------------------------------------- consumer
    def _waiter_enter_locked(self) -> None:
        """Register the current thread as a blocked consumer (lock held).

        Keyed by thread ident with a nesting depth: the VOL mux registering
        via ``set_consumer_waiting`` and the same thread then blocking in
        ``get`` collapse to ONE waiter, so the `latest` rendezvous fan-in
        decision sees distinct blocked consumers, not registration counts.
        """
        me = threading.get_ident()
        first = me not in self._waiters
        self._waiters[me] = self._waiters.get(me, 0) + 1
        if first:
            self._event_locked("consumer", "wait_begin")
            self._lock.notify_all()  # wake a producer doing `latest` rendezvous

    def _waiter_exit_locked(self) -> None:
        """Drop one nesting level; the thread stops counting at depth 0."""
        me = threading.get_ident()
        depth = self._waiters.get(me, 0) - 1
        if depth > 0:
            self._waiters[me] = depth
        else:
            self._waiters.pop(me, None)
            self._event_locked("consumer", "wait_end")

    def waiting_consumers(self) -> int:
        """Distinct consumer threads currently counted as blocked here."""
        with self._lock:
            return len(self._waiters)

    def _take_locked(self) -> Tuple[str, Any, int, int, Any]:
        """Pop under self._lock (caller holds it) and wake the producer.

        The dedup watermark advances HERE, at pop time, not at the end of
        ``_deliver``: delivery runs outside the lock (future result, file
        load), and a producer quarantine+replay landing in that window
        would re-serve a step the consumer has already taken -- the
        replayed serve passes the offer-side ``seq <= _delivered_seq``
        check against the stale watermark and the step delivers twice
        (found by the schedule explorer on the crash_replay scenario).
        ``quarantine_consumer`` still rewinds the watermark to the last
        consumer ack, so consumer-restart replay is unaffected."""
        item = self._queue.popleft()
        if item[2] > self._delivered_seq:
            self._delivered_seq = item[2]
        hb_consume(("chan", id(self), item[2]))  # HB edge half 2 (offer -> get)
        self._lock.notify_all()
        return item

    def _deliver(self, item: Tuple[str, Any, int, int, Any]) -> File:
        kind, payload, seq, epoch, src = item
        if kind == "future":
            fut: "Future[Tuple[Tuple[str, Any], int]]" = payload
            hit = fut.done()
            t0 = time.monotonic()
            try:
                inner, payload_bytes = fut.result()  # re-raises prepare errors
                fail = None
            except BaseException as e:
                fut._wilkins_observed = True  # consumer saw it: not "dropped"
                fail = e
            if fail is not None:
                if (self._prep_retry and src is not None
                        and not isinstance(fail, CancelledError)):
                    # Recovery path: the prep is pure (filter + CoW views of
                    # the producer's File), so re-run it synchronously here.
                    # Injected faults live in _prepare_timed, never here.
                    inner, payload_bytes = self._prepare(src)
                    with self._lock:
                        self.stats.prep_retries += 1
                        self._event_locked("consumer", "prep_retry")
                else:
                    # A payload that failed to prepare must not leave the
                    # producer parked forever in the rendezvous wait (the
                    # sync path failed fast inside offer; the async path
                    # surfaces the error here, in the consumer that asked
                    # for the data, so mark the channel done to unblock and
                    # stop the producer).
                    with self._lock:
                        self._done = True
                        self._event_locked("consumer", "prepare_error")
                        self._lock.notify_all()
                    self._notify_listeners()
                    raise fail
            blocked = 0.0 if hit else time.monotonic() - t0
            transport_stats().record_prefetch(hit, blocked_s=blocked)
            with self._lock:
                self.stats.bytes_moved += payload_bytes
                if hit:
                    self.stats.prefetch_hits += 1
                else:
                    self.stats.prefetch_misses += 1
                    self.stats.prefetch_blocked_s += blocked
            tr = self._tracer
            if tr is not None:
                # zero-length on a hit: still carries the cache verdict and
                # the payload bytes for the per-edge rollup
                tr.record("prefetch", "prefetch.wait", self.consumer[0],
                          self.consumer[1], t0, t0 + blocked, edge=self.name,
                          cache="hit" if hit else "miss",
                          bytes=payload_bytes)
            kind, payload = inner
        if kind == "file":
            f = File.load(payload, mmap=True)
            try:
                os.unlink(payload)  # np.memmap keeps the mapping alive (POSIX)
            except OSError:
                pass
        else:
            f = payload
        with self._lock:
            self._event_locked("consumer", "recv")
            if seq > self._delivered_seq:
                self._delivered_seq = seq
            if self._replay_enabled:
                # a structural CoW view: consumer writes materialize private
                # copies in the consumer's tree, the replay copy stays intact
                self._replay.append(("memory", f.view(), seq, epoch, None))
        return f

    def get(self, timeout: Optional[float] = None) -> Optional[File]:
        """Consumer-side blocking receive.

        Returns the next ``File``; ``None`` means the producer is all-done
        (query protocol).  If ``timeout`` elapses first, raises
        ``ChannelTimeout`` -- distinct from producer-done, and the elapsed
        wait still lands in ``consumer_wait_s``.  If the producer FAILED
        (the driver poisoned the channel), raises ``ChannelError`` naming
        the dead task immediately -- a blocked consumer is woken, it does
        not wait out its timeout.  Data queued before the failure still
        delivers first.
        """
        check_blocking("Channel.get")
        sched_point("Channel.get", key=("chan", id(self)))
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        with self._lock:
            if self._interrupt is not None:
                raise self._interrupt
            self._waiter_enter_locked()
            try:
                while (not self._queue and not self._done
                       and self._poison is None and self._interrupt is None):
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        if not _in_mux_wait_scope(self):
                            self.stats.consumer_wait_s += time.monotonic() - t0
                        self._event_locked("consumer", "timeout")
                        if self._tracer is not None:
                            self._tracer.record(
                                "channel", "channel.get", self.consumer[0],
                                self.consumer[1], t0, time.monotonic(),
                                edge=self.name, aborted=True, why="timeout")
                        raise ChannelTimeout(
                            f"{self.name}: no data within {timeout}s")
                    if self._supervisor is not None:
                        # a consumer parked on an empty channel is starved,
                        # not stalled: keep its heartbeat alive
                        self._supervisor.heartbeat(*self.consumer)
                        q = self._supervisor.wait_quantum(self.consumer[0])
                        remaining = q if remaining is None else min(
                            remaining, q)
                    self._lock.wait(timeout=remaining)
                now = time.monotonic()
                if not _in_mux_wait_scope(self):
                    self.stats.consumer_wait_s += now - t0
                tr = self._tracer
                if self._interrupt is not None:
                    if tr is not None:
                        tr.record("channel", "channel.get", self.consumer[0],
                                  self.consumer[1], t0, now, edge=self.name,
                                  aborted=True, why="interrupt")
                    raise self._interrupt
                if self._queue:
                    item = self._take_locked()
                    if tr is not None:
                        tr.record("channel", "channel.get", self.consumer[0],
                                  self.consumer[1], t0, now,
                                  flow=("f", flow_id(self.name, item[2])),
                                  edge=self.name)
                        tr.counter(f"qdepth:{self.name}",
                                   len(self._queue), t=now)
                elif self._poison is not None:
                    if tr is not None:
                        tr.record("channel", "channel.get", self.consumer[0],
                                  self.consumer[1], t0, now, edge=self.name,
                                  aborted=True, why="poison")
                    raise self._poison_error_locked()
                else:
                    return None  # all done
            finally:
                self._waiter_exit_locked()
        return self._deliver(item)

    def _poison_error_locked(self) -> ChannelError:
        """Build the poison-pill exception (caller holds the lock, and
        RAISES the result -- chained to the producer's own error)."""
        task, inst, cause = self._poison
        self._event_locked("consumer", "poisoned")
        err = ChannelError(
            f"{self.name}: producer task {task!r} (instance {inst}) failed "
            f"permanently: {type(cause).__name__}: {cause}",
            task=task, instance=inst)
        err.__cause__ = cause
        return err

    def try_get(self) -> Any:
        """Non-blocking receive: a ``File``, ``None`` (producer all-done), or
        ``NO_DATA`` (queue empty, producer still live).  Raises
        ``ChannelError`` if the producer failed permanently (poison pill --
        also how ``ChannelMux`` scan loops learn of a dead producer)."""
        with self._lock:
            if self._interrupt is not None:
                raise self._interrupt
            if self._queue:
                item = self._take_locked()
            elif self._poison is not None:
                raise self._poison_error_locked()
            elif self._done:
                return None
            else:
                return NO_DATA
        return self._deliver(item)

    def set_consumer_waiting(self, waiting: bool) -> None:
        """Mark the consumer as blocked on this channel (used by the VOL
        multiplexer so the `latest` strategy sees fan-in waiters).

        Idempotent per thread: a consumer the mux already registered that
        then blocks in ``get`` on the same channel counts once."""
        with self._lock:
            if waiting:
                self._waiter_enter_locked()
            else:
                self._waiter_exit_locked()

    def peek_pending(self) -> bool:
        with self._lock:
            return bool(self._queue)

    def is_done(self) -> bool:
        # a poisoned channel with nothing left to deliver is terminal too:
        # the driver's relaunch loop must stop relaunching its consumer
        with self._lock:
            return (self._done or self._poison is not None) and not self._queue

    def __repr__(self) -> str:
        return (
            f"<Channel {self.name} {self.producer}->{self.consumer} "
            f"{self.filename_pattern} mode={self.mode} fc={self.strategy}/{self.freq} "
            f"depth={self.queue_depth}>"
        )


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)
