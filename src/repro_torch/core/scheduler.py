"""Adaptive flow-control scheduling: weighted-fair prefetch arbitration,
prefetch-depth autotuning, and a telemetry timeline.

Wilkins' headline claim is that tasks with *disparate data rates* couple
without code changes because the transport absorbs the rate mismatch.  The
static knobs (``io_freq`` -> all/some/latest, per-edge ``prefetch: N``) make
the user hand-tune that absorption per workflow; this module moves the
arbitration to *runtime*, SIM-SITU-style:

* **Queue policies** (``FifoPolicy`` / ``FairPolicy``) -- the PrefetchPool's
  queue discipline is pluggable.  ``fifo`` (the default) is bit-for-bit the
  old single FIFO deque; ``fair`` is deficit-weighted round-robin (DWRR) over
  per-edge queues: each edge earns ``quantum * weight`` credits per round and
  spends one credit per payload prep, so a YAML ``weight: 3`` edge gets ~3x
  the prep completions of a ``weight: 1`` edge under contention while no edge
  ever starves.

* **DepthAutotuner** -- a feedback controller that widens or narrows each
  autotuned edge's prefetch depth within ``[min, max]`` bounds every K step
  events, driven by the per-edge deltas of the existing
  ``prefetch_hits/misses/prepared_s/blocked_s`` counters:

  ========================================  =======================
  per-tick counter deltas                   decision
  ========================================  =======================
  cancelled > 0                             shrink (wasted preps)
  blocked_s > 0 or misses > hits            grow   (consumer waits)
  served > 0, misses == 0, blocked ~= 0,    shrink after 2 idle
  in-flight < depth                         ticks  (depth unused)
  otherwise                                 hold
  ========================================  =======================

  Depth changes go through ``Channel.set_depth``, which resizes the edge's
  ``ResizableSemaphore`` under the channel lock -- in-flight preps above a
  shrunken limit simply drain; new acquires see the new limit.

* **TelemetryTimeline** -- a bounded ring of timestamped per-edge snapshots
  (queue occupancy, in-flight preps, depth, blocked/prepared seconds, bytes
  shipped, hit/miss/cancel counters) sampled at every autotuner tick and once
  at teardown.  ``WorkflowReport.summary()`` surfaces it and ``export()`` /
  ``load()`` round-trip it through JSON for SIM-SITU-style offline replay.

* **SchedulerRuntime** -- the per-run object the driver owns: it builds the
  pool's queue policy from the YAML ``scheduler:`` block, counts step events
  (producer file closes, consumer intercepted opens, explicit
  ``TaskComm.step()`` calls -- the vol/comm step-boundary hooks), and fires
  the autotuner + telemetry tick every ``tick_every`` events.

Nothing here imports ``channel``: channels are duck-typed (``name``,
``stats``, ``prefetch``, ``autotune``, ``set_depth``, ``_lock``, ``_queue``),
so ``channel.py`` can import the policies/semaphore without a cycle.
"""

from __future__ import annotations

import json
import threading

from ..analysis.lockcheck import make_condition, make_lock
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Hashable, List, Optional, Sequence, Tuple

__all__ = [
    "QueuePolicy",
    "FifoPolicy",
    "FairPolicy",
    "ResizableSemaphore",
    "SchedulerConfig",
    "DepthAutotuner",
    "AutotuneDecision",
    "TelemetryTimeline",
    "SchedulerRuntime",
    "POLICIES",
]

POLICIES = ("fifo", "fair")


# ---------------------------------------------------------------------------
# queue policies (PrefetchPool scheduler hook)
# ---------------------------------------------------------------------------
class QueuePolicy:
    """Queue discipline for pending payload preps inside the PrefetchPool.

    All methods are called with the pool's condition lock held, so
    implementations need no locking of their own.  Items are opaque to the
    policy (the pool passes ``(future, fn, args)`` tuples).
    """

    name = "abstract"

    def push(self, item: Any, edge: Optional[Hashable] = None,
             weight: int = 1) -> None:
        raise NotImplementedError

    def pop(self) -> Optional[Any]:
        raise NotImplementedError

    def pending(self) -> int:
        raise NotImplementedError

    def drain(self) -> List[Any]:
        """Remove and return every queued item (shutdown cancellation)."""
        raise NotImplementedError

    def __len__(self) -> int:
        return self.pending()


class FifoPolicy(QueuePolicy):
    """One FIFO deque: submission order == service order -- bit-for-bit the
    pre-scheduler PrefetchPool behaviour, and the default."""

    name = "fifo"

    def __init__(self) -> None:
        self._q: Deque[Any] = deque()

    def push(self, item: Any, edge: Optional[Hashable] = None,
             weight: int = 1) -> None:
        self._q.append(item)

    def pop(self) -> Optional[Any]:
        return self._q.popleft() if self._q else None

    def pending(self) -> int:
        return len(self._q)

    def drain(self) -> List[Any]:
        out = list(self._q)
        self._q.clear()
        return out


class FairPolicy(QueuePolicy):
    """Deficit-weighted round-robin over per-edge prep queues.

    Each *active* edge (one with queued preps) is visited in round-robin
    order; on each visit its deficit counter is topped up by
    ``quantum * weight`` and one credit is spent per prep served, so an edge
    with weight W completes ~W preps per round of the competition while a
    weight-1 edge still progresses every round (no starvation).  An edge's
    deficit resets when its queue empties, so a long-idle edge cannot hoard
    credit and burst past everyone when it wakes (standard DWRR).
    """

    name = "fair"

    def __init__(self, quantum: int = 1) -> None:
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.quantum = int(quantum)
        self._queues: Dict[Hashable, Deque[Any]] = {}
        self._active: Deque[Hashable] = deque()  # round-robin visit order
        self._deficit: Dict[Hashable, float] = {}
        self._weights: Dict[Hashable, int] = {}
        self._pending = 0

    def push(self, item: Any, edge: Optional[Hashable] = None,
             weight: int = 1) -> None:
        key = edge if edge is not None else "__anon__"
        self._weights[key] = max(1, int(weight))
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
        if not q:  # edge (re)activates: joins the tail of the round
            self._active.append(key)
            self._deficit[key] = 0.0
        q.append(item)
        self._pending += 1

    def pop(self) -> Optional[Any]:
        # Each non-empty edge needs at most one top-up before it can serve
        # (quantum * weight >= 1), so 2 * len(active) + 1 visits always
        # suffice to find a servable edge when anything is pending.
        for _ in range(2 * len(self._active) + 1):
            if not self._active:
                return None
            key = self._active[0]
            q = self._queues.get(key)
            if not q:  # drained edge: leave the round, forfeit credit
                self._active.popleft()
                self._deficit[key] = 0.0
                continue
            if self._deficit[key] >= 1.0:
                self._deficit[key] -= 1.0
                item = q.popleft()
                self._pending -= 1
                if not q:
                    self._active.popleft()
                    self._deficit[key] = 0.0
                return item
            # credit exhausted: top up, move to the back of the round
            self._deficit[key] += self.quantum * self._weights.get(key, 1)
            self._active.rotate(-1)
        return None

    def pending(self) -> int:
        return self._pending

    def drain(self) -> List[Any]:
        out: List[Any] = []
        for q in self._queues.values():
            out.extend(q)
            q.clear()
        self._active.clear()
        self._deficit.clear()
        self._pending = 0
        return out


def make_policy(name: str, quantum: int = 1) -> QueuePolicy:
    if name == "fifo":
        return FifoPolicy()
    if name == "fair":
        return FairPolicy(quantum=quantum)
    raise ValueError(f"unknown scheduler policy {name!r}; use one of {POLICIES}")


# ---------------------------------------------------------------------------
# resizable bounded semaphore (per-edge prefetch depth)
# ---------------------------------------------------------------------------
class ResizableSemaphore:
    """A BoundedSemaphore whose limit can change at runtime.

    ``threading.BoundedSemaphore`` bakes its value in at construction; depth
    autotuning needs to widen/narrow the per-edge in-flight-prep bound while
    producers are blocked in ``acquire``.  Growing the limit wakes waiters;
    shrinking below the current in-use count simply lets the excess drain --
    no prep is ever interrupted.  Like BoundedSemaphore, releasing more times
    than acquired raises ``ValueError`` (the slot-leak regression tests pin
    both directions).
    """

    def __init__(self, value: int, name: str = "channel.sem:prefetch"):
        if value < 0:
            raise ValueError(f"semaphore value must be >= 0, got {value}")
        self._cond = make_condition(name)
        self._limit = int(value)
        self._in_use = 0

    def acquire(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._in_use >= self._limit:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining)
            self._in_use += 1
            return True

    def release(self) -> None:
        with self._cond:
            if self._in_use <= 0:
                raise ValueError("ResizableSemaphore released too many times")
            self._in_use -= 1
            self._cond.notify()

    def resize(self, limit: int) -> None:
        with self._cond:
            limit = int(limit)
            if limit < 0:
                raise ValueError(f"semaphore limit must be >= 0, got {limit}")
            grew = limit > self._limit
            self._limit = limit
            if grew:
                self._cond.notify_all()

    @property
    def limit(self) -> int:
        with self._cond:
            return self._limit

    @property
    def in_use(self) -> int:
        with self._cond:
            return self._in_use


# ---------------------------------------------------------------------------
# YAML surface
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SchedulerConfig:
    """The top-level ``scheduler:`` block of the workflow YAML.

    policy:     ``fifo`` (default; today's single-deque order, bit-for-bit)
                or ``fair`` (deficit-weighted round-robin by per-inport
                ``weight:``).
    quantum:    DWRR credit top-up multiplier (``fair`` only).
    tick_every: autotuner/telemetry tick period, in step events (producer
                file closes + consumer intercepted opens + ``comm.step()``).
    telemetry:  timeline ring capacity in samples; 0 disables sampling.
    """

    policy: str = "fifo"
    quantum: int = 1
    tick_every: int = 4
    telemetry: int = 256
    #: True when the YAML carried a ``scheduler:`` block.  The driver wires
    #: the per-step VOL hooks only for explicit configs (or when some edge
    #: autotunes), so a workflow that never opted in pays zero per-step
    #: cost -- its report still gets a snapshot and one teardown sample.
    explicit: bool = False

    @classmethod
    def from_yaml(cls, doc: Any) -> "SchedulerConfig":
        if doc is None:
            return cls()
        if not isinstance(doc, dict):
            raise ValueError(
                f"workflow 'scheduler:' must be a mapping, got {type(doc).__name__}")
        unknown = set(doc) - {"policy", "quantum", "tick_every", "telemetry"}
        if unknown:
            raise ValueError(
                f"scheduler: unknown keys {sorted(unknown)} (expected policy, "
                f"quantum, tick_every, telemetry)")
        policy = str(doc.get("policy", "fifo"))
        if policy not in POLICIES:
            raise ValueError(
                f"scheduler: policy {policy!r} is invalid; use one of {POLICIES}")
        quantum = int(doc.get("quantum", 1))
        if quantum < 1:
            raise ValueError(f"scheduler: quantum must be >= 1, got {quantum}")
        tick_every = int(doc.get("tick_every", 4))
        if tick_every < 1:
            raise ValueError(
                f"scheduler: tick_every must be >= 1, got {tick_every}")
        telemetry = int(doc.get("telemetry", 256))
        if telemetry < 0:
            raise ValueError(
                f"scheduler: telemetry capacity must be >= 0 (0 disables), "
                f"got {telemetry}")
        return cls(policy=policy, quantum=quantum, tick_every=tick_every,
                   telemetry=telemetry, explicit=True)


# ---------------------------------------------------------------------------
# depth autotuner
# ---------------------------------------------------------------------------
@dataclass
class AutotuneDecision:
    t: float
    edge: str
    old: int
    new: int
    reason: str

    def as_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "edge": self.edge, "old": self.old,
                "new": self.new, "reason": self.reason}


#: consecutive idle ticks before the autotuner narrows an unused depth
#: (hysteresis so a single quiet tick cannot start a grow/shrink oscillation)
IDLE_TICKS_TO_SHRINK = 2

#: blocked seconds per tick below which the consumer counts as not blocked
BLOCKED_EPS_S = 1e-4


class DepthAutotuner:
    """Per-edge prefetch-depth feedback controller.

    ``tick(channels)`` reads each autotuned channel's per-edge counters,
    diffs them against the previous tick, and applies the decision table in
    the module docstring via ``Channel.set_depth`` (one step per tick, so the
    controller cannot overshoot the signal that drove it).  Decisions are
    kept for the report and the telemetry export.
    """

    def __init__(self) -> None:
        self._last: Dict[str, Dict[str, float]] = {}
        self._idle_ticks: Dict[str, int] = {}
        self.decisions: List[AutotuneDecision] = []
        self.ticks = 0

    def _snapshot(self, ch: Any) -> Tuple[Dict[str, float], int, int]:
        with ch._lock:
            s = ch.stats
            cur = {
                "hits": float(s.prefetch_hits),
                "misses": float(s.prefetch_misses),
                "cancelled": float(s.prefetch_cancelled),
                "blocked_s": float(s.prefetch_blocked_s),
                "served": float(s.served),
            }
            return cur, int(ch.prefetch), int(s.inflight_preps)

    def tick(self, channels: Sequence[Any]) -> List[AutotuneDecision]:
        made: List[AutotuneDecision] = []
        now = time.monotonic()
        for ch in channels:
            if getattr(ch, "autotune", None) is None:
                continue
            amin, amax = ch.autotune
            cur, depth, inflight = self._snapshot(ch)
            last = self._last.get(ch.name)
            self._last[ch.name] = cur
            if last is None:  # first sight of this edge: baseline only
                continue
            d = {k: cur[k] - last[k] for k in cur}
            new, reason = depth, None
            idle_branch = False
            if d["cancelled"] > 0 and depth > amin:
                new, reason = depth - 1, "cancelled preps -> shrink"
            elif (d["blocked_s"] > BLOCKED_EPS_S or d["misses"] > d["hits"]) \
                    and (d["misses"] > 0 or d["blocked_s"] > BLOCKED_EPS_S) \
                    and depth < amax:
                new, reason = depth + 1, "consumer blocked -> grow"
            elif (d["served"] > 0 and d["misses"] == 0
                    and d["blocked_s"] <= BLOCKED_EPS_S
                    and inflight < depth and depth > amin):
                idle_branch = True
                idle = self._idle_ticks.get(ch.name, 0) + 1
                if idle >= IDLE_TICKS_TO_SHRINK:
                    new, reason = depth - 1, "preps idle -> shrink"
                    idle = 0
                self._idle_ticks[ch.name] = idle
            if not idle_branch:
                # the shrink hysteresis counts CONSECUTIVE idle ticks: any
                # grow/cancel/hold tick in between restarts the count
                self._idle_ticks[ch.name] = 0
            if reason is not None and new != depth:
                ch.set_depth(new)
                dec = AutotuneDecision(now, ch.name, depth, new, reason)
                self.decisions.append(dec)
                made.append(dec)
        self.ticks += 1
        return made


# ---------------------------------------------------------------------------
# telemetry timeline
# ---------------------------------------------------------------------------
#: one row per (tick, edge); field order is the JSON schema
SAMPLE_FIELDS = (
    "t", "edge", "queue_len", "inflight", "depth", "served", "dropped",
    "bytes_moved", "prefetch_hits", "prefetch_misses", "prefetch_cancelled",
    "prepared_s", "blocked_s", "producer_wait_s", "consumer_wait_s",
)


class TelemetryTimeline:
    """Bounded ring of timestamped per-edge transport snapshots.

    Sampled at every scheduler tick (and once at teardown) so a run's rate
    mismatch is replayable offline: queue occupancy, in-flight preps, the
    current autotuned depth, cumulative blocked/prepared seconds, and bytes
    shipped, per edge.  ``export``/``load`` round-trip the ring through JSON
    (same per-edge sample counts after a round trip -- the acceptance
    criterion), so SIM-SITU-style simulators can consume real traces.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 0:
            raise ValueError(f"telemetry capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self._lock = make_lock("leaf:telemetry")
        self._samples: Deque[Dict[str, Any]] = deque(maxlen=capacity or None)
        self.dropped = 0
        # discrete lifecycle events (task restarts/drops) -- unlike the
        # sampled rows these are rare and never truncated, so a Gantt
        # consumer can always place every recovery on the timeline
        self._events: List[Dict[str, Any]] = []

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def sample(self, channels: Sequence[Any], t: Optional[float] = None) -> int:
        """Record one snapshot row per channel; returns rows recorded."""
        if not self.enabled:
            return 0
        now = time.monotonic() if t is None else t
        rows: List[Dict[str, Any]] = []
        for ch in channels:
            with ch._lock:
                s = ch.stats
                rows.append({
                    "t": now,
                    "edge": ch.name,
                    "queue_len": len(ch._queue),
                    "inflight": s.inflight_preps,
                    "depth": ch.prefetch,
                    "served": s.served,
                    "dropped": s.dropped,
                    "bytes_moved": s.bytes_moved,
                    "prefetch_hits": s.prefetch_hits,
                    "prefetch_misses": s.prefetch_misses,
                    "prefetch_cancelled": s.prefetch_cancelled,
                    "prepared_s": s.prefetch_prepared_s,
                    "blocked_s": s.prefetch_blocked_s,
                    "producer_wait_s": s.producer_wait_s,
                    "consumer_wait_s": s.consumer_wait_s,
                })
        with self._lock:
            for row in rows:
                if len(self._samples) == self.capacity:
                    self.dropped += 1
                self._samples.append(row)
        return len(rows)

    def record_event(self, kind: str, t: Optional[float] = None,
                     **detail: Any) -> None:
        """Append one discrete lifecycle event (``kind`` plus free-form
        detail, e.g. a task restart with task/instance/attempt/epoch).
        Recorded even when sampling is disabled (capacity 0): recovery
        events must never be invisible."""
        row = {"t": time.monotonic() if t is None else t, "kind": kind}
        row.update(detail)
        with self._lock:
            self._events.append(row)

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        return evs if kind is None else [e for e in evs if e["kind"] == kind]

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._samples)

    def per_edge_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for row in self.samples():
            counts[row["edge"]] = counts.get(row["edge"], 0) + 1
        return counts

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    # ------------------------------------------------------------ JSON I/O
    def to_json(self) -> str:
        with self._lock:
            payload = {
                "version": 1,
                "capacity": self.capacity,
                "dropped": self.dropped,
                "fields": list(SAMPLE_FIELDS),
                "samples": [[row[f] for f in SAMPLE_FIELDS]
                            for row in self._samples],
                "events": list(self._events),
            }
        return json.dumps(payload, sort_keys=True)

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")
        return path

    @classmethod
    def from_json(cls, text: str) -> "TelemetryTimeline":
        doc = json.loads(text)
        fields = doc.get("fields", list(SAMPLE_FIELDS))
        tl = cls(capacity=int(doc.get("capacity", 0)))
        tl.dropped = int(doc.get("dropped", 0))
        for values in doc.get("samples", []):
            tl._samples.append(dict(zip(fields, values)))
        tl._events = [dict(e) for e in doc.get("events", [])]
        return tl

    @classmethod
    def load(cls, path: str) -> "TelemetryTimeline":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# per-run runtime (driver-owned)
# ---------------------------------------------------------------------------
class SchedulerRuntime:
    """Per-``Wilkins.run`` scheduling state: step counting, autotuner ticks,
    and the telemetry timeline.

    Step events arrive from the VOL layer (producer file closes, consumer
    intercepted opens) and from explicit ``TaskComm.step()`` calls; every
    ``tick_every`` events the runtime samples telemetry and runs one
    autotuner pass.  ``close()`` stops event intake and takes a final sample
    so short runs still carry at least one telemetry row.
    """

    def __init__(self, config: SchedulerConfig, channels: Sequence[Any]):
        self.config = config
        self.channels = list(channels)
        self.autotuner = DepthAutotuner()
        self.timeline = TelemetryTimeline(config.telemetry)
        self._lock = make_lock("scheduler:runtime")
        self._tick_lock = make_lock("scheduler:tick")
        self._steps = 0
        self._ticks = 0
        self._restarts = 0
        self._rescales = 0
        self._stalls = 0
        self._step_sources: Dict[str, int] = {}
        self._closed = False

    def make_policy(self) -> QueuePolicy:
        return make_policy(self.config.policy, self.config.quantum)

    @property
    def steps(self) -> int:
        with self._lock:
            return self._steps

    def notify_step(self, source: str = "step") -> None:
        """One step event; fires a tick every ``tick_every`` events."""
        with self._lock:
            if self._closed:
                return
            self._steps += 1
            self._step_sources[source] = self._step_sources.get(source, 0) + 1
            due = (self._steps % self.config.tick_every) == 0
        if due:
            self.tick()

    def notify_restart(self, task: str, instance: int, attempt: int,
                       epoch: int, reason: str) -> None:
        """A task instance is restarting: land it on the telemetry timeline
        (visible to Gantt consumers) and count it.  Drops and permanent
        failures arrive through the same door with their own kind."""
        with self._lock:
            if self._closed:
                return
            self._restarts += 1
        self.timeline.record_event("restart", task=task, instance=instance,
                                   attempt=attempt, epoch=epoch, reason=reason)
        # an immediate sample brackets the recovery window in the ring
        with self._tick_lock:
            self.timeline.sample(self.channels)

    def notify_rescale(self, task: str, old_nslots: int, new_nslots: int,
                       old_nprocs: int, new_nprocs: int, trigger: str,
                       cut_step: int, latency_s: float,
                       reason: str = "") -> None:
        """An elastic rescale completed: old->new size, what triggered it
        (policy / stall / api), the checkpoint step the new incarnation
        resumed from, and how long the surgery took."""
        with self._lock:
            if self._closed:
                return
            self._rescales += 1
        self.timeline.record_event(
            "rescale", task=task, old_nslots=old_nslots,
            new_nslots=new_nslots, old_nprocs=old_nprocs,
            new_nprocs=new_nprocs, trigger=trigger, cut_step=cut_step,
            latency_s=latency_s, reason=reason)
        with self._tick_lock:
            self.timeline.sample(self.channels)

    def notify_stall(self, task: str, instance: int, silent_s: float,
                     timeout_s: float, action: str) -> None:
        """The watchdog declared an instance stalled (no heartbeat for
        ``silent_s`` against a ``timeout_s`` budget) and is applying
        ``action`` (rescale / drop)."""
        with self._lock:
            if self._closed:
                return
            self._stalls += 1
        self.timeline.record_event(
            "stall", task=task, instance=instance, silent_s=silent_s,
            timeout_s=timeout_s, action=action)

    def tick(self) -> None:
        # Serialized: step events fire from many producer/consumer threads,
        # but one tick at a time keeps the autotuner's deltas coherent.
        with self._tick_lock:
            self._ticks += 1
            self.timeline.sample(self.channels)
            if any(getattr(ch, "autotune", None) is not None
                   for ch in self.channels):
                self.autotuner.tick(self.channels)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        with self._tick_lock:
            self.timeline.sample(self.channels)  # final state, always recorded

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            steps = self._steps
            sources = dict(self._step_sources)
        return {
            "policy": self.config.policy,
            "quantum": self.config.quantum,
            "tick_every": self.config.tick_every,
            "steps": steps,
            "step_sources": sources,
            "ticks": self._ticks,
            "decisions": [d.as_dict() for d in self.autotuner.decisions],
            "depths": {ch.name: ch.prefetch for ch in self.channels
                       if getattr(ch, "prefetch", 0)},
            "telemetry_samples": len(self.timeline),
            "telemetry_dropped": self.timeline.dropped,
            "restarts": self._restarts,
            "restart_events": self.timeline.events("restart"),
            "rescales": self._rescales,
            "rescale_events": self.timeline.events("rescale"),
            "stalls": self._stalls,
            "stall_events": self.timeline.events("stall"),
        }
