"""Run-wide span tracing: the lock-sharded ``SpanRecorder`` and its YAML
config (``tracing: {...}`` / ``Wilkins.run(trace=...)``).

Zero-cost-when-off contract: the recorder follows the driver-attachment
pattern of the scheduler/supervisor -- every instrumented layer holds a
nullable ``tracer`` reference that defaults to ``None`` and is wired only
when the run opted in.  An untraced run performs ONE attribute load + None
test per hook site and allocates nothing (the zero-cost test counts
``SpanRecorder`` constructions process-wide).

Lock discipline: every shard lock comes from ``make_lock`` at the ``leaf``
rank (50, innermost), so ``record()`` may be called while holding any core
lock -- ``vol.serve`` (10), ``supervisor`` (20), ``channel.cv`` (30) --
without a rank inversion, and the lockcheck/explore harnesses stay sound.
A shard holder never takes another lock, so no cycle is possible either.

Span model (flat dicts, no open-span handles): every ``record()`` call is
final -- instrumented sites time their interval locally and report it
closed, with an ``aborted`` arg when the interval ended in an interrupt /
poison / crash instead of a delivery.  There is nothing to leak across a
restart or rescale; the span-lifecycle test asserts exactly that.

**Device time** (``device_mark`` / ``record_device``): on a CUDA device a
span may also carry the interval between two timing events recorded on
the stream, as ``args.dev_t0``/``dev_t1`` in monotonic seconds.  The
events wait in the recording shard's ``pending`` list (under the shard
lock, so no new lock) and are resolved when ``spans()`` collects them:
two anchors -- an event recorded on the idle device and waited for, and
the monotonic time read right after -- one taken before the run's first
device mark, one at collection, map the card's clock onto
``time.monotonic()`` linearly, so drift over the run cancels.  No event
object leaves the recorder: the span dicts (and so the export,
``load_trace`` and the flight dumps) hold floats only.  Nothing here
calls a profiler.

The **flight recorder** is a bounded per-shard ring of the most recent
spans; ``mark_failure(reason)`` snapshots the merged ring into
``failure_dumps`` so every failure path (task failure, restart exhaustion,
stall declaration, join timeout) ships the last N spans of what every
instance was doing, alongside the chained error.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.lockcheck import make_lock

__all__ = ["TraceConfig", "SpanRecorder", "flow_id", "span_categories",
           "last_run_spans", "device_to_monotonic"]

#: span taxonomy -- one category per instrumented layer (DESIGN.md
#: "Observability & tracing" documents the member spans of each)
CATEGORIES = ("vol", "channel", "prefetch", "reshard", "checkpoint",
              "recovery", "rescale", "task", "train", "counter", "timeline")

# process-wide construction counter: the zero-cost test asserts an untraced
# run leaves it unchanged (no recorder, hence no spans, was ever allocated)
_created_lock = make_lock("leaf:obs_created")
_CREATED = 0


def created_count() -> int:
    with _created_lock:
        return _CREATED


# the resolved spans of the process's newest finished traced run: set by
# the driver when a traced run finalises (a plain rebinding, no lock), so
# code in the same process reads them after the run's report is gone
_LAST_RUN_SPANS: Optional[List[Dict[str, Any]]] = None


def last_run_spans() -> Optional[List[Dict[str, Any]]]:
    """The span dicts of the newest traced run of this process that has
    finished (success or error path), or ``None`` before the first."""
    return _LAST_RUN_SPANS


def set_last_run_spans(spans: List[Dict[str, Any]]) -> None:
    global _LAST_RUN_SPANS
    _LAST_RUN_SPANS = spans


def device_to_monotonic(ms: float, t_first: float, ms_second: float,
                        t_second: float) -> float:
    """Monotonic seconds of a device event ``ms`` milliseconds after the
    first anchor, which the host saw at ``t_first``, the second anchor lying
    ``ms_second`` after the first and seen at ``t_second``: the linear map
    through both anchors."""
    return t_first + (t_second - t_first) * (ms / ms_second)


def _anchor(device: Any) -> Tuple[Any, float]:
    """An event on ``device``'s current stream, recorded once the device is
    idle and waited for, and the monotonic time the host read right after
    the wait."""
    import torch

    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    ev.synchronize()
    return ev, time.monotonic()


def flow_id(channel_name: str, seq: int) -> int:
    """Deterministic flow-arrow id for one (edge, seq) hand-off: the
    producer's ``offer`` span and the consumer's ``get`` span compute the
    same id independently, matching the ``hb_publish``/``hb_consume``
    happens-before identity ``("chan", id(ch), seq)`` used by the explorer
    (but stable across processes, so exported traces keep their arrows)."""
    return ((zlib.crc32(channel_name.encode()) & 0x7FFFFFFF) << 24) | (
        seq & 0xFFFFFF)


class TraceConfig:
    """Parsed ``tracing:`` block (or the ``Wilkins.run(trace=...)`` value).

    Accepted YAML spellings::

        tracing: true                      # defaults
        tracing: {path: trace.json}        # auto-export on run end
        tracing:
          path: trace.json
          flight_len: 256                  # failure-ring length (spans)
          max_spans: 200000                # retained-span cap (ring keeps
                                           # the newest past it)
          shards: 8                        # recorder lock shards (pow. of 2)
    """

    KEYS = ("path", "flight_len", "max_spans", "shards")

    def __init__(self, path: Optional[str] = None, flight_len: int = 256,
                 max_spans: int = 200_000, shards: int = 8,
                 explicit: bool = False):
        if flight_len < 1:
            raise ValueError(f"tracing flight_len must be >= 1, got {flight_len}")
        if max_spans < 1:
            raise ValueError(f"tracing max_spans must be >= 1, got {max_spans}")
        if shards < 1 or (shards & (shards - 1)) != 0:
            raise ValueError(
                f"tracing shards must be a power of two >= 1, got {shards}")
        self.path = path
        self.flight_len = int(flight_len)
        self.max_spans = int(max_spans)
        self.shards = int(shards)
        self.explicit = explicit

    @classmethod
    def from_yaml(cls, doc: Any) -> Optional["TraceConfig"]:
        """``None`` when the workflow declared no ``tracing:`` block (the
        zero-cost default); otherwise a validated config with unknown keys
        rejected by name (same contract as ``SchedulerConfig.from_yaml``)."""
        if doc is None:
            return None
        if doc is True:
            return cls(explicit=True)
        if doc is False:
            return None
        if not isinstance(doc, dict):
            raise ValueError(
                f"tracing: must be a boolean or a mapping "
                f"{{{', '.join(cls.KEYS)}}}, got {doc!r}")
        unknown = set(doc) - set(cls.KEYS)
        if unknown:
            raise ValueError(
                f"unknown tracing keys {sorted(unknown)} "
                f"(expected {', '.join(cls.KEYS)})")
        return cls(path=doc.get("path"),
                   flight_len=int(doc.get("flight_len", 256)),
                   max_spans=int(doc.get("max_spans", 200_000)),
                   shards=int(doc.get("shards", 8)),
                   explicit=True)

    @classmethod
    def coerce(cls, trace: Any) -> Optional["TraceConfig"]:
        """Normalize the ``Wilkins.run(trace=...)`` argument: ``None``/False
        -> off, ``True`` -> defaults, a path string -> auto-export there, a
        dict -> the YAML spelling, a ``TraceConfig`` -> itself."""
        if trace is None or trace is False:
            return None
        if isinstance(trace, cls):
            return trace
        if trace is True:
            return cls(explicit=True)
        if isinstance(trace, str):
            return cls(path=trace, explicit=True)
        if isinstance(trace, dict):
            return cls.from_yaml(trace)
        raise ValueError(
            f"trace= must be None/bool/path/dict/TraceConfig, got {trace!r}")


class _Shard:
    __slots__ = ("lock", "spans", "ring", "dropped", "pending")

    def __init__(self, index: int, flight_len: int):
        self.lock = make_lock(f"leaf:obs[{index}]")
        self.spans: List[Dict[str, Any]] = []
        self.ring: deque = deque(maxlen=flight_len)
        self.dropped = 0
        # (span, device, opening event, closing event) awaiting spans()
        self.pending: List[Tuple[Dict[str, Any], Any, Any, Any]] = []


class SpanRecorder:
    """Thread-safe span sink, sharded by recording thread.

    ``record`` (closed interval), ``instant`` (point event) and ``counter``
    (gauge sample) all append one flat dict; shard choice is
    ``thread_ident & (nshards - 1)`` so concurrent task threads almost never
    contend on one lock.  ``spans()`` merges the shards sorted by start
    time; ``flight()`` merges the bounded recent-history rings.
    """

    def __init__(self, config: Optional[TraceConfig] = None):
        global _CREATED
        self.config = config or TraceConfig()
        n = self.config.shards
        self._mask = n - 1
        self._shards = [_Shard(i, self.config.flight_len) for i in range(n)]
        self._per_shard_cap = max(self.config.flight_len,
                                  self.config.max_spans // n)
        self.failure_dumps: List[Dict[str, Any]] = []
        self._dump_lock = make_lock("leaf:obs_dumps")
        self.t_origin = time.monotonic()
        # device -> the first anchor (event, monotonic s); set once per
        # device by ``device_mark`` (``dict.setdefault``: no lock)
        self._anchors: Dict[Any, Tuple[Any, float]] = {}
        with _created_lock:
            _CREATED += 1

    # ------------------------------------------------------------- recording
    def record(self, cat: str, name: str, task: str, instance: int,
               t0: float, t1: float, step: Optional[int] = None,
               flow: Optional[Tuple[str, int]] = None, **args: Any) -> None:
        """One closed duration span (Perfetto "X").  ``flow`` is
        ``("s", id)`` on the producing side of a hand-off and ``("f", id)``
        on the consuming side; the exporter turns the pair into an arrow."""
        self._push({"ph": "X", "cat": cat, "name": name, "task": task,
                    "instance": instance, "t0": t0, "t1": t1, "step": step,
                    "flow": flow, "args": args or None})

    def instant(self, cat: str, name: str, task: str, instance: int,
                t: Optional[float] = None, **args: Any) -> None:
        """One point event (Perfetto "i")."""
        if t is None:
            t = time.monotonic()
        self._push({"ph": "i", "cat": cat, "name": name, "task": task,
                    "instance": instance, "t0": t, "t1": t, "step": None,
                    "flow": None, "args": args or None})

    def counter(self, name: str, value: float, t: Optional[float] = None,
                task: str = "counters", instance: int = 0) -> None:
        """One gauge sample on counter track ``name`` (Perfetto "C")."""
        if t is None:
            t = time.monotonic()
        self._push({"ph": "C", "cat": "counter", "name": name, "task": task,
                    "instance": instance, "t0": t, "t1": t, "step": None,
                    "flow": None, "args": {"value": value}})

    def device_mark(self, device: Any) -> Any:
        """A timing event recorded now on ``device``'s current stream (a
        CUDA device), for ``record_device``.  The run's first mark on a
        device takes that device's first anchor before it."""
        import torch

        if device not in self._anchors:
            self._anchors.setdefault(device, _anchor(device))
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def record_device(self, cat: str, name: str, task: str, instance: int,
                      t0: float, t1: float, device: Any, ev0: Any, ev1: Any,
                      step: Optional[int] = None, **args: Any) -> None:
        """``record`` of a span whose device interval runs from ``ev0`` to
        ``ev1`` (two ``device_mark`` events); ``spans()`` adds it to the
        span's args as ``dev_t0``/``dev_t1``."""
        self._push({"ph": "X", "cat": cat, "name": name, "task": task,
                    "instance": instance, "t0": t0, "t1": t1, "step": step,
                    "flow": None, "args": args},
                   (device, ev0, ev1))

    def _push(self, span: Dict[str, Any],
              device: Optional[Tuple[Any, Any, Any]] = None) -> None:
        sh = self._shards[threading.get_ident() & self._mask]
        with sh.lock:
            if len(sh.spans) < self._per_shard_cap:
                sh.spans.append(span)
            else:
                sh.dropped += 1
            sh.ring.append(span)
            if device is not None:
                sh.pending.append((span, *device))

    def _resolve_device(self, pending: List[Tuple[Dict[str, Any], Any, Any, Any]]
                        ) -> None:
        """Map the ``pending`` spans' events onto the monotonic clock by each
        device's first anchor and one taken now (the events are dropped)."""
        by_device: Dict[Any, List[Tuple[Dict[str, Any], Any, Any]]] = {}
        for span, device, ev0, ev1 in pending:
            by_device.setdefault(device, []).append((span, ev0, ev1))
        for device, items in by_device.items():
            first, t_first = self._anchors[device]
            try:
                second, t_second = _anchor(device)
                ms_second = first.elapsed_time(second)
                times = [(first.elapsed_time(ev0), first.elapsed_time(ev1))
                         for _, ev0, ev1 in items]
            except RuntimeError:
                # the device failed (a CUDA error ending the run): its spans
                # keep their host interval only, and collection goes on
                continue
            for (span, _, _), (ms0, ms1) in zip(items, times):
                span["args"]["dev_t0"] = device_to_monotonic(
                    ms0, t_first, ms_second, t_second)
                span["args"]["dev_t1"] = device_to_monotonic(
                    ms1, t_first, ms_second, t_second)

    # -------------------------------------------------------- flight recorder
    def flight(self) -> List[Dict[str, Any]]:
        """The most recent spans across all shards (bounded, end-time
        ordered) -- what every instance was doing just now."""
        out: List[Dict[str, Any]] = []
        for sh in self._shards:
            with sh.lock:
                out.extend(sh.ring)
        out.sort(key=lambda s: s["t1"])
        return out[-self.config.flight_len:]

    def mark_failure(self, reason: str, task: str = "?",
                     instance: int = -1) -> Dict[str, Any]:
        """Snapshot the flight ring for a failure path.  Bounded: only the
        first 8 dumps of a run are kept (a cascading failure re-dumps the
        same recent history anyway)."""
        dump = {"t": time.monotonic(), "reason": reason, "task": task,
                "instance": instance, "spans": self.flight()}
        with self._dump_lock:
            if len(self.failure_dumps) < 8:
                self.failure_dumps.append(dump)
        self.instant("recovery", "flight.dump", task, instance,
                     reason=reason)
        return dump

    def dumps(self) -> List[Dict[str, Any]]:
        with self._dump_lock:
            return list(self.failure_dumps)

    # ------------------------------------------------------------- snapshots
    def spans(self) -> List[Dict[str, Any]]:
        """Every retained span, merged across shards, start-time ordered,
        with the device intervals recorded so far resolved."""
        out: List[Dict[str, Any]] = []
        pending: List[Tuple[Dict[str, Any], Any, Any, Any]] = []
        for sh in self._shards:
            # one hold per shard, as without device spans: the explorer
            # counts every acquisition as a scheduling point
            with sh.lock:
                out.extend(sh.spans)
                pending.extend(sh.pending)
                sh.pending.clear()
        if pending:
            self._resolve_device(pending)
        out.sort(key=lambda s: (s["t0"], s["t1"]))
        return out

    @property
    def dropped(self) -> int:
        return sum(sh.dropped for sh in self._shards)

    def __len__(self) -> int:
        n = 0
        for sh in self._shards:
            with sh.lock:
                n += len(sh.spans)
        return n

    def __repr__(self) -> str:
        return (f"<SpanRecorder spans={len(self)} dropped={self.dropped} "
                f"dumps={len(self.failure_dumps)}>")


def span_categories(spans: List[Dict[str, Any]]) -> List[str]:
    """Distinct non-synthetic categories present (layer-coverage checks)."""
    return sorted({s["cat"] for s in spans
                   if s["cat"] not in ("counter", "timeline")})
