"""The device trace of a traced run: ``torch.profiler`` over a sub-window of
the measured window, entered and left by a thread of its own so that no
thread of the program pays for recording its host operations (the profiler
records host operations of the thread that starts it only; the card's
activity it records for the whole process).

The result is on the host's monotonic clock, the clock of the benchmark's
and the program's spans: an annotation made at a known monotonic time
anchors the profiler's clock to it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]
ANCHOR = "insitu_bench.anchor"


@dataclass
class Trace:
    """Device operations ``(name, t0, t1)`` (seconds, monotonic) inside the
    sub-window ``[t0, t1]``."""
    t0: float
    t1: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @classmethod
    def recorded(cls, t0: float, t_end: float,
                 ops: Sequence[Tuple[str, float, float]]) -> "Trace":
        """The trace of the operations that a profiler started at ``t0``
        recorded, up to ``t_end``.  The card may still run operations
        launched before the profiler started, which it does not record, so
        the sub-window opens with the first operation it recorded."""
        ops = [(n, a, b) for n, a, b in ops if b > t0 and a < t_end]
        t0 = max(t0, min((a for _, a, _ in ops), default=t0))
        return cls(t0, max(t0, t_end), ops)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Interval]:
        """The union of the operations' intervals, clipped to the window."""
        return merge([(max(a, self.t0), min(b, self.t1)) for _, a, b in self.ops
                      if b > self.t0 and a < self.t1])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle(self) -> List[Interval]:
        out, at = [], self.t0
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if at < self.t1:
            out.append((at, self.t1))
        return out

    def seconds_of(self, key: str) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name holds ``key``."""
        hits = [(b - a) for n, a, b in self.ops if key in n]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, a, b in self.ops:
            by[n[:96]] = by.get(n[:96], 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, host: Sequence[Tuple[str, float, float]], k: int = 10
                  ) -> List[List]:
        """The ``k`` longest idle gaps, each named by the host spans that
        cover its middle (``+``-joined, ``none`` where no span does)."""
        gaps = sorted(self.idle(), key=lambda iv: iv[0] - iv[1])[:k]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            names = sorted({n for n, s0, s1 in host if s0 <= mid <= s1})
            out.append(["+".join(names) or "none", b - a])
        return out


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    if torch.cuda.is_available():
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def merge(ivs: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(iv for iv in ivs if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Profiler:
    """Profile the card from a thread of its own, from a monotonic time
    (``schedule``) until ``finish(t_end)``, which the driver calls once the
    window has closed at ``t_end``: the profiler stops and its events are
    read then, so neither weighs on the window.  Returns the ``Trace`` of
    ``[start, t_end]``, or of ``[first recorded operation, t_end]`` where
    that is later (``None`` where the profiler never started)."""

    def __init__(self) -> None:
        from torch.profiler import profile

        with profile(activities=_activities()):
            pass      # the profiler's first session registers in this thread
        self._start: Optional[float] = None
        self._scheduled = threading.Event()
        self._stop = threading.Event()
        self._prof = None
        self._anchor = (0, 0.0)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._body, name="insitu-bench-profiler",
                                        daemon=True)
        self._thread.start()

    def schedule(self, t_start: float) -> None:
        self._start = t_start
        self._scheduled.set()

    def finish(self, t_end: float) -> Optional[Trace]:
        import torch

        self._stop.set()
        self._scheduled.set()
        self._thread.join()
        if self._error is not None:
            raise self._error
        if self._prof is None:
            return None
        anchor_ns, t0 = self._anchor
        events = self._prof.profiler.kineto_results.events()
        marks = [e.start_ns() for e in events if e.name() == ANCHOR]
        if not marks:
            raise RuntimeError("the profiler recorded no anchor annotation")
        offset = marks[0] - anchor_ns
        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for e in events:
            if e.device_type() == cuda:
                a = (e.start_ns() - offset) * 1e-9
                ops.append((e.name(), a, a + e.duration_ns() * 1e-9))
        return Trace.recorded(t0, t_end, ops)

    def _body(self) -> None:
        try:
            self._scheduled.wait()
            if self._start is None:
                return
            if self._stop.wait(max(0.0, self._start - time.monotonic())):
                return
            self._profile()
        except BaseException as e:  # noqa: BLE001 -- re-raised by finish()
            self._error = e

    def _profile(self) -> None:
        import torch
        from torch.profiler import profile, record_function

        with profile(activities=_activities()) as prof:
            anchor = time.monotonic_ns()
            with record_function(ANCHOR):
                pass
            self._anchor = (anchor, time.monotonic())
            self._stop.wait()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self._prof = prof
