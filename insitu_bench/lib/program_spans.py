"""The program's own spans of a traced run, for the readers of the model
step's phases and of the snapshot's write.

``repro_torch.obs.last_run_spans()`` holds the spans of the process's newest
finished traced run of the port's ``Wilkins``.  The readers import nothing
of the port: they read the module the driver's run loaded, where it is in
``sys.modules``.  A program without it gives nothing, and every reader then
returns ``None``.  Only spans that start
inside the run's window are read, so spans of an earlier run in the same
process are never taken for this one's.

The phases (``train.forward``, ``train.backward``, ``train.optimizer``,
children of ``train.step``) carry their device interval, from CUDA events
mapped onto the monotonic clock, as ``args.dev_t0``/``dev_t1``; on the CPU
they carry none.  The snapshot's write is the producer's ``vol.file`` span,
from the file's creation to the end of its close (serve and offer
included), on the host's clock, with the payload bytes of the file's
datasets as ``args.bytes``.
"""

from __future__ import annotations

import statistics
import sys
from typing import Any, Dict, List, Optional, Tuple

PHASES = ("train.forward", "train.backward", "train.optimizer")


def spans() -> Optional[List[Dict[str, Any]]]:
    """The program's spans of its newest finished traced run, or ``None``."""
    last = getattr(sys.modules.get("repro_torch.obs"), "last_run_spans", None)
    return last() if last is not None else None


def in_window(raw: Dict[str, Any], all_spans: List[Dict[str, Any]], name: str
              ) -> List[Dict[str, Any]]:
    """The spans called ``name`` that start inside ``[raw["t0"], raw["t_end"]]``."""
    t0, t_end = raw.get("t0"), raw.get("t_end")
    if t0 is None or t_end is None:
        return []
    return [s for s in all_spans
            if s["ph"] == "X" and s["name"] == name and t0 <= s["t0"] <= t_end]


def window_steps(raw: Dict[str, Any], all_spans: List[Dict[str, Any]]
                 ) -> List[Tuple[str, int, Any]]:
    """The window steps, ``(task, instance, step)``: the window's first
    steps, as many as ended before the profiled sub-window (every step of the
    window where there is no trace), the rule of ``train.mfu``."""
    ends = raw.get("step_ends") or []
    trace = raw.get("trace")
    if trace is not None:
        ends = [e for e in ends if e <= trace.t0]
    steps = sorted(in_window(raw, all_spans, "train.step"), key=lambda s: s["t0"])
    return [(s["task"], s["instance"], s["step"]) for s in steps[:len(ends)]]


def device_interval(span: Dict[str, Any]) -> Optional[Tuple[float, float]]:
    args = span.get("args") or {}
    if "dev_t0" not in args or "dev_t1" not in args:
        return None
    return args["dev_t0"], args["dev_t1"]


def phase_device_ms(raw: Dict[str, Any], phase: str) -> Optional[float]:
    """The median over the window steps of ``phase``'s device milliseconds
    in a step (its microbatches' summed, where there are several)."""
    got = spans()
    if not got:
        return None
    keys = set(window_steps(raw, got))
    per_step: Dict[Tuple[str, int, Any], float] = {}
    for s in got:
        key = (s["task"], s["instance"], s["step"])
        iv = device_interval(s) if s["ph"] == "X" and s["name"] == phase else None
        if iv is not None and key in keys:
            per_step[key] = per_step.get(key, 0.0) + 1e3 * (iv[1] - iv[0])
    return statistics.median(per_step.values()) if per_step else None


def phase_idle_share(raw: Dict[str, Any], phase: str) -> Optional[float]:
    """The share (%) of ``phase``'s device intervals, clipped to the profiled
    sub-window, in which no device operation of the trace ran."""
    got, trace = spans(), raw.get("trace")
    if not got or trace is None:
        return None
    ivs = []
    for s in in_window(raw, got, phase):
        iv = device_interval(s)
        if iv is not None:
            a, b = max(iv[0], trace.t0), min(iv[1], trace.t1)
            if b > a:
                ivs.append((a, b))
    total = sum(b - a for a, b in ivs)
    if total <= 0.0:
        return None
    busy = trace.busy()
    covered = sum(max(0.0, min(b, y) - max(a, x)) for a, b in ivs for x, y in busy)
    return 100.0 * (1.0 - covered / total)


def write_ms(raw: Dict[str, Any]) -> Optional[float]:
    """The mean host milliseconds of the ``vol.file`` spans that start
    inside the window: the window's snapshots, as the program writes them."""
    got = spans()
    ms = [1e3 * (s["t1"] - s["t0"]) for s in in_window(raw, got or [], "vol.file")]
    return sum(ms) / len(ms) if ms else None


def write_gb_per_s(raw: Dict[str, Any]) -> Optional[float]:
    """The payload of the window's ``vol.file`` spans (their ``bytes``) over
    their summed host seconds, in GB/s: how fast the coupling takes in a
    snapshot's weights."""
    files = [s for s in in_window(raw, spans() or [], "vol.file")
             if "bytes" in (s.get("args") or {})]
    seconds = sum(s["t1"] - s["t0"] for s in files)
    if seconds <= 0.0:
        return None
    return 1e-9 * sum(s["args"]["bytes"] for s in files) / seconds
