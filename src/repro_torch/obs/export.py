"""Chrome/Perfetto trace export (Trace Event JSON) and its round-trip loader.

One ``trace.json`` artifact per run, loadable in https://ui.perfetto.dev or
chrome://tracing:

* one **track per task instance** (pid = task, tid = instance, named via
  ``M`` metadata events); prefetch-pool preps get their own ``pool``
  process so overlapping worker spans never stack onto a task's track;
* **flow arrows** from a producer's ``channel.offer`` span to the
  consumer's ``channel.get``/``vol.open`` span for the same (edge, seq)
  hand-off (``ph: s``/``f`` pairs keyed by :func:`..recorder.flow_id`);
* **counter tracks** for queue depth / in-flight preps / cumulative bytes
  (sampled by the channel hooks and, when a ``TelemetryTimeline`` is
  merged, by the scheduler's per-tick rows);
* ``TelemetryTimeline`` lifecycle events (restart / drop / rescale /
  stall) merged as **instant events** on the affected task's track -- one
  unified timeline artifact instead of two half-views.

``load_trace`` inverts ``to_chrome`` back into recorder-style span dicts
(category, task, instance, monotonic seconds), which is what the critical
-path analyzer and the ``python -m repro_torch.obs report`` CLI consume -- the
exported file IS the offline analysis input, there is no second format.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["to_chrome", "export_trace", "load_trace", "merge_timeline"]

#: timeline event kinds that carry a task coordinate and become instants
_TIMELINE_INSTANTS = ("restart", "drop", "rescale", "stall")


def merge_timeline(timeline: Any) -> List[Dict[str, Any]]:
    """Convert a ``TelemetryTimeline`` into recorder-style span dicts:
    lifecycle events -> ``ph: i`` on the task's track, sampled per-edge
    rows -> ``ph: C`` counter samples (queue depth + in-flight preps)."""
    out: List[Dict[str, Any]] = []
    if timeline is None:
        return out
    for ev in timeline.events():
        kind = ev.get("kind")
        if kind not in _TIMELINE_INSTANTS:
            continue
        args = {k: v for k, v in ev.items() if k not in ("t", "kind")}
        out.append({"ph": "i", "cat": "timeline", "name": f"timeline.{kind}",
                    "task": str(ev.get("task", "?")),
                    "instance": int(ev.get("instance", 0)),
                    "t0": ev["t"], "t1": ev["t"], "step": None,
                    "flow": None, "args": args or None})
    for row in timeline.samples():
        edge = row.get("edge", "?")
        t = row["t"]
        for field, track in (("queue_len", "qdepth"),
                             ("inflight", "inflight")):
            if field in row:
                out.append({"ph": "C", "cat": "counter",
                            "name": f"{track}:{edge}", "task": "counters",
                            "instance": 0, "t0": t, "t1": t, "step": None,
                            "flow": None, "args": {"value": row[field]}})
    return out


def _tracks(spans: Iterable[Dict[str, Any]]) -> Dict[str, int]:
    """Stable pid assignment: one process per task name, sorted."""
    tasks = sorted({s["task"] for s in spans})
    return {task: i + 1 for i, task in enumerate(tasks)}


def to_chrome(spans: List[Dict[str, Any]],
              timeline: Any = None) -> Dict[str, Any]:
    """Recorder span dicts -> a Chrome Trace Event JSON document."""
    spans = list(spans) + merge_timeline(timeline)
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_origin = min(s["t0"] for s in spans)
    pids = _tracks(spans)
    events: List[Dict[str, Any]] = []
    for task, pid in pids.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": task}})
    seen_tids = set()

    def us(t: float) -> float:
        return round((t - t_origin) * 1e6, 3)

    for s in spans:
        pid = pids[s["task"]]
        tid = int(s["instance"]) + 1
        if (pid, tid) not in seen_tids and s["ph"] != "C":
            seen_tids.add((pid, tid))
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"{s['task']}[{s['instance']}]"}})
        args = dict(s["args"] or {})
        if s["step"] is not None:
            args["step"] = s["step"]
        # recorder coordinates ride along so load_trace can invert exactly
        args["_cat"] = s["cat"]
        args["_task"] = s["task"]
        args["_instance"] = s["instance"]
        if s["ph"] == "X":
            events.append({"ph": "X", "name": s["name"], "cat": s["cat"],
                           "pid": pid, "tid": tid, "ts": us(s["t0"]),
                           "dur": round((s["t1"] - s["t0"]) * 1e6, 3),
                           "args": args})
            flow = s.get("flow")
            if flow is not None:
                role, fid = flow
                ev = {"ph": role, "name": "handoff", "cat": "flow",
                      "id": int(fid), "pid": pid, "tid": tid,
                      "ts": us(s["t1"] if role == "s" else s["t0"])}
                if role == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice
                events.append(ev)
        elif s["ph"] == "i":
            events.append({"ph": "i", "name": s["name"], "cat": s["cat"],
                           "pid": pid, "tid": tid, "ts": us(s["t0"]),
                           "s": "t", "args": args})
        elif s["ph"] == "C":
            events.append({"ph": "C", "name": s["name"], "pid": pid,
                           "tid": 0, "ts": us(s["t0"]),
                           "args": {"value": s["args"]["value"]}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"t_origin_monotonic": t_origin,
                          "exporter": "repro_torch.obs"}}


def export_trace(path: str, recorder: Any, timeline: Any = None) -> str:
    """Write one unified ``trace.json`` (spans + merged telemetry)."""
    spans = recorder.spans() if hasattr(recorder, "spans") else list(recorder)
    doc = to_chrome(spans, timeline=timeline)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Invert an exported ``trace.json`` back into recorder-style span
    dicts (times relative to the export origin, in seconds)."""
    with open(path) as f:
        doc = json.load(f)
    t_origin = float(doc.get("otherData", {}).get("t_origin_monotonic", 0.0))
    flows: Dict[Tuple[int, int, float], Tuple[str, int]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") in ("s", "f"):
            flows[(ev["pid"], ev["tid"], ev["ts"])] = (ev["ph"], ev["id"])
    out: List[Dict[str, Any]] = []
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in ("X", "i", "C"):
            continue
        args = dict(ev.get("args") or {})
        if ph == "C":
            name = ev["name"]
            t = t_origin + ev["ts"] / 1e6
            out.append({"ph": "C", "cat": "counter", "name": name,
                        "task": "counters", "instance": 0, "t0": t, "t1": t,
                        "step": None, "flow": None,
                        "args": {"value": args.get("value")}})
            continue
        cat = args.pop("_cat", ev.get("cat", "?"))
        task = args.pop("_task", "?")
        instance = int(args.pop("_instance", ev.get("tid", 1) - 1))
        step = args.pop("step", None)
        t0 = t_origin + ev["ts"] / 1e6
        t1 = t0 + (ev.get("dur", 0.0) / 1e6 if ph == "X" else 0.0)
        flow: Optional[Tuple[str, int]] = None
        if ph == "X":
            for ts_key in (round((t1 - t_origin) * 1e6, 3),
                           round((t0 - t_origin) * 1e6, 3)):
                hit = flows.get((ev["pid"], ev["tid"], ts_key))
                if hit is not None:
                    flow = hit
                    break
        out.append({"ph": "X" if ph == "X" else "i", "cat": cat,
                    "name": ev["name"], "task": task, "instance": instance,
                    "t0": t0, "t1": t1, "step": step, "flow": flow,
                    "args": args or None})
    out.sort(key=lambda s: (s["t0"], s["t1"]))
    return out
