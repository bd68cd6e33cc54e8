"""Critical-path analysis over recorded spans.

Attributes each task instance's wall-clock window -- and each step's
latency on the slowest ("critical") instance -- to WHERE the time went:

``block``      rendezvous waits (``channel.offer`` / ``channel.get`` block
               intervals, ``vol.open`` mux waits)
``prep``       prefetch preparation the consumer actually blocked on
``reshard``    pack/numpy redistribute executes
``checkpoint`` checkpoint save/restore
``recovery``   restart surgery + replay
``rescale``    rescale surgery stages
``compute``    everything else (the remainder)

The algorithm is precedence subtraction, not DAG search: for one instance,
take its window ``[min t0, max t1]``, then claim intervals category by
category in the precedence order above, subtracting what earlier
categories already claimed (a reshard running inside a blocked ``get`` is
charged to ``block`` once, never twice).  ``compute`` is the unclaimed
remainder, so per-instance attribution sums to the window EXACTLY by
construction -- the 5% acceptance tolerance only absorbs clock jitter
between the window edges and the step boundaries.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["attribute", "critical_path", "per_edge", "format_report"]

#: claim precedence (outer blocking states absorb nested work)
PRECEDENCE = ("block", "prep", "reshard", "checkpoint", "recovery", "rescale")

#: span category -> attribution bucket
_BUCKET = {"channel": "block", "vol": "block", "prefetch": "prep",
           "reshard": "reshard", "checkpoint": "checkpoint",
           "recovery": "recovery", "rescale": "rescale"}


def _bucket_of(s: Dict[str, Any]) -> Optional[str]:
    """Attribution bucket for one span; lifecycle spans (e.g. ``vol.close``,
    which *contains* serve work and nested rendezvous waits) claim nothing
    themselves -- their blocking portion arrives via the nested spans."""
    if s["cat"] == "vol" and not s["name"].endswith(".wait"):
        return None
    return _BUCKET.get(s["cat"])

Interval = Tuple[float, float]


def _merge(ivs: List[Interval]) -> List[Interval]:
    if not ivs:
        return []
    ivs = sorted(ivs)
    out = [ivs[0]]
    for a, b in ivs[1:]:
        la, lb = out[-1]
        if a <= lb:
            out[-1] = (la, max(lb, b))
        else:
            out.append((a, b))
    return out


def _subtract(iv: Interval, claimed: List[Interval]) -> List[Interval]:
    """Parts of ``iv`` not covered by the merged, sorted ``claimed``."""
    a, b = iv
    out: List[Interval] = []
    for ca, cb in claimed:
        if cb <= a:
            continue
        if ca >= b:
            break
        if ca > a:
            out.append((a, ca))
        a = max(a, cb)
        if a >= b:
            break
    if a < b:
        out.append((a, b))
    return out


def _total(ivs: List[Interval]) -> float:
    return sum(b - a for a, b in ivs)


def _claim(spans: List[Dict[str, Any]], window: Interval) -> Dict[str, float]:
    """Precedence-subtraction attribution of one window."""
    by_bucket: Dict[str, List[Interval]] = {}
    wa, wb = window
    for s in spans:
        if s["ph"] != "X":
            continue
        bucket = _bucket_of(s)
        if bucket is None:
            continue
        a, b = max(s["t0"], wa), min(s["t1"], wb)
        if b > a:
            by_bucket.setdefault(bucket, []).append((a, b))
    claimed: List[Interval] = []
    out = {b: 0.0 for b in PRECEDENCE}
    for bucket in PRECEDENCE:
        fresh: List[Interval] = []
        for iv in _merge(by_bucket.get(bucket, [])):
            fresh.extend(_subtract(iv, claimed))
        out[bucket] = _total(fresh)
        claimed = _merge(claimed + fresh)
    out["compute"] = max(0.0, (wb - wa) - _total(claimed))
    return out


def _by_instance(spans: List[Dict[str, Any]]
                 ) -> Dict[Tuple[str, int], List[Dict[str, Any]]]:
    out: Dict[Tuple[str, int], List[Dict[str, Any]]] = {}
    for s in spans:
        if s["cat"] in ("counter", "timeline") or s["task"] in (
                "counters", "pool"):
            continue
        out.setdefault((s["task"], s["instance"]), []).append(s)
    return out


def attribute(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Full attribution report (plain dict, JSON-serializable).

    ``instances``: per (task, instance) window + bucket seconds (summing to
    the window exactly); ``steps``: the same restricted to each step's
    interval on the critical instance; ``edges``: per-edge block/prep/bytes
    rollup; ``critical``: the instance whose window is longest.
    """
    groups = _by_instance(spans)
    instances: Dict[str, Any] = {}
    for (task, inst), group in sorted(groups.items()):
        xs = [s for s in group if s["ph"] == "X"]
        if not xs:
            continue
        window = (min(s["t0"] for s in xs), max(s["t1"] for s in xs))
        att = _claim(group, window)
        instances[f"{task}[{inst}]"] = {
            "task": task, "instance": inst,
            "window_s": window[1] - window[0], **att}
    critical = max(instances, key=lambda k: instances[k]["window_s"],
                   default=None)
    steps: Dict[str, Any] = {}
    if critical is not None:
        task = instances[critical]["task"]
        inst = instances[critical]["instance"]
        group = groups[(task, inst)]
        by_step: Dict[int, List[Interval]] = {}
        for s in group:
            if s["ph"] == "X" and s["step"] is not None:
                by_step.setdefault(int(s["step"]), []).append(
                    (s["t0"], s["t1"]))
        bounds = sorted((step, min(a for a, _ in ivs), max(b for _, b in ivs))
                        for step, ivs in by_step.items())
        for i, (step, a, b) in enumerate(bounds):
            # a step lasts until the next step's first span begins
            end = bounds[i + 1][1] if i + 1 < len(bounds) else b
            end = max(end, b)
            att = _claim(group, (a, end))
            steps[str(step)] = {"latency_s": end - a, **att}
    return {"instances": instances, "steps": steps,
            "edges": per_edge(spans), "critical": critical}


def critical_path(spans: List[Dict[str, Any]]) -> Optional[str]:
    """``"task[instance]"`` with the longest span window, or ``None``."""
    return attribute(spans)["critical"]


def per_edge(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-edge rollup of hand-off costs: producer/consumer blocked time,
    prep time blocked on, bytes moved, plan-cache hits/misses seen."""
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        if s["ph"] != "X":
            continue
        args = s["args"] or {}
        edge = args.get("edge")
        if edge is None:
            continue
        row = out.setdefault(edge, {"blocked_s": 0.0, "prep_s": 0.0,
                                    "bytes": 0, "hits": 0, "misses": 0})
        dt = s["t1"] - s["t0"]
        bucket = _bucket_of(s)
        if bucket == "prep" and s["name"].endswith(".prep"):
            row["prep_s"] += dt        # pool-side preparation work
        elif bucket in ("block", "prep"):
            row["blocked_s"] += dt     # consumer/producer blocked on the edge
        if "bytes" in args:
            row["bytes"] += int(args["bytes"])
        if args.get("cache") == "hit":
            row["hits"] += 1
        elif args.get("cache") == "miss":
            row["misses"] += 1
    return out


def format_report(report: Dict[str, Any]) -> str:
    """Human-readable attribution tables for summary() / the CLI."""
    lines: List[str] = []
    cols = PRECEDENCE + ("compute",)
    if report["instances"]:
        lines.append("critical-path attribution (s):")
        head = f"  {'instance':<22}" + "".join(f"{c:>11}" for c in
                                               ("window",) + cols)
        lines.append(head)
        for key, row in report["instances"].items():
            mark = " *" if key == report["critical"] else ""
            lines.append(
                f"  {key + mark:<22}" + f"{row['window_s']:>11.4f}"
                + "".join(f"{row[c]:>11.4f}" for c in cols))
    if report["steps"]:
        lines.append(f"per-step attribution on {report['critical']} (s):")
        lines.append(f"  {'step':<22}" + "".join(
            f"{c:>11}" for c in ("latency",) + cols))
        for step, row in report["steps"].items():
            lines.append(
                f"  {step:<22}" + f"{row['latency_s']:>11.4f}"
                + "".join(f"{row[c]:>11.4f}" for c in cols))
    if report["edges"]:
        lines.append("per-edge hand-off costs:")
        lines.append(f"  {'edge':<22}{'blocked_s':>11}{'prep_s':>11}"
                     f"{'MiB':>9}{'hit':>5}{'miss':>6}")
        for edge, row in sorted(report["edges"].items()):
            lines.append(
                f"  {edge:<22}{row['blocked_s']:>11.4f}{row['prep_s']:>11.4f}"
                f"{row['bytes'] / 2**20:>9.2f}{row['hits']:>5d}"
                f"{row['misses']:>6d}")
    return "\n".join(lines)
