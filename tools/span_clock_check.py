"""One run of an ``insitu_bench`` cell, as ``insitu_bench/run.py`` makes it,
and a report of how the program's device spans agree with the profiler's
trace of the same run.

    python3 tools/span_clock_check.py [--root CHECKOUT] [--out FILE] -- \\
        --workload mamba2-2.7b.insitu_train --seed 7 --seconds 51 --trace 1

Runs ``CHECKOUT``'s ``insitu_bench/run.py`` (default: this one) in this
process through its own ``main``, so the standard output and the exit code
are the benchmark's, and keeps the driver's raw result.  After a traced run
whose program records device spans (``repro_torch.obs.last_run_spans()``),
it writes one JSON object to ``--out`` (else to standard error):

- ``boundaries``: the phase-boundary events (``dev_t0``/``dev_t1`` of the
  ``train.*`` phases) inside the profiled sub-window, and for each how far
  it lies inside a device operation of the trace (0 where it lies between
  operations): ``n``, ``median_us``, ``median_signed_us`` (+: the events
  map later than the trace's operations), ``worst_us``,
  ``share_within_50us``; ``over_50us`` names each event past 50 µs and
  its operation;
- ``phases``: for each phase, its metric's device milliseconds and idle
  share (``insitu_bench/lib/program_spans.py``) and the median host
  milliseconds over the same window steps; ``sum_device_ms`` of the three
  device medians against ``s_per_step_ms``, the window's seconds per step.

A program without device spans (an older checkout) gives ``null``.  A tool
for checking the program's tracing on the card, not a metric: the
benchmark's readers are ``insitu_bench/metrics/``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inside_us(t, ops_sorted, starts):
    """How far ``t`` lies inside the operation that holds it, in µs (the
    nearer edge), signed (+ nearer its start: the event maps later than
    the boundary it was recorded at; - nearer its end: earlier), and that
    operation's name; 0 and ``None`` where no operation holds it."""
    best, name = 0.0, None
    i = bisect.bisect_right(starts, t)
    for n, a, b in ops_sorted[max(0, i - 64):i]:
        if a <= t <= b and min(t - a, b - t) * 1e6 > abs(best):
            best = (t - a) * 1e6 if t - a < b - t else -(b - t) * 1e6
            name = n
    return best, name


def report(raw, spans):
    """The clock check of one traced run's ``raw`` result and spans."""
    from insitu_bench.lib import program_spans as ps

    trace = raw.get("trace")
    if not spans or trace is None:
        return None
    phases = [s for s in spans if s["ph"] == "X" and s["name"] in ps.PHASES
              and ps.device_interval(s) is not None]
    if not phases:
        return None
    ops = sorted(trace.ops, key=lambda o: o[1])
    starts = [a for _, a, _ in ops]
    marks = {}       # one entry per event: a boundary ends one phase, starts the next
    for s in phases:
        for t, end in zip(ps.device_interval(s), ("start", "end")):
            if trace.t0 <= t <= trace.t1:
                marks.setdefault(t, f"{s['name']}.{end}")
    found = [(t, kind, *inside_us(t, ops, starts)) for t, kind in sorted(marks.items())]
    signed = [o for _, _, o, _ in found]
    offs = [abs(o) for o in signed]
    keys = set(ps.window_steps(raw, spans))
    out = {"phases": {}}
    for name in ps.PHASES:
        host = {}
        for s in phases:
            key = (s["task"], s["instance"], s["step"])
            if s["name"] == name and key in keys:
                host[key] = host.get(key, 0.0) + 1e3 * (s["t1"] - s["t0"])
        out["phases"][name] = {
            "device_ms": ps.phase_device_ms(raw, name),
            "idle_share": ps.phase_idle_share(raw, name),
            "host_ms": statistics.median(host.values()) if host else None}
    meds = [v["device_ms"] for v in out["phases"].values()]
    out["sum_device_ms"] = sum(meds) if None not in meds else None
    out["s_per_step_ms"] = 1e3 * raw["window_s"] / raw["steps"]
    out["boundaries"] = {
        "n": len(offs),
        "median_us": statistics.median(offs) if offs else None,
        "median_signed_us": statistics.median(signed) if signed else None,
        "worst_us": max(offs) if offs else None,
        "share_within_50us": (sum(o <= 50.0 for o in offs) / len(offs)) if offs else None,
        "over_50us": [[kind, o, op[:80]] for _, kind, o, op in found if abs(o) > 50.0]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out")
    ap.add_argument("run_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    run_args = args.run_args[1:] if args.run_args[:1] == ["--"] else args.run_args
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    from insitu_bench import run
    from insitu_bench.lib import spec

    kept = {}
    real_driver = spec.driver

    def driver(name, bench_dir=spec.HERE):
        mod = real_driver(name, bench_dir)
        real_run = mod.run

        def run_and_keep(ctx):
            kept["raw"] = real_run(ctx)
            return kept["raw"]

        mod.run = run_and_keep
        return mod

    spec.driver = driver
    rc = run.main(run_args)
    obs = sys.modules.get("repro_torch.obs")
    spans = obs.last_run_spans() if hasattr(obs, "last_run_spans") else None
    doc = report(kept["raw"], spans) if "raw" in kept else None
    text = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
