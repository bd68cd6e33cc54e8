"""One run of an ``insitu_bench`` cell, as ``insitu_bench/run.py`` makes it,
and what PyTorch's caching allocator did inside the trainer's forward
passes, steps and snapshots.

    python3 tools/alloc_probe.py [--root CHECKOUT] [--out FILE] -- \\
        --workload mamba2-2.7b.insitu_train --seed 7 --seconds 51 --trace 0

Runs ``CHECKOUT``'s ``insitu_bench/run.py`` (default: this one) in this
process through its own ``main``, so the standard output and the exit code
are the benchmark's.  Around every ``trainer.step`` and ``trainer.snapshot``
of the driver (``insitu_bench/lib/host.py``'s spans, traced or not) and
every loss of the model on the trainer's thread inside a step (the step's
``train.forward`` phase: ``registry``'s ssm ``loss_fn``), it reads
``torch.cuda.memory_stats()`` on entry and exit, the host's clock, and (the
forward only) two CUDA events.  It writes one JSON object to ``--out``
(else to standard error): for each of ``forward``, ``step`` and
``snapshot``, the events' count, the medians of their host and device
milliseconds, and the sums over them of the allocator's counters
(``DELTAS``: retries after a failed allocation, which free the cache and
wait for the card, ``cudaMalloc``/``cudaFree`` calls, synchronisations of
every stream) and the medians at entry of its gauges (``GAUGES``), each
event beside it in ``events`` (a snapshot's also with ``close_ms``, its
``h5`` file's close: the serve and the offer to the evaluator); the whole
run's counters; and ``spans``, every host span of the driver (name, start,
end on ``time.monotonic()``), the evaluator's too.

Reads nothing of the program but PyTorch's allocator and the family's
``loss_fn``: a tool for explaining a move of the benchmark's metrics, not a
metric.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DELTAS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
          "num_sync_all_streams", "num_ooms", "allocation.all.allocated")
GAUGES = ("allocated_bytes.all.current", "reserved_bytes.all.current",
          "inactive_split_bytes.all.current")


class Probe:
    """The allocator's counters around each probed event."""

    def __init__(self, torch):
        self.torch = torch
        self.events = {"forward": [], "step": [], "snapshot": []}
        self.spans = []          # every host span of the driver: name, t0, t1
        self.local = threading.local()
        self.first = None

    def read(self):
        stats = self.torch.cuda.memory_stats()
        return {k: stats.get(k, 0) for k in DELTAS + GAUGES}

    @contextmanager
    def around(self, kind, device_events=False):
        torch = self.torch
        a = self.read()
        if self.first is None:
            self.first = a
        e0 = e1 = None
        if device_events:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        t0 = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            if e1 is not None:
                e1.record()
            b = self.read()
            self.events[kind].append({
                "t0": t0, "host_ms": 1e3 * (t1 - t0), "events": (e0, e1),
                "close_ms": self.local.__dict__.pop("close_ms", None),
                "at_entry": {k: a[k] for k in GAUGES},
                **{k: b[k] - a[k] for k in DELTAS}})

    def report(self):
        self.torch.cuda.synchronize()
        out = {}
        for kind, evs in self.events.items():
            for e in evs:
                e0, e1 = e.pop("events")
                e["device_ms"] = e0.elapsed_time(e1) if e0 is not None else None
            dev = [e["device_ms"] for e in evs if e["device_ms"] is not None]
            out[kind] = {
                "n": len(evs),
                "host_ms_median": statistics.median(e["host_ms"] for e in evs) if evs else None,
                "device_ms_median": statistics.median(dev) if dev else None,
                "sums": {k: sum(e[k] for e in evs) for k in DELTAS},
                "at_entry_median": {k: statistics.median(e["at_entry"][k] for e in evs)
                                    for k in GAUGES} if evs else None,
                "events": evs}
        last = self.read()
        out["run"] = {k: last[k] - (self.first or last)[k] for k in DELTAS}
        out["spans"] = self.spans
        out["peak_reserved_bytes"] = self.torch.cuda.max_memory_reserved()
        return out


def install(probe):
    """Wrap the driver's host spans, the ssm family's ``loss_fn`` (the
    trainer's forward phase, and the evaluator's score) and the ``h5``
    file's close (a snapshot's serve and offer to the evaluator)."""
    import dataclasses

    from insitu_bench.lib import host
    from repro_torch.core import h5
    from repro_torch.models import registry

    real_span = host.HostSpans.span

    @contextmanager
    def span(self, name):
        kind = {"trainer.step": "step", "trainer.snapshot": "snapshot"}.get(name)
        t0 = time.monotonic()
        try:
            with real_span(self, name):
                if kind is None:
                    yield
                    return
                probe.local.kind = kind
                try:
                    with probe.around(kind):
                        yield
                finally:
                    probe.local.kind = None
        finally:
            probe.spans.append((name, t0, time.monotonic()))

    host.HostSpans.span = span
    real_close = h5._H5File.close

    def close(self):
        if getattr(probe.local, "kind", None) != "snapshot":
            return real_close(self)
        t0 = time.monotonic()
        try:
            return real_close(self)
        finally:
            probe.local.close_ms = 1e3 * (time.monotonic() - t0)

    h5._H5File.close = close
    fam = registry._FAMILIES["ssm"]
    real_loss = fam.loss_fn

    def loss_fn(*args, **kwargs):
        if getattr(probe.local, "kind", None) != "step":
            return real_loss(*args, **kwargs)
        with probe.around("forward", device_events=True):
            return real_loss(*args, **kwargs)

    registry._FAMILIES["ssm"] = dataclasses.replace(fam, loss_fn=loss_fn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out")
    ap.add_argument("run_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    run_args = args.run_args[1:] if args.run_args[:1] == ["--"] else args.run_args
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    from insitu_bench import run

    probe = Probe(torch)
    install(probe)
    rc = run.main(run_args)
    text = json.dumps(probe.report() if torch.cuda.is_available() else None)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
