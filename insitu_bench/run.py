"""Run one cell of the benchmark once, on the card this process finds.

    python3 insitu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its files are found by name
(``lib/spec.py``).  The run makes its inputs from ``--seed``, warms up its
cell's shapes (set-up), measures for ``--seconds``, compares what the timed
path produced with the plain reference, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from a profiled sub-window of the window and the
benchmark's own host spans), ``device``, with ``--trace 1`` ``breakdown`` and the
traced run's end-to-end numbers, and last ``checks``: each number compared
with its limit.  The checks are also the last lines of standard error.

Without as many CUDA devices as the cell asks for, it exits with 2 and
prints no result; it never runs on the CPU.  It exits with 3, and prints no
result, if the JAX package or JAX was loaded into the process.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "ml_dtypes", "repro")


def banned_modules():
    """The top-level names in ``sys.modules`` that belong to JAX or to the
    JAX package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def json_safe(obj):
    """``obj`` with every float that is not finite written as a string, so
    the result line stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """One run of ``cell`` (a ``lib.spec.Cell``) on ``device``: the result
    line's object."""
    import torch

    from insitu_bench.lib import spec

    tmp = tempfile.mkdtemp(prefix="insitu_bench_")
    try:
        ctx = spec.Context(cell, seed, seconds, trace, device, tmp, t_start)
        raw = spec.driver(cell.traffic["driver"], cell.bench_dir).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cuda = device.type == "cuda"
    raw["device_name"] = torch.cuda.get_device_name(device) if cuda else "cpu"
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(m["name"], cell.bench_dir).read(raw)
        if value is None and not trace:
            raise RuntimeError(f"{cell.name}: no reading of {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {c["name"]: {"value": c["value"], "limit": c["limit"]}
              for c in raw["checks"]}
    result = {
        "correct": all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()),
        "attempted": raw["attempted"], "failed": raw["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": raw["device_name"],
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": raw["memory_peak_bytes"]},
    }
    if trace:
        tr = raw["trace"]
        if tr is None:
            raise RuntimeError(f"{cell.name}: the profiled sub-window never started")
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps(raw["host_spans"])}
        result["end_to_end_traced"] = {
            m["name"]: spec.reader(m["name"], cell.bench_dir).read(raw)
            for m in cell.end_to_end}
    if "readings" in raw:
        result["readings"] = raw["readings"]
    result["checks"] = checks
    return json_safe(result)


def main(argv=None) -> int:
    faulthandler.enable()    # a crash in native code prints every thread's stack
    args = parse(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from insitu_bench.lib import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"insitu_bench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    found = banned_modules()
    if found:
        print(f"insitu_bench: the process loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
