"""One run of an ``insitu_bench`` cell, as ``insitu_bench/run.py`` makes it,
with per-layer readers of ``insitu_bench/metrics/`` that ``BENCHMARK.json``
does not declare for the cell added to its result line.

    python3 tools/run_with_readers.py --reader attn_roofline:% \\
        --reader train.forward_ms -- \\
        --workload zamba2-7b.insitu_train_4k --seed 7 --seconds 51 --trace 1

Each ``--reader NAME[:UNIT]`` names a reader file ``metrics/NAME.py``; a
name that ``BENCHMARK.json`` declares for another cell keeps its unit
there, any other needs ``UNIT``.  The run goes through ``run.main``, so the
standard output, the result line and the exit code are the benchmark's;
the added readers read the same raw result as the declared ones, in a
``--trace 1`` run.  A tool for reading a metric before a benchmark change
declares it, not a metric of the benchmark.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def extra_metrics(specs: List[str], declared: Dict[str, Dict]) -> List[Dict]:
    """The per-layer entries of ``--reader`` arguments ``NAME[:UNIT]``."""
    out = []
    for s in specs:
        name, _, unit = s.partition(":")
        m = dict(declared.get(name, {"name": name}))
        if unit:
            m["unit"] = unit
        if not m.get("unit"):
            raise ValueError(f"{name}: not declared in BENCHMARK.json, give NAME:UNIT")
        out.append(m)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reader", action="append", default=[], metavar="NAME[:UNIT]")
    ap.add_argument("run_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    run_args = args.run_args[1:] if args.run_args[:1] == ["--"] else args.run_args
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from insitu_bench import run
    from insitu_bench.lib import spec

    declared = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    extra = extra_metrics(args.reader, declared)
    for m in extra:
        spec.reader(m["name"])      # a missing reader fails before the run
    load_cell = spec.load_cell

    def with_readers(name, *a, **kw):
        cell = load_cell(name, *a, **kw)
        have = {m["name"] for m in cell.per_layer}
        cell.per_layer.extend(m for m in extra if m["name"] not in have)
        return cell

    spec.load_cell = with_readers
    try:
        return run.main(run_args)
    finally:
        spec.load_cell = load_cell


if __name__ == "__main__":
    sys.exit(main())
