"""CLI: offline analysis of an exported trace.

    python -m repro_torch.obs report trace.json [--json]

Loads a Perfetto ``trace.json`` written by ``export_trace`` (round-trips
the recorder coordinates stashed in event args), runs the critical-path
analyzer, and prints the attribution tables -- or the raw report as JSON
with ``--json``.
"""

from __future__ import annotations

import argparse
import json
import sys

from .critical import attribute, format_report
from .export import load_trace
from .recorder import span_categories


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="critical-path report from a trace")
    rep.add_argument("trace", help="trace.json written by export_trace")
    rep.add_argument("--json", action="store_true", dest="as_json",
                     help="emit the raw attribution report as JSON")
    ns = p.parse_args(argv)

    spans = load_trace(ns.trace)
    if not spans:
        print(f"{ns.trace}: no spans", file=sys.stderr)
        return 1
    report = attribute(spans)
    if ns.as_json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        cats = span_categories(spans)
        print(f"{ns.trace}: {len(spans)} spans across layers "
              f"{', '.join(cats)}")
        print(format_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
