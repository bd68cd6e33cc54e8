"""Command-line face of the analyzers.

::

    python -m repro_torch.analysis check workflow.yaml [more.yaml examples/x.py]
    python -m repro_torch.analysis lint [src/repro_torch/core more paths]
    python -m repro_torch.analysis explore [--scenario NAME ...] [--budget N]
    python -m repro_torch.analysis explore --scenario NAME --schedule ID
    python -m repro_torch.analysis codes

``check`` runs the workflow-graph analyzer (Pass 1) over YAML files or
example ``.py`` modules with embedded ``WORKFLOW`` strings; ``lint`` runs
the concurrency AST lint (Pass 2, static half), over this package's
``core/`` when given no path; ``explore`` runs the deterministic schedule
explorer (Pass 3) over the clean-scenario corpus, with the channel
payloads on ``--device`` (the card unless asked otherwise) -- or replays
one schedule ID from a previous finding.  All print text findings (or
``--json``) and exit non-zero when any error-severity
finding survives suppression -- warnings and infos never fail the run
unless ``--strict``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .diagnostics import REGISTRY, Findings, Severity

__all__ = ["main"]

CORE_TREE = os.path.normpath(os.path.join(os.path.dirname(__file__), "..",
                                          "core"))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Pre-run workflow analyzer and lock-discipline lint")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ck = sub.add_parser("check", help="analyze workflow YAMLs / example "
                                      ".py modules without running them")
    ck.add_argument("files", nargs="+")
    ck.add_argument("--json", action="store_true")
    ck.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too")

    ln = sub.add_parser("lint", help="AST lock-discipline lint over "
                                     "Python sources")
    ln.add_argument("paths", nargs="*",
                    help=f"default: this package's core ({CORE_TREE})")
    ln.add_argument("--json", action="store_true")
    ln.add_argument("--strict", action="store_true")

    ex = sub.add_parser("explore", help="enumerate thread schedules over "
                                        "the protocol scenario corpus")
    ex.add_argument("--scenario", action="append", default=None,
                    metavar="NAME", help="scenario(s) to explore "
                    "(default: the whole corpus); see --list")
    ex.add_argument("--list", action="store_true",
                    help="list the scenario corpus and exit")
    ex.add_argument("--budget", type=int, default=256, metavar="N",
                    help="max schedules per scenario (default 256)")
    ex.add_argument("--preemptions", type=int, default=2, metavar="K",
                    help="preemption bound per schedule (default 2)")
    ex.add_argument("--max-steps", type=int, default=20000, metavar="N")
    ex.add_argument("--schedule", metavar="ID",
                    help="replay one schedule ID (requires exactly one "
                    "--scenario; the ID itself names the scenario too)")
    ex.add_argument("--json", action="store_true")
    ex.add_argument("--device", default="cuda", metavar="DEV",
                    help="device of the scenarios' channel payloads "
                    "(default cuda)")

    sub.add_parser("codes", help="list every diagnostic code")

    args = ap.parse_args(argv)

    if args.cmd == "codes":
        for code, (sev, title) in sorted(REGISTRY.items()):
            print(f"{code}  {sev:<7}  {title}")
        return 0

    if args.cmd == "explore":
        return _explore(args)

    if args.cmd == "check":
        from .workflow import analyze_file
        findings = Findings()
        for f in args.files:
            findings.extend(analyze_file(f))
    else:
        from .astlint import lint_paths
        findings = lint_paths(args.paths or [CORE_TREE])

    print(findings.render_json() if args.json else findings.render_text())
    if findings.errors():
        return 1
    if args.strict and any(d.severity == Severity.WARNING for d in findings):
        return 1
    return 0


def _explore(args) -> int:
    # the factories read WILKINS_EXPLORE at make_* time, so the flag must
    # be up before any scenario constructs a core object
    os.environ["WILKINS_EXPLORE"] = "1"
    import json as _json

    from .explore import build_scenario, explore, names, replay

    if args.list:
        for n in names():
            print(n)
        return 0

    if args.schedule:
        scen = args.schedule.partition("@")[0]
        if args.scenario and args.scenario != [scen]:
            print(f"--schedule names scenario {scen!r}, which contradicts "
                  f"--scenario {args.scenario}", file=sys.stderr)
            return 2
        res = replay(build_scenario(scen, args.device), args.schedule,
                     max_steps=args.max_steps)
        doc = {"scenario": scen, "schedule_id": args.schedule,
               "found": len(res.findings) > 0,
               "codes": sorted({d.code for d in res.findings})}
        print(_json.dumps(doc, indent=2) if args.json
              else res.findings.render_text())
        return 1 if res.findings.errors() else 0

    targets = args.scenario or names()
    reports = []
    rc = 0
    for name in targets:
        rep = explore(build_scenario(name, args.device), scenario=name,
                      max_schedules=args.budget,
                      preemption_bound=args.preemptions,
                      max_steps=args.max_steps)
        reports.append(rep)
        if rep.found:
            rc = 1
    if args.json:
        print(_json.dumps([r.as_dict() for r in reports], indent=2))
        return rc
    for rep in reports:
        status = "FOUND" if rep.found else (
            "clean" if rep.complete else "clean (budget-capped)")
        print(f"{rep.scenario:<20} {rep.schedules:>5} schedules "
              f"({rep.pruned} pruned, {rep.steps_total} steps, "
              f"{rep.elapsed_s:.2f}s)  {status}")
        if rep.found:
            print(rep.findings.render_text())
            print(f"  replay: python -m repro_torch.analysis explore "
                  f"--device {args.device} --schedule '{rep.schedule_id}'")
    return rc


if __name__ == "__main__":
    sys.exit(main())
