"""Command-line face of the analyzers.

::

    python -m repro_torch.analysis check workflow.yaml [more.yaml examples/x.py]
    python -m repro_torch.analysis lint [src/repro_torch/core more paths]
    python -m repro_torch.analysis codes

``check`` runs the workflow-graph analyzer (Pass 1) over YAML files or
example ``.py`` modules with embedded ``WORKFLOW`` strings; ``lint`` runs
the concurrency AST lint (Pass 2, static half), over this package's
``core/`` when given no path.  ``explore``, the schedule explorer (Pass
3), is not part of this package yet and raises ``NotImplementedError``
(ROADMAP Queue 1, item 14b).  ``check`` and ``lint`` print text
findings (or ``--json``) and exit non-zero when any error-severity
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

    ex = sub.add_parser("explore", help="the schedule explorer (not yet "
                                        "ported: raises)")
    ex.add_argument("rest", nargs=argparse.REMAINDER)

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
    raise NotImplementedError(
        "the schedule explorer (analysis/explore/) is not yet ported: "
        "ROADMAP Queue 1, item 14b")


if __name__ == "__main__":
    sys.exit(main())
