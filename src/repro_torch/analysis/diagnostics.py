"""Shared diagnostics framework for the pre-run analyzers.

Every finding the workflow analyzer (``analysis.workflow``), the AST lint
(``analysis.astlint``) or the runtime lock checker (``analysis.lockcheck``)
produces is a :class:`Diagnostic`: a stable code (``WLK...``), a severity,
a human message, and a location that names the YAML file/task/port or the
source file/line it anchors to.  The code is the contract -- tests, CI
gates and suppressions key on it, never on message text.

Suppressions come in two spellings:

* a line comment on the offending YAML/source line::

      queue_depth: 1   # wilkins: ignore[WLK201]

  (bare ``# wilkins: ignore`` suppresses every code on that line);

* a workflow-level block in the YAML document::

      lint:
        ignore: [WLK222, WLK224]

Output is text (one finding per line, ``file:line: CODE severity message``)
or JSON (``render_json``), selected by the CLI.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Severity",
    "Location",
    "Diagnostic",
    "Findings",
    "REGISTRY",
    "severity_of",
    "line_suppressions",
]


class Severity:
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    _RANK = {ERROR: 2, WARNING: 1, INFO: 0}

    @classmethod
    def rank(cls, sev: str) -> int:
        return cls._RANK.get(sev, 0)


#: code -> (default severity, one-line title).  The single source of truth:
#: the CLI ``--codes`` listing, the DESIGN.md table and the fixture corpus
#: all enumerate THIS dict, so a code without a fixture is a test failure.
REGISTRY: Dict[str, tuple] = {
    # ---- input / document structure --------------------------------------
    "WLK001": (Severity.ERROR, "workflow YAML failed to parse"),
    "WLK002": (Severity.ERROR, "workflow document structure invalid"),
    # ---- schema / policy legality (shared with core.graph parse time) ----
    "WLK101": (Severity.ERROR, "queue_depth out of range"),
    "WLK102": (Severity.ERROR, "io_freq invalid"),
    "WLK103": (Severity.ERROR, "redistribute axis invalid"),
    "WLK104": (Severity.ERROR, "prefetch depth invalid"),
    "WLK105": (Severity.ERROR, "scheduler weight invalid"),
    "WLK106": (Severity.ERROR, "autotune spelling or bounds invalid"),
    "WLK107": (Severity.ERROR, "ownership spelling invalid"),
    "WLK108": (Severity.ERROR, "knob declared on the wrong port side"),
    "WLK109": (Severity.ERROR, "autotune conflicts with prefetch: 0"),
    "WLK110": (Severity.ERROR, "ownership nranks matches no rank count"),
    "WLK111": (Severity.ERROR, "stall_timeout_s invalid"),
    "WLK112": (Severity.ERROR, "stall_timeout_s needs a managed policy"),
    "WLK113": (Severity.ERROR, "on_failure policy invalid"),
    "WLK114": (Severity.ERROR, "scheduler block invalid"),
    "WLK115": (Severity.ERROR, "actions spelling invalid"),
    "WLK116": (Severity.ERROR, "duplicate task func names"),
    "WLK117": (Severity.ERROR, "rescale target violates structural rules"),
    "WLK118": (Severity.ERROR, "programmatic rescale request invalid"),
    # ---- graph shape ------------------------------------------------------
    "WLK201": (Severity.ERROR, "rendezvous deadlock cycle (all edges "
                               "io_freq: all + queue_depth: 1)"),
    "WLK202": (Severity.WARNING, "bounded-queue cycle can deadlock when "
                                 "rings fill"),
    "WLK203": (Severity.WARNING, "outport matches the task's own inport "
                                 "(self-edge is ignored at runtime)"),
    "WLK204": (Severity.WARNING, "memory-mode inport matched no producer"),
    "WLK210": (Severity.WARNING, "fan-in mixes a strict rendezvous edge "
                                 "with a dropping edge"),
    "WLK211": (Severity.WARNING, "producer gated by a strict edge; sibling "
                                 "dropping edge cannot run ahead"),
    "WLK212": (Severity.INFO, "latest-mode edge with prefetch/autotune "
                              "preps payloads that may be dropped"),
    # ---- decomposition legality ------------------------------------------
    "WLK220": (Severity.ERROR, "decomposition axis out of range for the "
                               "declared dataset rank"),
    "WLK221": (Severity.WARNING, "declared shape yields empty blocks"),
    "WLK222": (Severity.INFO, "flattened inner extent not a 128-lane "
                              "multiple (pack kernel pads)"),
    "WLK223": (Severity.WARNING, "nwriters exceeds nprocs"),
    "WLK224": (Severity.INFO, "shape not divisible by the decomposition "
                              "rank count (uneven blocks)"),
    "WLK225": (Severity.ERROR, "reshard plan does not cover every "
                               "destination element exactly once"),
    "WLK226": (Severity.ERROR, "reshard plan slab box out of bounds"),
    # ---- concurrency: AST lint over core/ --------------------------------
    "WLK301": (Severity.ERROR, "channel state mutated outside the channel "
                               "condition variable"),
    "WLK302": (Severity.ERROR, "Condition.wait outside a while predicate "
                               "loop"),
    "WLK303": (Severity.WARNING, "supervisor-aware wait loop does not "
                                 "heartbeat"),
    "WLK304": (Severity.ERROR, "stats counter mutated outside its owning "
                               "lock"),
    "WLK305": (Severity.ERROR, "direct threading primitive construction in "
                               "core (use the make_* factories)"),
    # ---- concurrency: runtime lock checker (WILKINS_LOCKCHECK=1) ---------
    "WLK310": (Severity.ERROR, "lock-acquisition cycle (potential "
                               "deadlock)"),
    "WLK311": (Severity.ERROR, "blocking call while holding a lock"),
    "WLK312": (Severity.WARNING, "locks acquired against the canonical "
                                 "rank order"),
    # ---- concurrency: schedule explorer (WILKINS_EXPLORE=1) --------------
    "WLK320": (Severity.ERROR, "data race: unordered accesses to a shared "
                               "buffer, at least one a write"),
    "WLK321": (Severity.ERROR, "deadlock or timed-wait livelock under an "
                               "explored schedule"),
    "WLK322": (Severity.ERROR, "lost wakeup: waiter parked with no live "
                               "notifier"),
    "WLK323": (Severity.ERROR, "scenario invariant failed under an "
                               "explored schedule"),
}


def severity_of(code: str) -> str:
    return REGISTRY.get(code, (Severity.ERROR,))[0]


@dataclass(frozen=True)
class Location:
    """Where a finding anchors: a file plus whichever of line/task/port
    applies.  Any field may be absent (runtime lockcheck findings have no
    file at all)."""

    file: Optional[str] = None
    line: Optional[int] = None
    task: Optional[str] = None
    port: Optional[str] = None

    def __str__(self) -> str:
        head = self.file or "<workflow>"
        if self.line is not None:
            head += f":{self.line}"
        tail = []
        if self.task is not None:
            tail.append(f"task {self.task!r}")
        if self.port is not None:
            tail.append(f"port {self.port!r}")
        return head + (" (" + ", ".join(tail) + ")" if tail else "")

    def as_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in (("file", self.file), ("line", self.line),
                                  ("task", self.task), ("port", self.port))
                if v is not None}


@dataclass
class Diagnostic:
    code: str
    message: str
    location: Location = field(default_factory=Location)
    severity: Optional[str] = None  # None = the registry default for code

    def __post_init__(self):
        if self.severity is None:
            self.severity = severity_of(self.code)

    def render(self) -> str:
        return f"{self.location}: {self.code} {self.severity}: {self.message}"

    def as_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "severity": self.severity,
                "message": self.message, "location": self.location.as_dict()}


_IGNORE_RE = re.compile(r"#\s*wilkins:\s*ignore(?:\[([A-Z0-9,\s]+)\])?")


def line_suppressions(text: str) -> Dict[int, Optional[set]]:
    """Map 1-based line number -> set of suppressed codes (None = all codes)
    for every ``# wilkins: ignore[...]`` line comment in ``text``."""
    out: Dict[int, Optional[set]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _IGNORE_RE.search(line)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return out


class Findings:
    """An ordered collection of diagnostics with suppression filtering and
    the two renderers."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = ()):
        self.diagnostics: List[Diagnostic] = list(diagnostics)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.ERROR]

    def suppress(self, codes: Sequence[str] = (),
                 by_line: Optional[Dict[int, Optional[set]]] = None
                 ) -> "Findings":
        """A new Findings with document-level ``codes`` and per-line
        ``# wilkins: ignore`` suppressions applied."""
        doc = set(codes or ())
        by_line = by_line or {}
        kept = []
        for d in self.diagnostics:
            if d.code in doc:
                continue
            ln = d.location.line
            if ln is not None and ln in by_line:
                only = by_line[ln]
                if only is None or d.code in only:
                    continue
            kept.append(d)
        return Findings(kept)

    def sorted(self) -> "Findings":
        return Findings(sorted(
            self.diagnostics,
            key=lambda d: (-Severity.rank(d.severity),
                           d.location.file or "", d.location.line or 0,
                           d.code)))

    def render_text(self) -> str:
        if not self.diagnostics:
            return "no findings"
        lines = [d.render() for d in self.sorted()]
        n_err = len(self.errors())
        lines.append(f"{len(self.diagnostics)} finding(s), {n_err} error(s)")
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "findings": [d.as_dict() for d in self.sorted()],
            "counts": {
                "total": len(self.diagnostics),
                "error": len(self.errors()),
                "warning": sum(1 for d in self.diagnostics
                               if d.severity == Severity.WARNING),
                "info": sum(1 for d in self.diagnostics
                            if d.severity == Severity.INFO),
            }}, indent=2)
