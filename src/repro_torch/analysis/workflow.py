"""Pass 1: the offline workflow-graph analyzer.

Builds the task/port/edge graph from a workflow YAML *without running it*
and collects every legality and hazard finding as diagnostics:

* **policy/schema legality** (WLK1xx) -- the same ``analysis.rules``
  registry ``core.graph`` enforces at parse time, but run per-field so one
  pass reports *every* violation instead of raising on the first;
* **graph shape** (WLK20x/21x) -- rendezvous deadlock cycles over
  ``io_freq: all`` + ``queue_depth: 1`` edges, self-feeding ports,
  unmatched memory inports, and flow-control hazards (strict/dropping
  mixes, latest x prefetch);
* **decomposition legality** (WLK22x) -- ``redistribute``/``ownership``
  axis vs the declared dataset rank, empty/uneven blocks, and the Pallas
  lane-width hint (the pack kernels tile 128 lanes; for flattened N-D
  plans the effective tile is ``tile_rows * inner``).

Rank/shape checks key on *optional* dataset hints the runtime ignores::

    dsets:
      - name: /particles
        rank: 3                 # or shape: [512, 64, 48]

Entry points: :func:`analyze_source` (YAML text), :func:`analyze_file`
(``.yaml`` or an example ``.py`` with an embedded ``WORKFLOW`` string).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import yaml

from . import plancheck, rules
from .diagnostics import Diagnostic, Findings, Location, line_suppressions
from .rules import WorkflowValidationError

__all__ = ["analyze_source", "analyze_file", "analyze_doc", "load_workflows"]


# ---------------------------------------------------------------------------
# line-tracking YAML loader
# ---------------------------------------------------------------------------
class LineDict(dict):
    """A dict that remembers the 1-based YAML line of its mapping node (and
    of each scalar key) -- a plain dict to every consumer (iteration,
    unknown-key checks, ``**kwargs`` expansion all unchanged)."""

    line: Optional[int] = None
    key_lines: Optional[Dict[str, int]] = None


class _LineLoader(yaml.SafeLoader):
    pass


def _construct_mapping(loader, node):
    d = LineDict()
    d.line = node.start_mark.line + 1
    d.key_lines = {
        k.value: k.start_mark.line + 1 for k, _ in node.value
        if isinstance(getattr(k, "value", None), str)}
    yield d
    d.update(loader.construct_mapping(node, deep=True))


_LineLoader.add_constructor(
    yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, _construct_mapping)


def _line(obj: Any) -> Optional[int]:
    return getattr(obj, "line", None)


def _key_line(obj: Any, key: Optional[str]) -> Optional[int]:
    """The 1-based line of ``key:`` inside mapping ``obj``, if tracked --
    findings anchor at the offending knob's own line, which is also where
    a ``# wilkins: ignore[...]`` comment must sit to suppress them."""
    kl = getattr(obj, "key_lines", None)
    if kl and key:
        return kl.get(key)
    return None


# ---------------------------------------------------------------------------
# per-document analysis
# ---------------------------------------------------------------------------
def analyze_source(text: str, filename: Optional[str] = None) -> Findings:
    """Analyze one workflow YAML document given as text."""
    try:
        doc = yaml.load(text, Loader=_LineLoader)
    except yaml.YAMLError as e:
        mark = getattr(e, "problem_mark", None)
        return Findings([Diagnostic(
            "WLK001", f"workflow YAML failed to parse: {e}",
            Location(file=filename,
                     line=mark.line + 1 if mark is not None else None))])
    findings = analyze_doc(doc, filename=filename)
    ignore: List[str] = []
    if isinstance(doc, dict):
        lint = doc.get("lint")
        if isinstance(lint, dict):
            ignore = [str(c) for c in lint.get("ignore", [])]
    return findings.suppress(codes=ignore, by_line=line_suppressions(text))


def analyze_file(path: str) -> Findings:
    """Analyze a ``.yaml``/``.yml`` workflow file, or every embedded
    ``WORKFLOW`` string of an example ``.py`` module."""
    if path.endswith(".py"):
        out = Findings()
        for name, text in load_workflows(path):
            out.extend(analyze_source(text, filename=f"{path}::{name}"))
        return out
    with open(path) as f:
        return analyze_source(f.read(), filename=path)


def load_workflows(py_path: str) -> List[Tuple[str, str]]:
    """Import a ``.py`` module and return its embedded workflow strings as
    ``(attr_name, yaml_text)`` -- module-level str attributes named
    ``*WORKFLOW*`` (the examples convention), so f-string workflows come
    back already formatted."""
    import importlib.util
    import sys
    mod_name = "_wilkins_check_" + os.path.splitext(
        os.path.basename(py_path))[0]
    spec = importlib.util.spec_from_file_location(mod_name, py_path)
    mod = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [py_path]   # examples may read CLI args at import time
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    out = []
    for attr in sorted(dir(mod)):
        if "WORKFLOW" in attr and isinstance(getattr(mod, attr), str):
            out.append((attr, getattr(mod, attr)))
    return out


def analyze_doc(doc: Any, filename: Optional[str] = None) -> Findings:
    """Analyze an already-loaded workflow document (suppressions NOT
    applied -- :func:`analyze_source` owns those)."""
    findings = Findings()

    def add(code: str, message: str, line: Optional[int] = None,
            task: Optional[str] = None, port: Optional[str] = None) -> None:
        findings.add(Diagnostic(code, message, Location(
            file=filename, line=line, task=task, port=port)))

    def add_err(e: WorkflowValidationError, line: Optional[int] = None
                ) -> None:
        add(e.code, str(e), line=line, task=e.task, port=e.port)

    try:
        rules.check_workflow_doc(doc)
    except WorkflowValidationError as e:
        add_err(e, line=_line(doc) if isinstance(doc, dict) else None)
        return findings
    tasks_doc = doc["tasks"]
    if not isinstance(tasks_doc, list):
        add("WLK002", f"'tasks' must be a list, got {type(tasks_doc).__name__}",
            line=_line(doc))
        return findings

    from ..core.graph import WorkflowGraph, _parse_port
    from ..core.recovery import FailurePolicy
    from ..core.scheduler import SchedulerConfig
    from ..core.datamodel import match_file, match_path

    # ---- scheduler block (WLK114) -----------------------------------------
    scheduler = None
    try:
        scheduler = SchedulerConfig.from_yaml(doc.get("scheduler"))
    except ValueError as e:
        add("WLK114", str(e), line=_line(doc.get("scheduler")) or _line(doc))

    # ---- per-task schema/policy legality (WLK1xx), collected --------------
    specs = []            # TaskSpec for tasks that parsed fully
    port_lines: Dict[Tuple[str, str], Optional[int]] = {}
    task_lines: Dict[str, Optional[int]] = {}
    names: List[str] = []
    for t in tasks_doc:
        if not isinstance(t, dict) or "func" not in t:
            add("WLK002", f"task entry must be a mapping with a 'func' key, "
                f"got {t!r}", line=_line(t) if isinstance(t, dict) else None)
            continue
        name = str(t["func"])
        names.append(name)
        task_lines[name] = _line(t)
        broken = False
        inports, outports = [], []
        for side, dest in (("inports", inports), ("outports", outports)):
            for p in t.get(side, []) or []:
                pline = _line(p) or _line(t)
                if isinstance(p, dict) and "filename" in p:
                    port_lines[(name, str(p["filename"]))] = pline
                try:
                    dest.append(_parse_port(p, name))
                except WorkflowValidationError as e:
                    add_err(e, line=_key_line(p, e.key) or pline)
                    broken = True
                except (KeyError, TypeError, ValueError) as e:
                    add("WLK002", f"task {name!r}: malformed {side[:-1]} "
                        f"{p!r} ({e})", line=pline, task=name)
                    broken = True
        policy = FailurePolicy()
        try:
            policy = FailurePolicy.from_yaml(t.get("on_failure"), name)
        except ValueError as e:
            add("WLK113", str(e), line=_line(t), task=name)
            broken = True
        try:
            actions = rules.validated_actions(t.get("actions"))
        except WorkflowValidationError as e:
            add_err(e, line=_key_line(t, e.key) or _line(t))
            broken = True
            actions = None
        stall = None
        try:
            stall = rules.validated_stall_timeout(t)
        except WorkflowValidationError as e:
            add_err(e, line=_key_line(t, e.key) or _line(t))
            broken = True
        try:
            from ..core.graph import TaskSpec
            spec = TaskSpec(
                func=name,
                nprocs=int(t.get("nprocs", 1)),
                task_count=int(t.get("taskCount", 1)),
                nwriters=int(t["nwriters"]) if "nwriters" in t else (
                    int(t["io_proc"]) if "io_proc" in t else None),
                actions=actions, inports=inports, outports=outports,
                on_failure=policy, stall_timeout_s=stall, raw=dict(t))
        except (TypeError, ValueError) as e:
            add("WLK002", f"task {name!r}: malformed task entry ({e})",
                line=_line(t), task=name)
            continue
        try:
            rules.check_task(spec)
        except WorkflowValidationError as e:
            add_err(e, line=port_lines.get((name, e.port or ""), _line(t)))
            broken = True
        if not broken:
            specs.append(spec)

    try:
        rules.check_duplicate_names(names)
    except WorkflowValidationError as e:
        add_err(e, line=_line(doc))

    if not specs:
        return findings

    # ---- the graph, built without parse-time raising ----------------------
    graph = object.__new__(WorkflowGraph)
    graph.tasks = {s.func: s for s in specs}
    graph.scheduler = scheduler if scheduler is not None else SchedulerConfig()
    graph.edges = graph._match()

    def tloc(name: str) -> Optional[int]:
        return task_lines.get(name)

    def ploc(name: str, port: str) -> Optional[int]:
        return port_lines.get((name, port), task_lines.get(name))

    # declared rescale policies: structural rules (WLK117), collected
    for s in specs:
        pol = s.on_failure
        if pol.kind == "rescale" and pol.nslots is not None:
            try:
                rules.validate_rescale_target(graph, s.func)
            except WorkflowValidationError as e:
                add_err(e, line=tloc(s.func))

    _check_graph_shape(graph, add, tloc, ploc, match_file, match_path)
    _check_decomposition(graph, add, ploc)
    return findings


# ---------------------------------------------------------------------------
# graph-shape hazards (WLK20x / WLK21x)
# ---------------------------------------------------------------------------
def _strict(e) -> bool:
    """A rendezvous edge: every step is delivered and the ring holds one
    item, so the producer blocks until the consumer takes each step."""
    return e.io_freq in (0, 1) and e.queue_depth == 1


def _latest(e) -> bool:
    """Latest-mode sheds *rate-dependently*: it only drops when the
    producer outruns the consumer.  (some-mode, io_freq N>1, skips every
    Nth step deterministically at offer and is immune to pacing.)"""
    return e.io_freq == -1


def _sccs(nodes: List[str], succ: Dict[str, set]) -> List[List[str]]:
    """Tarjan's strongly connected components, iterative."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: set = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(sorted(succ.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(succ.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _check_graph_shape(graph, add, tloc, ploc, match_file, match_path) -> None:
    succ: Dict[str, set] = {}
    for e in graph.edges:
        succ.setdefault(e.producer, set()).add(e.consumer)

    # WLK201 / WLK202: cycles.  A component whose every internal edge is a
    # rendezvous (all + depth-1) deadlocks at step 0: each producer blocks in
    # offer() until its consumer takes, and the consumer is itself parked
    # offering upstream.  With buffering the cycle survives until the rings
    # fill, then deadlocks the same way -- unless a latest-mode edge breaks
    # the blocking chain.
    for comp in _sccs(list(graph.tasks), succ):
        if len(comp) < 2:
            continue
        members = set(comp)
        internal = [e for e in graph.edges
                    if e.producer in members and e.consumer in members]
        path = "->".join(sorted(comp))
        if all(_strict(e) for e in internal):
            add("WLK201",
                f"tasks {sorted(comp)} form a rendezvous cycle: every edge "
                f"is io_freq: all with queue_depth: 1, so each producer "
                f"blocks in offer() until its consumer takes -- the cycle "
                f"deadlocks at the first step ({path})",
                line=tloc(sorted(comp)[0]), task=sorted(comp)[0])
        elif not any(e.io_freq == -1 for e in internal):
            add("WLK202",
                f"tasks {sorted(comp)} form a cycle over bounded queues "
                f"(no latest-mode edge to shed steps): the cycle deadlocks "
                f"once every ring fills ({path})",
                line=tloc(sorted(comp)[0]), task=sorted(comp)[0])

    # WLK203: an outport matching the task's own inport -- the matcher skips
    # self-edges, so the coupling the YAML appears to declare never exists.
    for name, t in graph.tasks.items():
        for outp in t.outports:
            for inp in t.inports:
                if not (match_file(inp.filename, outp.filename)
                        or match_file(outp.filename, inp.filename)):
                    continue
                if any(match_path(i.name, o.name) or match_path(o.name, i.name)
                       for i in inp.dsets for o in outp.dsets):
                    add("WLK203",
                        f"task {name!r}: outport {outp.filename!r} matches "
                        f"the task's own inport {inp.filename!r}; self-edges "
                        f"are ignored at runtime, so this coupling never "
                        f"exists (feed it through a second task or drop the "
                        f"port)", line=ploc(name, inp.filename), task=name,
                        port=inp.filename)

    # WLK204: a memory-mode inport no producer outport matched -- the
    # consumer's intercepted open waits for an in-situ file that no task
    # ever serves.  (File-mode dsets may legitimately read pre-existing
    # files from disk, so only all-memory ports are flagged.)
    for name, t in graph.tasks.items():
        for inp in t.inports:
            if any(d.mode != "memory" for d in inp.dsets):
                continue
            matched = any(e.consumer == name
                          and e.filename_pattern == inp.filename
                          for e in graph.edges)
            if not matched:
                add("WLK204",
                    f"task {name!r}: memory-mode inport {inp.filename!r} "
                    f"matched no producer outport; the consumer will wait "
                    f"forever for an in-situ file no task serves",
                    line=ploc(name, inp.filename), task=name,
                    port=inp.filename)

    # WLK210: fan-in mixing a strict rendezvous edge with a latest edge --
    # the strict edge rate-limits the consumer to its producer, so the
    # latest edge (declared to shed steps when THIS consumer lags) instead
    # sees a consumer that can never catch up to its own pace.
    for name in graph.tasks:
        inbound = graph.producers_of(name)
        stricts = [e for e in inbound if _strict(e)]
        drops = [e for e in inbound if _latest(e)]
        if stricts and drops:
            s, d = stricts[0], drops[0]
            add("WLK210",
                f"task {name!r}: fan-in mixes a strict rendezvous edge from "
                f"{s.producer!r} ({s.filename_pattern!r}) with a latest-mode "
                f"edge from {d.producer!r} ({d.filename_pattern!r}); the "
                f"strict edge paces the consumer, so the latest edge sheds "
                f"steps whenever {s.producer!r} is the slower producer "
                f"(pipeline the strict edge with queue_depth >= 2 if every "
                f"step from {d.producer!r} matters)",
                line=ploc(name, s.filename_pattern), task=name,
                port=s.filename_pattern)

    # WLK211: the mirror image on the producer side -- a producer feeding
    # both a strict rendezvous consumer and a latest consumer is paced by
    # the strict one, so the latest edge's never-block-the-producer intent
    # is defeated: the producer still blocks, on the strict sibling.
    for name in graph.tasks:
        outbound = graph.consumers_of(name)
        stricts = [e for e in outbound if _strict(e)]
        drops = [e for e in outbound if _latest(e)]
        if stricts and drops:
            s, d = stricts[0], drops[0]
            add("WLK211",
                f"task {name!r}: producer feeds a strict rendezvous edge to "
                f"{s.consumer!r} and a latest-mode edge to {d.consumer!r}; "
                f"the strict consumer paces the producer, so io_freq: -1's "
                f"never-block-the-producer intent is defeated (pipeline the "
                f"strict edge with queue_depth >= 2)",
                line=ploc(d.consumer, d.filename_pattern), task=name,
                port=d.filename_pattern)

    # WLK212: latest-mode x prefetch -- async preps are paid for steps the
    # consumer may never take, and an autotuner bumping depth amplifies it.
    for e in graph.edges:
        if e.io_freq == -1 and (e.autotune is not None
                                or (e.prefetch is not None
                                    and e.prefetch != 0)):
            knob = "autotune" if e.autotune is not None else "prefetch"
            add("WLK212",
                f"task {e.consumer!r} port {e.filename_pattern!r}: "
                f"io_freq: -1 (latest) with {knob} preps payloads for "
                f"steps the consumer may drop; prepped-but-dropped steps "
                f"waste pool slots and can starve sibling edges",
                line=ploc(e.consumer, e.filename_pattern), task=e.consumer,
                port=e.filename_pattern)


# ---------------------------------------------------------------------------
# decomposition legality (WLK22x) -- keyed on optional rank/shape dset hints
# ---------------------------------------------------------------------------
def _dset_hints(raw_port: Dict[str, Any]) -> List[Tuple[str, Optional[int],
                                                        Optional[tuple]]]:
    out = []
    for d in raw_port.get("dsets", []) or []:
        if not isinstance(d, dict):
            continue
        shape = d.get("shape")
        shape = tuple(int(x) for x in shape) if isinstance(
            shape, (list, tuple)) else None
        rank = d.get("rank")
        rank = int(rank) if rank is not None else (
            len(shape) if shape is not None else None)
        out.append((str(d.get("name", "*")), rank, shape))
    return out


def _check_decomposition(graph, add, ploc) -> None:
    for name, t in graph.tasks.items():
        # WLK223: subset writers beyond the rank count
        if t.nwriters is not None and t.nwriters > t.nprocs:
            add("WLK223",
                f"task {name!r}: nwriters {t.nwriters} exceeds nprocs "
                f"{t.nprocs}; only nprocs ranks exist to write",
                line=ploc(name, ""), task=name)
        for side, ports in (("inports", t.inports), ("outports", t.outports)):
            raw_ports = t.raw.get(side, []) or []
            for port, raw in zip(ports, raw_ports):
                if side == "inports" and port.redistribute:
                    axis, nranks, what = port.redist_axis, t.nprocs, \
                        "redistribute"
                elif side == "outports" and port.ownership:
                    axis, what = port.own_axis, "ownership"
                    nranks = port.own_nranks if port.own_nranks is not None \
                        else t.io_procs
                else:
                    continue
                if not isinstance(raw, dict):
                    continue
                for dname, rank, shape in _dset_hints(raw):
                    line = ploc(name, port.filename)
                    if rank is not None and axis >= rank:
                        add("WLK220",
                            f"task {name!r} port {port.filename!r}: "
                            f"{what} axis {axis} out of range for dataset "
                            f"{dname!r} with declared rank {rank}",
                            line=line, task=name, port=port.filename)
                        continue
                    if shape is None:
                        continue
                    if shape[axis] < nranks:
                        add("WLK221",
                            f"task {name!r} port {port.filename!r}: "
                            f"dataset {dname!r} extent {shape[axis]} along "
                            f"{what} axis {axis} is smaller than the "
                            f"{nranks}-rank decomposition -- some blocks "
                            f"will be empty",
                            line=line, task=name, port=port.filename)
                    elif shape[axis] % nranks != 0:
                        add("WLK224",
                            f"task {name!r} port {port.filename!r}: "
                            f"dataset {dname!r} extent {shape[axis]} along "
                            f"{what} axis {axis} is not divisible by the "
                            f"{nranks}-rank decomposition (uneven blocks)",
                            line=line, task=name, port=port.filename)
                    inner = math.prod(shape[axis + 1:]) if len(shape) > 1 \
                        else None
                    if inner is not None and inner % 128 != 0:
                        add("WLK222",
                            f"task {name!r} port {port.filename!r}: "
                            f"dataset {dname!r} flattened inner extent "
                            f"{inner} (shape {list(shape)} after axis "
                            f"{axis}) is not a 128-lane multiple; the pack "
                            f"kernel pads each tile_rows*{inner} tile to "
                            f"128 lanes",
                            line=line, task=name, port=port.filename)
                    # WLK225/226: prove the compiled reshard plan for this
                    # edge covers every destination element exactly once
                    # and never indexes out of bounds (plancheck)
                    if side == "inports" and port.redistribute:
                        for e in graph.producers_of(name):
                            if e.filename_pattern != port.filename:
                                continue
                            src_n = graph.tasks[e.producer].io_procs
                            for d in plancheck.verify_edge(
                                    shape, axis, src_n, nranks,
                                    context=(f"edge {e.producer}->{name}:"
                                             f"{port.filename} dataset "
                                             f"{dname!r}")):
                                add(d.code, d.message, line=line,
                                    task=name, port=port.filename)
