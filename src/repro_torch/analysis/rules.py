"""The single validation-rule registry for workflow descriptions.

Every parse-time legality rule lives HERE, once: ``core.graph`` calls in at
YAML parse time (raising on the first violation, exactly as before), the
driver calls in for programmatic ``RunSupervisor.rescale`` triggers, and
``analysis.workflow`` calls in per-field to *collect* every violation as a
diagnostic.  Before this module the same rules lived as three drifting
copies across ``graph.py`` and ``driver.py``.

Rules raise :class:`WorkflowValidationError` -- a ``ValueError`` subclass
carrying the stable diagnostic ``code`` plus the task/port the message
names, so existing callers (and every test asserting on message text) see
byte-identical errors while the analyzer gets structured locations for
free.

This module imports nothing from ``repro_torch.core``: ports are validated into
plain kwarg dicts (the graph builds its ``Port`` dataclass from them) and
task/graph objects are duck-typed, so ``graph.py`` and ``driver.py`` can
both import it without cycles.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["WorkflowValidationError", "validated_port", "validated_actions",
           "validated_stall_timeout", "check_task", "check_workflow_doc",
           "check_duplicate_names", "validate_rescale_target",
           "validate_rescale_request"]


class WorkflowValidationError(ValueError):
    """A workflow-description rule violation.

    A plain ``ValueError`` to every pre-existing caller; the diagnostic
    ``code`` and the task/port anchors ride along for the analyzer."""

    def __init__(self, message: str, *, code: str = "WLK100",
                 task: Optional[str] = None, port: Optional[str] = None,
                 key: Optional[str] = None):
        super().__init__(message)
        self.code = code
        self.task = task
        self.port = port
        #: the YAML key the rule rejected (``queue_depth``, ``io_freq``...)
        #: -- lets the analyzer anchor the finding at the knob's own line
        self.key = key


def _err(message: str, code: str, task: Optional[str] = None,
         port: Optional[str] = None, key: Optional[str] = None
         ) -> WorkflowValidationError:
    return WorkflowValidationError(message, code=code, task=task, port=port,
                                   key=key)


# ---------------------------------------------------------------------------
# document structure
# ---------------------------------------------------------------------------
def check_workflow_doc(doc: Any) -> None:
    if not isinstance(doc, dict) or "tasks" not in doc:
        raise _err("workflow YAML must have a top-level 'tasks' list",
                   "WLK002")


def check_duplicate_names(names: List[str]) -> None:
    if len(set(names)) != len(names):
        raise _err(f"duplicate task func names: {names}", "WLK116")


# ---------------------------------------------------------------------------
# port-level legality (the old graph._parse_port body)
# ---------------------------------------------------------------------------
def validated_port(p: Dict[str, Any], task: str = "?") -> Dict[str, Any]:
    """Validate one inport/outport mapping and return the ``Port`` kwargs.

    ``dsets`` comes back as ``(name, file, memory)`` tuples -- the caller
    owns the dataclass."""
    dsets = [
        (d["name"],
         int(d.get("file", 0) or 0),
         int(d.get("memory", 0) or 0) if "memory" in d or "file" in d else 1)
        for d in p.get("dsets", [])
    ]
    if not dsets:
        dsets = [("*", 0, 1)]
    qd = int(p.get("queue_depth", 1))
    if qd < 1:
        raise _err(f"queue_depth must be >= 1, got {qd}",
                   "WLK101", task, p.get("filename"), key="queue_depth")
    # Flow control is validated HERE, with the task and port named -- by the
    # time a bad value used to reach FlowControl.from_io_freq (at channel
    # construction, deep inside the driver) the error no longer said which
    # YAML line to fix, and a typo'd -2 read like a runtime bug.
    io_freq = int(p.get("io_freq", 1))
    if io_freq < -1:
        raise _err(
            f"task {task!r} port {p['filename']!r}: io_freq {io_freq} is "
            f"invalid; use 0/1 (all), N>1 (some: every Nth step), or -1 "
            f"(latest)", "WLK102", task, p.get("filename"), key="io_freq")
    # ``redistribute: 1`` or ``redistribute: {axis: A}`` on a consumer inport
    redist = p.get("redistribute", 0)
    axis = 0
    if isinstance(redist, dict):
        axis = int(redist.get("axis", 0))
        redist = True
    else:
        redist = bool(int(redist or 0))
    if axis < 0:
        raise _err(f"redistribute axis must be >= 0, got {axis}",
                   "WLK103", task, p.get("filename"), key="redistribute")
    # ``prefetch: N`` on a consumer inport: per-edge async-prep depth
    # (0 = synchronous serve, N >= 1 = at most N in-flight preps per
    # channel).  YAML booleans pass through untouched so the legacy
    # ``prefetch: true`` spelling keeps meaning "default depth", not 1.
    prefetch = p.get("prefetch")
    if prefetch is not None and not isinstance(prefetch, bool):
        prefetch = int(prefetch)
        if prefetch < 0:
            raise _err(
                f"task {task!r} port {p['filename']!r}: prefetch depth must "
                f"be >= 0 (0 = sync serve, N = per-edge depth), got {prefetch}",
                "WLK104", task, p.get("filename"), key="prefetch")
    # ``weight: N`` on a consumer inport: this port's DWRR share under the
    # top-level ``scheduler: {policy: fair}`` arbitration
    weight = int(p.get("weight", 1))
    if weight < 1:
        raise _err(
            f"task {task!r} port {p['filename']!r}: scheduler weight must be "
            f">= 1, got {weight}", "WLK105", task, p.get("filename"), key="weight")
    # ``autotune: 1`` / ``autotune: N`` / ``autotune: {min: A, max: B}`` on a
    # consumer inport: runtime prefetch-depth bounds for the autotuner.
    # Spellings: 1/true -> default bounds [1, 8]; an int N >= 2 -> [1, N];
    # a mapping sets both ends.  min >= 1 always (a zero-depth autotuned
    # edge could park a producer forever on an unpassable semaphore; use
    # ``prefetch: 0`` to disable prefetch instead).
    at = p.get("autotune", None)
    autotune: Optional[Tuple[int, int]] = None
    if isinstance(at, dict):
        unknown = set(at) - {"min", "max"}
        if unknown:
            raise _err(
                f"task {task!r} port {p['filename']!r}: unknown autotune keys "
                f"{sorted(unknown)} (expected min, max)",
                "WLK106", task, p.get("filename"), key="autotune")
        bounds = {}
        for key, default in (("min", 1), ("max", 8)):
            val = at.get(key, default)
            if isinstance(val, bool) or not isinstance(val, int):
                raise _err(
                    f"task {task!r} port {p['filename']!r}: autotune {key} "
                    f"must be an integer depth, got {val!r}",
                    "WLK106", task, p.get("filename"), key="autotune")
            bounds[key] = val
        autotune = (bounds["min"], bounds["max"])
    elif at is not None and at is not False and at != 0:
        if at is True or at == 1:
            autotune = (1, 8)
        elif isinstance(at, int) and at >= 2:
            autotune = (1, at)
        else:
            raise _err(
                f"task {task!r} port {p['filename']!r}: autotune must be "
                f"1/true, a max depth >= 2, or {{min, max}}, got {at!r}",
                "WLK106", task, p.get("filename"), key="autotune")
    if autotune is not None:
        amin, amax = autotune
        if amin < 1:
            raise _err(
                f"task {task!r} port {p['filename']!r}: autotune min must be "
                f">= 1, got {amin} (use prefetch: 0 to disable prefetch)",
                "WLK106", task, p.get("filename"), key="autotune")
        if amax < amin:
            raise _err(
                f"task {task!r} port {p['filename']!r}: autotune bounds must "
                f"satisfy min <= max, got [{amin}, {amax}]",
                "WLK106", task, p.get("filename"), key="autotune")
    # ``ownership: 1`` or ``ownership: {axis: A, nranks: K}`` on an outport
    own = p.get("ownership", 0)
    own_axis, own_nranks = 0, None
    if isinstance(own, dict):
        unknown = set(own) - {"axis", "nranks"}
        if unknown:
            raise _err(
                f"port {p['filename']!r}: unknown ownership keys {sorted(unknown)} "
                f"(expected axis, nranks)", "WLK107", task, p.get("filename"), key="ownership")
        own_axis = int(own.get("axis", 0))
        if "nranks" in own:
            own_nranks = int(own["nranks"])
        own = True
    else:
        own = bool(int(own or 0))
    if own_axis < 0:
        raise _err(
            f"port {p['filename']!r}: ownership axis must be >= 0, got {own_axis}",
            "WLK107", task, p.get("filename"), key="ownership")
    if own_nranks is not None and own_nranks < 1:
        raise _err(
            f"port {p['filename']!r}: ownership nranks must be >= 1, got {own_nranks}",
            "WLK107", task, p.get("filename"), key="ownership")
    return dict(filename=p["filename"], dsets=dsets,
                io_freq=io_freq, queue_depth=qd,
                redistribute=redist, redist_axis=axis, prefetch=prefetch,
                weight=weight, autotune=autotune,
                ownership=own, own_axis=own_axis, own_nranks=own_nranks)


# ---------------------------------------------------------------------------
# task-level legality (the old graph._parse_task checks)
# ---------------------------------------------------------------------------
def validated_actions(actions: Any) -> Optional[Tuple[str, str]]:
    if actions is None:
        return None
    if not (isinstance(actions, (list, tuple)) and len(actions) == 2):
        raise _err(f"actions must be [script, function], got {actions!r}",
                   "WLK115", key="actions")
    return (str(actions[0]), str(actions[1]))


def validated_stall_timeout(t: Dict[str, Any]) -> Optional[float]:
    stall = t.get("stall_timeout_s")
    if stall is None:
        return None
    try:
        stall = float(stall)
    except (TypeError, ValueError):
        raise _err(
            f"task {t['func']!r}: stall_timeout_s must be a number of "
            f"seconds, got {t['stall_timeout_s']!r}",
            "WLK111", t.get("func"), key="stall_timeout_s") from None
    if stall <= 0:
        raise _err(
            f"task {t['func']!r}: stall_timeout_s must be > 0, got "
            f"{stall} (omit the key to disable the watchdog)",
            "WLK111", t.get("func"), key="stall_timeout_s")
    return stall


def check_task(spec: Any) -> None:
    """Cross-field legality of a parsed task spec (duck-typed: needs
    ``func``/``nprocs``/``io_procs``/``inports``/``outports``/
    ``on_failure``/``stall_timeout_s``).  Raises on the FIRST violation, in
    the same order the old inline checks ran."""
    for p in spec.inports:
        if p.ownership:
            raise _err(
                f"task {spec.func!r}: ownership is an outport declaration "
                f"(inport {p.filename!r} declared it); use redistribute: on "
                f"inports", "WLK108", spec.func, p.filename)
    for p in spec.inports:
        if p.autotune is not None and p.prefetch == 0:
            raise _err(
                f"task {spec.func!r} inport {p.filename!r}: autotune needs "
                f"prefetch enabled, but the port declares prefetch: 0; drop "
                f"one of the two", "WLK109", spec.func, p.filename)
    for p in spec.outports:
        if p.prefetch is not None:
            raise _err(
                f"task {spec.func!r}: prefetch is an inport declaration "
                f"(outport {p.filename!r} declared it); it rides the "
                f"consumer's redistribute port", "WLK108", spec.func,
                p.filename)
        if p.weight != 1:
            raise _err(
                f"task {spec.func!r}: weight is an inport declaration "
                f"(outport {p.filename!r} declared it); the fair scheduler "
                f"arbitrates consumer edges", "WLK108", spec.func, p.filename)
        if p.autotune is not None:
            raise _err(
                f"task {spec.func!r}: autotune is an inport declaration "
                f"(outport {p.filename!r} declared it); depth is a consumer-"
                f"edge property", "WLK108", spec.func, p.filename)
        if p.own_nranks is not None and p.own_nranks not in (
                spec.nprocs, spec.io_procs):
            raise _err(
                f"task {spec.func!r} outport {p.filename!r}: ownership nranks "
                f"{p.own_nranks} matches neither nprocs={spec.nprocs} nor "
                f"nwriters={spec.io_procs}", "WLK110", spec.func, p.filename)
    if spec.stall_timeout_s is not None:
        # The watchdog turns "no heartbeat" into a *policy application*; on
        # an unmanaged task there is no policy to apply, and restart-on-stall
        # is rejected too (a stalled-but-alive incarnation would keep serving
        # into channels its restarted twin also serves -- rescale fences the
        # old incarnation under a new generation, restart does not).
        pol = spec.on_failure
        managed = (pol.kind == "drop"
                   or (pol.kind == "rescale" and pol.nslots is not None))
        if not managed:
            raise _err(
                f"task {spec.func!r}: stall_timeout_s requires a managed "
                f"on_failure policy that can fence the stalled incarnation "
                f"-- rescale: {{nslots: N}} or drop: -- but the task "
                f"declares {pol.kind!r}", "WLK112", spec.func)


# ---------------------------------------------------------------------------
# elastic-rescale structural rules (parse-time AND programmatic triggers)
# ---------------------------------------------------------------------------
def validate_rescale_target(graph: Any, name: str) -> None:
    """Structural rules for resizing ``name``'s instance count.

    ``graph`` is duck-typed: a ``tasks`` mapping (specs with ``outports``/
    ``task_count``) plus ``producers_of(name)`` returning the inbound edges
    (``producer``/``mode``/``filename_pattern``/``io_freq``).  Used at parse
    time for declared ``on_failure: {rescale: ...}`` policies and again by
    the driver for programmatic ``RunSupervisor.rescale`` triggers."""
    t = graph.tasks[name]
    if t.outports:
        raise _err(
            f"task {name!r}: rescale: {{nslots: ...}} requires a "
            f"pure consumer (no outports) -- resizing a producer "
            f"would re-pair every downstream edge's round-robin "
            f"instance links mid-run; use rescale: {{nprocs: ...}} "
            f"to resize a producer's logical ranks instead", "WLK117", name)
    inbound = graph.producers_of(name)
    if not inbound:
        raise _err(
            f"task {name!r}: rescale: {{nslots: ...}} declared but "
            f"no inport edge matched -- an isolated task has no "
            f"channels to re-partition", "WLK117", name)
    for e in inbound:
        if graph.tasks[e.producer].task_count != 1:
            raise _err(
                f"task {name!r}: rescale: {{nslots: ...}} requires "
                f"every feeding producer to run a single instance, "
                f"but {e.producer!r} has taskCount="
                f"{graph.tasks[e.producer].task_count}", "WLK117", name)
        if e.mode != "memory":
            raise _err(
                f"task {name!r}: rescale: {{nslots: ...}} requires "
                f"memory transport on every inbound edge, but the "
                f"edge from {e.producer!r} ({e.filename_pattern!r}) "
                f"uses file mode", "WLK117", name)
        if e.io_freq == -1:
            raise _err(
                f"task {name!r}: rescale: {{nslots: ...}} cannot "
                f"combine with io_freq: -1 (latest) on the edge from "
                f"{e.producer!r} -- latest-mode step selection "
                f"depends on live consumer timing, so the replay "
                f"set is not deterministic across sizes", "WLK117", name)


def validate_rescale_request(graph: Any, task: str,
                             nslots: Optional[int] = None,
                             nprocs: Optional[int] = None) -> None:
    """Programmatic-trigger validation (``RunSupervisor.rescale`` / YAML-free
    callers): request-shape rules, then the same structural rules the graph
    enforces at parse time."""
    if task not in graph.tasks:
        raise _err(f"rescale: unknown task {task!r}", "WLK118", task)
    if nslots is None and nprocs is None:
        raise _err(
            f"rescale {task!r}: nothing to change -- give nslots "
            f"and/or nprocs", "WLK118", task)
    if nslots is not None and int(nslots) < 1:
        raise _err(
            f"rescale {task!r}: nslots must be >= 1, got {nslots}",
            "WLK118", task)
    if nprocs is not None and int(nprocs) < 1:
        raise _err(
            f"rescale {task!r}: nprocs must be >= 1, got {nprocs}",
            "WLK118", task)
    if nslots is not None:
        validate_rescale_target(graph, task)
