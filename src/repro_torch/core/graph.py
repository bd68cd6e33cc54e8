"""Data-centric workflow graph construction from the YAML description.

Users specify *data requirements* (inports/outports: filename + dataset name
patterns), never edges.  Wilkins matches ports to build the task graph
(paper §3.2): a producer outport and a consumer inport are coupled when their
filename patterns match and at least one dataset pattern overlaps.  Any
directed topology results -- pipeline, fan-in, fan-out, NxN, cycles.

Ensembles (§3.2.1): a task with ``taskCount: N`` expands into N instances.
For each matched edge, producer instances and consumer instances are linked
round-robin over the *longer* index list, reproducing Fig. 3 exactly:
4 producers x 2 consumers -> P0-C0, P1-C1, P2-C0, P3-C1;
1 producer  x N consumers -> fan-out; N x N -> one-to-one pairing.

Subset writers (§3.2.2): ``nwriters`` (the paper's ``io_proc``) restricts
which logical ranks of a producer participate in I/O.

Flow control (§3.6): ``io_freq`` on the consumer inport (1/0 = all, N>1 =
some, -1 = latest).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..analysis import rules
from ..obs.recorder import TraceConfig
from .datamodel import match_file, match_path
from .recovery import FailurePolicy
from .scheduler import SchedulerConfig

__all__ = ["DsetSpec", "Port", "TaskSpec", "Edge", "WorkflowGraph"]


@dataclass
class DsetSpec:
    name: str
    file: int = 0
    memory: int = 1

    @property
    def mode(self) -> str:
        if self.memory and not self.file:
            return "memory"
        if self.file and not self.memory:
            return "file"
        if self.file and self.memory:
            return "memory"  # prefer in-situ when both allowed
        raise ValueError(f"dataset {self.name}: neither file nor memory transport enabled")


@dataclass
class Port:
    filename: str
    dsets: List[DsetSpec]
    io_freq: int = 1      # flow control (inports only): 0/1 = all, N>1 =
                          # some (every Nth), -1 = latest; anything else is
                          # rejected at parse time with the task/port named
    queue_depth: int = 1  # channel ring-queue depth (inports only); 1 = paper
                          # rendezvous, >=2 pipelines producer ahead of consumer
    redistribute: bool = False  # M->N planning on this inport: the consumer's
                                # instances/ranks own a decomposition of every
                                # matched dataset and the channel ships only
                                # the owned blocks (paper §3.2.2 / LowFive)
    redist_axis: int = 0        # decomposition axis of the owned blocks
    prefetch: Optional[int] = None  # inport knob: per-edge prefetch DEPTH --
                                    # max in-flight async payload preps on
                                    # each channel of this port (0 = sync
                                    # serve; None = default depth whenever
                                    # the port redistributes)
    weight: int = 1             # inport knob: DWRR share under the `fair`
                                # scheduler policy -- this port's edges get
                                # ~weight x the prep completions of a
                                # weight-1 edge under pool contention
    autotune: Optional[Tuple[int, int]] = None  # inport knob: (min, max)
                                # runtime bounds for the prefetch-depth
                                # autotuner; implies prefetch (initial depth
                                # clamps into the bounds); None = static
    ownership: bool = False     # outports only: the producer's logical ranks
                                # own an even decomposition of every written
                                # dataset; the VOL stamps BlockOwnership at
                                # file close (replaces create_dataset(
                                # ownership=...) in task code)
    own_axis: int = 0           # decomposition axis of the producer blocks
    own_nranks: Optional[int] = None  # block count; None = the task's
                                      # io_procs (nwriters | nprocs)


@dataclass
class TaskSpec:
    func: str
    nprocs: int = 1
    task_count: int = 1
    nwriters: Optional[int] = None       # paper's io_proc / subset writers
    actions: Optional[Tuple[str, str]] = None  # (script/module, function)
    inports: List[Port] = field(default_factory=list)
    outports: List[Port] = field(default_factory=list)
    # YAML ``on_failure:`` -- fail (default, today's chained-error behavior),
    # restart: {max_retries, backoff_s, jitter}, drop (optional task: edges
    # degrade to no-ops), or rescale: {nslots, nprocs} (elastic relaunch at a
    # different size).  See recovery.FailurePolicy.
    on_failure: FailurePolicy = field(default_factory=FailurePolicy)
    # YAML ``stall_timeout_s:`` -- health-watchdog window: no heartbeat from
    # an instance for this long (two consecutive scans: hysteresis) declares
    # it stalled and applies the task's on_failure policy.  None = no watchdog.
    stall_timeout_s: Optional[float] = None
    raw: Dict[str, Any] = field(default_factory=dict)

    @property
    def io_procs(self) -> int:
        return self.nwriters if self.nwriters is not None else self.nprocs


@dataclass
class Edge:
    """A matched producer-outport -> consumer-inport coupling (task level)."""

    producer: str
    consumer: str
    filename_pattern: str       # the consumer's view of the filename
    dset_patterns: List[str]    # consumer dataset selections that matched
    mode: str                   # "memory" | "file"
    io_freq: int = 1
    queue_depth: int = 1
    redistribute: bool = False  # consumer inport declared M->N ownership
    redist_axis: int = 0
    prefetch: Optional[int] = None  # consumer inport's per-edge prefetch depth
    weight: int = 1                 # consumer inport's DWRR scheduler share
    autotune: Optional[Tuple[int, int]] = None  # depth-autotuner bounds

    def instance_links(self, np_: int, nc: int) -> List[Tuple[int, int]]:
        """Round-robin instance pairing over the longer list (paper Fig. 3)."""
        n = max(np_, nc)
        return [(i % np_, i % nc) for i in range(n)]


def _parse_port(p: Dict[str, Any], task: str = "?") -> Port:
    # All legality rules live in analysis.rules (shared with the offline
    # analyzer and the driver's programmatic-trigger checks); this wrapper
    # only owns the dataclasses.
    kw = rules.validated_port(p, task)
    kw["dsets"] = [DsetSpec(name=n, file=f, memory=m)
                   for (n, f, m) in kw["dsets"]]
    return Port(**kw)


def _parse_task(t: Dict[str, Any]) -> TaskSpec:
    actions = rules.validated_actions(t.get("actions"))
    stall = rules.validated_stall_timeout(t)
    spec = TaskSpec(
        func=t["func"],
        nprocs=int(t.get("nprocs", 1)),
        task_count=int(t.get("taskCount", 1)),
        nwriters=int(t["nwriters"]) if "nwriters" in t else (
            int(t["io_proc"]) if "io_proc" in t else None),
        actions=actions,
        inports=[_parse_port(p, t["func"]) for p in t.get("inports", [])],
        outports=[_parse_port(p, t["func"]) for p in t.get("outports", [])],
        on_failure=FailurePolicy.from_yaml(t.get("on_failure"), t["func"]),
        stall_timeout_s=stall,
        raw=dict(t),
    )
    rules.check_task(spec)
    return spec


class WorkflowGraph:
    """Tasks + matched edges; the driver instantiates channels from this."""

    def __init__(self, tasks: List[TaskSpec],
                 scheduler: Optional[SchedulerConfig] = None,
                 tracing: Optional[TraceConfig] = None):
        rules.check_duplicate_names([t.func for t in tasks])
        self.tasks: Dict[str, TaskSpec] = {t.func: t for t in tasks}
        self.scheduler = scheduler if scheduler is not None else SchedulerConfig()
        self.tracing = tracing  # None = the zero-cost default (no tracer)
        self.edges: List[Edge] = self._match()
        self._validate_rescale()

    # ------------------------------------------------------------- loading
    @classmethod
    def from_yaml(cls, source: Union[str, Dict[str, Any]]) -> "WorkflowGraph":
        if isinstance(source, str):
            # imported here: a caller passing a parsed dict needs no PyYAML
            import yaml

            if os.path.exists(source):
                with open(source) as f:
                    doc = yaml.safe_load(f)
            else:
                doc = yaml.safe_load(source)
        else:
            doc = source
        rules.check_workflow_doc(doc)
        return cls([_parse_task(t) for t in doc["tasks"]],
                   scheduler=SchedulerConfig.from_yaml(doc.get("scheduler")),
                   tracing=TraceConfig.from_yaml(doc.get("tracing")))

    # ------------------------------------------------------------ matching
    def _match(self) -> List[Edge]:
        edges: List[Edge] = []
        for pname, ptask in self.tasks.items():
            for outp in ptask.outports:
                for cname, ctask in self.tasks.items():
                    if cname == pname:
                        continue
                    for inp in ctask.inports:
                        if not (match_file(inp.filename, outp.filename)
                                or match_file(outp.filename, inp.filename)):
                            continue
                        matched: List[str] = []
                        mode = "memory"
                        for ind in inp.dsets:
                            for outd in outp.dsets:
                                if match_path(ind.name, outd.name) or match_path(
                                    outd.name, ind.name
                                ):
                                    matched.append(ind.name)
                                    mode = ind.mode
                                    break
                        if matched:
                            edges.append(
                                Edge(
                                    producer=pname,
                                    consumer=cname,
                                    filename_pattern=inp.filename,
                                    dset_patterns=matched,
                                    mode=mode,
                                    io_freq=inp.io_freq,
                                    queue_depth=inp.queue_depth,
                                    redistribute=inp.redistribute,
                                    redist_axis=inp.redist_axis,
                                    prefetch=inp.prefetch,
                                    weight=inp.weight,
                                    autotune=inp.autotune,
                                )
                            )
        return edges

    # -------------------------------------------------- rescale validation
    def _validate_rescale(self) -> None:
        """Reject unsupportable elastic-rescale declarations at parse time.

        A ``rescale: {nslots: N}`` relaunch re-partitions the task's inbound
        channels and replays undelivered steps from the producers' retention
        rings -- byte-identical replay is only well-defined when:

        * the task is a pure consumer (no outports): re-cutting a producer's
          instance count would re-pair every downstream edge's round-robin
          ``instance_links`` mid-run;
        * every feeding producer runs a single instance (``taskCount: 1``):
          with multiple producer instances the modulo pairing changes which
          producer feeds which consumer slot across sizes;
        * every inbound edge uses memory transport (file-mode edges carry no
          replayable payloads);
        * no inbound edge uses ``io_freq: -1`` (latest-mode seq assignment
          depends on live waiter timing, so the replay set is not
          deterministic across sizes).

        ``rescale: {nprocs: K}`` alone (no nslots) changes only the logical
        rank count and carries none of these restrictions.
        """
        for name, t in self.tasks.items():
            pol = t.on_failure
            if pol.kind != "rescale" or pol.nslots is None:
                continue
            self.validate_rescale_target(name)

    def validate_rescale_target(self, name: str) -> None:
        """Structural rules for resizing ``name``'s instance count; used at
        parse time for declared policies and again by the driver for
        programmatic ``RunSupervisor.rescale(task, nslots=...)`` triggers
        (which have no YAML to validate).  The rules themselves live in
        ``analysis.rules`` (shared with the offline analyzer)."""
        rules.validate_rescale_target(self, name)

    # ----------------------------------------------------------- utilities
    def producers_of(self, task: str) -> List[Edge]:
        return [e for e in self.edges if e.consumer == task]

    def consumers_of(self, task: str) -> List[Edge]:
        return [e for e in self.edges if e.producer == task]

    def total_instances(self) -> int:
        return sum(t.task_count for t in self.tasks.values())

    def total_procs(self) -> int:
        return sum(t.nprocs * t.task_count for t in self.tasks.values())

    def topology_kind(self) -> str:
        """Classify for reporting: pipeline / fan-in / fan-out / NxN / general."""
        if not self.edges:
            return "disconnected"
        kinds = set()
        for e in self.edges:
            np_ = self.tasks[e.producer].task_count
            nc = self.tasks[e.consumer].task_count
            if np_ == 1 and nc == 1:
                kinds.add("pipeline")
            elif np_ == 1:
                kinds.add("fan-out")
            elif nc == 1:
                kinds.add("fan-in")
            elif np_ == nc:
                kinds.add("NxN")
            else:
                kinds.add("MxN")
        return "+".join(sorted(kinds))

    def __repr__(self) -> str:
        return (f"<WorkflowGraph tasks={list(self.tasks)} edges={len(self.edges)} "
                f"topology={self.topology_kind()}>")
