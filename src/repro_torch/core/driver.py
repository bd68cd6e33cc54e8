"""Wilkins-master: the generic workflow driver (paper §3.3, §3.5).

The driver (i) reads the workflow YAML and builds the matched graph,
(ii) partitions global resources into restricted per-task worlds,
(iii) creates the channels for every matched edge x ensemble-instance pair
with the configured transport mode and flow control, (iv) installs a VOL
object per task instance and loads custom actions, and (v) launches the task
callables and runs them to completion -- relaunching stateless consumers while
matched producers still have data (the query protocol) and restarting failed
tasks up to a restart budget (fault tolerance).

Users never modify this code; everything is driven by the YAML plus optional
external action scripts -- exactly the paper's usability contract.

Execution model notes (hardware adaptation, see DESIGN.md): task instances run
as Python threads (Henson-style cooperative coroutines are used by the tests
for determinism where needed).  SPMD rank parallelism *within* a task is
carried by the data model (BlockOwnership on datasets + the M->N
redistribution planner) and by the task's restricted device group, rather
than by OS processes.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..analysis.lockcheck import make_lock
from ..obs.critical import attribute, format_report
from ..obs.export import export_trace
from ..obs.recorder import SpanRecorder, TraceConfig, set_last_run_spans
from . import actions as actions_mod
from .channel import Channel, PrefetchPool
from .comm import TaskComm, pop_comm, push_comm
from .datamodel import transport_stats
from .graph import WorkflowGraph
from .recovery import (FailurePolicy, FaultPlan, RecoveryContext,
                       RescaleEvent, RescaleInterrupt, RunSupervisor,
                       StallEvent, SupersededError, TaskState)
from .redistribute import RedistSpec, plan_cache
from .scheduler import SchedulerRuntime, TelemetryTimeline
from .vol import VOL, pop_vol, push_vol

__all__ = ["Wilkins", "WorkflowReport", "TaskFailure"]

# Monotonic id per Wilkins instance: checkpoint roots are keyed by
# (driver, run) so two drivers sharing a spill_dir stay isolated.
_driver_seq_lock = make_lock("leaf:driver_seq")
_driver_seq = 0


def _next_driver_seq() -> int:
    global _driver_seq
    with _driver_seq_lock:
        _driver_seq += 1
        return _driver_seq


@dataclass
class TaskFailure:
    task: str
    instance: int
    attempt: int
    error: str


@dataclass
class WorkflowReport:
    wall_time_s: float = 0.0
    task_times: Dict[Tuple[str, int], float] = field(default_factory=dict)
    task_launches: Dict[Tuple[str, int], int] = field(default_factory=dict)
    channels: List[Channel] = field(default_factory=list)
    failures: List[TaskFailure] = field(default_factory=list)
    # end-of-run snapshots of the PROCESS-WIDE transport / plan-cache
    # counters (prefetch hit/miss + overlap seconds, redistribution bytes,
    # compiled-plan reuse) -- filled by ``Wilkins.run`` on success and on
    # both failure paths, so ``err.report.summary()`` shows them too
    transport: Dict[str, Any] = field(default_factory=dict)
    plan_cache: Dict[str, Any] = field(default_factory=dict)
    # runtime-scheduling snapshot (policy, step/tick counts, autotuner
    # decisions, final per-edge depths) and the telemetry timeline ring --
    # exportable as JSON via ``timeline.export(path)`` for offline replay
    scheduler: Dict[str, Any] = field(default_factory=dict)
    timeline: Optional[TelemetryTimeline] = None
    # recovery outcomes: one dict per RestartEvent (task/instance/attempt/
    # epoch/reason), the instances a `drop` policy degraded to no-ops, and
    # async prep errors nobody re-raised (drained from the prefetch pool at
    # teardown -- the shutdown-race audit; never silently dropped)
    restarts: List[Dict[str, Any]] = field(default_factory=list)
    dropped_tasks: List[Tuple[str, int]] = field(default_factory=list)
    prefetch_errors: List[Tuple[Optional[str], str]] = field(default_factory=list)
    # elastic rescale outcomes: one dict per RescaleEvent (old/new sizes,
    # trigger, consistent-cut step, end-to-end surgery latency) and one per
    # StallEvent the health watchdog declared (silent window vs timeout and
    # the action the policy took)
    rescales: List[Dict[str, Any]] = field(default_factory=list)
    stalls: List[Dict[str, Any]] = field(default_factory=list)
    # observability (repro_torch.obs, traced runs only): the critical-path
    # attribution report (``obs.critical.attribute`` over this run's spans),
    # the flight-recorder failure dumps (most recent spans at each failure),
    # and where/how-much the Perfetto export wrote
    critical_path: Dict[str, Any] = field(default_factory=dict)
    flight_recorder: List[Dict[str, Any]] = field(default_factory=list)
    trace_path: Optional[str] = None
    trace_spans: int = 0

    @property
    def total_bytes_moved(self) -> int:
        return sum(c.stats.bytes_moved for c in self.channels)

    @property
    def total_served(self) -> int:
        return sum(c.stats.served for c in self.channels)

    @property
    def total_dropped(self) -> int:
        return sum(c.stats.dropped for c in self.channels)

    def gantt_events(self) -> List[Tuple[float, str, str, str]]:
        out = []
        for c in self.channels:
            for (t, who, what) in c.stats.events:
                out.append((t, c.name, who, what))
        return sorted(out)

    def summary(self) -> str:
        lines = [
            f"wall_time_s={self.wall_time_s:.3f}",
            f"served={self.total_served} dropped={self.total_dropped} "
            f"bytes={self.total_bytes_moved}",
        ]
        t = self.transport
        if t:
            lines.append(
                f"prefetch: hits={t['prefetch_hits']} "
                f"misses={t['prefetch_misses']} "
                f"cancelled={t.get('prefetch_cancelled', 0)} "
                f"prepared_s={t['prefetch_prepared_s']:.3f} "
                f"blocked_s={t['prefetch_blocked_s']:.3f}")
            lines.append(
                f"redist: planned={t['redist_planned_bytes']} "
                f"shipped={t['redist_shipped_bytes']} "
                f"baseline={t['redist_baseline_bytes']} "
                f"aligned={t['redist_aligned']} slabs={t['redist_slabs']} "
                f"reshard_pack={t['reshard_pack']} "
                f"reshard_numpy={t['reshard_numpy']}")
        pc = self.plan_cache
        if pc:
            lines.append(
                f"plan_cache: size={pc['size']} hits={pc['hits']} "
                f"misses={pc['misses']} evictions={pc['evictions']} "
                f"hit_rate={pc['hit_rate']:.2f}")
        sc = self.scheduler
        if sc:
            lines.append(
                f"scheduler: policy={sc['policy']} steps={sc['steps']} "
                f"ticks={sc['ticks']} retunes={len(sc['decisions'])} "
                f"telemetry_samples={sc['telemetry_samples']}")
            for d in sc["decisions"]:
                lines.append(
                    f"  retune {d['edge']}: depth {d['old']}->{d['new']} "
                    f"({d['reason']})")
        replayed = sum(c.stats.replayed for c in self.channels)
        deduped = sum(c.stats.deduped for c in self.channels)
        retries = sum(c.stats.prep_retries for c in self.channels)
        if (self.restarts or self.dropped_tasks or replayed or deduped
                or retries or self.rescales or self.stalls):
            lines.append(
                f"recovery: restarts={len(self.restarts)} "
                f"dropped_tasks={len(self.dropped_tasks)} replayed={replayed} "
                f"deduped={deduped} prep_retries={retries} "
                f"rescales={len(self.rescales)} stalls={len(self.stalls)}")
        for (task, inst), secs in sorted(self.task_times.items()):
            lines.append(
                f"  {task}[{inst}]: {secs:.3f}s launches={self.task_launches.get((task, inst), 1)}"
            )
        for f in self.failures:
            lines.append(f"  FAILURE {f.task}[{f.instance}] attempt={f.attempt}: {f.error}")
        for r in self.restarts:
            lines.append(
                f"  RESTART {r['task']}[{r['instance']}] after attempt="
                f"{r['attempt']} -> epoch={r['epoch']}: {r['reason']}")
        for task, inst in self.dropped_tasks:
            lines.append(f"  DROPPED {task}[{inst}] (on_failure: drop)")
        for r in self.rescales:
            lines.append(
                f"  RESCALE {r['task']}: nslots {r['old_nslots']}->"
                f"{r['new_nslots']} nprocs {r['old_nprocs']}->"
                f"{r['new_nprocs']} trigger={r['trigger']} "
                f"cut_step={r['cut_step']} latency={r['latency_s']:.3f}s"
                + (f" ({r['reason']})" if r.get("reason") else ""))
        for s in self.stalls:
            lines.append(
                f"  STALL {s['task']}[{s['instance']}] "
                f"silent={s['silent_s']:.2f}s timeout={s['timeout_s']}s "
                f"-> {s['action']}")
        for edge, msg in self.prefetch_errors:
            lines.append(f"  PREFETCH-ERROR edge={edge}: {msg}")
        if self.trace_spans:
            lines.append(
                f"trace: spans={self.trace_spans}"
                + (f" -> {self.trace_path}" if self.trace_path else ""))
        for d in self.flight_recorder:
            lines.append(
                f"  FLIGHT-DUMP {d['task']}[{d['instance']}] "
                f"({len(d['spans'])} recent spans): {d['reason']}")
        if self.critical_path.get("instances"):
            lines.append(format_report(self.critical_path))
        return "\n".join(lines)


class Wilkins:
    """The workflow runtime. Construct with YAML + task callables, then run().

    Parameters
    ----------
    config:        YAML path, YAML string, or parsed dict (paper Listing 1/2/4/6).
    funcs:         mapping from task ``func`` name to a Python callable.  A
                   callable may take zero args (fully unmodified code reading
                   its world via ``repro_torch.core.comm.world()``) or one arg (the
                   TaskComm).
    devices:       list of ``torch.device``s to partition among tasks
                   proportionally to nprocs (restricted worlds).  Default
                   ``[cuda:0]``; without CUDA the caller must pass one
                   explicitly (``[torch.device("cpu")]``) -- there is no
                   silent CPU fallback.
    spill_dir:     directory for the ``file: 1`` transport path.
    record_events: keep per-channel event timelines (Gantt / Fig. 5).
    max_restarts:  per-instance restart budget on task failure (fault tolerance).
    action_dirs:   extra directories to search for custom action scripts.
    zero_copy:     transport fast path (default True): channels ship CoW
                   dataset views and fan-out shares one filtered payload.
                   False restores the legacy materialize-per-channel copies
                   (the benchmark baseline).  See DESIGN.md.

    ``run()`` owns the prefetch-executor lifecycle: a fresh ``PrefetchPool``
    sized to the workflow's total per-edge prefetch depth is injected into
    this run's channels at start and shut down (queued preps cancelled,
    channels detached) on success and error paths alike -- per run, so
    concurrent runs in one process never cancel each other's preps.
    """

    def __init__(
        self,
        config: Union[str, Dict[str, Any]],
        funcs: Dict[str, Callable],
        devices: Optional[Sequence[Any]] = None,
        spill_dir: Optional[str] = None,
        record_events: bool = False,
        max_restarts: int = 0,
        action_dirs: Sequence[str] = (),
        zero_copy: bool = True,
    ):
        self.graph = config if isinstance(config, WorkflowGraph) else WorkflowGraph.from_yaml(config)
        self.funcs = dict(funcs)
        missing = [t for t in self.graph.tasks if t not in self.funcs]
        if missing:
            raise ValueError(f"no callable provided for tasks: {missing}")
        # not the reference's ``wilkins_spill_<pid>``: both packages number
        # their drivers from 1, so in one process a port run would restore
        # the checkpoints a reference run left under the same root
        self.spill_dir = spill_dir or os.path.join(
            tempfile.gettempdir(), f"wilkins_torch_spill_{os.getpid()}")
        self.record_events = record_events
        self.max_restarts = max_restarts
        self.action_dirs = list(action_dirs)
        self.zero_copy = zero_copy

        # Per-task failure policies: YAML ``on_failure:`` wins; a task that
        # declared nothing inherits the legacy ``max_restarts`` budget as an
        # UNMANAGED restart (relaunch the callable in place, no channel
        # quarantine / checkpoint restore -- bit-for-bit the pre-recovery
        # behaviour), or plain ``fail`` when that budget is 0.
        self.policies: Dict[str, FailurePolicy] = {}
        for name, t in self.graph.tasks.items():
            if "on_failure" in t.raw:
                self.policies[name] = t.on_failure
            elif max_restarts > 0:
                self.policies[name] = FailurePolicy(
                    kind="restart", max_retries=max_restarts, managed=False)
            else:
                self.policies[name] = FailurePolicy()

        self.device_groups = self._partition_devices(devices)
        self.channels: List[Channel] = []
        self.vols: Dict[Tuple[str, int], VOL] = {}
        # per-run scheduling state (set for the duration of ``run``): step
        # events from the VOLs / TaskComms tick the autotuner + telemetry
        self._sched_runtime: Optional[SchedulerRuntime] = None
        # per-instance checkpoint surfaces (wired onto TaskComms per run)
        self._recovery_ctx: Dict[Tuple[str, int], RecoveryContext] = {}
        self._run_seq = 0  # distinguishes checkpoint roots across run() calls
        # ...and across Wilkins INSTANCES: two drivers sharing the default
        # per-pid spill dir must never restore each other's checkpoints
        self._driver_seq = _next_driver_seq()
        # run-scoped elastic-rescale surfaces (set for the duration of
        # ``run``): the supervisor/report/pool/checkpoint-root the surgery
        # module reaches back into, plus the threads it spawns for the new
        # instances (joined by ``run`` after the original cohort)
        self._run_supervisor: Optional[RunSupervisor] = None
        self._run_report: Optional[WorkflowReport] = None
        self._run_pool: Optional[PrefetchPool] = None
        self._run_tracer: Optional[SpanRecorder] = None
        self._ck_root = ""
        self._extra_threads: List[threading.Thread] = []
        self._extra_lock = make_lock("leaf:driver_extra")
        self._spawn_extra: Optional[Callable[[str, int, int], None]] = None
        self._build()

    # ------------------------------------------------------------ resources
    def _partition_devices(
        self, devices: Optional[Sequence[Any]]
    ) -> Dict[Tuple[str, int], Optional[List[Any]]]:
        """Slice the global device list into disjoint restricted worlds,
        proportionally to nprocs (the PMPI-partitioning analogue).  On one
        GPU every instance's group is that GPU."""
        groups: Dict[Tuple[str, int], Optional[List[Any]]] = {}
        instances: List[Tuple[str, int, int]] = []  # (task, inst, nprocs)
        for name, t in self.graph.tasks.items():
            for i in range(t.task_count):
                instances.append((name, i, t.nprocs))
        if devices is None:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Wilkins runs on cuda:0 by default and CUDA is not "
                    "available; pass devices=[torch.device('cpu')] to run "
                    "on the CPU")
            devices = [torch.device("cuda", 0)]
        devices = list(devices)
        total_procs = sum(n for _, _, n in instances) or 1
        off = 0
        for k, (name, i, n) in enumerate(instances):
            share = max(1, (len(devices) * n) // total_procs)
            if k == len(instances) - 1:
                grp = devices[off:]
            else:
                grp = devices[off : off + share]
            off = min(off + share, len(devices) - (len(instances) - 1 - k))
            groups[(name, i)] = grp or devices[-1:]
        return groups

    # ------------------------------------------------------------ wiring
    def _build(self) -> None:
        for edge in self.graph.edges:
            ptask = self.graph.tasks[edge.producer]
            ctask = self.graph.tasks[edge.consumer]
            for pi, ci in edge.instance_links(ptask.task_count, ctask.task_count):
                # M->N redistribution: an inport with declared ownership gets
                # a RedistSpec describing which blocks THIS consumer instance
                # (and its logical ranks / subset writers) owns; the channel
                # consults the plan cache and ships only those blocks.
                redist = None
                if edge.redistribute:
                    redist = RedistSpec(
                        axis=edge.redist_axis,
                        nslots=ctask.task_count,
                        slot=ci,
                        nranks=ctask.io_procs,
                    )
                ch = Channel(
                    name=f"{edge.producer}[{pi}]->{edge.consumer}[{ci}]:{edge.filename_pattern}",
                    producer=(edge.producer, pi),
                    consumer=(edge.consumer, ci),
                    filename_pattern=edge.filename_pattern,
                    dset_patterns=edge.dset_patterns,
                    mode=edge.mode,
                    io_freq=edge.io_freq,
                    spill_dir=self.spill_dir,
                    record_events=self.record_events,
                    queue_depth=edge.queue_depth,
                    zero_copy=self.zero_copy,
                    redistribute=redist,
                    prefetch=edge.prefetch,
                    weight=edge.weight,
                    autotune=edge.autotune,
                )
                self.channels.append(ch)

        rank_offset = 0
        for name, t in self.graph.tasks.items():
            for i in range(t.task_count):
                vol = VOL(name, instance=i, nprocs=t.nprocs, io_procs=t.io_procs)
                for ch in self.channels:
                    if ch.producer == (name, i):
                        vol.outgoing.append(ch)
                    if ch.consumer == (name, i):
                        vol.incoming.append(ch)
                # memory/file VOL properties per matched port (driver sets
                # these from YAML; LowFive equivalent of set_memory/set_file)
                for ch in vol.outgoing + vol.incoming:
                    if ch.mode == "memory":
                        vol.set_memory(ch.filename_pattern)
                    else:
                        vol.set_file(ch.filename_pattern)
                # declared producer ownership (YAML `outports: {ownership:}`):
                # datasets written through this VOL get per-rank blocks
                # stamped at close, so M->N planning sees the real source
                # decomposition without task-code changes
                for port in t.outports:
                    if port.ownership:
                        vol.set_ownership(port.filename, port.own_axis,
                                          port.own_nranks or t.io_procs)
                self.vols[(name, i)] = vol
                rank_offset += t.nprocs

    # ------------------------------------------------------------ execution
    def _make_comm(self, name: str, inst: int) -> TaskComm:
        t = self.graph.tasks[name]
        # Wire the task's RedistSpecs so task code can `comm.reshard(...)`
        # without touching plans: consumer inport specs are exact (their slot
        # IS this instance); a producer feeding a redistributing port gets
        # the consumer's decomposition with ``slot=-1`` -- the producer has
        # no "mine", so reshard demands ranks="all" (or explicit ids)
        # instead of silently returning one consumer instance's blocks.
        specs: Dict[str, RedistSpec] = {}
        for ch in self.channels:
            if ch.redistribute is not None and ch.producer == (name, inst):
                specs.setdefault(ch.filename_pattern,
                                 replace(ch.redistribute, slot=-1))
        for ch in self.channels:
            if ch.redistribute is not None and ch.consumer == (name, inst):
                specs[ch.filename_pattern] = ch.redistribute
        return TaskComm(
            task=name,
            instance=inst,
            rank=0,
            size=t.nprocs,
            io_procs=t.io_procs,
            devices=self.device_groups.get((name, inst)),
            redist_specs=specs,
            scheduler=self._sched_runtime,
            supervisor=self._run_supervisor,
            tracer=self._run_tracer,
        )

    def _run_instance(self, name: str, inst: int, report: WorkflowReport,
                      sup: RunSupervisor, gen: int = 0) -> None:
        """Supervised task lifecycle: RUNNING -> (FAILED -> RESTARTING)* ->
        DONE | DROPPED, per the task's ``on_failure`` policy.

        The outer loop is the restart loop (one iteration per incarnation);
        the inner loop is the query-protocol relaunch loop for stateless
        consumers (§3.5.1) -- unchanged from the pre-recovery driver.  A
        MANAGED restart quarantines this instance's channels under a fresh
        epoch and resets the VOL before relaunching, so the new incarnation
        re-rendezvouses cleanly and replays from its last checkpoint; the
        legacy unmanaged budget (``Wilkins(max_restarts=N)``) relaunches in
        place with no surgery, exactly as before.

        ``gen`` is the task generation this thread was spawned for: a
        completed rescale bumps it, fencing every older thread -- a fenced
        thread's failures and results are moot and it exits quietly.  The
        VOL/channel/recovery tables are re-fetched every incarnation because
        a rescale swaps the dict entries under this thread.
        """
        t0 = time.monotonic()
        launches = 0
        vol: Optional[VOL] = None
        attempt = sup.attempt(name, inst)
        first = True
        try:
            while True:  # restart loop: one iteration per incarnation
                t = self.graph.tasks[name]
                vol = self.vols[(name, inst)]
                fn = self.funcs[name]
                policy = sup.policy_for(name)
                rc = self._recovery_ctx.get((name, inst))
                sup.mark(name, inst, TaskState.RUNNING)
                if first and t.actions is not None:
                    action = actions_mod.load_action(t.actions, self.action_dirs)
                    action(vol, 0)
                first = False
                comm = self._make_comm(name, inst)
                if rc is not None:
                    rc.attempt = attempt
                    rc.epoch = sup.epoch(name, inst)
                    comm.recovery = rc
                try:
                    sup.fire(name, inst, "start", attempt)
                    while True:  # query-protocol relaunch loop
                        launches += 1
                        push_vol(vol)
                        push_comm(comm)
                        try:
                            if _takes_arg(fn):
                                fn(comm)
                            else:
                                fn()
                        finally:
                            pop_comm()
                            pop_vol()
                        # Query protocol (§3.5.1): if this task consumes and
                        # any matched producer is still live or has pending
                        # data, the consumer is stateless -- relaunch it for
                        # the next datum.  Only PURE consumers participate: a
                        # task that also produces (intermediate / steering
                        # node in a cycle) is stateful by construction --
                        # relaunching it would livelock the cycle.
                        if vol.incoming and not vol.outgoing and any(
                            (not c.is_done()) or c.peek_pending()
                            for c in vol.incoming
                        ):
                            continue
                        break
                except RescaleInterrupt:
                    # not a failure: a pending resize pulled us out of the
                    # callable.  Arrive at the op; the LAST arriver leads the
                    # surgery, everyone else just retires.  A vanished op
                    # means the surgery already sealed -- we're a zombie.
                    op = sup.pending_rescale(name)
                    if op is not None and sup.arrive(op, inst):
                        sup.lead(op)
                    return
                except SupersededError:
                    # fenced zombie (e.g. a stalled thread that woke after
                    # its task was resized away from it): exit quietly
                    return
                except Exception as e:
                    if sup.is_superseded(name, gen) or sup.is_fenced(name, inst):
                        return  # a rescale retired this incarnation already
                    report.failures.append(
                        TaskFailure(name, inst, attempt,
                                    f"{type(e).__name__}: {e}")
                    )
                    sup.mark(name, inst, TaskState.FAILED)
                    if policy.kind == "rescale" and attempt < policy.max_retries:
                        cur = sup.task_counts.get(name, t.task_count)
                        if policy.nslots is not None and policy.nslots != cur:
                            # relaunch at a different instance count: full
                            # channel surgery.  This crashed thread is fenced
                            # out of the required set; it leads only when no
                            # live sibling remains to arrive last.
                            op, lead = sup.request_rescale(
                                name, nslots=policy.nslots,
                                nprocs=policy.nprocs, trigger="policy",
                                reason=f"{type(e).__name__}: {e}",
                                fence_instance=inst)
                            if lead:
                                sup.lead(op)
                            return
                        # nprocs-only: a managed restart that also moves the
                        # logical rank count -- no topology change, no barrier
                        self._apply_nprocs_rescale(name, inst, policy, e,
                                                   vol, sup, report, attempt)
                        delay = policy.backoff(name, inst, attempt)
                        if delay > 0:
                            time.sleep(delay)
                        attempt += 1
                        continue
                    if policy.kind == "restart" and attempt < policy.max_retries:
                        if policy.managed:
                            ev = sup.begin_restart(name, inst, e, vol=vol)
                            report.restarts.append(ev.as_dict())
                            sched = self._sched_runtime
                            if sched is not None:
                                sched.notify_restart(name, inst, attempt,
                                                     ev.epoch, ev.reason)
                            delay = policy.backoff(name, inst, attempt)
                            if delay > 0:
                                time.sleep(delay)
                        attempt += 1
                        continue
                    if policy.kind == "drop":
                        # optional task: degrade its edges to no-ops and let
                        # the rest of the workflow run to completion
                        sup.drop(name, inst)
                        report.dropped_tasks.append((name, inst))
                        sched = self._sched_runtime
                        if sched is not None:
                            sched.timeline.record_event(
                                "drop", task=name, instance=inst,
                                attempt=attempt,
                                reason=f"{type(e).__name__}: {e}")
                        return
                    tr = sup.tracer
                    if tr is not None:
                        why = ("restarts exhausted"
                               if policy.kind in ("restart", "rescale")
                               and policy.max_retries > 0 else "task failure")
                        tr.mark_failure(
                            f"{why}: {type(e).__name__}: {e}", name, inst)
                        # the runner's generic dump would re-snapshot the
                        # same history -- mark this error as already dumped
                        e._flight_dumped = True  # type: ignore[attr-defined]
                    raise  # fail (or retries exhausted): chain per PR 3
                op = sup.mark_done_or_join(name, inst)
                if op is not None:
                    # finished exactly as a rescale landed: the op still
                    # needs this instance out of the way -- count the clean
                    # exit as the arrival (and lead if we were the last)
                    if sup.arrive(op, inst):
                        sup.lead(op)
                return
        finally:
            if vol is not None:
                vol.finalize()
            report.task_times[(name, inst)] = time.monotonic() - t0
            report.task_launches[(name, inst)] = launches

    def _apply_nprocs_rescale(self, name: str, inst: int,
                              policy: FailurePolicy, error: BaseException,
                              vol: VOL, sup: RunSupervisor,
                              report: WorkflowReport, attempt: int) -> None:
        """``rescale: {nprocs: K}`` with no instance-count change: a managed
        restart that also moves the task's logical rank count.

        No barrier and no channel rebuild -- the topology is unchanged; only
        the per-rank decompositions are re-pointed: the producer-side
        declared ownership (``VOL._ownership``) and the consumer-side frozen
        ``RedistSpec`` rank counts, on EVERY instance of the task.  Sibling
        channels of one edge share a slot decomposition, so a per-instance
        change would mix rank counts within one plan; the all-instance
        change only re-subdivides future slabs' ownership maps -- the slab
        bytes per slot are a function of ``nslots`` alone and do not move.
        """
        t = self.graph.tasks[name]
        t1 = time.monotonic()
        ev0 = sup.begin_restart(name, inst, error, vol=vol)
        report.restarts.append(ev0.as_dict())
        sched = self._sched_runtime
        if sched is not None:
            sched.notify_restart(name, inst, attempt, ev0.epoch, ev0.reason)
        old_np = sup.task_nprocs.get(name, t.nprocs)
        new_np = policy.nprocs
        if new_np is None or new_np == old_np:
            return
        old_io = t.nwriters if t.nwriters is not None else old_np
        new_io = t.nwriters if t.nwriters is not None else new_np
        t.nprocs = new_np
        for (tn, _i), v in self.vols.items():
            if tn == name:
                v.nprocs = new_np
                v.io_procs = new_io
                v.update_ownership_nranks(old_io, new_io)
        for ch in self.channels:
            if ch.consumer[0] == name and ch.redistribute is not None:
                ch.redistribute = replace(ch.redistribute, nranks=new_io)
        sup.task_nprocs[name] = new_np
        rc = self._recovery_ctx.get((name, inst))
        cut = rc.latest_step() if rc is not None else None
        ev = RescaleEvent(time.monotonic(), name, t.task_count, t.task_count,
                          old_np, new_np, "policy",
                          cut if cut is not None else -1,
                          time.monotonic() - t1,
                          f"{type(error).__name__}: {error}")
        sup.rescales.append(ev)
        report.rescales.append(ev.as_dict())
        if sched is not None:
            sched.notify_rescale(name, t.task_count, t.task_count, old_np,
                                 new_np, "policy", ev.cut_step, ev.latency_s,
                                 ev.reason)

    def _execute_rescale(self, op: Any) -> None:
        """Surgery executor the supervisor's ``lead(op)`` dispatches to."""
        from .rescale import execute_rescale
        execute_rescale(self, op)

    def _validate_rescale_request(self, task: str,
                                  nslots: Optional[int] = None,
                                  nprocs: Optional[int] = None) -> None:
        """Validator for programmatic ``RunSupervisor.rescale`` / YAML-free
        triggers: same structural rules the graph enforces at parse time for
        declared ``on_failure: {rescale: ...}`` policies -- one shared
        implementation in ``analysis.rules``."""
        from ..analysis import rules
        rules.validate_rescale_request(self.graph, task,
                                       nslots=nslots, nprocs=nprocs)

    def run(self, timeout: Optional[float] = None,
            faults: Optional[Any] = None,
            trace: Optional[Any] = None) -> WorkflowReport:
        """Run the workflow to completion.

        ``faults`` threads a deterministic fault-injection plan through the
        run: a ``recovery.FaultPlan``, a single ``FaultSpec`` (or its dict
        spelling), or a list of either.  Injected crashes take the same
        failure paths real errors do -- policies, quarantine, poison pills
        and all -- which is what makes every recovery path testable without
        flaky sleeps.

        ``trace`` opts this run into span tracing (``True`` for defaults, a
        path string to auto-export a Perfetto ``trace.json`` there, a dict
        in the YAML ``tracing:`` spelling, or a ``TraceConfig``); it wins
        over the workflow's ``tracing:`` block.  Both absent is the
        zero-cost default: no recorder is allocated and every hook site
        stays one attribute load + None test."""
        report = WorkflowReport(channels=self.channels)
        threads: List[threading.Thread] = []
        errors: List[BaseException] = []
        tcfg = TraceConfig.coerce(trace) or self.graph.tracing
        tracer: Optional[SpanRecorder] = (
            SpanRecorder(tcfg) if tcfg is not None else None)
        self._run_tracer = tracer

        # The run's supervisor: lifecycle states, epochs, fault firing, and
        # the channel surgery for restart / drop / rescale / permanent
        # failure.  It knows the live instance count per task (rescales move
        # it) and the stall-watchdog windows; the driver installs itself as
        # the surgery executor and rescale validator.
        stall_timeouts = {name: t.stall_timeout_s
                          for name, t in self.graph.tasks.items()
                          if t.stall_timeout_s is not None}
        sup = RunSupervisor(
            self.policies, self.channels,
            faults=FaultPlan.coerce(faults),
            task_counts={name: t.task_count
                         for name, t in self.graph.tasks.items()},
            stall_timeouts=stall_timeouts)
        sup.task_nprocs = {name: t.nprocs
                           for name, t in self.graph.tasks.items()}
        sup.on_rescale = self._execute_rescale
        sup.validate_rescale = self._validate_rescale_request
        sup.tracer = tracer
        self._run_supervisor = sup
        self._run_report = report
        self._extra_threads = []
        extra_lock = self._extra_lock

        def runner(name: str, inst: int, gen: int = 0) -> None:
            try:
                self._run_instance(name, inst, report, sup, gen=gen)
            except BaseException as e:
                if sup.is_superseded(name, gen):
                    return  # a rescale retired this incarnation mid-failure
                errors.append(e)
                if tracer is not None and not getattr(
                        e, "_flight_dumped", False):
                    tracer.mark_failure(
                        f"task failure: {type(e).__name__}: {e}", name, inst)
                # poison our outgoing channels FIRST: consumers blocked in
                # get() raise a ChannelError naming us instead of waiting
                # out their timeout (finalize()'s producer-done races this,
                # but get() checks poison before done, so the error wins)
                sup.poison(name, inst, e)
                # unblock everyone coupled to us (a shrink may have dropped
                # this instance's VOL from the table -- nothing to unblock)
                vol = self.vols.get((name, inst))
                if vol is not None:
                    vol.finalize()

        def spawn_extra(name: str, inst: int, gen: int) -> None:
            # fresh threads for a rescaled task's new instances; run() joins
            # them after the original cohort (they may spawn more in turn)
            th = threading.Thread(
                target=runner, args=(name, inst, gen),
                name=f"wilkins-{name}-{inst}-g{gen}", daemon=True)
            with extra_lock:
                self._extra_threads.append(th)
            th.start()

        self._spawn_extra = spawn_extra

        # Prefetch executor lifecycle is tied to THIS run: a fresh pool
        # sized to the run's total per-edge depth is injected into this
        # run's channels up front and torn down (queued preps cancelled,
        # channels detached) on success and error paths alike -- the old
        # process-wide executor was never shut down, so its non-daemon
        # workers leaked across runs and a prep stuck in I/O could hang
        # interpreter exit.  The pool is PER RUN, not the module global:
        # concurrent Wilkins runs in one process must not cancel each
        # other's in-flight preps.
        # The run's scheduler: builds the pool's queue policy from the YAML
        # ``scheduler:`` block, counts step events from the VOLs/TaskComms,
        # and fires the depth autotuner + telemetry sampler every
        # ``tick_every`` events.  Pool sizing uses each edge's MAX depth
        # (autotune upper bound), so a retune upward never starves for
        # workers mid-run.
        sched = SchedulerRuntime(self.graph.scheduler, self.channels)
        self._sched_runtime = sched
        # Per-step hooks are wired only when the workflow opted in (an
        # explicit ``scheduler:`` block, or an autotuned edge that needs
        # ticks to retune): a legacy workflow pays zero per-step cost --
        # its report still carries the snapshot and one teardown sample.
        if self.graph.scheduler.explicit or any(
                ch.autotune is not None for ch in self.channels):
            for vol in self.vols.values():
                vol.scheduler = sched
        # Tracing wiring (traced runs only): the VOLs, the channels and the
        # supervisor all hold the one run-scoped recorder; TaskComms pick it
        # up per incarnation via ``_make_comm``, rescale surgery re-wires
        # the rebuilt channels/VOLs from ``sup.tracer``.
        if tracer is not None:
            for vol in self.vols.values():
                vol.tracer = tracer
            for ch in self.channels:
                ch.set_tracer(tracer)
        # Recovery wiring, gated on actually being able to recover (managed
        # restart/drop policies or an injected fault plan): VOLs get the
        # supervisor (fault points + epoch stamping), channels get the fault
        # hook for async preps, prep-error retry, and -- on edges into a
        # managed-restart consumer -- the replay buffer.  Every instance
        # gets a RecoveryContext so ``comm.checkpoint()/restore()`` work
        # (they are cheap, lazy, and no-ops-by-absence standalone).
        recovery_on = sup.recovery_active
        if recovery_on:
            for vol in self.vols.values():
                vol.supervisor = sup
            for ch in self.channels:
                ch.set_supervisor(sup)
                ch.set_prep_retry(True)
                cpol = sup.policy_for(ch.consumer[0])
                if cpol.kind == "restart" and cpol.managed:
                    ch.set_replay(True)
                elif cpol.kind == "rescale":
                    # a resize re-cuts steps the consumer may already have
                    # checkpointed past: replay tracking plus the retention
                    # ring (acked payloads) back the consistent-cut replay
                    ch.set_replay(True)
                    ch.set_retention(True)
        self._recovery_ctx = {}
        # per-run checkpoint root: a second run() of the same Wilkins must
        # start fresh, not restore the previous run's checkpoints
        self._run_seq += 1
        ck_root = os.path.join(
            self.spill_dir, f"ckpt_d{self._driver_seq}_run{self._run_seq}")
        self._ck_root = ck_root  # rescale surgery re-cuts shards under here
        for (name, i), vol in self.vols.items():
            self._recovery_ctx[(name, i)] = RecoveryContext(
                name, i, os.path.join(ck_root, f"{name}_{i}"),
                incoming=vol.incoming, outgoing=vol.outgoing)
        total_depth = sum(ch.max_prefetch_depth for ch in self.channels)
        pool: Optional[PrefetchPool] = None
        if total_depth:
            pool = PrefetchPool(max_workers=max(2, min(16, total_depth)),
                                thread_name_prefix="wilkins-prefetch-run",
                                policy=sched.make_policy())
            for ch in self.channels:
                ch.set_prefetch_pool(pool)
        self._run_pool = pool
        # Health watchdog: one daemon scanning heartbeats when any managed
        # task declared ``stall_timeout_s``.  Stalls take the task's policy
        # (rescale away from the fenced instance, or drop); the 2-strike
        # hysteresis lives in ``sup.scan_stalls`` -- slow-but-progressing
        # tasks heartbeat through channel waits and are never declared.
        watchdog_stop = threading.Event()
        watchdog_thread: Optional[threading.Thread] = None
        if stall_timeouts and recovery_on:
            wd_interval = max(0.05,
                              min(1.0, min(stall_timeouts.values()) / 2.0))

            def watchdog() -> None:
                while not watchdog_stop.wait(wd_interval):
                    for (task, i, silent, wd_timeout) in sup.scan_stalls():
                        pol = sup.policy_for(task)
                        action = "rescale" if pol.kind == "rescale" else "drop"
                        sev = StallEvent(time.monotonic(), task, i, silent,
                                         wd_timeout, action)
                        sup.record_stall(sev)
                        report.stalls.append(sev.as_dict())
                        sched.notify_stall(task, i, silent, wd_timeout,
                                           action)
                        if tracer is not None:
                            tracer.mark_failure(
                                f"stall declared: silent {silent:.2f}s > "
                                f"{wd_timeout}s -> {action}", task, i)
                        try:
                            if pol.kind == "rescale":
                                # resize away from the stalled instance; the
                                # watchdog leads only when no live sibling
                                # remains to arrive last
                                op, lead = sup.request_rescale(
                                    task, nslots=pol.nslots,
                                    nprocs=pol.nprocs, trigger="stall",
                                    reason=f"stalled {silent:.2f}s > "
                                           f"{wd_timeout}s (instance {i})",
                                    fence_instance=i)
                                if lead:
                                    sup.lead(op)
                            else:  # drop
                                sup.drop(task, i)
                                report.dropped_tasks.append((task, i))
                        except BaseException as e:
                            errors.append(e)

            watchdog_thread = threading.Thread(
                target=watchdog, name="wilkins-watchdog", daemon=True)
            watchdog_thread.start()
        t0 = time.monotonic()
        try:
            for name, t in self.graph.tasks.items():
                for i in range(t.task_count):
                    th = threading.Thread(
                        target=runner, args=(name, i), name=f"wilkins-{name}-{i}", daemon=True
                    )
                    threads.append(th)
            for th in threads:
                th.start()
            # One global deadline across ALL joins: a per-thread timeout would
            # let a hung workflow take N_threads x timeout to fail.
            deadline = None if timeout is None else time.monotonic() + timeout
            hung: List[str] = []
            for th in threads:
                remaining = None
                if deadline is not None:
                    remaining = max(0.0, deadline - time.monotonic())
                th.join(timeout=remaining)
                if th.is_alive():
                    hung.append(th.name)
            # Drain the threads rescale surgeries spawned for new instances
            # (a rescaled task may rescale again, spawning more -- loop to a
            # fixed point) under the same global deadline.
            joined: set = set()
            while not hung:
                with extra_lock:
                    extra = [th for th in self._extra_threads
                             if th not in joined]
                if not extra:
                    break
                for th in extra:
                    remaining = None
                    if deadline is not None:
                        remaining = max(0.0, deadline - time.monotonic())
                    th.join(timeout=remaining)
                    joined.add(th)
                    if th.is_alive():
                        hung.append(th.name)
            report.wall_time_s = time.monotonic() - t0
            # Tear the prefetch pool down HERE (not only in the finally) so
            # any prep exception the shutdown raced -- erroring on a worker
            # after the consumers already exited -- lands on the report
            # instead of vanishing with the daemon worker.
            if pool is not None:
                pool.shutdown()
                report.prefetch_errors = [
                    (edge, f"{type(e).__name__}: {e}")
                    for edge, e in pool.drain_errors(timeout=5.0)]
            sched.close()  # final telemetry sample before the snapshot
            report.transport = transport_stats().snapshot()
            report.plan_cache = plan_cache().snapshot()
            report.scheduler = sched.snapshot()
            report.scheduler["recovery"] = sup.snapshot()
            report.timeline = sched.timeline
            # Both failure paths carry the partial WorkflowReport (channel
            # stats, gantt events, per-task failures) as ``err.report``, and
            # every secondary task error stays reachable via the __context__
            # chain -- raising only errors[0] used to silently discard the rest.
            if hung:
                if tracer is not None:
                    tracer.mark_failure(f"join timeout: {hung}")
                err: BaseException = TimeoutError(
                    f"task threads did not finish before the deadline: {hung}")
                err = _chain_errors(err, errors)
                err.report = report  # type: ignore[attr-defined]
                raise err
            if errors:
                primary = _chain_errors(errors[0], errors[1:])
                primary.report = report  # type: ignore[attr-defined]
                raise primary
            return report
        finally:
            if watchdog_thread is not None:
                watchdog_stop.set()
                watchdog_thread.join(timeout=5.0)
            # scheduler teardown mirrors the pool's: close on success and
            # error paths alike, and always feed the report (the error paths
            # attach the partial report to the raised exception above, so
            # err.report.summary() shows scheduler state too)
            sched.close()
            if not report.scheduler:
                report.scheduler = sched.snapshot()
                report.scheduler["recovery"] = sup.snapshot()
                report.timeline = sched.timeline
            # An exception between the joins and the success-path snapshot
            # block (shutdown races, KeyboardInterrupt) would leave the
            # report attached to the chained error without its transport /
            # plan-cache counters -- re-snapshot here, under the stats'
            # own locks, exactly like the scheduler above.
            if not report.transport:
                report.transport = transport_stats().snapshot()
                report.plan_cache = plan_cache().snapshot()
            for vol in self.vols.values():
                vol.scheduler = None
                vol.supervisor = None
                vol.tracer = None
            self._sched_runtime = None
            if pool is not None:
                pool.shutdown()
                if not report.prefetch_errors:
                    report.prefetch_errors = [
                        (edge, f"{type(e).__name__}: {e}")
                        for edge, e in pool.drain_errors(timeout=5.0)]
                for ch in self.channels:
                    ch.set_prefetch_pool(None)
            if recovery_on:
                for ch in self.channels:
                    ch.set_supervisor(None)
                    ch.set_prep_retry(False)
                    ch.set_replay(False)
                    ch.set_retention(False)
            if tracer is not None:
                # Finalize the trace on success and error paths alike: the
                # returned report (or ``err.report`` -- same object) carries
                # the span count, flight dumps, attribution and export path;
                # mutating it here is visible to the caller even after the
                # ``return report`` above.
                for ch in self.channels:
                    ch.set_tracer(None)
                sup.tracer = None
                spans = tracer.spans()
                set_last_run_spans(spans)   # obs.last_run_spans()
                report.trace_spans = len(spans)
                report.flight_recorder = tracer.dumps()
                report.critical_path = attribute(spans)
                if tracer.config.path:
                    report.trace_path = export_trace(
                        tracer.config.path, tracer, timeline=sched.timeline)
            self._run_tracer = None
            self._run_supervisor = None
            self._run_report = None
            self._run_pool = None
            self._spawn_extra = None


def _chain_errors(
    primary: BaseException, rest: Sequence[BaseException]
) -> BaseException:
    """Attach ``rest`` to ``primary``'s ``__context__`` chain (exception-group
    semantics on the implicit-chaining mechanism: ``raise primary`` shows
    every secondary as 'During handling of ... another exception occurred').

    Cycle-safe: an error already reachable from the chain is not re-linked.
    """
    seen: set = set()

    def _tail(e: BaseException) -> BaseException:
        seen.add(id(e))
        while e.__context__ is not None and id(e.__context__) not in seen:
            e = e.__context__
            seen.add(id(e))
        return e

    tail = _tail(primary)
    for e in rest:
        if id(e) in seen:
            continue
        tail.__context__ = e
        tail = _tail(e)
    return primary


def _takes_arg(fn: Callable) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = [
        p
        for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        and p.default is p.empty
    ]
    return len(params) >= 1
