"""Fault-tolerant execution: task supervision, checkpointed restart, and a
deterministic fault-injection harness.

Wilkins promises resilient coupling of tasks with disparate data rates, but a
single crash used to kill the whole run -- the error chaining reported the
failure cleanly, yet nothing recovered.  This module turns the transport's
existing machinery (epochal channels, the reshard ``PlanCache``,
``train/checkpoint.py``'s ``AsyncCheckpointer``) into a recovery feature:

* **FailurePolicy** -- the per-task YAML ``on_failure:`` declaration:

  - ``fail``    (default): today's behaviour -- the error is chained onto the
    run's primary exception and the partial ``WorkflowReport`` rides on it.
    Additionally the dead task's outgoing channels are *poisoned* so a
    consumer blocked in ``Channel.get()`` raises a ``ChannelError`` naming
    the dead task immediately instead of waiting out its timeout.
  - ``restart: {max_retries, backoff_s, jitter}``: the supervisor quarantines
    the failed instance's channels under a new epoch, restores task state
    through ``TaskComm.checkpoint()/restore()``, and relaunches the callable.
    Jitter is *deterministic* (hashed from task/instance/attempt), so
    recovery paths are testable without flaky sleeps.
  - ``drop``: optional analysis tasks degrade to no-ops -- outgoing channels
    finish (consumers see producer-done), incoming channels are abandoned
    (producers' offers turn into counted drops instead of blocking).

* **FaultPlan / FaultSpec / InjectedFault** -- deterministic fault injection
  at named points (``start``, ``close``, ``open``, ``recv``, ``prefetch``)
  keyed by (task, instance, step, attempt).  Threaded through
  ``Wilkins.run(faults=...)``; every recovery path is reachable from a test
  without sleeping for "long enough".

* **RunSupervisor** -- the per-run object the driver owns: task lifecycle
  states (RUNNING -> FAILED -> RESTARTING -> DONE / DROPPED), per-instance
  epoch + attempt counters, fault firing, and the channel surgery for
  quarantine / poison / drop.

* **RecoveryContext** -- the per-instance face of ``TaskComm.checkpoint()``
  and ``TaskComm.restore()``: saves through ``AsyncCheckpointer`` (atomic
  directories, LATEST pointer) and *acks* the instance's channels -- a
  producer's serves up to the checkpoint are durable (quarantine keeps
  them), a consumer's deliveries up to the checkpoint are consumed
  (quarantine replays only what came after).

* **reshard_blocks** -- restores taken at one rank count replay onto another
  through a cached ``PlanCache`` reshard plan (the live M->N rescale face of
  the redistribution subsystem).

Nothing here imports driver/graph/channel -- channels and vols are duck-typed
(``quarantine_producer``, ``poison``, ``producer``/``consumer`` tuples), so
``graph.py`` and ``channel.py`` can both import this module without cycles.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading

from ..analysis.lockcheck import check_blocking, make_lock, sched_point
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "FailurePolicy",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "FAULT_KINDS",
    "FAULT_POINTS",
    "TaskState",
    "RestartEvent",
    "RescaleEvent",
    "StallEvent",
    "RescaleInterrupt",
    "RescaleError",
    "SupersededError",
    "RescaleOp",
    "RecoveryContext",
    "RunSupervisor",
    "edge_key",
    "reshard_blocks",
]


# ---------------------------------------------------------------------------
# failure policy (YAML `on_failure:` per task)
# ---------------------------------------------------------------------------
POLICY_KINDS = ("fail", "restart", "drop", "rescale")


@dataclass(frozen=True)
class FailurePolicy:
    """Per-task failure handling, parsed from the YAML ``on_failure:`` block.

    ``managed`` distinguishes a YAML-declared restart (full recovery protocol:
    epoch quarantine, checkpoint restore, replay) from the legacy
    ``Wilkins(max_restarts=N)`` budget, which restarts the callable *without*
    channel surgery -- bit-for-bit the pre-recovery behaviour.
    """

    kind: str = "fail"
    max_retries: int = 0
    backoff_s: float = 0.0
    jitter: float = 0.0
    managed: bool = True
    # rescale-only knobs: the instance count / logical rank count the task
    # restarts at.  None = keep the current value.
    nslots: Optional[int] = None
    nprocs: Optional[int] = None

    def backoff(self, task: str, instance: int, attempt: int) -> float:
        """Exponential backoff with DETERMINISTIC jitter.

        The jitter term is hashed from (task, instance, attempt), not drawn
        from a RNG: two runs of the same workflow with the same fault plan
        recover on the same schedule, which is what makes the recovery suite
        assertable without sleeps-and-hope."""
        if self.backoff_s <= 0 and self.jitter <= 0:
            return 0.0
        base = self.backoff_s * (2 ** attempt)
        if self.jitter > 0:
            h = hashlib.sha256(
                f"{task}:{instance}:{attempt}".encode()).digest()
            u = int.from_bytes(h[:8], "little") / 2 ** 64  # [0, 1)
            base += self.jitter * u
        return base

    @classmethod
    def from_yaml(cls, doc: Any, task: str = "?") -> "FailurePolicy":
        """Parse ``on_failure:`` with the task named in every error.

        Accepted spellings::

            on_failure: fail                 # default (today's behaviour)
            on_failure: drop                 # optional task: degrade to no-op
            on_failure: restart              # restart with defaults
            on_failure:
              restart: {max_retries: 3, backoff_s: 0.1, jitter: 0.05}
        """
        if doc is None:
            return cls()
        if isinstance(doc, str):
            if doc == "restart":
                return cls(kind="restart", max_retries=1)
            if doc in ("fail", "drop"):
                return cls(kind=doc)
            raise ValueError(
                f"task {task!r}: on_failure {doc!r} is invalid; use one of "
                f"{POLICY_KINDS} (or a restart: mapping)")
        if isinstance(doc, dict):
            if "rescale" in doc and "drop" in doc:
                raise ValueError(
                    f"task {task!r}: on_failure cannot combine rescale: with "
                    f"drop: -- a dropped task has no instances left to "
                    f"restart at a new size; pick one")
            unknown = set(doc) - {"restart", "rescale"}
            if unknown:
                raise ValueError(
                    f"task {task!r}: unknown on_failure keys "
                    f"{sorted(unknown)} (expected a restart: or rescale: "
                    f"mapping, or the strings fail/drop/restart)")
            if "restart" in doc and "rescale" in doc:
                raise ValueError(
                    f"task {task!r}: on_failure cannot combine restart: and "
                    f"rescale:; a rescale IS a supervised restart (use "
                    f"rescale with the current size for a same-size restart)")
            if "rescale" in doc:
                return cls._parse_rescale(doc["rescale"], task)
            r = doc.get("restart")
            if r is None:
                raise ValueError(
                    f"task {task!r}: on_failure mapping must carry a "
                    f"restart: block")
            if not isinstance(r, dict):
                raise ValueError(
                    f"task {task!r}: on_failure restart must be a mapping "
                    f"{{max_retries, backoff_s, jitter}}, got {r!r}")
            bad = set(r) - {"max_retries", "backoff_s", "jitter"}
            if bad:
                raise ValueError(
                    f"task {task!r}: unknown on_failure restart keys "
                    f"{sorted(bad)} (expected max_retries, backoff_s, jitter)")
            retries = int(r.get("max_retries", 1))
            if retries < 1:
                raise ValueError(
                    f"task {task!r}: on_failure restart max_retries must be "
                    f">= 1, got {retries} (use on_failure: fail for no "
                    f"restarts)")
            backoff = float(r.get("backoff_s", 0.0))
            if backoff < 0:
                raise ValueError(
                    f"task {task!r}: on_failure restart backoff_s must be "
                    f">= 0, got {backoff}")
            jitter = float(r.get("jitter", 0.0))
            if jitter < 0:
                raise ValueError(
                    f"task {task!r}: on_failure restart jitter must be >= 0, "
                    f"got {jitter}")
            return cls(kind="restart", max_retries=retries,
                       backoff_s=backoff, jitter=jitter)
        raise ValueError(
            f"task {task!r}: on_failure must be fail/drop/restart or a "
            f"restart: mapping, got {doc!r}")

    @classmethod
    def _parse_rescale(cls, r: Any, task: str) -> "FailurePolicy":
        """Parse ``on_failure: {rescale: {nslots, nprocs, ...}}``."""
        if not isinstance(r, dict):
            raise ValueError(
                f"task {task!r}: on_failure rescale must be a mapping "
                f"{{nslots, nprocs, max_retries, backoff_s, jitter}}, "
                f"got {r!r}")
        bad = set(r) - {"nslots", "nprocs", "max_retries", "backoff_s",
                        "jitter"}
        if bad:
            raise ValueError(
                f"task {task!r}: unknown on_failure rescale keys "
                f"{sorted(bad)} (expected nslots, nprocs, max_retries, "
                f"backoff_s, jitter)")
        nslots = r.get("nslots")
        nprocs = r.get("nprocs")
        if nslots is None and nprocs is None:
            raise ValueError(
                f"task {task!r}: on_failure rescale needs nslots and/or "
                f"nprocs (the size the task restarts at)")
        if nslots is not None:
            nslots = int(nslots)
            if nslots < 1:
                raise ValueError(
                    f"task {task!r}: on_failure rescale nslots must be >= 1, "
                    f"got {nslots} (use on_failure: drop to remove the task)")
        if nprocs is not None:
            nprocs = int(nprocs)
            if nprocs < 1:
                raise ValueError(
                    f"task {task!r}: on_failure rescale nprocs must be >= 1, "
                    f"got {nprocs}")
        retries = int(r.get("max_retries", 1))
        if retries < 1:
            raise ValueError(
                f"task {task!r}: on_failure rescale max_retries must be >= 1, "
                f"got {retries}")
        backoff = float(r.get("backoff_s", 0.0))
        if backoff < 0:
            raise ValueError(
                f"task {task!r}: on_failure rescale backoff_s must be >= 0, "
                f"got {backoff}")
        jitter = float(r.get("jitter", 0.0))
        if jitter < 0:
            raise ValueError(
                f"task {task!r}: on_failure rescale jitter must be >= 0, "
                f"got {jitter}")
        return cls(kind="rescale", max_retries=retries, backoff_s=backoff,
                   jitter=jitter, nslots=nslots, nprocs=nprocs)


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------
FAULT_KINDS = ("crash", "stall", "slow_io")
#: named injection points: ``start`` fires at task-callable launch (step =
#: attempt), ``close`` at producer file close *before* the serve, ``open`` at
#: consumer intercepted open *before* any delivery, ``recv`` after a payload
#: was delivered but before task code sees it (the replay-protocol window),
#: ``prefetch`` inside the async payload prep on the pool worker.
FAULT_POINTS = ("start", "close", "open", "recv", "prefetch")


class InjectedFault(RuntimeError):
    """A crash raised by the fault-injection harness (never by real code)."""

    def __init__(self, task: str, instance: int, point: str, step: int,
                 attempt: int):
        super().__init__(
            f"injected crash: {task}[{instance}] at {point} step={step} "
            f"attempt={attempt}")
        self.task = task
        self.instance = instance
        self.point = point
        self.step = step
        self.attempt = attempt


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fires when (task, instance, point, step,
    attempt) all match.  ``instance``/``step``/``attempt`` of ``None`` match
    anything; ``times`` bounds total firings (default once).  ``seconds`` is
    the stall / slow-io duration."""

    task: str
    kind: str = "crash"
    point: str = "close"
    instance: Optional[int] = None
    step: Optional[int] = None
    attempt: Optional[int] = 0
    times: Optional[int] = 1
    seconds: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} is invalid; use one of {FAULT_KINDS}")
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"fault point {self.point!r} is invalid; use one of "
                f"{FAULT_POINTS}")
        if self.seconds < 0:
            raise ValueError(f"fault seconds must be >= 0, got {self.seconds}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"fault times must be >= 1, got {self.times}")

    def matches(self, task: str, instance: int, point: str, step: int,
                attempt: int) -> bool:
        return (self.task == task and self.point == point
                and (self.instance is None or self.instance == instance)
                and (self.step is None or self.step == step)
                and (self.attempt is None or self.attempt == attempt))


class FaultPlan:
    """An ordered set of ``FaultSpec``s with per-spec firing budgets.

    ``fire`` is called from the VOL hooks / prefetch preps with the current
    (task, instance, point, step, attempt) coordinates; a matching ``crash``
    spec raises ``InjectedFault``, ``stall``/``slow_io`` sleep for
    ``seconds``.  Counting is thread-safe (preps fire from pool workers).
    """

    def __init__(self, specs: Sequence[Union[FaultSpec, Dict[str, Any]]] = ()):
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs]
        self._fired: Dict[int, int] = {}
        self._lock = make_lock("leaf:faults")
        self.log: List[Tuple[str, str, int, str, int, int]] = []

    @classmethod
    def coerce(cls, faults: Any) -> Optional["FaultPlan"]:
        if faults is None:
            return None
        if isinstance(faults, FaultPlan):
            return faults
        if isinstance(faults, (FaultSpec, dict)):
            return cls([faults])
        return cls(list(faults))

    def fire(self, task: str, instance: int, point: str, step: int,
             attempt: int) -> None:
        for i, spec in enumerate(self.specs):
            if not spec.matches(task, instance, point, step, attempt):
                continue
            with self._lock:
                n = self._fired.get(i, 0)
                if spec.times is not None and n >= spec.times:
                    continue
                self._fired[i] = n + 1
                self.log.append((spec.kind, task, instance, point, step,
                                 attempt))
            if spec.kind == "crash":
                raise InjectedFault(task, instance, point, step, attempt)
            check_blocking("sleep")
            time.sleep(spec.seconds)  # stall / slow_io

    def fired(self) -> int:
        with self._lock:
            return sum(self._fired.values())


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
class TaskState:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    FAILED = "FAILED"
    RESTARTING = "RESTARTING"
    DONE = "DONE"
    DROPPED = "DROPPED"


@dataclass
class RestartEvent:
    t: float
    task: str
    instance: int
    attempt: int          # the attempt that FAILED (restart launches attempt+1)
    epoch: int            # the new epoch the instance restarts into
    reason: str

    def as_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "task": self.task, "instance": self.instance,
                "attempt": self.attempt, "epoch": self.epoch,
                "reason": self.reason}


# ---------------------------------------------------------------------------
# elastic rescale: events, interrupts, and the per-task rescale operation
# ---------------------------------------------------------------------------
class RescaleInterrupt(Exception):
    """Raised out of a blocked/next channel operation to pull a sibling
    instance out of its task callable so the task can be resized.  Not an
    error: the driver converts it into op participation, never a failure."""

    def __init__(self, task: str = "?", instance: int = -1):
        super().__init__(f"rescale interrupt: {task}[{instance}]")
        self.task = task
        self.instance = instance


class SupersededError(RuntimeError):
    """Raised by a retired incarnation's checkpoint/channel surface after a
    rescale replaced it -- a fenced zombie (e.g. a stalled thread that woke
    up late) must exit quietly, not corrupt the new incarnation's state."""


class RescaleError(RuntimeError):
    """A rescale could not be performed safely (lost retention window,
    inconsistent replicated state, missing checkpoint shard...)."""


@dataclass
class RescaleEvent:
    t: float
    task: str
    old_nslots: int
    new_nslots: int
    old_nprocs: int
    new_nprocs: int
    trigger: str          # "policy" (crash), "stall" (watchdog), "api"
    cut_step: int = -1    # checkpoint step the task restarted from (-1 fresh)
    latency_s: float = 0.0
    reason: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "task": self.task,
                "old_nslots": self.old_nslots, "new_nslots": self.new_nslots,
                "old_nprocs": self.old_nprocs, "new_nprocs": self.new_nprocs,
                "trigger": self.trigger, "cut_step": self.cut_step,
                "latency_s": self.latency_s, "reason": self.reason}


@dataclass
class StallEvent:
    t: float
    task: str
    instance: int
    silent_s: float
    timeout_s: float
    action: str           # what the policy did about it: "rescale" / "drop"

    def as_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "task": self.task, "instance": self.instance,
                "silent_s": self.silent_s, "timeout_s": self.timeout_s,
                "action": self.action}


_INSTANCE_RE = re.compile(r"\[\d+\]")


def edge_key(channel_name: str) -> str:
    """Instance-invariant identity of a channel's edge.

    Channel names carry instance indices (``p[0]->c[1]:a.h5``); the rescale
    protocol needs to match per-edge state (consumed seqs at a checkpoint
    step) across instances of different incarnation sizes, so sidecars key by
    the name with the indices stripped (``p->c:a.h5``)."""
    return _INSTANCE_RE.sub("", channel_name)


class RescaleOp:
    """One pending M->N resize of a task: the rendezvous between the
    triggering event, the task's still-live sibling instances, and the driver
    surgery that rebuilds channels/checkpoints at the new size.

    Lifecycle: created under the supervisor lock (capturing the set of
    instances that must stop touching the old channels), siblings *arrive* as
    their channel operations raise ``RescaleInterrupt``; the LAST arriver
    becomes the leader and executes the surgery callback.  If the required
    set is empty (every instance already finished, or the sole instance is a
    fenced zombie) the triggering thread leads immediately."""

    def __init__(self, task: str, old_nslots: int, new_nslots: int,
                 old_nprocs: int, new_nprocs: int, trigger: str,
                 reason: str = ""):
        self.task = task
        self.old_nslots = old_nslots
        self.new_nslots = new_nslots
        self.old_nprocs = old_nprocs
        self.new_nprocs = new_nprocs
        self.trigger = trigger
        self.reason = reason
        self.t0 = time.monotonic()
        self.required: set = set()
        self.arrived: set = set()
        self.leader_claimed = False
        self.done = threading.Event()
        self.cut_step = -1
        self.error: Optional[BaseException] = None


# ---------------------------------------------------------------------------
# checkpoint / restore surface (TaskComm.checkpoint / restore)
# ---------------------------------------------------------------------------
class RecoveryContext:
    """Per-instance checkpoint surface, wired onto the TaskComm by the driver.

    ``checkpoint(state)`` snapshots a pytree through ``AsyncCheckpointer``
    (atomic container + LATEST pointer) and then *acks* the instance's
    channels: serves/deliveries up to this point are durable, so a later
    quarantine keeps them and replays only what came after.  ``restore``
    returns ``(step, state)`` from the newest checkpoint, or ``None`` on a
    fresh start.  Both are no-ops-by-absence: standalone task code (no
    workflow) sees ``comm.checkpoint(...) is None`` and runs unchanged.
    """

    def __init__(self, task: str, instance: int, directory: str,
                 incoming: Sequence[Any] = (), outgoing: Sequence[Any] = ()):
        self.task = task
        self.instance = instance
        self.directory = directory
        self.incoming = list(incoming)
        self.outgoing = list(outgoing)
        self.attempt = 0
        self.epoch = 0
        self._ck = None
        self._next_step = 0
        self._lock = make_lock("leaf:recovery_ctx")
        # set by a rescale when a newer incarnation owns this (task, instance):
        # every later checkpoint/ack/restore from the fenced zombie raises.
        self.superseded = False

    def _checkpointer(self):
        # lazy: tasks that never checkpoint never create the directory
        with self._lock:
            if self._ck is None:
                from ..train.checkpoint import AsyncCheckpointer
                self._ck = AsyncCheckpointer(self.directory, keep=3)
            return self._ck

    def checkpoint(self, state: Any, step: Optional[int] = None,
                   block: bool = True,
                   sharded_axes: Optional[Dict[str, int]] = None) -> int:
        """Save ``state`` and ack this instance's channels.

        ``block=True`` (the default) waits for the container to be durable
        before acking -- the ack is what tells quarantine "steps up to here
        are consumed/served", so acking an un-durable checkpoint would lose
        data on a crash in the write window.  ``block=False`` overlaps the
        write with compute at the cost of that window (cadence guidance in
        DESIGN.md).

        ``sharded_axes`` declares which top-level keys of a flat-dict state
        hold this instance's *shard* of a task-global array (key -> axis);
        a later M->N rescale re-cuts exactly those leaves through
        ``reshard_blocks`` and requires the rest to be replicas.  The
        declaration is persisted next to the checkpoints (``sharded.json``)
        so the rescale surgery -- which runs with no task code on the stack
        -- can find it."""
        if self.superseded:
            raise SupersededError(
                f"{self.task}[{self.instance}]: checkpoint after rescale "
                f"superseded this incarnation")
        ck = self._checkpointer()
        if step is None:
            step = self._next_step
        ck.save(step, state, block=block)
        self._next_step = step + 1
        if sharded_axes:
            self._write_json("sharded.json", dict(sharded_axes))
        # per-step consumed-seq sidecar: which channel seq each incoming edge
        # had delivered when this step became durable.  The rescale cut
        # replays everything after this watermark into the new partition.
        # Duck-typed stand-ins without the rescale surface just don't get a
        # watermark (they can't be rescaled either).
        self._write_json(
            f"seqs_{step:08d}.json",
            {"step": step,
             "seqs": {edge_key(ch.name): ch.delivered_seq
                      for ch in self.incoming
                      if hasattr(ch, "name")
                      and hasattr(ch, "delivered_seq")}})
        self.ack()
        return step

    def _write_json(self, name: str, payload: Dict[str, Any]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(self.directory, name))

    def ack(self) -> None:
        """Mark everything served/delivered so far as durable (checkpointed)."""
        if self.superseded:
            raise SupersededError(
                f"{self.task}[{self.instance}]: ack after rescale superseded "
                f"this incarnation")
        for ch in self.outgoing:
            ch.ack_producer()
        for ch in self.incoming:
            ch.ack_consumer()

    def restore(self, like: Any) -> Optional[Tuple[int, Any]]:
        """(step, state) from the newest checkpoint, or None on fresh start."""
        if self.superseded:
            raise SupersededError(
                f"{self.task}[{self.instance}]: restore after rescale "
                f"superseded this incarnation")
        from ..train.checkpoint import restore_latest
        out = restore_latest(self.directory, like)
        if out is not None:
            self._next_step = out[0] + 1
        return out

    def latest_step(self) -> Optional[int]:
        """Newest durable checkpoint step, without creating the directory."""
        p = os.path.join(self.directory, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())


# ---------------------------------------------------------------------------
# live M->N rescale of restored state (PlanCache replay)
# ---------------------------------------------------------------------------
def reshard_blocks(blocks: Sequence[Any], new_nranks: int,
                   axis: int = 0) -> List[Any]:
    """Re-split per-rank blocks saved by M ranks onto N ranks.

    The checkpointed decomposition (M contiguous blocks along ``axis``)
    becomes the src side of a redistribution plan and the even N-way split is
    the dst side; the plan comes from the process-wide ``PlanCache`` (so a
    whole ensemble restoring at a new scale compiles the M->N intersection
    once) and executes as the scatter path -- the global array is never
    stitched.  This is how a restart at a different rank count replays a
    checkpoint: the reshard machinery, turned from a startup feature into a
    recovery feature."""
    import numpy as np
    import torch

    from ..convert import numpy_from_tensor
    from .redistribute import even_blocks, plan_cache

    arrs = [numpy_from_tensor(b) if isinstance(b, torch.Tensor)
            else np.asarray(b) for b in blocks]
    if not arrs:
        raise ValueError("reshard_blocks needs at least one source block")
    if new_nranks < 1:
        raise ValueError(f"new_nranks must be >= 1, got {new_nranks}")
    nd = arrs[0].ndim
    if not 0 <= axis < nd:
        raise ValueError(f"axis {axis} out of range for rank-{nd} blocks")
    gshape = list(arrs[0].shape)
    gshape[axis] = sum(a.shape[axis] for a in arrs)
    gshape = tuple(gshape)
    src = []
    off = 0
    for a in arrs:
        if tuple(a.shape[:axis]) + tuple(a.shape[axis + 1:]) != \
                tuple(gshape[:axis]) + tuple(gshape[axis + 1:]):
            raise ValueError(
                f"source blocks disagree off-axis: {a.shape} vs global "
                f"{gshape} along axis {axis}")
        starts = tuple(off if d == axis else 0 for d in range(nd))
        src.append((starts, tuple(a.shape)))
        off += a.shape[axis]
    dst = even_blocks(gshape, new_nranks, axis=axis)
    plan = plan_cache().get(src, dst, gshape, arrs[0].dtype)
    return plan.execute(arrs)


# ---------------------------------------------------------------------------
# the per-run supervisor
# ---------------------------------------------------------------------------
class RunSupervisor:
    """Per-run task supervision: lifecycle states, epochs, fault firing, and
    the channel surgery behind restart / drop / permanent failure.

    The driver owns one per ``run()``; channels and VOLs get a reference for
    the duration (fault injection + epoch stamping) and are detached on
    teardown.  All channel mutation happens through the channels' own
    epoch-aware verbs (``quarantine_producer``/``quarantine_consumer``/
    ``poison``/``abandon_consumer``/``finish``), so the supervisor holds no
    channel locks itself.
    """

    def __init__(self, policies: Dict[str, FailurePolicy],
                 channels: Sequence[Any],
                 faults: Optional[FaultPlan] = None,
                 task_counts: Optional[Dict[str, int]] = None,
                 stall_timeouts: Optional[Dict[str, float]] = None):
        self.policies = dict(policies)
        self.channels = list(channels)
        self.faults = faults
        self._lock = make_lock("supervisor:run")
        self._state: Dict[Tuple[str, int], str] = {}
        self._attempt: Dict[Tuple[str, int], int] = {}
        self._epoch: Dict[Tuple[str, int], int] = {}
        self.restarts: List[RestartEvent] = []
        self.dropped: List[Tuple[str, int]] = []
        # ---- elastic rescale / watchdog state -----------------------------
        self.task_counts: Dict[str, int] = dict(task_counts or {})
        self.task_nprocs: Dict[str, int] = {}
        self.stall_timeouts: Dict[str, float] = dict(stall_timeouts or {})
        self.rescales: List[RescaleEvent] = []
        self.stalls: List[StallEvent] = []
        self._pending_rescale: Dict[str, RescaleOp] = {}
        self._gen: Dict[str, int] = {}          # bumped per completed rescale
        self._fenced: set = set()               # (task, inst) zombies
        self._hb_lock = make_lock("supervisor.hb:run")
        self._hb: Dict[Tuple[str, int], Tuple[int, float]] = {}
        self._strikes: Dict[Tuple[str, int], Tuple[int, int]] = {}
        # driver-installed callbacks: surgery executor + rescale validator
        self.on_rescale: Optional[Callable[[RescaleOp], None]] = None
        self.validate_rescale: Optional[Callable[..., None]] = None
        # per-run SpanRecorder (driver-attached on traced runs)
        self.tracer: Optional[Any] = None

    # ------------------------------------------------------------- queries
    def policy_for(self, task: str) -> FailurePolicy:
        return self.policies.get(task, FailurePolicy())

    def attempt(self, task: str, instance: int) -> int:
        with self._lock:
            return self._attempt.get((task, instance), 0)

    def epoch(self, task: str, instance: int) -> int:
        with self._lock:
            return self._epoch.get((task, instance), 0)

    def state(self, task: str, instance: int) -> str:
        with self._lock:
            return self._state.get((task, instance), TaskState.PENDING)

    def states(self) -> Dict[Tuple[str, int], str]:
        with self._lock:
            return dict(self._state)

    @property
    def recovery_active(self) -> bool:
        """True when this run can exercise recovery paths (managed restart
        policies or injected faults) -- gates the prep-retry fast path."""
        return self.faults is not None or bool(self.stall_timeouts) or any(
            p.kind in ("restart", "drop", "rescale") and p.managed
            for p in self.policies.values())

    # ----------------------------------------------------------- lifecycle
    def mark(self, task: str, instance: int, state: str) -> None:
        with self._lock:
            self._state[(task, instance)] = state
        if state == TaskState.RUNNING:
            # a fresh incarnation starts with a full stall-timeout budget
            self.heartbeat(task, instance)

    def fire(self, task: str, instance: int, point: str, step: int) -> None:
        """Fault-injection hook: no-op without a plan."""
        if self.faults is not None:
            self.faults.fire(task, instance, point, step,
                             self.attempt(task, instance))

    def _instance_channels(self, task: str, instance: int):
        outgoing = [c for c in self.channels if c.producer == (task, instance)]
        incoming = [c for c in self.channels if c.consumer == (task, instance)]
        return incoming, outgoing

    def begin_restart(self, task: str, instance: int, error: BaseException,
                      vol: Any = None) -> RestartEvent:
        """Quarantine the dead incarnation and open the next epoch.

        Outgoing channels drop un-acked queued payloads (the restarted
        producer regenerates them from its checkpoint; in-flight prefetch
        futures are cancelled) and rewind their serve/flow-control counters
        to the last ack.  Incoming channels requeue delivered-but-unacked
        payloads for replay and rewind the dedup watermark.  Producers
        blocked in ``offer()`` are woken by the queue surgery and
        re-rendezvous against the new epoch."""
        t0 = time.monotonic()
        with self._lock:
            key = (task, instance)
            self._attempt[key] = self._attempt.get(key, 0) + 1
            self._epoch[key] = self._epoch.get(key, 0) + 1
            attempt = self._attempt[key] - 1
            epoch = self._epoch[key]
            self._state[key] = TaskState.RESTARTING
        incoming, outgoing = self._instance_channels(task, instance)
        # the restart window: counters are updated but no queue surgery has
        # happened yet -- the explorer preempts between the two
        sched_point("RunSupervisor.quarantine", key=("restart", task, instance))
        for ch in outgoing:
            ch.quarantine_producer(epoch)
        for ch in incoming:
            ch.quarantine_consumer(epoch)
        if vol is not None:
            vol.reset_for_restart()
        now = time.monotonic()
        if self.tracer is not None:
            self.tracer.record("recovery", "recovery.restart", task, instance,
                               t0, now, attempt=attempt, epoch=epoch,
                               error=type(error).__name__)
        ev = RestartEvent(now, task, instance, attempt, epoch,
                          f"{type(error).__name__}: {error}")
        with self._lock:
            self.restarts.append(ev)
        return ev

    def drop(self, task: str, instance: int) -> None:
        """Degrade the instance's edges to no-ops (optional analysis task)."""
        incoming, outgoing = self._instance_channels(task, instance)
        for ch in outgoing:
            ch.finish()          # consumers see producer-done, exit cleanly
        for ch in incoming:
            ch.abandon_consumer()  # producers' offers become counted drops
        if self.tracer is not None:
            self.tracer.instant("recovery", "task.drop", task, instance)
        with self._lock:
            self._state[(task, instance)] = TaskState.DROPPED
            self.dropped.append((task, instance))

    def poison(self, task: str, instance: int, error: BaseException) -> None:
        """Permanent failure: wake every coupled peer with the bad news.

        Consumers blocked in ``get()`` on the dead producer's channels raise
        a chained ``ChannelError`` naming the task; producers blocked in
        ``offer()`` toward the dead consumer are released (their serves
        become counted drops) so the run winds down instead of hanging to
        the join deadline."""
        incoming, outgoing = self._instance_channels(task, instance)
        for ch in outgoing:
            ch.poison(task, instance, error)
        for ch in incoming:
            ch.abandon_consumer()
        with self._lock:
            self._state[(task, instance)] = TaskState.FAILED

    # ------------------------------------------- heartbeats & the watchdog
    def heartbeat(self, task: str, instance: int) -> None:
        """Progress signal, fed from the VOL step hooks, ``comm.step()``,
        checkpoints, and channel wait loops (a consumer parked on an empty
        channel is *starved*, not stalled -- it keeps heartbeating)."""
        with self._hb_lock:
            c, _ = self._hb.get((task, instance), (0, 0.0))
            self._hb[(task, instance)] = (c + 1, time.monotonic())

    def wait_quantum(self, task: str) -> float:
        """Heartbeat cadence for a parked wait loop (channel rendezvous /
        fan-in mux): well inside ``task``'s stall window, so a
        starved-but-alive instance beats often enough that the watchdog
        never mistakes the gap between keep-alives for silence."""
        t = self.stall_timeouts.get(task)
        if t is None:
            return 0.5
        return max(0.02, min(0.5, t / 4.0))

    def scan_stalls(self) -> List[Tuple[str, int, float, float]]:
        """One watchdog pass: (task, instance, silent_s, timeout_s) for every
        instance newly DECLARED stalled.  Hysteresis: an instance must be
        over its timeout on two consecutive scans with no heartbeat movement
        in between -- a slow-but-progressing task resets its strikes on every
        heartbeat and is never killed."""
        out: List[Tuple[str, int, float, float]] = []
        now = time.monotonic()
        with self._lock:
            states = dict(self._state)
            counts = dict(self.task_counts)
            pending = set(self._pending_rescale)
            fenced = set(self._fenced)
        for task, timeout in self.stall_timeouts.items():
            if task in pending:
                continue                      # already being resized
            for i in range(counts.get(task, 1)):
                key = (task, i)
                if states.get(key) != TaskState.RUNNING or key in fenced:
                    self._strikes.pop(key, None)
                    continue
                with self._hb_lock:
                    c, ts = self._hb.get(key, (0, now))
                silent = now - ts
                if silent <= timeout:
                    self._strikes.pop(key, None)
                    continue
                prev_c, strikes = self._strikes.get(key, (c, 0))
                strikes = strikes + 1 if prev_c == c else 1
                self._strikes[key] = (c, strikes)
                if strikes >= 2:
                    self._strikes.pop(key, None)
                    out.append((task, i, silent, timeout))
        return out

    def record_stall(self, ev: StallEvent) -> None:
        if self.tracer is not None:
            self.tracer.instant("recovery", "stall.declared", ev.task,
                                ev.instance, silent_s=ev.silent_s)
        with self._lock:
            self.stalls.append(ev)

    # --------------------------------------------------- elastic rescale
    def generation(self, task: str) -> int:
        with self._lock:
            return self._gen.get(task, 0)

    def is_superseded(self, task: str, gen: int) -> bool:
        """True when a rescale completed after the caller's incarnation was
        launched -- the caller is a zombie and must exit quietly."""
        return self.generation(task) > gen

    def fence(self, task: str, instance: int) -> None:
        with self._lock:
            self._fenced.add((task, instance))

    def is_fenced(self, task: str, instance: int) -> bool:
        with self._lock:
            return (task, instance) in self._fenced

    def pending_rescale(self, task: str) -> Optional[RescaleOp]:
        with self._lock:
            return self._pending_rescale.get(task)

    def request_rescale(self, task: str, nslots: Optional[int] = None,
                        nprocs: Optional[int] = None, trigger: str = "policy",
                        reason: str = "",
                        fence_instance: Optional[int] = None
                        ) -> Tuple[RescaleOp, bool]:
        """Create (or join) the pending ``RescaleOp`` for ``task``.

        Returns ``(op, lead)``; ``lead`` is True when the CALLER must execute
        the surgery immediately (no live instance remains to arrive last --
        e.g. a watchdog resizing a task whose only instance is the fenced
        zombie).  Joining an existing op never leads."""
        with self._lock:
            op = self._pending_rescale.get(task)
            if op is not None:
                return op, False
            if fence_instance is not None:
                self._fenced.add((task, fence_instance))
            M = self.task_counts.get(task, 1)
            old_np = self.task_nprocs.get(task, 1)
            op = RescaleOp(task, M,
                           nslots if nslots is not None else M,
                           old_np,
                           nprocs if nprocs is not None else old_np,
                           trigger, reason)
            op.required = {
                i for i in range(M)
                if self._state.get((task, i), TaskState.PENDING)
                not in (TaskState.DONE, TaskState.DROPPED)
                and (task, i) not in self._fenced}
            self._pending_rescale[task] = op
            lead = False
            if not op.required:
                op.leader_claimed = True
                lead = True
        # outside the lock: pull every old instance out of its callable --
        # its next (or currently blocked) channel operation raises
        # RescaleInterrupt, which the driver converts into op arrival
        for i in range(op.old_nslots):
            incoming, _ = self._instance_channels(task, i)
            for ch in incoming:
                ch.interrupt_consumer(RescaleInterrupt(task, i))
        return op, lead

    def arrive(self, op: RescaleOp, instance: int) -> bool:
        """An old instance stopped touching the old channels.  Returns True
        when this arrival completed the required set: the caller is the
        leader and must execute the surgery (``lead(op)``)."""
        with self._lock:
            if instance not in op.required:
                return False
            op.arrived.add(instance)
            if op.required <= op.arrived and not op.leader_claimed:
                op.leader_claimed = True
                return True
        return False

    def lead(self, op: RescaleOp) -> None:
        """Execute the surgery through the driver-installed callback."""
        if self.on_rescale is None:
            raise RescaleError(
                f"task {op.task!r}: rescale requested but no surgery "
                f"executor is attached (is the run managed?)")
        self.on_rescale(op)

    def rescale(self, task: str, nslots: Optional[int] = None,
                nprocs: Optional[int] = None, reason: str = "") -> RescaleOp:
        """Programmatic trigger (``RunSupervisor.rescale(task, ...)``): resize
        ``task`` without waiting for a crash.  Asynchronous -- live instances
        are interrupted and the last one to arrive performs the surgery;
        ``op.done.wait()`` blocks until it lands."""
        if self.validate_rescale is not None:
            self.validate_rescale(task, nslots=nslots, nprocs=nprocs)
        op, lead = self.request_rescale(task, nslots=nslots, nprocs=nprocs,
                                        trigger="api", reason=reason)
        if lead:
            self.lead(op)
        return op

    def finish_rescale(self, op: RescaleOp, cut_step: int = -1) -> RescaleEvent:
        """Seal a completed surgery: bump the task's generation (fencing every
        pre-rescale incarnation), adopt the new sizes, and record the event."""
        now = time.monotonic()
        with self._lock:
            self._gen[op.task] = self._gen.get(op.task, 0) + 1
            self.task_counts[op.task] = op.new_nslots
            self.task_nprocs[op.task] = op.new_nprocs
            self._pending_rescale.pop(op.task, None)
            self._fenced = {(t, i) for (t, i) in self._fenced
                            if t != op.task}
            for i in range(max(op.old_nslots, op.new_nslots)):
                key = (op.task, i)
                self._attempt[key] = self._attempt.get(key, 0) + 1
                self._epoch[key] = self._epoch.get(key, 0) + 1
                self._state.pop(key, None)
            ev = RescaleEvent(now, op.task, op.old_nslots, op.new_nslots,
                              op.old_nprocs, op.new_nprocs, op.trigger,
                              cut_step, now - op.t0, op.reason)
            self.rescales.append(ev)
        op.cut_step = cut_step
        op.done.set()
        return ev

    def fail_rescale(self, op: RescaleOp, error: BaseException) -> None:
        with self._lock:
            self._pending_rescale.pop(op.task, None)
        op.error = error
        op.done.set()

    def mark_done_or_join(self, task: str, instance: int
                          ) -> Optional[RescaleOp]:
        """DONE-transition that cannot race a pending rescale: if an op for
        this task exists and the instance is required, return the op (the
        caller must ``arrive`` instead of finishing); else mark DONE."""
        with self._lock:
            op = self._pending_rescale.get(task)
            if op is not None and instance in op.required \
                    and instance not in op.arrived:
                return op
            # a watchdog-dropped instance that later wakes and runs to the
            # end stays DROPPED -- its output was already written off
            if self._state.get((task, instance)) != TaskState.DROPPED:
                self._state[(task, instance)] = TaskState.DONE
            return None

    def replace_channels(self, old: Sequence[Any],
                         new: Sequence[Any]) -> None:
        """Swap a rescaled task's retired channels for the new partition's."""
        with self._lock:
            dead = {id(c) for c in old}
            self.channels = [c for c in self.channels if id(c) not in dead]
            self.channels.extend(new)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "restarts": [e.as_dict() for e in self.restarts],
                "dropped": list(self.dropped),
                "rescales": [e.as_dict() for e in self.rescales],
                "stalls": [e.as_dict() for e in self.stalls],
                "states": {f"{t}[{i}]": s
                           for (t, i), s in sorted(self._state.items())},
                "faults_fired": self.faults.fired() if self.faults else 0,
            }
