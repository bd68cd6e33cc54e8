"""Pass 3: the deterministic schedule explorer (CHESS/loom-style).

A scenario is a function returning a list of ``(name, fn)`` thread bodies
closed over freshly-built shared state (real ``Channel``/``Dataset``
objects, or seeded-race mockups).  The :class:`Controller` runs those
bodies on real OS threads but serializes them onto ONE runnable-at-a-time
token: every instrumented operation -- ``ExploreLock.acquire``,
``ExploreCondition.wait``/``notify``, ``ExploreSemaphore``, and every
explicit ``lockcheck.sched_point`` in core -- is a *yield point* where the
controller decides which thread proceeds.  Because only the chosen thread
ever runs, an execution is fully determined by the sequence of decisions,
which makes every interleaving reproducible.

Enumeration (``explore``) is a stateless DFS over decision prefixes:

* **bounded preemption** (CHESS): switching away from a thread that could
  still run costs one unit of a small budget (default 2).  Most concurrency
  bugs need very few preemptions, and the bound collapses the schedule
  space from exponential-in-steps to polynomial.
* **sleep sets** (partial-order reduction): after exploring thread *t* at a
  decision node, sibling branches put *t* to sleep until some executed
  operation is *dependent* with the operation *t* was about to perform
  (same object key).  Commuting acquisitions are explored once, not twice.

What the explorer reports (each with a **replayable schedule ID** that
re-runs the exact interleaving):

* **WLK320** -- a data race: two accesses to the same buffer, at least one
  a write, unordered by the happens-before relation (vector clocks stamped
  at lock release->acquire, CV notify->wake, semaphore release->acquire,
  and the explicit ``hb_publish``/``hb_consume`` channel and CoW edges).
  Both stack traces are attached.
* **WLK321** -- deadlock: no thread is runnable and at least one is blocked
  on a lock (or the run spins on timed waits without progress).
* **WLK322** -- lost wakeup: every blocked thread is parked on a condition
  variable no one will ever notify again.
* **WLK323** -- a scenario invariant (assertion) failed under some
  schedule: exactly-once delivery violated, torn value observed, etc.

Schedule IDs are ``<scenario>@s<step>.<thread>[-s<step>.<thread>...]``:
the decisions taken at every multi-candidate yield point of the failing
run.  ``replay`` forces those decisions and lets the deterministic default
policy (run the current thread while it can) fill in the rest.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..diagnostics import Diagnostic, Findings, Location
from .. import lockcheck

__all__ = [
    "Controller", "ExploreAbort", "ExploreError", "RunResult",
    "ExploreReport", "run_schedule", "explore", "replay",
    "encode_schedule", "decode_schedule",
]

#: thread states
RUNNABLE = "runnable"
BLOCKED_LOCK = "lock"      # parked on a model lock; enabled iff lock free
WAITING_CV = "cv-wait"     # parked in Condition.wait; never enabled
REACQ_CV = "cv-reacq"      # notified/timed out; enabled iff the CV lock is free
BLOCKED_SEM = "sem"        # parked on a model semaphore; enabled iff permits
DONE = "done"

#: timed waits fire only when nothing else can run; a run that takes more
#: than this many consecutive timeout-wakes without real progress is spinning
#: on deadlines -- report it as a stall (WLK321) instead of looping forever.
MAX_TIMEOUT_WAKES = 64


class ExploreAbort(BaseException):
    """Raised through parked threads to unwind a finished/failed schedule.

    Derives from ``BaseException`` so scenario code's ``except Exception``
    handlers cannot swallow it."""


class ExploreError(RuntimeError):
    """The explorer itself hit a hard limit (step cap, wedged thread)."""


def _trim_stack(skip: int = 2, limit: int = 10) -> str:
    frames = traceback.extract_stack()[:-skip]
    interesting = [f for f in frames
                   if "explore/control.py" not in f.filename
                   and "explore/instrument.py" not in f.filename
                   and "/threading.py" not in f.filename]
    return "".join(traceback.format_list(interesting[-limit:]))


class _VC:
    """A vector clock over the scenario's thread indices."""

    __slots__ = ("c",)

    def __init__(self, n: int):
        self.c = [0] * n

    def copy(self) -> "_VC":
        out = _VC(0)
        out.c = list(self.c)
        return out

    def join(self, other: "_VC") -> None:
        self.c = [max(a, b) for a, b in zip(self.c, other.c)]

    def leq(self, other: "_VC") -> bool:
        return all(a <= b for a, b in zip(self.c, other.c))


class _Thread:
    """One managed scenario thread plus its model/scheduling state."""

    def __init__(self, idx: int, name: str, fn: Callable[[], None], n: int):
        self.idx = idx
        self.name = name
        self.fn = fn
        self.event = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.state = RUNNABLE
        self.waiting_on: Any = None     # the model primitive when blocked
        self.timed = False              # parked with a timeout?
        self.wait_result = True         # what Condition.wait returns on resume
        self.pending_join: Optional[_VC] = None  # notifier's clock, if notified
        self.pending_key: Any = ("begin", idx)   # op key for dependence/sleep
        self.clock = _VC(n)
        self.clock.c[idx] = 1


@dataclass
class _Node:
    """A multi-candidate decision point observed during one run."""

    step: int
    candidates: List[Tuple[int, Any]]   # (thread idx, its pending op key)
    chosen: int


@dataclass
class RunResult:
    decisions: List[Tuple[int, int]] = field(default_factory=list)
    nodes: List[_Node] = field(default_factory=list)
    findings: Findings = field(default_factory=Findings)
    pruned: bool = False      # redundant under sleep sets; not counted as clean
    overflow: bool = False    # hit the per-schedule step cap
    steps: int = 0


class Controller:
    """Serializes managed threads onto one token and records decisions.

    One Controller runs ONE schedule; ``explore`` constructs a fresh one
    (and fresh scenario state) per enumerated schedule.
    """

    def __init__(self, bodies: Sequence[Tuple[str, Callable[[], None]]],
                 forced: Optional[Dict[int, int]] = None,
                 sleep_at: Optional[Dict[int, Dict[int, Any]]] = None,
                 preemption_bound: int = 2,
                 max_steps: int = 20000,
                 scenario: str = "scenario"):
        n = len(bodies)
        self.threads = [_Thread(i, name, fn, n)
                        for i, (name, fn) in enumerate(bodies)]
        self.forced = dict(forced or {})
        self.sleep_at = {s: dict(m) for s, m in (sleep_at or {}).items()}
        self.preemption_bound = int(preemption_bound)
        self.max_steps = int(max_steps)
        self.scenario = scenario
        self.step = 0
        self.preemptions = 0
        self.timeout_wakes = 0
        self.live_sleep: Dict[int, Any] = {}
        self.result = RunResult()
        self.abort = False
        self._mu = threading.Lock()  # wilkins: ignore[WLK305] -- controller internals
        self._driver_evt = threading.Event()
        self._by_ident: Dict[int, _Thread] = {}
        # happens-before state
        self._pub: Dict[Any, _VC] = {}       # hb_publish key -> clock
        # shadow memory: addr -> (write (vc, tidx, stack) | None,
        #                         {tidx: (vc, stack)} reads since last write)
        self._shadow: Dict[Any, Tuple[Optional[Tuple[_VC, int, str]],
                                      Dict[int, Tuple[_VC, str]]]] = {}
        self._race_sites: set = set()        # dedupe reported (addr, pair)
        # raw op key -> dense index, assigned in first-reference order.
        # Raw keys embed id() of PER-RUN objects (every schedule rebuilds
        # the scenario), so they are meaningless across runs; the reference
        # ORDER over a shared forced prefix is deterministic, so interned
        # indices recorded in a parent's sleep sets match the sibling run's
        # indices for the same logical operation.  Without this the sleep
        # keys never match, sleepers never wake, and sibling branches get
        # pruned as "redundant" before reaching their bugs.
        self._key_intern: Dict[Any, int] = {}

    # ------------------------------------------------------------ plumbing
    def _me(self) -> Optional[_Thread]:
        return self._by_ident.get(threading.get_ident())

    def managed(self) -> bool:
        return self._me() is not None

    def _park(self, t: _Thread) -> None:
        t.event.wait()
        t.event.clear()
        if self.abort:
            raise ExploreAbort()

    def _switch(self, cur: _Thread, nxt: _Thread) -> None:
        if nxt is cur:
            return
        nxt.event.set()
        self._park(cur)

    def _abort_all(self) -> None:
        with self._mu:
            self.abort = True
            for t in self.threads:
                t.event.set()

    # ----------------------------------------------------------- enabling
    def _enabled(self, t: _Thread) -> bool:
        if t.state == RUNNABLE:
            return True
        if t.state == BLOCKED_LOCK:
            return t.waiting_on.owner is None
        if t.state == REACQ_CV:
            return t.waiting_on._lk.owner is None
        if t.state == BLOCKED_SEM:
            return t.waiting_on.permits > 0
        return False  # WAITING_CV, DONE

    # ----------------------------------------------------------- deciding
    def _decide(self, cur: Optional[_Thread]) -> _Thread:
        if self.abort:
            raise ExploreAbort()
        self.step += 1
        if self.step > self.max_steps:
            self.result.overflow = True
            self._abort_all()
            raise ExploreAbort()
        enabled = [t for t in self.threads if self._enabled(t)]
        if not enabled:
            return self._handle_stuck(cur)
        awake = [t for t in enabled if t.idx not in self.live_sleep]
        if not awake:
            # every runnable thread is asleep: this schedule is equivalent
            # to one already explored -- prune it
            self.result.pruned = True
            self._abort_all()
            raise ExploreAbort()
        cur_enabled = cur is not None and cur in awake
        if cur_enabled and self.preemptions >= self.preemption_bound:
            candidates = [cur]
        else:
            candidates = awake
        chosen: Optional[_Thread] = None
        want = self.forced.get(self.step)
        if want is not None:
            chosen = next((t for t in candidates if t.idx == want), None)
        if chosen is None:
            chosen = cur if cur_enabled else candidates[0]
        if len(candidates) > 1:
            self.result.nodes.append(_Node(
                step=self.step,
                candidates=[(t.idx, t.pending_key) for t in candidates],
                chosen=chosen.idx))
        if len(enabled) > 1:
            # record a decision for every multi-ENABLED step, not just
            # multi-candidate ones: sleep sets narrow `candidates` during
            # exploration but do not exist during replay, so a replay of
            # this schedule faces the full enabled set here and needs the
            # forced entry to stay on the recorded path
            self.result.decisions.append((self.step, chosen.idx))
        if cur_enabled and chosen is not cur:
            self.preemptions += 1
        sl = self.sleep_at.get(self.step)
        if sl:
            self.live_sleep.update(sl)
            self.live_sleep.pop(chosen.idx, None)
        return chosen

    def _handle_stuck(self, cur: Optional[_Thread]) -> _Thread:
        """No thread is enabled: fire a timed wait if one exists, else
        report deadlock (WLK321) / lost wakeup (WLK322) and abort."""
        timed = [t for t in self.threads
                 if t.state == WAITING_CV and t.timed]
        if timed:
            self.timeout_wakes += 1
            if self.timeout_wakes <= MAX_TIMEOUT_WAKES:
                t = timed[0]
                cv = t.waiting_on
                cv.waiters.remove(t.idx)
                t.state = REACQ_CV
                t.wait_result = False      # Condition.wait timeout contract
                return self._decide(cur)   # re-evaluate with t now enabled
            self._report_stuck(
                "WLK321",
                f"no progress after {MAX_TIMEOUT_WAKES} timeout-wakes: "
                f"threads spin on timed waits without the predicate ever "
                f"becoming true")
        else:
            blocked = [t for t in self.threads if t.state != DONE]
            if blocked and all(t.state == WAITING_CV for t in blocked):
                self._report_stuck(
                    "WLK322",
                    "lost wakeup: "
                    + "; ".join(f"thread {t.name!r} is parked in "
                                f"{t.waiting_on.name}.wait() and no live "
                                f"thread will notify it" for t in blocked))
            else:
                self._report_stuck(
                    "WLK321",
                    "deadlock: "
                    + "; ".join(f"thread {t.name!r} blocked ({t.state}) on "
                                f"{getattr(t.waiting_on, 'name', '?')}"
                                for t in blocked))
        self._abort_all()
        raise ExploreAbort()

    def _report_stuck(self, code: str, message: str) -> None:
        self.result.findings.add(Diagnostic(
            code, f"[{self.scenario}] {message}", Location()))

    # ------------------------------------------------ model-primitive ops
    def lock_acquire(self, lk, blocking: bool = True,
                     timeout: Optional[float] = None) -> bool:
        cur = self._me()
        self._set_pending(cur, ("lock", id(lk)))
        self._switch(cur, self._decide(cur))   # the pre-acquire window
        while lk.owner is not None:
            if not blocking:
                return False
            cur.state = BLOCKED_LOCK
            cur.waiting_on = lk
            self._switch(cur, self._decide(cur))
        lk.owner = cur.idx
        cur.state = RUNNABLE
        cur.waiting_on = None
        cur.clock.join(lk.clock)               # HB: release -> acquire
        return True

    def lock_release(self, lk) -> None:
        cur = self._me()
        if lk.owner != cur.idx:
            raise RuntimeError(
                f"{lk.name}: released by thread {cur.name!r} which does "
                f"not hold it (owner={lk.owner})")
        lk.clock.join(cur.clock)
        cur.clock.c[cur.idx] += 1
        lk.owner = None
        self._set_pending(cur, ("lock", id(lk)))
        self._switch(cur, self._decide(cur))   # post-critical-section window

    def cv_wait(self, cv, timeout: Optional[float] = None) -> bool:
        cur = self._me()
        lk = cv._lk
        if lk.owner != cur.idx:
            raise RuntimeError(f"{cv.name}: wait() on un-acquired lock")
        # Pre-park window: the wait is pending but the thread is not yet
        # a waiter.  This keeps the park a single-object step (sleep-set
        # dependency checks compare one pending key per step; a step that
        # silently runs from an earlier yield straight into the park has
        # a hidden CV effect and lets the sleep set prune the lost-wakeup
        # interleaving as "independent").  With proper locking the window
        # is unreachable by a notifier, which must hold the CV's lock.
        self._set_pending(cur, ("cv", id(cv)))
        self._switch(cur, self._decide(cur))
        # release the lock (with the HB edge), park as a waiter
        lk.clock.join(cur.clock)
        cur.clock.c[cur.idx] += 1
        lk.owner = None
        self._op_executed(self._intern_key(("lock", id(lk))))
        cur.state = WAITING_CV
        cur.waiting_on = cv
        cur.timed = timeout is not None
        cur.wait_result = True
        cur.pending_join = None
        cv.waiters.append(cur.idx)
        self._set_pending(cur, ("cv", id(cv)))
        self._switch(cur, self._decide(cur))
        # resumed: state is REACQ_CV (notified, or timed out in _handle_stuck)
        while lk.owner is not None:
            cur.state = BLOCKED_LOCK
            cur.waiting_on = lk
            self._switch(cur, self._decide(cur))
        lk.owner = cur.idx
        cur.state = RUNNABLE
        cur.waiting_on = None
        cur.timed = False
        cur.clock.join(lk.clock)
        self._op_executed(self._intern_key(("lock", id(lk))))
        if cur.pending_join is not None:       # HB: notify -> wake
            cur.clock.join(cur.pending_join)
            cur.pending_join = None
        return cur.wait_result

    def cv_notify(self, cv, n: int = 1) -> None:
        """Wake up to ``n`` waiters.  Deliberately does NOT require the
        caller to hold the CV's lock: a notify racing the check-to-park gap
        of a waiter is exactly the lost-wakeup hazard the explorer models
        (real ``threading`` forbids it; lower-level CVs do not).

        The notify is its own scheduling step: without the yield it runs
        hidden inside whatever step preceded it, its CV effect invisible
        to the sleep set's one-key-per-step dependency check."""
        cur = self._me()
        self._set_pending(cur, ("cv", id(cv)))
        self._switch(cur, self._decide(cur))
        woken = cv.waiters[:max(0, n)] if n >= 0 else list(cv.waiters)
        for idx in woken:
            t = self.threads[idx]
            cv.waiters.remove(idx)
            t.state = REACQ_CV
            t.pending_join = cur.clock.copy()
        if woken:
            cur.clock.c[cur.idx] += 1

    def sem_acquire(self, sem, blocking: bool = True,
                    timeout: Optional[float] = None) -> bool:
        cur = self._me()
        self._set_pending(cur, ("sem", id(sem)))
        self._switch(cur, self._decide(cur))
        while sem.permits <= 0:
            if not blocking:
                return False
            cur.state = BLOCKED_SEM
            cur.waiting_on = sem
            cur.timed = timeout is not None
            self._switch(cur, self._decide(cur))
        sem.permits -= 1
        cur.state = RUNNABLE
        cur.waiting_on = None
        cur.timed = False
        cur.clock.join(sem.clock)              # HB: release -> acquire
        return True

    def sem_release(self, sem, n: int = 1) -> None:
        cur = self._me()
        sem.clock.join(cur.clock)
        cur.clock.c[cur.idx] += 1
        sem.permits += n
        self._set_pending(cur, ("sem", id(sem)))
        self._switch(cur, self._decide(cur))

    # ----------------------------------------------- sched_point + HB/race
    def sched_point(self, tag: str, key: Any = None,
                    access: Optional[str] = None) -> None:
        cur = self._me()
        if cur is None:
            return   # unmanaged thread (e.g. a prefetch worker): no model
        self._set_pending(cur, key if key is not None else ("tag", tag))
        self._switch(cur, self._decide(cur))
        if access is not None:
            self._race_check(cur, tag, cur.pending_key, access)

    def access_point(self, tag: str, key: Any, access: str) -> None:
        """Race-check an access with no decision: the current thread keeps
        the token, and the key is interned as a yield point's would be."""
        cur = self._me()
        if cur is None:
            return
        self._race_check(cur, tag, self._intern_key(key), access)

    def hb_publish(self, key: Any) -> None:
        cur = self._me()
        if cur is None:
            return
        vc = self._pub.setdefault(key, _VC(len(self.threads)))
        vc.join(cur.clock)
        cur.clock.c[cur.idx] += 1

    def hb_consume(self, key: Any) -> None:
        cur = self._me()
        if cur is None:
            return
        vc = self._pub.get(key)
        if vc is not None:
            cur.clock.join(vc)

    def _race_check(self, cur: _Thread, tag: str, addr: Any,
                    mode: str) -> None:
        write, reads = self._shadow.get(addr, (None, {}))
        stack = _trim_stack()
        racy: List[Tuple[str, int, str]] = []
        if write is not None and write[1] != cur.idx \
                and not write[0].leq(cur.clock):
            racy.append(("write", write[1], write[2]))
        if mode == "w":
            for tidx, (vc, rstack) in reads.items():
                if tidx != cur.idx and not vc.leq(cur.clock):
                    racy.append(("read", tidx, rstack))
        for kind, tidx, ostack in racy:
            site = (addr, min(tidx, cur.idx), max(tidx, cur.idx))
            if site in self._race_sites:
                continue
            self._race_sites.add(site)
            self.result.findings.add(Diagnostic(
                "WLK320",
                f"[{self.scenario}] data race at {tag!r}: thread "
                f"{cur.name!r} {'writes' if mode == 'w' else 'reads'} a "
                f"buffer that thread {self.threads[tidx].name!r} "
                f"{kind.replace('e', 'es', 1) if kind == 'write' else kind + 's'} "
                f"with no happens-before edge between them\n"
                f"--- access by {cur.name!r}:\n{stack}"
                f"--- prior {kind} by {self.threads[tidx].name!r}:\n{ostack}",
                Location()))
        if racy:
            self._abort_all()
            raise ExploreAbort()
        if mode == "w":
            self._shadow[addr] = ((cur.clock.copy(), cur.idx, stack), {})
        else:
            reads = dict(reads)
            reads[cur.idx] = (cur.clock.copy(), stack)
            self._shadow[addr] = (write, reads)

    def _intern_key(self, key: Any) -> int:
        idx = self._key_intern.get(key)
        if idx is None:
            idx = len(self._key_intern)
            self._key_intern[key] = idx
        return idx

    def _set_pending(self, cur: _Thread, key: Any) -> None:
        """Stamp ``cur``'s next operation (interned) and count it as
        executed for sleep-set dependence."""
        cur.pending_key = self._intern_key(key)
        self._op_executed(cur.pending_key)

    def _op_executed(self, key: Any) -> None:
        """An operation with ``key`` is about to run: wake sleeping threads
        whose pending operation is dependent (same key) with it.  A thread
        put to sleep before it ever ran carries the opaque ``("begin", i)``
        marker -- its first operation is unknown, so it must wake on ANY
        operation (keeping it asleep on an op it might depend on would be
        unsound)."""
        if self.live_sleep:
            for idx in [i for i, k in self.live_sleep.items()
                        if k == key or (isinstance(k, tuple) and k
                                        and k[0] == "begin")]:
                del self.live_sleep[idx]

    # -------------------------------------------------------- thread loop
    def _run_thread(self, t: _Thread) -> None:
        try:
            self._park(t)      # wait for the first token
            t.fn()
        except ExploreAbort:
            pass
        except BaseException as e:
            if not self.abort:
                self.result.findings.add(Diagnostic(
                    "WLK323",
                    f"[{self.scenario}] thread {t.name!r} failed: "
                    f"{type(e).__name__}: {e}\n"
                    + "".join(traceback.format_exception(
                        type(e), e, e.__traceback__, limit=8)),
                    Location()))
                self._abort_all()
        finally:
            self._finish(t)

    def _finish(self, t: _Thread) -> None:
        t.state = DONE
        with self._mu:
            if all(th.state == DONE for th in self.threads):
                self._driver_evt.set()
                return
            if self.abort:
                return
        try:
            nxt = self._decide(None)
            nxt.event.set()
        except ExploreAbort:
            pass

    # -------------------------------------------------------------- drive
    def run(self, wall_timeout: float = 60.0) -> RunResult:
        self._by_ident.clear()
        for t in self.threads:
            t.thread = threading.Thread(
                target=self._run_thread, args=(t,),
                name=f"explore:{t.name}", daemon=True)
        for t in self.threads:
            t.thread.start()
            # the ident is only known once the thread runs; park() gates the
            # body until the map is filled in below, so register eagerly
            self._by_ident[t.thread.ident] = t
        self.threads[0].event.set()
        if not self._driver_evt.wait(timeout=wall_timeout):
            self.abort = True
            for t in self.threads:
                t.event.set()
            raise ExploreError(
                f"[{self.scenario}] schedule wedged after {wall_timeout}s "
                f"(a managed thread blocked outside the model?)")
        for t in self.threads:
            t.thread.join(timeout=5.0)
        self.result.steps = self.step
        return self.result


# ---------------------------------------------------------------------------
# schedule IDs
# ---------------------------------------------------------------------------
def encode_schedule(scenario: str, decisions: Sequence[Tuple[int, int]]) -> str:
    body = "-".join(f"s{s}.{t}" for s, t in decisions) or "root"
    return f"{scenario}@{body}"


def decode_schedule(schedule_id: str) -> Tuple[str, Dict[int, int]]:
    scenario, _, body = schedule_id.partition("@")
    forced: Dict[int, int] = {}
    if body and body != "root":
        for part in body.split("-"):
            s, _, t = part[1:].partition(".")
            forced[int(s)] = int(t)
    return scenario, forced


# ---------------------------------------------------------------------------
# the DFS driver
# ---------------------------------------------------------------------------
@dataclass
class ExploreReport:
    scenario: str
    schedules: int = 0
    pruned: int = 0
    complete: bool = False          # frontier exhausted within budget
    findings: Findings = field(default_factory=Findings)
    schedule_id: Optional[str] = None
    steps_total: int = 0
    elapsed_s: float = 0.0

    @property
    def found(self) -> bool:
        return len(self.findings) > 0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "schedules": self.schedules,
            "pruned": self.pruned,
            "complete": self.complete,
            "found": self.found,
            "codes": sorted({d.code for d in self.findings}),
            "schedule_id": self.schedule_id,
            "steps_total": self.steps_total,
            "elapsed_s": self.elapsed_s,
        }


def run_schedule(build: Callable[[], Sequence[Tuple[str, Callable[[], None]]]],
                 forced: Optional[Dict[int, int]] = None,
                 sleep_at: Optional[Dict[int, Dict[int, Any]]] = None,
                 preemption_bound: int = 2,
                 max_steps: int = 20000,
                 scenario: str = "scenario") -> RunResult:
    """Run ONE schedule of ``build()`` under a fresh controller."""
    ctl = Controller(build(), forced=forced, sleep_at=sleep_at,
                     preemption_bound=preemption_bound,
                     max_steps=max_steps, scenario=scenario)
    prev = lockcheck.set_explore_controller(ctl)
    try:
        return ctl.run()
    finally:
        lockcheck.set_explore_controller(prev)


def explore(build: Callable[[], Sequence[Tuple[str, Callable[[], None]]]],
            *, scenario: str = "scenario", max_schedules: int = 256,
            preemption_bound: int = 2, max_steps: int = 20000) -> ExploreReport:
    """Enumerate schedules of ``build`` until a finding, exhaustion, or the
    ``max_schedules`` budget; stops at the FIRST finding (its schedule ID
    replays it)."""
    t0 = time.monotonic()
    report = ExploreReport(scenario=scenario)
    # frontier entries: (forced decisions, sleep_at); LIFO => DFS
    frontier: List[Tuple[List[Tuple[int, int]],
                         Dict[int, Dict[int, Any]]]] = [([], {})]
    while frontier and report.schedules < max_schedules:
        forced_list, sleep_at = frontier.pop()
        forced = dict(forced_list)
        res = run_schedule(build, forced=forced, sleep_at=sleep_at,
                           preemption_bound=preemption_bound,
                           max_steps=max_steps, scenario=scenario)
        report.schedules += 1
        report.steps_total += res.steps
        if res.pruned:
            report.pruned += 1
        if len(res.findings):
            report.findings = res.findings
            report.schedule_id = encode_schedule(scenario, res.decisions)
            report.elapsed_s = time.monotonic() - t0
            return report
        # expand fresh nodes (deeper than this run's forced prefix)
        last_forced = forced_list[-1][0] if forced_list else -1
        for node in res.nodes:
            if node.step <= last_forced:
                continue
            base = [d for d in res.decisions if d[0] < node.step]
            keys = dict(node.candidates)
            slept: Dict[int, Any] = {node.chosen: keys[node.chosen]}
            siblings = [idx for idx, _ in node.candidates
                        if idx != node.chosen]
            # push in reverse so the LIFO explores siblings in order, each
            # sleeping every sibling explored before it (sleep-set POR)
            pending = []
            for idx in siblings:
                new_sleep = {s: dict(m) for s, m in sleep_at.items()
                             if s <= node.step}
                new_sleep[node.step] = dict(slept)
                pending.append((base + [(node.step, idx)], new_sleep))
                slept[idx] = keys[idx]
            frontier.extend(reversed(pending))
    report.complete = not frontier
    report.elapsed_s = time.monotonic() - t0
    return report


def replay(build: Callable[[], Sequence[Tuple[str, Callable[[], None]]]],
           schedule_id: str, *, preemption_bound: Optional[int] = None,
           max_steps: int = 20000) -> RunResult:
    """Re-run the exact interleaving named by ``schedule_id``.

    The preemption bound is lifted to the number of forced decisions (every
    forced switch must be takeable), so a schedule found near the budget
    edge still replays."""
    scenario, forced = decode_schedule(schedule_id)
    bound = preemption_bound if preemption_bound is not None \
        else len(forced) + 2
    return run_schedule(build, forced=forced, preemption_bound=bound,
                        max_steps=max_steps, scenario=scenario)
