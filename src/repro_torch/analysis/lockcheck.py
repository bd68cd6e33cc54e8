"""Pass 2 (runtime half): the instrumented lock/CV wrapper.

Opt-in via ``WILKINS_LOCKCHECK=1``: ``make_lock``/``make_condition``
return checked wrappers that record the cross-thread lock-acquisition
graph while code runs (a tier-1 shard, a benchmark, anything).  Disabled
-- the default -- they return plain ``threading`` primitives with zero
overhead, so adopting the factories costs nothing on production paths.

What the recorder catches:

* **WLK310** -- a cycle in the name-level acquisition graph: thread A
  takes ``x`` then ``y`` while thread B takes ``y`` then ``x`` is a
  potential deadlock even if the runs interleave safely today.
* **WLK311** -- a known-blocking call (``Channel.get``, ``sleep``,
  ``future.result``) entered while holding a fine-grained lock.  Core
  code marks those sites with :func:`check_blocking`, a no-op when the
  checker is off.  Coarse locks (the VOL serve locks, rank < RANK_FINE)
  are exempt: a producer parked in ``offer()`` *holds* its serve lock by
  design -- that is the rescale grace protocol, not a bug.
* **WLK312** -- an acquisition against the canonical rank order (below).

The canonical order (outermost first) is the one the PR-7 rescale surgery
established; the checker turns the convention into an enforced rule::

    10  vol.serve      per-producer-instance VOL serve lock
    20  supervisor     recovery.RunSupervisor._lock
    25  scheduler      SchedulerRuntime._lock/_tick_lock, PrefetchPool cv
    30  channel.cv     the per-channel condition variable
    40  channel.sem    ResizableSemaphore cv, supervisor heartbeat lock
    50  leaf           mux, telemetry, stats, fault plans, driver misc

Same-rank nesting is allowed only for ranks declaring it (the serve locks
are acquired in sorted producer order by the surgery; sibling channel CVs
are snapshotted one at a time).  Reentrant re-acquisition of the *same*
object (Condition wraps an RLock) is never an edge.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, Findings, Location

__all__ = ["enabled", "explore_enabled", "make_lock", "make_condition",
           "make_semaphore", "check_blocking", "sched_point", "access_point",
           "hb_publish", "hb_consume", "set_explore_controller",
           "explore_controller", "registry", "LockCheckRegistry", "RANK_FINE",
           "RANKS"]

#: canonical rank bands (outermost = smallest); see module docstring
RANKS: Dict[str, int] = {
    "vol.serve": 10,
    "supervisor": 20,
    "scheduler": 25,
    "pool": 25,
    "channel.cv": 30,
    "channel.sem": 40,
    "supervisor.hb": 40,
    "leaf": 50,
}

#: blocking calls are only an error under locks at least this fine --
#: holding a coarse serve lock across a blocking offer IS the grace
#: protocol the rescale surgery depends on.
RANK_FINE = 25

#: ranks where same-rank nesting is legal because the code imposes its own
#: total order (serve locks: sorted producer order; channel CVs: the
#: surgery snapshots siblings one at a time under the serve locks).
SELF_NESTING_RANKS: Set[int] = {10, 30}


def enabled() -> bool:
    return os.environ.get("WILKINS_LOCKCHECK", "") not in ("", "0")


def explore_enabled() -> bool:
    """Pass 3 (``analysis.explore``): the deterministic schedule explorer.

    When ``WILKINS_EXPLORE=1`` the factories hand out *cooperative* model
    primitives that serialize every managed thread onto a single
    runnable-at-a-time token (see ``analysis/explore/control.py``); outside
    an active exploration they delegate to plain ``threading`` primitives,
    so merely having the env var set never changes production behaviour.
    """
    return os.environ.get("WILKINS_EXPLORE", "") not in ("", "0")


# The active schedule-exploration controller.  ``None`` (the default, and
# always the case unless WILKINS_EXPLORE=1 *and* an exploration is running)
# makes every hook below a single global-load + ``is None`` test -- the
# whole instrumentation budget on the production hot path.
_EXPLORE_CONTROLLER: Optional[Any] = None


def set_explore_controller(controller: Optional[Any]) -> Optional[Any]:
    """Install (or clear, with ``None``) the active explore controller;
    returns the previous one so nested use can restore it."""
    global _EXPLORE_CONTROLLER
    prev = _EXPLORE_CONTROLLER
    _EXPLORE_CONTROLLER = controller
    return prev


def explore_controller() -> Optional[Any]:
    return _EXPLORE_CONTROLLER


def sched_point(tag: str, key: Any = None, access: Optional[str] = None) -> None:
    """An explicit scheduler yield point (no-op unless exploring).

    Core code marks the windows that matter to the transport/rescale
    protocols -- the unlocked gap in ``Channel.offer``, the share re-read in
    ``Dataset._acquire_share``, the rescale surgery steps -- so the explorer
    can preempt exactly there.  ``key`` identifies the object the operation
    touches (dependence relation for sleep-set pruning); ``access`` of
    ``"r"``/``"w"`` additionally records a shadow-state data access at
    ``key`` for the happens-before race detector (WLK320).
    """
    c = _EXPLORE_CONTROLLER
    if c is not None:
        c.sched_point(tag, key=key, access=access)


def access_point(tag: str, key: Any, access: str) -> None:
    """A shadow-state data access (``"r"``/``"w"``) at ``key`` for the
    happens-before race detector, WITHOUT a yield point (no-op unless
    exploring).

    For accesses the JAX package has no yield point at -- the read of a
    tensor buffer, which it makes of an immutable ``jax.Array`` -- so the
    explored interleavings stay the JAX package's while the detector still
    sees a mutable tensor being read."""
    c = _EXPLORE_CONTROLLER
    if c is not None:
        c.access_point(tag, key=key, access=access)


def hb_publish(key: Any) -> None:
    """Stamp a happens-before *publish* edge at ``key`` (channel offer,
    CoW share hand-off): the publisher's vector clock is merged into the
    key's clock so a later ``hb_consume`` is ordered after it.  No-op
    unless exploring."""
    c = _EXPLORE_CONTROLLER
    if c is not None:
        c.hb_publish(key)


def hb_consume(key: Any) -> None:
    """Join the clock published at ``key`` into the consuming thread
    (channel get / delivery).  No-op unless exploring."""
    c = _EXPLORE_CONTROLLER
    if c is not None:
        c.hb_consume(key)


def rank_of(name: str) -> int:
    """Rank from a lock name: the prefix before ``:`` keys into RANKS."""
    return RANKS.get(name.split(":", 1)[0], RANKS["leaf"])


class LockCheckRegistry:
    """Process-wide recorder: per-thread held stacks, the name-level edge
    graph, rank violations, and blocking-under-lock events."""

    def __init__(self):
        self._mu = threading.Lock()  # wilkins: ignore[WLK305] -- checker internals
        self._held = threading.local()
        # (outer_prefix, inner_prefix) -> one example (outer, inner, thread)
        self.edges: Dict[Tuple[str, str], Tuple[str, str, str]] = {}
        self.rank_violations: List[Tuple[str, str, str]] = []
        self.blocking: List[Tuple[str, str, str]] = []

    # ------------------------------------------------------------- held API
    def _stack(self) -> List[Tuple[str, int, int]]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def held(self) -> List[str]:
        return [name for name, _, _ in self._stack()]

    def push(self, name: str, rank: int, obj_id: int) -> None:
        st = self._stack()
        if any(oid == obj_id for _, _, oid in st):
            # reentrant re-acquisition of the same object (Condition wraps
            # an RLock): never an edge, never a violation
            st.append((name, rank, obj_id))
            return
        if st:
            outer_name, outer_rank, _ = st[-1]
            a, b = _prefix(outer_name), _prefix(name)
            if a != b:
                with self._mu:
                    self.edges.setdefault(
                        (a, b), (outer_name, name,
                                 threading.current_thread().name))
            bad_order = (rank < outer_rank
                         or (rank == outer_rank
                             and rank not in SELF_NESTING_RANKS
                             and a != b))
            if bad_order:
                with self._mu:
                    self.rank_violations.append(
                        (outer_name, name, threading.current_thread().name))
        st.append((name, rank, obj_id))

    def pop(self, obj_id: int) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][2] == obj_id:
                del st[i]
                return

    # --------------------------------------------------------- diagnostics
    def note_blocking(self, what: str) -> None:
        st = self._stack()
        fine = [name for name, rank, _ in st if rank >= RANK_FINE]
        if fine:
            with self._mu:
                self.blocking.append(
                    (what, fine[-1], threading.current_thread().name))

    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the prefix-level edge graph (DFS)."""
        with self._mu:
            succ: Dict[str, Set[str]] = {}
            for (a, b) in self.edges:
                succ.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        for start in sorted(succ):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(succ.get(node, ())):
                    if nxt == start:
                        cyc = path + [start]
                        key = tuple(sorted(set(cyc)))
                        if key not in seen_cycles:
                            seen_cycles.add(key)
                            out.append(cyc)
                    elif nxt not in path:
                        stack.append((nxt, path + [nxt]))
        return out

    def findings(self) -> Findings:
        out = Findings()
        for cyc in self.cycles():
            out.add(Diagnostic(
                "WLK310",
                f"lock-acquisition cycle: {' -> '.join(cyc)} (threads "
                f"acquire these lock groups in conflicting orders)",
                Location()))
        with self._mu:
            for outer, inner, thread in self.rank_violations:
                out.add(Diagnostic(
                    "WLK312",
                    f"thread {thread!r} acquired {inner!r} (rank "
                    f"{rank_of(inner)}) while holding {outer!r} (rank "
                    f"{rank_of(outer)}) -- against the canonical order",
                    Location()))
            for what, under, thread in self.blocking:
                out.add(Diagnostic(
                    "WLK311",
                    f"thread {thread!r} entered blocking call {what!r} "
                    f"while holding {under!r}",
                    Location()))
        return out

    def assert_clean(self) -> None:
        f = self.findings()
        if f.errors():
            raise AssertionError(
                "lock-discipline violations recorded:\n" + f.render_text())

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.rank_violations.clear()
            self.blocking.clear()


def _prefix(name: str) -> str:
    return name.split(":", 1)[0]


_registry = LockCheckRegistry()


def registry() -> LockCheckRegistry:
    return _registry


# ---------------------------------------------------------------------------
# checked primitives
# ---------------------------------------------------------------------------
class CheckedLock:
    """A named, rank-aware wrapper over ``threading.Lock``."""

    def __init__(self, name: str):
        self.name = name
        self.rank = rank_of(name)
        self._lock = threading.Lock()  # wilkins: ignore[WLK305] -- the wrapped primitive

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            registry().push(self.name, self.rank, id(self))
        return got

    def release(self) -> None:
        registry().pop(id(self))
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()


class CheckedCondition:
    """A named, rank-aware wrapper over ``threading.Condition``.

    ``wait`` pops the held entry while parked (the CV releases its lock)
    and re-records it on wakeup, so the recorder never sees a parked
    waiter as "holding" the lock."""

    def __init__(self, name: str):
        self.name = name
        self.rank = rank_of(name)
        self._cond = threading.Condition()  # wilkins: ignore[WLK305] -- the wrapped primitive

    # -- lock surface
    def acquire(self, *args) -> bool:
        got = self._cond.acquire(*args)
        if got:
            registry().push(self.name, self.rank, id(self))
        return got

    def release(self) -> None:
        registry().pop(id(self))
        self._cond.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- condition surface
    def wait(self, timeout: Optional[float] = None) -> bool:
        registry().pop(id(self))
        try:
            # the wrapper delegates; the while-predicate discipline
            # applies to its CALLERS
            return self._cond.wait(timeout)  # wilkins: ignore[WLK302]
        finally:
            registry().push(self.name, self.rank, id(self))

    def wait_for(self, predicate, timeout: Optional[float] = None):
        registry().pop(id(self))
        try:
            # wrapper pass-through, see wait()
            return self._cond.wait_for(predicate, timeout)  # wilkins: ignore[WLK302]
        finally:
            registry().push(self.name, self.rank, id(self))

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# ---------------------------------------------------------------------------
# factories + the blocking-site hook
# ---------------------------------------------------------------------------
# Factory precedence: explore > lockcheck > plain.  The explore wrappers are
# imported lazily (only when WILKINS_EXPLORE=1) so the common path never pays
# the import and there is no lockcheck <-> explore import cycle.
def make_lock(name: str) -> Any:
    """A ``threading.Lock`` -- checked when WILKINS_LOCKCHECK=1, a
    cooperative model lock when WILKINS_EXPLORE=1."""
    if explore_enabled():
        from .explore.instrument import ExploreLock
        return ExploreLock(name)
    return CheckedLock(name) if enabled() else threading.Lock()  # wilkins: ignore[WLK305] -- the factory itself


def make_condition(name: str) -> Any:
    """A ``threading.Condition`` -- checked and named when
    WILKINS_LOCKCHECK=1, a cooperative model CV when WILKINS_EXPLORE=1."""
    if explore_enabled():
        from .explore.instrument import ExploreCondition
        return ExploreCondition(name)
    return CheckedCondition(name) if enabled() else threading.Condition()  # wilkins: ignore[WLK305] -- the factory itself


def make_semaphore(name: str, value: int = 1) -> Any:
    """A ``threading.Semaphore`` -- a cooperative model semaphore when
    WILKINS_EXPLORE=1.  Lockcheck has no semaphore discipline to enforce
    (semaphores carry no canonical rank), so the lockcheck path stays
    plain; the name still matters to the explorer's dependence relation."""
    if explore_enabled():
        from .explore.instrument import ExploreSemaphore
        return ExploreSemaphore(name, value)
    return threading.Semaphore(value)  # wilkins: ignore[WLK305] -- the factory itself


def check_blocking(what: str) -> None:
    """Mark a known-blocking call site (``Channel.get``, ``sleep``,
    ``future.result``).  No-op unless the checker is on; records WLK311
    when entered while holding a fine-grained lock."""
    if enabled():
        registry().note_blocking(what)
