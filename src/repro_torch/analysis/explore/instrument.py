"""Explore-mode synchronization primitives.

When ``WILKINS_EXPLORE=1`` the ``make_lock``/``make_condition``/
``make_semaphore`` factories in :mod:`repro_torch.analysis.lockcheck` hand out
these wrappers instead of real ``threading`` objects.  Each wrapper has a
dual personality:

* On a thread **managed** by the active :class:`~.control.Controller`
  (i.e. a scenario thread), every operation routes through the controller:
  it is a yield point, it updates the lock/CV/semaphore *model* state the
  controller schedules against, and it stamps the happens-before vector
  clocks.  No real OS blocking ever happens -- the controller's one-token
  handoff guarantees only one managed thread runs at a time, so the model
  lock IS the mutual exclusion.
* On an **unmanaged** thread (imports at module load, a stray daemon
  worker, test setup code) the wrapper falls back to a real ``threading``
  primitive so code outside a scenario still just works.

The wrappers deliberately implement only the API surface core uses
(context manager, ``acquire``/``release``, ``wait``/``notify``/
``notify_all``, semaphore ``acquire``/``release``).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from .. import lockcheck

__all__ = ["ExploreLock", "ExploreCondition", "ExploreSemaphore",
           "TrackedCell"]


def _controller_for(obj) -> Optional[Any]:
    c = lockcheck.explore_controller()
    if c is not None and c.managed():
        return c
    return None


class ExploreLock:
    """Model mutex: ``owner`` is a thread index or None."""

    def __init__(self, name: str):
        self.name = name
        self.owner: Optional[int] = None
        self.clock = None                      # _VC, sized per controller
        self._ctl = None                       # which run the model state is for
        self._real = threading.Lock()          # wilkins: ignore[WLK305] -- unmanaged-thread fallback

    def _sync(self, c) -> None:
        """Reset the model state when a NEW controller touches this object.

        Module-level locks (transport stats, plan cache) outlive a single
        exploration run; an aborted schedule may have unwound mid-critical-
        section leaving a stale ``owner``, and the vector clock is sized to
        the run's thread count.  Only managed threads of the *current* run
        can genuinely hold a model lock, so resetting on controller change
        is always sound."""
        if self._ctl is not c:
            from .control import _VC
            self._ctl = c
            self.clock = _VC(len(c.threads))
            self.owner = None

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        c = _controller_for(self)
        if c is None:
            if timeout is not None and timeout >= 0:
                return self._real.acquire(blocking, timeout)
            return self._real.acquire(blocking)
        self._sync(c)
        return c.lock_acquire(self, blocking=blocking, timeout=timeout)

    def release(self) -> None:
        c = _controller_for(self)
        if c is None:
            self._real.release()
            return
        self._sync(c)
        c.lock_release(self)

    def locked(self) -> bool:
        c = _controller_for(self)
        if c is None:
            return self._real.locked()
        return self.owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class ExploreCondition:
    """Model condition variable over an embedded :class:`ExploreLock`.

    ``notify`` does NOT require the lock to be held (see
    :meth:`Controller.cv_notify`): the model permits -- and therefore can
    expose -- the notify-outside-lock lost-wakeup hazard that real
    ``threading.Condition`` turns into a hard error.
    """

    def __init__(self, name: str):
        self.name = name
        self._lk = ExploreLock(name)
        self.waiters: List[int] = []
        self._real = threading.Condition()     # wilkins: ignore[WLK305] -- unmanaged-thread fallback

    def _sync(self, c) -> None:
        if self._lk._ctl is not c:
            self._lk._sync(c)
            self.waiters.clear()

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        c = _controller_for(self)
        if c is None:
            return self._real.acquire(blocking) if timeout is None \
                else self._real.acquire(blocking, timeout)
        self._sync(c)
        return self._lk.acquire(blocking=blocking, timeout=timeout)

    def release(self) -> None:
        c = _controller_for(self)
        if c is None:
            self._real.release()
            return
        self._lk.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        c = _controller_for(self)
        if c is None:
            return self._real.wait(timeout)
        self._sync(c)
        return c.cv_wait(self, timeout=timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None) -> bool:
        c = _controller_for(self)
        if c is None:
            return self._real.wait_for(predicate, timeout)
        while not predicate():
            if not self.wait(timeout):
                return predicate()
        return True

    def notify(self, n: int = 1) -> None:
        c = _controller_for(self)
        if c is None:
            with self._real_held_guard():
                self._real.notify(n)
            return
        self._sync(c)
        c.cv_notify(self, n)

    def notify_all(self) -> None:
        c = _controller_for(self)
        if c is None:
            with self._real_held_guard():
                self._real.notify_all()
            return
        self._sync(c)
        c.cv_notify(self, -1)

    def _real_held_guard(self):
        # threading.Condition.notify requires the lock; unmanaged callers
        # are expected to hold it already (core always does), so this is a
        # no-op guard kept for symmetry / future diagnostics.
        class _Noop:
            def __enter__(self_inner): return self_inner
            def __exit__(self_inner, *exc): return False
        return _Noop()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class ExploreSemaphore:
    """Model counting semaphore: ``permits`` is the available count."""

    def __init__(self, name: str, value: int = 1):
        self.name = name
        self.permits = int(value)
        self._value0 = int(value)
        self.clock = None
        self._ctl = None
        self._real = threading.Semaphore(value)  # wilkins: ignore[WLK305] -- unmanaged-thread fallback

    def _sync(self, c) -> None:
        if self._ctl is not c:
            from .control import _VC
            self._ctl = c
            self.clock = _VC(len(c.threads))
            self.permits = self._value0

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        c = _controller_for(self)
        if c is None:
            return self._real.acquire(blocking, timeout)
        self._sync(c)
        return c.sem_acquire(self, blocking=blocking, timeout=timeout)

    def release(self, n: int = 1) -> None:
        c = _controller_for(self)
        if c is None:
            self._real.release(n)
            return
        self._sync(c)
        c.sem_release(self, n)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TrackedCell:
    """A scalar shared variable whose reads/writes feed the race detector.

    Scenario and fixture code uses this to model an unprotected (or
    mis-protected) field: each access is a yield point tagged with the
    cell's identity and an access mode, so the controller both interleaves
    around it and runs the shadow-state happens-before check on it.
    """

    __slots__ = ("name", "_value")

    def __init__(self, name: str, value: Any = 0):
        self.name = name
        self._value = value

    def read(self) -> Any:
        lockcheck.sched_point(f"cell:{self.name}",
                              key=("cell", id(self)), access="r")
        return self._value

    def write(self, value: Any) -> None:
        lockcheck.sched_point(f"cell:{self.name}",
                              key=("cell", id(self)), access="w")
        self._value = value

    def add(self, delta: Any) -> Any:
        """A deliberately torn read-modify-write: read, yield, write."""
        v = self.read()
        v = v + delta
        self.write(v)
        return v
