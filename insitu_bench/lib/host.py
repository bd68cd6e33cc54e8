"""The benchmark's own host spans: what each thread of a traced run was
doing, on the monotonic clock, to name the device's idle gaps by.  An
untraced run records none (``enabled=False``) and allocates nothing per
span."""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import ContextManager, Iterator, List, Tuple

_NOTHING = nullcontext()


class HostSpans:
    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.items: List[Tuple[str, float, float]] = []

    def span(self, name: str) -> ContextManager[None]:
        return self._record(name) if self.enabled else _NOTHING

    @contextmanager
    def _record(self, name: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.items.append((name, t0, time.monotonic()))   # atomic append
