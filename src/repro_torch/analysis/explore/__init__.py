"""Pass 3: deterministic schedule exploration + happens-before race
detection for the transport and rescale protocols.

Entry points:

* ``python -m repro_torch.analysis explore [--scenario NAME | --all]`` -- run the
  clean-scenario corpus (or one scenario) under a bounded schedule budget.
* ``explore(build, ...)`` / ``replay(build, schedule_id)`` -- library use.
* ``WILKINS_EXPLORE=1`` -- makes the ``make_lock``/``make_condition``/
  ``make_semaphore`` factories hand out cooperative model primitives; they
  only behave differently while a :class:`Controller` is installed.

See ``control.py`` for the scheduler/DFS design, ``instrument.py`` for the
model primitives, ``scenarios.py`` for the corpus.
"""

from .control import (Controller, ExploreAbort, ExploreError, ExploreReport,
                      RunResult, decode_schedule, encode_schedule, explore,
                      replay, run_schedule)
from .scenarios import CORPUS, build_scenario, names

__all__ = [
    "Controller", "ExploreAbort", "ExploreError", "ExploreReport",
    "RunResult", "decode_schedule", "encode_schedule", "explore", "replay",
    "run_schedule", "CORPUS", "build_scenario", "names",
]
