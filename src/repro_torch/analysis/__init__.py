"""Pre-run static analysis for Wilkins workflows and the core transport.

Two passes over one diagnostics framework (``analysis.diagnostics``):

* ``analysis.workflow`` -- the offline workflow-graph analyzer
  (``python -m repro_torch.analysis check workflow.yaml``): deadlock
  cycles, flow-control hazards, decomposition legality, policy legality,
  and (with dset ``shape:`` hints) reshard-plan coverage (``plancheck``).
* ``analysis.astlint`` + ``analysis.lockcheck`` -- the concurrency
  checker: an AST lint enforcing the codified lock discipline over
  ``src/repro_torch/core/`` (``python -m repro_torch.analysis lint``), and
  an opt-in (``WILKINS_LOCKCHECK=1``) runtime recorder of the cross-thread
  lock-acquisition graph.

The schedule explorer (``analysis.explore`` in the JAX package) is not
ported yet: with ``WILKINS_EXPLORE=1`` the lock factories raise.

``analysis.rules`` is the validation registry ``core.graph`` and the
driver call into at parse time.  Submodules resolve lazily, so importing
one never drags in the others (the analyzer itself imports
``core.graph``).
"""

from __future__ import annotations

import importlib

__all__ = ["rules", "diagnostics", "workflow", "astlint", "lockcheck",
           "plancheck", "cli"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
