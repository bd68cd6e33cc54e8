"""Validation and concurrency-checking support used by the core modules.

``analysis.rules`` is the validation registry ``core.graph`` and the driver
call into at parse time; ``analysis.lockcheck`` holds the lock factories
and the opt-in (``WILKINS_LOCKCHECK=1``) runtime lock-order checker;
``analysis.diagnostics`` is the findings framework both report through.
Submodules resolve lazily so importing one never drags in the others.
"""

from __future__ import annotations

import importlib

__all__ = ["rules", "diagnostics", "lockcheck"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
