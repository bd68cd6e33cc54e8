"""User-defined custom actions (paper §3.5.2, Listings 3 & 5).

Users extend the otherwise declarative workflow with imperative callbacks by
supplying an external Python script; the YAML names it per task:

    actions: ["actions", "nyx"]     # script `actions.py`, function `nyx`

The function receives ``(vol, rank)`` -- the task instance's VOL object and
its rank -- and registers callbacks on the VOL's execution points
(``set_after_file_close`` etc.).  The Wilkins-master code itself is never
modified: this is the paper's middle ground between declarative and
imperative interfaces.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
from typing import Callable, Optional, Tuple

__all__ = ["load_action"]


def load_action(spec: Tuple[str, str], search_dirs=()) -> Callable:
    """Resolve (script_or_module, function) to a callable.

    ``script_or_module`` may be a path to a ``.py`` file (with or without the
    extension, searched in ``search_dirs`` then the CWD) or an importable
    module name.
    """
    modname, funcname = spec
    candidates = []
    for d in list(search_dirs) + [os.getcwd()]:
        candidates.append(os.path.join(d, modname + ".py"))
        candidates.append(os.path.join(d, modname))
    for path in candidates:
        if os.path.isfile(path):
            spec_ = importlib.util.spec_from_file_location(
                f"wilkins_actions_{os.path.basename(modname)}", path
            )
            mod = importlib.util.module_from_spec(spec_)
            spec_.loader.exec_module(mod)
            return getattr(mod, funcname)
    # fall back to a normal import
    mod = importlib.import_module(modname)
    return getattr(mod, funcname)
