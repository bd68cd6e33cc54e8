"""Pass 2 (static half): the AST lint enforcing the core lock discipline.

The transport's concurrency invariants used to live only in docstrings and
review memory.  This lint codifies them as checkable rules over
``src/repro_torch/core/``:

* **WLK301** -- channel state (the ring queue, seq counters, epoch/poison/
  grace flags, waiter sets) is mutated only under the channel condition
  variable.  Methods whose names end in ``_locked`` declare
  caller-holds-lock and are exempt (the convention the lint enforces
  everywhere else makes the exemption auditable); ``__init__`` runs before
  the object is shared.
* **WLK302** -- ``Condition.wait`` only inside a ``while`` predicate loop:
  an ``if``-guarded wait misses spurious wakeups and missed-notify races.
* **WLK303** -- a wait loop that paces itself by the supervisor's
  ``wait_quantum`` must also ``heartbeat``: a parked-but-alive waiter that
  goes silent gets declared stalled by the watchdog and killed.
* **WLK304** -- ``stats`` counters are mutated only under a lock (or in
  ``_locked`` helpers); torn increments silently undercount.
* **WLK305** -- synchronization primitives are constructed through the
  ``make_lock``/``make_condition``/``make_semaphore`` factories in
  ``analysis.lockcheck``, never via ``threading.Lock()`` and friends
  directly: a raw primitive is invisible to the runtime lock-order
  recorder AND to the schedule explorer, so its interleavings are never
  checked.  The factories themselves (and the explore-mode fallbacks)
  carry line suppressions.

Suppress a finding with a ``# wilkins: ignore[WLK30x]`` comment on the
offending line -- the one legitimate use in-tree (``ChannelMux.wait``'s
if-guarded wait, whose callers rescan by design) documents why.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from .diagnostics import Diagnostic, Findings, Location, line_suppressions

__all__ = ["lint_file", "lint_paths", "PROTECTED_CHANNEL_STATE"]

#: Channel fields owned by the channel CV (the channel.py state block).
PROTECTED_CHANNEL_STATE = frozenset({
    "_queue", "_done", "_serve_seq", "_acked_seq", "_close_count",
    "_acked_close_count", "_delivered_seq", "_acked_delivered_seq",
    "_replay", "_replay_enabled", "_epoch", "_poison", "_abandoned",
    "_grace", "_retention", "_retained", "_interrupt", "_waiters",
})

#: attribute names that identify a condition-variable receiver for the
#: wait-in-while rule
CV_ATTRS = frozenset({"_lock", "_cond", "_cv"})

_MUTATORS = frozenset({"append", "appendleft", "pop", "popleft", "clear",
                       "extend", "add", "remove", "discard", "update",
                       "insert"})

#: constructors the make_* factories wrap; Event/Thread/Barrier stay legal
#: (they are signaling, not mutual exclusion -- nothing for the lock-order
#: recorder or the explorer to model)
_RAW_PRIMITIVES = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                             "BoundedSemaphore"})

_FACTORY_FOR = {"Lock": "make_lock", "RLock": "make_lock",
                "Condition": "make_condition", "Semaphore": "make_semaphore",
                "BoundedSemaphore": "make_semaphore"}


def _ident(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_lockish(expr: ast.AST) -> bool:
    """Does this with-item expression look like a lock/CV acquisition?"""
    if isinstance(expr, ast.Call):      # e.g. ``with self._lock:`` vs call
        expr = expr.func
    s = _ident(expr)
    if s is None:
        return False
    s = s.lower()
    return "lock" in s or "cond" in s or s in ("cv", "_cv", "sem", "_sem")


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Diagnostic] = []
        self._func_stack: List[str] = []
        self._with_lock_depth = 0
        self._while_depth = 0
        # the shared-state rules (WLK301/304) only apply inside classes
        # that own a lock -- a single-threaded queue or a local stats dict
        # has no lock to hold
        self._class_owns_lock: List[bool] = []
        # local aliases bound by ``from threading import Lock [as L]``
        self._threading_aliases: dict = {}

    # ------------------------------------------------------------- helpers
    def _exempt(self) -> bool:
        """True inside a caller-holds-lock helper or a constructor."""
        return any(f.endswith("_locked") or f == "__init__"
                   for f in self._func_stack)

    def _add(self, code: str, message: str, node: ast.AST) -> None:
        self.findings.append(Diagnostic(code, message, Location(
            file=self.path, line=getattr(node, "lineno", None))))

    # -------------------------------------------------------------- scopes
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        saved = self._while_depth
        self._while_depth = 0
        self.generic_visit(node)
        self._while_depth = saved
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        owns = any(
            isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
            and isinstance(n.value, ast.Name) and n.value.id == "self"
            and _is_lockish(n)
            for n in ast.walk(node))
        self._class_owns_lock.append(owns)
        self.generic_visit(node)
        self._class_owns_lock.pop()

    def _locked_domain(self) -> bool:
        return bool(self._class_owns_lock) and self._class_owns_lock[-1]

    def visit_With(self, node: ast.With) -> None:
        lockish = any(_is_lockish(item.context_expr) for item in node.items)
        if lockish:
            self._with_lock_depth += 1
        self.generic_visit(node)
        if lockish:
            self._with_lock_depth -= 1

    def visit_While(self, node: ast.While) -> None:
        self._while_depth += 1
        self._check_wait_loop_heartbeat(node)
        self.generic_visit(node)
        self._while_depth -= 1

    # --------------------------------------------------------------- rules
    def _check_wait_loop_heartbeat(self, node: ast.While) -> None:
        calls = [n.func.attr for n in ast.walk(node)
                 if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)]
        if "wait_quantum" in calls and "heartbeat" not in calls:
            self._add(
                "WLK303",
                "wait loop paces itself by the supervisor's wait_quantum "
                "but never calls heartbeat -- a parked-but-alive waiter "
                "will be declared stalled by the watchdog", node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "threading":
            for alias in node.names:
                if alias.name in _RAW_PRIMITIVES:
                    self._threading_aliases[alias.asname or alias.name] = \
                        alias.name
        self.generic_visit(node)

    def _check_raw_primitive(self, node: ast.Call) -> None:
        f = node.func
        prim = None
        if isinstance(f, ast.Attribute) and f.attr in _RAW_PRIMITIVES \
                and isinstance(f.value, ast.Name) \
                and f.value.id == "threading":
            prim = f.attr
        elif isinstance(f, ast.Name) and f.id in self._threading_aliases:
            prim = self._threading_aliases[f.id]
        if prim is not None:
            self._add(
                "WLK305",
                f"direct threading.{prim}() construction -- use "
                f"analysis.lockcheck.{_FACTORY_FOR[prim]}(name) so the "
                f"lock-order recorder and the schedule explorer can see "
                f"this primitive", node)

    def visit_Call(self, node: ast.Call) -> None:
        self._check_raw_primitive(node)
        f = node.func
        if isinstance(f, ast.Attribute):
            # WLK302: cv.wait(...) outside a while loop
            if f.attr in ("wait", "wait_for") \
                    and isinstance(f.value, ast.Attribute) \
                    and f.value.attr in CV_ATTRS:
                if self._while_depth == 0:
                    self._add(
                        "WLK302",
                        f"Condition.wait on {ast.unparse(f.value)} outside "
                        f"a while predicate loop -- spurious wakeups and "
                        f"missed notifies slip through an if-guard", node)
            # WLK301/304: mutating method calls on protected state
            if f.attr in _MUTATORS and not self._exempt() \
                    and self._with_lock_depth == 0 and self._locked_domain():
                tgt = f.value
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self" \
                        and tgt.attr in PROTECTED_CHANNEL_STATE:
                    self._add(
                        "WLK301",
                        f"channel state self.{tgt.attr}.{f.attr}(...) "
                        f"mutated outside the channel condition variable",
                        node)
                elif self._chain_has_stats(tgt):
                    self._add(
                        "WLK304",
                        f"stats field {ast.unparse(tgt)}.{f.attr}(...) "
                        f"mutated outside its owning lock", node)
        self.generic_visit(node)

    @staticmethod
    def _chain_has_stats(node: ast.AST) -> bool:
        while isinstance(node, ast.Attribute):
            if node.attr == "stats":
                return True
            node = node.value
        return isinstance(node, ast.Name) and node.id == "stats"

    def _check_store(self, target: ast.AST, node: ast.AST) -> None:
        if self._exempt() or self._with_lock_depth > 0 \
                or not self._locked_domain():
            return
        if isinstance(target, ast.Attribute):
            if isinstance(target.value, ast.Name) \
                    and target.value.id == "self" \
                    and target.attr in PROTECTED_CHANNEL_STATE:
                self._add(
                    "WLK301",
                    f"channel state self.{target.attr} assigned outside "
                    f"the channel condition variable", node)
            elif self._chain_has_stats(target.value):
                self._add(
                    "WLK304",
                    f"stats field {ast.unparse(target)} mutated outside "
                    f"its owning lock", node)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_store(elt, node)
        elif isinstance(target, ast.Subscript):
            self._check_store(target.value, node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_store(t, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store(node.target, node)
        self.generic_visit(node)


def lint_file(path: str) -> Findings:
    with open(path) as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return Findings([Diagnostic(
            "WLK001", f"failed to parse {path}: {e}",
            Location(file=path, line=e.lineno))])
    linter = _Linter(path)
    linter.visit(tree)
    return Findings(linter.findings).suppress(
        by_line=line_suppressions(source))


def lint_paths(paths: List[str]) -> Findings:
    out = Findings()
    for p in paths:
        if os.path.isdir(p):
            for dirpath, _, names in sorted(os.walk(p)):
                for n in sorted(names):
                    if n.endswith(".py"):
                        out.extend(lint_file(os.path.join(dirpath, n)))
        elif p.endswith(".py"):
            out.extend(lint_file(p))
    return out
