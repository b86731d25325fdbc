"""Rule: lock-discipline (port of
``gaussiank_sgd_tpu/lint/rules/lock_discipline.py``; the same scope,
conventions and message).

The telemetry package is the repo's one genuinely multi-threaded surface:
the trainer thread emits through the EventBus/exporters while the
HealthServer thread reads monitor state for ``/healthz``. Every such class
guards its mutable attributes with a single ``self._lock``. This rule
infers, per class, which ``self._x`` attributes are lock-guarded — any
underscore-prefixed attribute touched at least once under
``with self._lock:`` — and flags accesses of those attributes from methods
that do NOT hold the lock. That is exactly the bug class a data race
produces: a read/write path added later that forgets the lock, invisible
to tests because CPython's GIL usually papers over it.

Exemptions (the repo's established conventions):

  * ``__init__`` / ``__new__`` — no concurrent access before the object
    escapes the constructor;
  * methods whose name ends in ``_locked`` — the documented
    called-while-holding-the-lock convention (e.g.
    ``PrometheusTextfileExporter._write_locked``).

Scoped to the packages that actually run host threads: ``telemetry/``
(bus/exporters/health/tracing), ``policy/`` (engine state read by the
health monitor), ``training/`` (metrics writer driven from the trainer
and prefetch threads), and ``data/loader.py`` (the prefetch thread
itself). Lock usage elsewhere (if any appears) has its own idioms and
this heuristic would be noise there.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set

from ..core import Finding, ModuleCtx

NAME = "lock-discipline"
SEVERITY = "warning"

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
_EXEMPT_METHODS = {"__init__", "__new__"}

# directories whose modules run host threads and follow the
# self._lock / *_locked convention; plus individually listed files
_THREADED_DIRS = {"telemetry", "policy", "training"}
_THREADED_FILES = {"loader.py"}


def _in_scope(path: str) -> bool:
    if os.path.basename(os.path.dirname(path)) in _THREADED_DIRS:
        return True
    return (os.path.basename(path) in _THREADED_FILES
            and os.path.basename(os.path.dirname(path)) == "data")


def _terminal_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for an ``self.x`` attribute node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attribute names assigned ``self.X = threading.Lock()/RLock()/...``."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign) and isinstance(node.value,
                                                            ast.Call)):
            continue
        if _terminal_name(node.value.func) not in _LOCK_FACTORIES:
            continue
        for tgt in node.targets:
            attr = _self_attr(tgt)
            if attr:
                locks.add(attr)
    return locks


class Rule:
    name = NAME
    severity = SEVERITY
    description = ("in threaded packages (telemetry/, policy/, training/, "
                   "data/loader.py), lock-guarded self._x attributes must "
                   "not be touched outside `with self._lock` (except in "
                   "__init__ and *_locked helpers)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not _in_scope(ctx.path):
            return
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(ctx, cls)

    # -- per-class ---------------------------------------------------------
    def _check_class(self, ctx: ModuleCtx,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        locks = _lock_attrs(cls)
        if not locks:
            return
        accesses = self._collect_accesses(ctx, cls, locks)
        guarded = {attr for attr, _, _, under in accesses if under} - locks
        if not guarded:
            return
        for attr, node, method, under in accesses:
            if under or attr not in guarded:
                continue
            if method is None or method.name in _EXEMPT_METHODS \
                    or method.name.endswith("_locked"):
                continue
            yield ctx.finding(
                NAME, SEVERITY, node,
                f"self.{attr} is lock-guarded elsewhere in "
                f"{cls.name} but accessed here without `with "
                f"self.{sorted(locks)[0]}`; take the lock, or rename the "
                f"method `*_locked` if every caller already holds it")

    def _collect_accesses(self, ctx: ModuleCtx, cls: ast.ClassDef,
                          locks: Set[str]) -> List[tuple]:
        """(attr, node, enclosing method, held) for every underscore
        ``self._x`` access lexically inside ``cls``."""
        out: List[tuple] = []
        for node in ast.walk(cls):
            attr = _self_attr(node)
            if attr is None or not attr.startswith("_") or attr in locks:
                continue
            method: Optional[ast.AST] = None
            owner: Optional[ast.ClassDef] = None
            held = False
            for anc in ctx.ancestors(node):
                if (isinstance(anc, ast.With)
                        and any(self._is_lock_expr(it.context_expr, locks)
                                for it in anc.items)):
                    held = True
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and method is None:
                    method = anc
                if isinstance(anc, ast.ClassDef):
                    owner = anc
                    break
            if owner is not cls:  # nested class: analysed on its own
                continue
            out.append((attr, node, method, held))
        return out

    @staticmethod
    def _is_lock_expr(expr: ast.AST, locks: Set[str]) -> bool:
        attr = _self_attr(expr)
        if attr in locks:
            return True
        # `with self._cond:` via acquire()-style calls is out of scope;
        # but `with self._lock as _:` parses the same Attribute
        return False
