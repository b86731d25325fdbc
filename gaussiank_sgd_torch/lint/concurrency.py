"""gklint v3 — host-runtime concurrency tier (port of
``gaussiank_sgd_tpu/lint/concurrency.py``; it ports as it is).

The host runtime is the multi-threaded half the step audit cannot see:
EventBus fan-out, the prefetch worker, HealthMonitor ticks,
the policy engine and SIGTERM shutdown all share mutable state behind
``threading`` locks. This tier runs whole-package (same
:func:`~.core.lint_paths` pass as the AST rules) and applies a per-class *lock
model*: a ``self._x`` attribute is **guarded** when it is touched at
least once under ``with self.<lock>:`` or inside a ``*_locked`` method,
anywhere in the package. On top of that model, four rules:

``conc-unguarded-access``
    guarded state read/written from a method that does not hold the lock
    (and is not ``__init__``/``__new__``/``*_locked``).
``conc-callback-under-lock``
    a callback — callable parameter, stored ``self._hook`` attribute, or
    fan-out over a ``self._exporters``-style collection — invoked while a
    lock is held. This is the EventBus.publish → exporter → publish
    reentrancy/deadlock shape.
``conc-thread-escape``
    ``threading.Thread(target=f)`` where ``f`` writes closure or
    ``self.*`` state that is also used outside the thread without any
    lock. Queue-only communication stays quiet.
``conc-blocking-under-lock``
    blocking calls inside a lock region: ``sleep``, thread-style
    ``.join()``, ``open()``, file/socket I/O methods, ``subprocess``.
    ``cond.wait()`` is exempt (it releases the lock).

Like every gklint tier this is pure-AST: nothing is imported or run.
Run it via ``python -m gaussiank_sgd_torch.lint concurrency``.
"""

from __future__ import annotations

import ast
from typing import (Dict, FrozenSet, Iterator, List, Optional, Sequence,
                    Set, Tuple)

from .core import Finding, ModuleCtx, lint_paths_detailed
from .rules.lock_discipline import _lock_attrs, _self_attr, _terminal_name

_EXEMPT_METHODS = {"__init__", "__new__"}
_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

# attribute-call names treated as blocking I/O when a lock is held
_IO_METHODS = {"write", "writelines", "read", "readline", "readlines",
               "recv", "send", "sendall", "flush_to_disk"}
_SUBPROCESS_CALLS = {"run", "check_call", "check_output", "Popen",
                     "communicate", "call"}


# --------------------------------------------------------------------------
# lock model helpers
# --------------------------------------------------------------------------

def _class_locks(cls: ast.ClassDef) -> FrozenSet[str]:
    """``_lock_attrs`` memoised on the class node: the rules ask once a
    call site, and the answer depends on the class alone."""
    locks = getattr(cls, "_gklint_locks", None)
    if locks is None:
        locks = frozenset(_lock_attrs(cls))
        cls._gklint_locks = locks  # type: ignore[attr-defined]
    return locks


def _module_locks(tree: ast.Module) -> Set[str]:
    """Module-global names bound to ``threading.Lock()/RLock()/Condition()``."""
    out: Set[str] = set()
    for node in tree.body:
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        if _terminal_name(node.value.func) not in _LOCK_FACTORIES:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                out.add(tgt.id)
    return out


def _is_lock_expr(expr: ast.AST, self_locks: Set[str],
                  mod_locks: Set[str]) -> bool:
    attr = _self_attr(expr)
    if attr is not None and attr in self_locks:
        return True
    if isinstance(expr, ast.Name) and expr.id in mod_locks:
        return True
    return False


def _lock_state(ctx: ModuleCtx, node: ast.AST, self_locks: Set[str],
                mod_locks: Set[str]) -> Tuple[bool, Optional[ast.AST],
                                              Optional[ast.expr]]:
    """(held, enclosing function, innermost held lock expr) for ``node``.

    ``held`` is True when a ``with <lock>:`` sits between the node and its
    nearest enclosing function, or when that function follows the
    ``*_locked`` naming convention (caller holds the lock). The with-lock
    search stops at the function boundary: a nested ``def`` under a lock
    does not *run* under it.
    """
    held = False
    fn: Optional[ast.AST] = None
    lock_expr: Optional[ast.expr] = None
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if fn is None:
                fn = anc
                if anc.name.endswith("_locked"):
                    held = True
            continue
        if fn is None and isinstance(anc, ast.With):
            for it in anc.items:
                if _is_lock_expr(it.context_expr, self_locks, mod_locks):
                    held = True
                    if lock_expr is None:
                        lock_expr = it.context_expr
    return held, fn, lock_expr


def _enclosing_method(ctx: ModuleCtx,
                      node: ast.AST) -> Optional[ast.FunctionDef]:
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _owner_class(ctx: ModuleCtx, node: ast.AST) -> Optional[ast.ClassDef]:
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc
    return None


def _fn_params(fn: ast.AST) -> Set[str]:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        return set()
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _local_defs(fn: ast.AST) -> Set[str]:
    """Names bound by ``def``/``class``/import inside ``fn`` (not calls)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node is not fn:
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
    return out


def _assigned_names(fn: ast.AST) -> Set[str]:
    """Every plain-``Name`` binding inside ``fn`` (params, =, for, with as,
    comprehensions) — the function's locals, approximately."""
    out = set(_fn_params(fn))
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            out -= set(node.names)
    return out


# --------------------------------------------------------------------------
# rule 1: conc-unguarded-access
# --------------------------------------------------------------------------

class UnguardedAccessRule:
    name = "conc-unguarded-access"
    severity = "error"
    description = ("lock-guarded self._x state (touched under `with "
                   "self._lock` or in a *_locked method anywhere in the "
                   "package) accessed without the lock")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(ctx, cls)

    def _check_class(self, ctx: ModuleCtx,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        locks = _class_locks(cls)
        if not locks:
            return
        mod_locks = _module_locks(ctx.tree)
        accesses: List[tuple] = []
        for node in ast.walk(cls):
            attr = _self_attr(node)
            if attr is None or not attr.startswith("_") or attr in locks:
                continue
            if _owner_class(ctx, node) is not cls:
                continue
            held, fn, _ = _lock_state(ctx, node, locks, mod_locks)
            accesses.append((attr, node, fn, held))
        guarded = {a for a, _, _, held in accesses if held}
        if not guarded:
            return
        for attr, node, fn, held in accesses:
            if held or attr not in guarded:
                continue
            if fn is None or fn.name in _EXEMPT_METHODS \
                    or fn.name.endswith("_locked"):
                continue
            yield ctx.finding(
                self.name, self.severity, node,
                f"self.{attr} is guarded by self.{sorted(locks)[0]} "
                f"elsewhere in {cls.name} but touched here without it; "
                f"take the lock or rename this helper `*_locked`")


# --------------------------------------------------------------------------
# rule 2: conc-callback-under-lock
# --------------------------------------------------------------------------

class CallbackUnderLockRule:
    name = "conc-callback-under-lock"
    severity = "error"
    description = ("callback / exporter fan-out invoked while holding a "
                   "lock — reentrant publish or slow callee deadlocks "
                   "every other thread on the lock")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        mod_locks = _module_locks(ctx.tree)
        for call in ast.walk(ctx.tree):
            if not isinstance(call, ast.Call):
                continue
            cls = _owner_class(ctx, call)
            self_locks = _class_locks(cls) if cls is not None else set()
            if not self_locks and not mod_locks:
                continue
            held, fn, _ = _lock_state(ctx, call, self_locks, mod_locks)
            if not held or fn is None:
                continue
            reason = self._callback_reason(ctx, call, cls, fn)
            if reason:
                yield ctx.finding(self.name, self.severity, call, reason)

    def _callback_reason(self, ctx: ModuleCtx, call: ast.Call,
                         cls: Optional[ast.ClassDef],
                         fn: ast.AST) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in _local_defs(fn):
                return None  # locally-defined helper: body is visible
            if func.id in _fn_params(fn):
                return (f"callable parameter `{func.id}` invoked while "
                        f"holding a lock; call it after releasing")
            src = self._fanout_source(ctx, call, func.id, fn)
            if src:
                return (f"fan-out over {src} invoked under the lock; "
                        f"snapshot the collection and call outside")
            return None
        if isinstance(func, ast.Attribute):
            base = func.value
            attr = _self_attr(func)
            if attr is not None and cls is not None:
                methods = {n.name for n in cls.body
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
                if attr not in methods and self._is_data_attr(cls, attr):
                    return (f"stored callback self.{attr} invoked while "
                            f"holding a lock; snapshot it and call after "
                            f"releasing")
                return None
            if isinstance(base, ast.Name):
                src = self._fanout_source(ctx, call, base.id, fn)
                if src:
                    return (f"`.{func.attr}()` on an element of {src} "
                            f"while holding the lock; deliver outside "
                            f"the critical section")
        return None

    @staticmethod
    def _is_data_attr(cls: ast.ClassDef, attr: str) -> bool:
        for node in ast.walk(cls):
            tgt_attr = None
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if _self_attr(t) == attr:
                        tgt_attr = attr
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                if _self_attr(node.target) == attr:
                    tgt_attr = attr
            if tgt_attr:
                return True
        return False

    @staticmethod
    def _fanout_source(ctx: ModuleCtx, call: ast.Call, name: str,
                       fn: ast.AST) -> Optional[str]:
        """'self._x' when ``name`` is the loop variable of a
        ``for name in self._x`` (or an alias of self._x) ancestor."""
        def _self_collection(expr: ast.AST) -> Optional[str]:
            a = _self_attr(expr)
            if a is not None:
                return f"self.{a}"
            if isinstance(expr, ast.Call) and \
                    _terminal_name(expr.func) in {"list", "tuple", "sorted"}:
                if expr.args:
                    return _self_collection(expr.args[0])
            return None

        for anc in ctx.ancestors(call):
            if anc is fn:
                break
            if isinstance(anc, ast.For) and \
                    isinstance(anc.target, ast.Name) and \
                    anc.target.id == name:
                direct = _self_collection(anc.iter)
                if direct:
                    return direct
                if isinstance(anc.iter, ast.Name):
                    # one step through a local alias: x = self._y; for e in x
                    for node in ast.walk(fn):
                        if isinstance(node, ast.Assign) and \
                                any(isinstance(t, ast.Name)
                                    and t.id == anc.iter.id
                                    for t in node.targets):
                            src = _self_collection(node.value)
                            if src:
                                return src
        return None


# --------------------------------------------------------------------------
# rule 3: conc-thread-escape
# --------------------------------------------------------------------------

class ThreadEscapeRule:
    name = "conc-thread-escape"
    severity = "warning"
    description = ("threading.Thread target writes closure / self state "
                   "that is also used outside the thread without a lock; "
                   "communicate through a Queue or guard both sides")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        mod_locks = _module_locks(ctx.tree)
        for call in ast.walk(ctx.tree):
            if not (isinstance(call, ast.Call)
                    and _terminal_name(call.func) == "Thread"):
                continue
            target = next((kw.value for kw in call.keywords
                           if kw.arg == "target"), None)
            if target is None:
                continue
            tgt_fn = self._resolve_target(ctx, call, target)
            if tgt_fn is None:
                continue
            cls = _owner_class(ctx, call)
            self_locks = _class_locks(cls) if cls is not None else set()
            yield from self._check_target(ctx, call, tgt_fn, cls,
                                          self_locks, mod_locks)

    @staticmethod
    def _resolve_target(ctx: ModuleCtx, call: ast.Call,
                        target: ast.AST) -> Optional[ast.AST]:
        if isinstance(target, ast.Name):
            # nearest lexically-enclosing def with that name, else module
            best: Optional[ast.AST] = None
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name == target.id:
                    best = node if best is None else best
            return best
        attr = _self_attr(target)
        if attr is not None:
            cls = _owner_class(ctx, call)
            if cls is not None:
                for node in cls.body:
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                            and node.name == attr:
                        return node
        return None

    def _check_target(self, ctx: ModuleCtx, call: ast.Call, tgt_fn: ast.AST,
                      cls: Optional[ast.ClassDef], self_locks: Set[str],
                      mod_locks: Set[str]) -> Iterator[Finding]:
        locals_ = _assigned_names(tgt_fn)
        for node in ast.walk(tgt_fn):
            stored = self._shared_store(node, locals_)
            if stored is None:
                continue
            held, _, _ = _lock_state(ctx, node, self_locks, mod_locks)
            if held:
                continue
            if not self._used_outside(ctx, tgt_fn, cls, stored):
                continue
            kind, name = stored
            what = f"self.{name}" if kind == "attr" else f"`{name}`"
            yield ctx.finding(
                self.name, self.severity, node,
                f"thread target `{getattr(tgt_fn, 'name', '<lambda>')}` "
                f"writes {what}, which is also used outside the thread, "
                f"without holding a lock (thread-escape); guard both "
                f"sides or hand results over a Queue")

    @staticmethod
    def _shared_store(node: ast.AST,
                      locals_: Set[str]) -> Optional[Tuple[str, str]]:
        """('attr'|'name', identifier) when ``node`` stores shared state."""
        tgts: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            tgts = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            tgts = [node.target]
        for t in tgts:
            if isinstance(t, ast.Subscript):
                t = t.value
            attr = _self_attr(t)
            if attr is not None:
                return ("attr", attr)
            if isinstance(t, ast.Name) and t.id not in locals_:
                return ("name", t.id)
        return None

    @staticmethod
    def _used_outside(ctx: ModuleCtx, tgt_fn: ast.AST,
                      cls: Optional[ast.ClassDef],
                      stored: Tuple[str, str]) -> bool:
        kind, name = stored
        scope: ast.AST = cls if (kind == "attr" and cls is not None) \
            else ctx.tree
        inside = set(ast.walk(tgt_fn))
        for node in ast.walk(scope):
            if node in inside:
                continue
            if kind == "attr" and _self_attr(node) == name:
                return True
            if kind == "name" and isinstance(node, ast.Name) \
                    and node.id == name:
                return True
        return False


# --------------------------------------------------------------------------
# rule 4: conc-blocking-under-lock
# --------------------------------------------------------------------------

class BlockingUnderLockRule:
    name = "conc-blocking-under-lock"
    severity = "warning"
    description = ("blocking call (sleep / thread join / file or socket "
                   "I/O / subprocess) inside a lock region stalls every "
                   "thread contending for the lock")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        mod_locks = _module_locks(ctx.tree)
        for call in ast.walk(ctx.tree):
            if not isinstance(call, ast.Call):
                continue
            cls = _owner_class(ctx, call)
            self_locks = _class_locks(cls) if cls is not None else set()
            if not self_locks and not mod_locks:
                continue
            held, fn, lock_expr = _lock_state(ctx, call, self_locks,
                                              mod_locks)
            if not held:
                continue
            reason = self._blocking_reason(call, lock_expr)
            if reason:
                yield ctx.finding(self.name, self.severity, call, reason)

    def _blocking_reason(self, call: ast.Call,
                         lock_expr: Optional[ast.expr]) -> Optional[str]:
        func = call.func
        term = _terminal_name(func)
        if term == "sleep":
            return "time.sleep() while holding a lock"
        if isinstance(func, ast.Name) and term == "open":
            return "open() while holding a lock — file I/O in a " \
                   "critical section"
        if isinstance(func, ast.Attribute):
            base = func.value
            if term == "wait" and lock_expr is not None and \
                    ast.dump(base) == ast.dump(lock_expr):
                return None  # cond.wait() releases the lock it waits on
            if term == "join" and self._is_thread_join(call):
                return ".join() on a thread/queue while holding a lock " \
                       "— classic shutdown deadlock"
            if term in _IO_METHODS:
                return f".{term}() under a lock — blocking I/O in a " \
                       f"critical section"
            if term in _SUBPROCESS_CALLS and \
                    isinstance(base, ast.Name) and base.id == "subprocess":
                return f"subprocess.{term}() while holding a lock"
        return None

    @staticmethod
    def _is_thread_join(call: ast.Call) -> bool:
        """Thread/queue join, not str.join / os.path.join: zero args, a
        timeout kwarg, or a single numeric timeout."""
        if any(kw.arg == "timeout" for kw in call.keywords):
            return True
        if not call.args and not call.keywords:
            return True
        if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, (int, float)):
            return True
        return False


CONCURRENCY_RULES = (UnguardedAccessRule(), CallbackUnderLockRule(),
                     ThreadEscapeRule(), BlockingUnderLockRule())


def concurrency_rules() -> Sequence[object]:
    return list(CONCURRENCY_RULES)


def lint_concurrency(paths: Sequence[str],
                     rel_to: Optional[str] = None):
    """Run the concurrency tier whole-package.

    Returns ``(findings, suppressions)`` — suppressions carry ``matched``
    flags for the stale-suppression detector in the CLI.
    """
    return lint_paths_detailed(paths, rules=concurrency_rules(),
                               rel_to=rel_to)
